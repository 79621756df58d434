"""Blocked domain decomposition (counterpart of ``roms_tpu/parallel``).

``halo.py`` holds the halo exchange (the mp_exchange analog) and its two
implementations, ``InProcess`` (every block in one process, a thread a
block) and ``Distributed`` (a block a rank of ``torch.distributed``);
``smap.py`` splits a state into blocks and steps them.  roms_tpu's
``parallel/shard.py`` (XLA's GSPMD partitioner) has no PyTorch analog: the
blocked path computes the same decomposed step.
"""
