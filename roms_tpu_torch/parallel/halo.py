"""Halo exchange between the blocks of a decomposed domain (the
mp_exchange facade; counterpart of ``roms_tpu/parallel/halo.py``).

The reference's mp_exchange2d/3d/4d (ROMS/Utility/mp_exchange.F:290-3429)
swaps Nghost-wide edge strips with the four lattice neighbours in two
phases (W-E first, then S-N including the just-filled corners) and fuses
up to 4 fields per message.  Here a block is a halo-padded [..., j, i]
tensor; ``exchange_axis`` swaps one axis' strips on a ring of blocks (the
periodic wrap falls out of the ring), and ``exchange_2d`` does both
phases for several fields stacked into one message.

The swap and the all-block sum go through an exchange object, of which
there are two:

- ``InProcess(eta_blocks, xi_blocks)``: every block in this process, each
  stepped by a thread of its own (``map``), one thread running at a time:
  a block runs to its next swap, posts its strips and hands on to the
  next block; when its turn comes again every block has posted.
- ``Distributed(eta_blocks, xi_blocks)``: a block a rank of an
  initialised ``torch.distributed`` process group (gloo on the CPU, NCCL
  on CUDA tensors), one rank per block, ranks row-major over the layout.

A swap or a sum is a collective: every block calls it in the same order.
A branch on edge ownership may skip a boundary write, never an exchange.
"""

from __future__ import annotations

import threading

import torch


def _neighbours(shape, pos, axis: int):
    """The blocks below and above `pos` along `axis` (-1 xi, -2 eta) on
    the ring of its row or column."""
    py, px = shape
    r, c = pos
    if axis == -1:
        return (r, (c - 1) % px), (r, (c + 1) % px)
    return ((r - 1) % py, c), ((r + 1) % py, c)


class InProcess:
    """The blocks of an (eta_blocks, xi_blocks) layout in one process, a
    thread a block, run one at a time: a block runs until its next
    collective, posts its part and hands the turn to the next block; at
    its next turn every block has posted and it reads.  So the blocks run
    in a fixed order without contending for the interpreter, and two
    buffers of posts suffice (a post of collective g + 2 comes after every
    block has read g).  ``rank`` is the process number of the output
    files (io/pio.py): 0."""

    rank = 0

    def __init__(self, eta_blocks: int, xi_blocks: int):
        self.shape = (int(eta_blocks), int(xi_blocks))
        self._tls = threading.local()

    def blocks(self):
        """The block positions (row, column) this process steps."""
        py, px = self.shape
        return [(r, c) for r in range(py) for c in range(px)]

    def position(self):
        return self._tls.pos

    def _wait_turn(self, k: int):
        self._go[k].acquire()
        if self._failed:
            raise RuntimeError("another block of the layout failed")

    def _hand_on(self, k: int) -> int:
        """Give the turn to the next block still running; returns it."""
        n = len(self._done)
        nxt = next((k + d) % n for d in range(1, n + 1)
                   if not self._done[(k + d) % n])
        self._go[nxt].release()
        return nxt

    def _collective(self, item, read):
        """Post `item`, let every other block post its own, then
        read(posts)."""
        k, gen = self._tls.k, self._tls.gen
        self._tls.gen += 1
        box = self._boxes[gen % 2]
        box[self.position()] = (gen, item)
        if self._hand_on(k) == k:
            raise RuntimeError("a collective that the other blocks of the "
                               "layout did not call")
        self._wait_turn(k)
        if any(g != gen for g, _ in box.values()):
            raise RuntimeError("the blocks of the layout called different "
                               "collectives")
        return read({pos: it for pos, (_, it) in box.items()})

    def swap(self, lo, hi, axis: int):
        """Send the strip next to the low halo (`lo`) to the block below
        and `hi` to the block above; returns (the strip of the block below
        for my low halo, the strip of the block above for my high halo)."""
        below, above = _neighbours(self.shape, self.position(), axis)
        return self._collective(
            (lo, hi), lambda box: (box[below][1], box[above][0]))

    def sum(self, t):
        """The sum of `t` over all blocks, in block order, the same tensor
        on every block (the mp_reduce analog)."""
        order = self.blocks()

        def read(box):
            total = box[order[0]].clone()
            for pos in order[1:]:
                total = total + box[pos]
            return total
        return self._collective(t, read)

    def map(self, fn, blocks: dict) -> dict:
        """{pos: fn(pos, blocks[pos])} with a thread a block, in turns.  A
        failure in one block stops the others at their next collective;
        the first failure is raised."""
        order = self.blocks()
        self._boxes = [{}, {}]
        self._done = [False] * len(order)
        self._go = [threading.Semaphore(0) for _ in order]
        self._failed = False
        out, errors = {}, []
        grad = torch.is_grad_enabled()

        def work(k, pos):
            self._tls.pos, self._tls.k, self._tls.gen = pos, k, 0
            torch.set_grad_enabled(grad)
            try:
                self._wait_turn(k)
                out[pos] = fn(pos, blocks[pos])
            except BaseException as exc:  # noqa: BLE001 - re-raised below
                errors.append(exc)
                self._failed = True
                for go in self._go:
                    go.release()
            finally:
                self._done[k] = True
                if not all(self._done):
                    self._hand_on(k)

        threads = [threading.Thread(target=work, args=(k, pos))
                   for k, pos in enumerate(order)]
        for th in threads:
            th.start()
        self._go[0].release()
        for th in threads:
            th.join()
        if errors:
            raise errors[0]
        return out


class Distributed:
    """A block a rank of the default ``torch.distributed`` group (already
    initialised, world size eta_blocks * xi_blocks, ranks row-major)."""

    def __init__(self, eta_blocks: int, xi_blocks: int):
        import torch.distributed as dist
        self._dist = dist
        self.shape = (int(eta_blocks), int(xi_blocks))
        world = dist.get_world_size()
        if world != self.shape[0] * self.shape[1]:
            raise ValueError(f"{world} ranks for a {self.shape[0]}x"
                             f"{self.shape[1]} layout")
        self.rank = dist.get_rank()
        self._pos = divmod(self.rank, self.shape[1])

    def blocks(self):
        return [self._pos]

    def position(self):
        return self._pos

    def _rank(self, pos) -> int:
        return pos[0] * self.shape[1] + pos[1]

    def swap(self, lo, hi, axis: int):
        dist = self._dist
        below, above = (self._rank(p) for p in
                        _neighbours(self.shape, self._pos, axis))
        lo, hi = lo.contiguous(), hi.contiguous()
        from_below = torch.empty_like(hi)
        from_above = torch.empty_like(lo)
        # receives posted in the order the neighbours send (lo, then hi),
        # so they match also where tags are ignored and below == above
        ops = [dist.P2POp(dist.isend, lo, below, tag=0),
               dist.P2POp(dist.isend, hi, above, tag=1),
               dist.P2POp(dist.irecv, from_above, above, tag=0),
               dist.P2POp(dist.irecv, from_below, below, tag=1)]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        return from_below, from_above

    def sum(self, t):
        t = t.clone()
        self._dist.all_reduce(t)
        return t

    def map(self, fn, blocks: dict) -> dict:
        return {self._pos: fn(self._pos, blocks[self._pos])}


def exchange_axis(f, exchange, width: int, axis: int = -1):
    """Refresh the `width`-wide halos of `f` along `axis` (-1 xi, -2 eta;
    the exchange's shape is (eta, xi) blocks)
    from the neighbouring blocks: my high interior strip becomes the block
    above's low halo and vice versa.  With one block along the axis the
    strips wrap locally (roms_tpu/parallel/halo.py:40-47).  Returns a new
    tensor."""
    size = f.shape[axis]
    lo = f.narrow(axis, width, width)
    hi = f.narrow(axis, size - 2 * width, width)
    if exchange.shape[axis] == 1:
        from_below, from_above = hi, lo
    else:
        from_below, from_above = exchange.swap(lo, hi, axis)
    out = f.clone()
    out.narrow(axis, 0, width).copy_(from_below)
    out.narrow(axis, size - width, width).copy_(from_above)
    return out


def exchange_2d(cfg, *fields, exchange, width: int = None):
    """Two-phase exchange of one or more same-shaped [..., j, i] blocks:
    xi first, then eta with the corners (mp_exchange.F:413,538), the
    fields stacked into one message each way."""
    width = cfg.halo if width is None else width
    stacked = torch.stack(fields, dim=0) if len(fields) > 1 else fields[0]
    stacked = exchange_axis(stacked, exchange, width, axis=-1)
    stacked = exchange_axis(stacked, exchange, width, axis=-2)
    if len(fields) > 1:
        return tuple(stacked[i] for i in range(len(fields)))
    return stacked
