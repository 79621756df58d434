"""A blocked run of a model case with sharded history output.

    python -m roms_tpu_torch.parallel.run --case upwelling --layout 2x4 \\
        --nsteps 10 --nhis 5 --out his_blocked [--device cpu] \\
        [--config '{"Lm": 24, "Mm": 16, "N": 4}']

runs every block in this process (``halo.InProcess``).  With ``--init
tcp://HOST:PORT --rank R --world W`` it is one of W processes, a block
each (``halo.Distributed``; gloo for ``--device cpu``, NCCL for cuda),
started once per rank.  Each process writes its blocks' interiors to
``<out>.pNNN.nc`` (io/pio.py); ``io.pio.read_sharded(out)`` or
``assemble(out)`` joins them.  The last line printed is a JSON summary.
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m roms_tpu_torch.parallel.run")
    ap.add_argument("--case", default="upwelling")
    ap.add_argument("--config", default="{}",
                    help="JSON object of Config fields (the YAML config "
                         "section)")
    ap.add_argument("--layout", default="2x4",
                    help="eta_blocks x xi_blocks")
    ap.add_argument("--nsteps", type=int, default=10)
    ap.add_argument("--nhis", type=int, default=0,
                    help="a history record every NHIS steps (0: the last)")
    ap.add_argument("--out", required=True, help="base of the part files")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--init", default=None,
                    help="torch.distributed init method (tcp://host:port)")
    ap.add_argument("--rank", type=int, default=0)
    ap.add_argument("--world", type=int, default=1)
    args = ap.parse_args(argv)

    import torch
    from ..io import pio
    from ..utils.yamlcfg import build_from_dict
    from . import halo, smap

    py, px = (int(n) for n in args.layout.lower().split("x"))
    dist = None
    if args.init is not None:
        import torch.distributed as dist
        backend = "gloo" if args.device == "cpu" else "nccl"
        dist.init_process_group(backend, init_method=args.init,
                                rank=args.rank, world_size=args.world)
        exchange = halo.Distributed(py, px)
    else:
        exchange = halo.InProcess(py, px)
    try:
        lay = smap.Layout(py, px, exchange)
        cfg, grid, s0, ffn, _ = build_from_dict(
            {"case": args.case, "config": json.loads(args.config)},
            device=args.device)
        step = smap.make_smap_stepper(cfg, grid, lay, ffn)
        blocks = smap.block(cfg, lay, s0)
        writer = pio.ShardedHistoryWriter(args.out, cfg, lay)
        nhis = args.nhis or args.nsteps
        t0 = time.perf_counter()
        for n in range(1, args.nsteps + 1):
            blocks = step(blocks)
            if n % nhis == 0:
                writer.write(blocks, next(iter(blocks.values())).time)
        if args.device != "cpu":
            torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        writer.close()
    finally:
        if dist is not None:
            dist.destroy_process_group()
    print(json.dumps({"case": cfg.name, "layout": [py, px],
                      "rank": exchange.rank, "blocks": len(blocks),
                      "nsteps": args.nsteps, "seconds": seconds,
                      "part": writer.path}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
