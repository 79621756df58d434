"""Device time of the grid_flux and eos kernels at BENCHMARK1 (512x64x30)
from several trees, launch plans and boundary conditions, on one set of
arguments: the probe behind the two kernels' designs (PERF.md §6).

    cd CHECKOUT && python3 scripts/torch_diag_probe.py TREE [TREE ...]

Each TREE holds a roms_tpu_torch (`.`, or a `git archive` checkout of
another commit); its kernels are built into TREE/build/kernels.  The
arguments are those one float32 and one float64 BENCHMARK1 step give the
kernels (chip_smoke's captured_calls, from the package of the current
directory); every tree is timed on them with chip_smoke.profiled_ms
(twice) and checked bitwise against the first tree's output.  A tree
whose diag_cuda has grid_flux_plan is also timed with grid_flux on 32 x 1,
2, 4 and 8 point tiles of 256 threads, 16 x 6 and 24 x 4 ones of 192
(396 blocks at BENCHMARK1: three an SM), and 32 x 2 and 32 x 4 ones of
128.  Every tree is also timed with
closed E-W walls, whose halo columns take their W from inside their tile,
where the periodic ones take it from the far end of the row.  Needs a
CUDA card.
"""

import importlib
import sys

sys.path.insert(0, ".")


def main() -> int:
    import torch

    import chip_smoke as cs
    from roms_tpu_torch.config import LBC
    from roms_tpu_torch.models import benchmark
    from roms_tpu_torch.state import TENSOR_FIELDS

    dev = torch.device("cuda:0")
    print("[diagtime]", cs.nvidia_smi(), flush=True)
    _, _, s, _ = cs.bench_developed(dev)
    calls = {}
    for dtype in ("float32", "float64"):
        cfg, grid, _, ffn = benchmark.build(
            benchmark.make_config(dtype=dtype), device=dev)
        state = s.replace(**{k: getattr(s, k).to(grid.h.dtype)
                             for k in TENSOR_FIELDS})
        calls[dtype] = cs.captured_calls(cfg, grid, state, ffn)
    closed = LBC()
    ref = {}

    def run(tag, mod, name, dtype, args, kw):
        fn = getattr(mod, name)
        out = fn(*cs.fresh(args), **kw)
        torch.cuda.synchronize()
        key = (name, dtype, args[0].ew_periodic)
        same = "ref"
        if key in ref:
            same = all(torch.equal(a, b) for a, b in zip(out, ref[key]))
        else:
            ref[key] = out
        d = cs.profiled_ms(fn, args, kw)
        d2 = cs.profiled_ms(fn, args, kw)
        print(f"[diagtime] {tag:34s} {name:9s} {dtype}: device {d:.4f} / "
              f"{d2:.4f} ms, equal to the first tree's: {same}", flush=True)

    for tree in sys.argv[1:]:
        for m in [m for m in sys.modules if m.startswith("roms_tpu_torch")]:
            del sys.modules[m]
        sys.path.insert(0, tree)
        dc = importlib.import_module("roms_tpu_torch.ops.diag_cuda")
        importlib.import_module("roms_tpu_torch.ops._kernels").library()
        sys.path.pop(0)
        planned = hasattr(dc, "grid_flux_plan")
        for dtype in ("float32", "float64"):
            t = getattr(torch, dtype)
            if planned:
                print("[diagtime]", tree, dtype, "grid_flux",
                      dc.grid_flux_plan(t, 30, 70, 518),
                      dc.grid_flux_layout(t), "eos",
                      dc.eos_plan(t, 30, 70, 518, True, True),
                      dc.eos_layout(t), flush=True)
            for name in ("grid_flux", "eos"):
                run(tree + " default", dc, name, dtype, *calls[dtype][name])
            args, kw = calls[dtype]["grid_flux"]
            walls = (args[0].replace(
                ew_periodic=False, lbc_zeta=closed, lbc_ubar=closed,
                lbc_vbar=closed, lbc_u=closed, lbc_v=closed,
                lbc_t=closed),) + args[1:]
            run(tree + " closed E-W", dc, "grid_flux", dtype, walls, kw)
            if not planned:
                continue
            tile_plan, threads = dc.tile_plan, dc.THREADS
            for tx, ty, th in ((32, 1, 256), (32, 2, 256), (32, 4, 256),
                               (32, 8, 256), (16, 6, 192), (24, 4, 192),
                               (32, 2, 128), (32, 4, 128)):
                dc.tile_plan = lambda make, a=tx, b=ty: make(a, b)
                dc.THREADS = th
                run(f"{tree} tiles {tx}x{ty}, {th} threads", dc,
                    "grid_flux", dtype, args, kw)
            dc.tile_plan, dc.THREADS = tile_plan, threads
    return 0


if __name__ == "__main__":
    sys.exit(main())
