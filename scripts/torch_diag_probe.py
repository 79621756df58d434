"""Device time of the grid_flux, eos and omega kernels from several trees,
launch plans and boundary conditions, on one set of arguments each: the
probe behind the three kernels' designs (PERF.md §6).

    cd CHECKOUT && python3 scripts/torch_diag_probe.py [--omega] TREE ...

Each TREE holds a roms_tpu_torch (`.`, or a `git archive` checkout of
another commit); its kernels are built into TREE/build/kernels.  The
arguments are those one float32 and one float64 step give the kernels
(chip_smoke's captured_calls, from the package of the current directory):
BENCHMARK1 (512x64x30) for all three, UPWELLING (41x80x16) for omega;
every tree is timed on them with chip_smoke.profiled_ms (twice) and
checked bitwise against the first tree's output.  A tree whose diag_cuda
has grid_flux_plan is also timed with grid_flux on 32 x 1, 2, 4 and 8
point tiles of 256 threads, 16 x 6 and 24 x 4 ones of 192 (396 blocks at
BENCHMARK1: three an SM), and 32 x 2 and 32 x 4 ones of 128.  Every tree
is also timed with closed E-W walls, whose halo columns take their W from
inside their tile, where the periodic ones take it from the far end of
the row.  --omega times omega alone.  Needs a CUDA card.
"""

import importlib
import sys

sys.path.insert(0, ".")


def main() -> int:
    import torch

    import chip_smoke as cs
    from roms_tpu_torch import stepping
    from roms_tpu_torch.config import LBC
    from roms_tpu_torch.models import benchmark, upwelling
    from roms_tpu_torch.ops._kernels import SMEM_MAX
    from roms_tpu_torch.state import TENSOR_FIELDS

    only_omega = "--omega" in sys.argv[1:]
    trees = [a for a in sys.argv[1:] if a != "--omega"]
    dev = torch.device("cuda:0")
    print("[diagtime]", cs.nvidia_smi(), flush=True)
    cfg, grid, s, ffn = upwelling.build(upwelling.make_config(), device=dev)
    developed = {
        "benchmark1": (benchmark, cs.bench_developed(dev)[2]),
        "upwelling": (upwelling, stepping.run(cfg.replace(pallas2d=False),
                                              grid, s, 3, ffn))}
    calls = {}
    for case, (model, s) in developed.items():
        for dtype in ("float32", "float64"):
            cfg, grid, _, ffn = model.build(model.make_config(dtype=dtype),
                                            device=dev)
            state = s.replace(**{k: getattr(s, k).to(grid.h.dtype)
                                 for k in TENSOR_FIELDS})
            calls[case, dtype] = cs.captured_calls(cfg, grid, state, ffn)
    closed = LBC()
    ref = {}

    def run(tag, mod, name, case, dtype, args, kw):
        fn = getattr(mod, name)
        out = fn(*cs.fresh(args), **kw)
        torch.cuda.synchronize()
        key = (name, case, dtype, args[0].ew_periodic)
        same = "ref"
        if key in ref:
            same = all(torch.equal(a, b) for a, b in
                       zip(cs.tensors_of(out), cs.tensors_of(ref[key])))
        else:
            ref[key] = out
        d = cs.profiled_ms(fn, args, kw)
        d2 = cs.profiled_ms(fn, args, kw)
        print(f"[diagtime] {tag:34s} {name:9s} {case} {dtype}: device "
              f"{d:.4f} / {d2:.4f} ms, equal to the first tree's: {same}",
              flush=True)

    def with_walls(args):
        return (args[0].replace(
            ew_periodic=False, lbc_zeta=closed, lbc_ubar=closed,
            lbc_vbar=closed, lbc_u=closed, lbc_v=closed,
            lbc_t=closed),) + args[1:]

    def sweep(tree, dc, name, case, dtype, tiles):
        """Time `name` on each tile that fits the shared memory."""
        args, kw = calls[case, dtype][name]
        c = args[0]
        tile_plan, threads = dc.tile_plan, dc.THREADS
        try:
            for tx, ty, th in tiles:
                dc.tile_plan = lambda make, a=tx, b=ty: make(a, b)
                dc.THREADS = th
                plan = getattr(dc, f"{name}_plan")(
                    getattr(torch, dtype), c.N, c.ny_tot, c.nx_tot)
                if plan["smem_bytes"] > SMEM_MAX:
                    continue
                run(f"{tree} tiles {tx}x{ty}, {th} threads", dc, name, case,
                    dtype, args, kw)
        finally:
            dc.tile_plan, dc.THREADS = tile_plan, threads

    for tree in trees:
        for m in [m for m in sys.modules if m.startswith("roms_tpu_torch")]:
            del sys.modules[m]
        sys.path.insert(0, tree)
        dc = importlib.import_module("roms_tpu_torch.ops.diag_cuda")
        importlib.import_module("roms_tpu_torch.ops._kernels").library()
        sys.path.pop(0)
        for dtype in ("float32", "float64"):
            t = getattr(torch, dtype)
            for case in ("benchmark1", "upwelling"):
                args, kw = calls[case, dtype]["omega"]
                run(tree + " default", dc, "omega", case, dtype, args, kw)
                run(tree + " closed E-W", dc, "omega", case, dtype,
                    with_walls(args), kw)
            if only_omega:
                continue
            case = "benchmark1"
            if hasattr(dc, "grid_flux_plan"):
                print("[diagtime]", tree, dtype, "grid_flux",
                      dc.grid_flux_plan(t, 30, 70, 518),
                      dc.grid_flux_layout(t), "eos",
                      dc.eos_plan(t, 30, 70, 518, True, True),
                      dc.eos_layout(t), flush=True)
            for name in ("grid_flux", "eos"):
                run(tree + " default", dc, name, case, dtype,
                    *calls[case, dtype][name])
            args, kw = calls[case, dtype]["grid_flux"]
            run(tree + " closed E-W", dc, "grid_flux", case, dtype,
                with_walls(args), kw)
            if hasattr(dc, "grid_flux_plan"):
                sweep(tree, dc, "grid_flux", case, dtype,
                      ((32, 1, 256), (32, 2, 256), (32, 4, 256),
                       (32, 8, 256), (16, 6, 192), (24, 4, 192),
                       (32, 2, 128), (32, 4, 128)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
