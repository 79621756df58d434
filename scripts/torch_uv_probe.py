"""Device time of the uv_corrector and uv3dmix2 kernels at BENCHMARK1
(512x64x30) from several trees and launch plans, on one set of arguments:
the probe that chose the two kernels' plans (PERF.md, PR 9).

    cd CHECKOUT && python3 scripts/torch_uv_probe.py TREE [TREE ...]

Each TREE holds a roms_tpu_torch (`.`, or a copy whose csrc/ was edited);
its kernels are built into TREE/build/kernels.  The arguments are those
one float32 and one float64 BENCHMARK1 step give the kernels (chip_smoke's
captured_calls, from the package of the current directory); every tree
and plan is timed on them with chip_smoke.profiled_ms (twice), uv3dmix2 on
fresh copies for each call, and checked bitwise against the first tree's
output.  Each tree is timed with its default plans and with uv_corrector
on 128 threads a block; the first tree also with uv_corrector on tiles of
16 columns (float32) and uv3dmix2 on 32 x 1, 2, 4 and 8 point tiles.
Needs a CUDA card.
"""

import importlib
import sys

sys.path.insert(0, ".")


def main() -> int:
    import torch

    import chip_smoke as cs
    from roms_tpu_torch.models import benchmark
    from roms_tpu_torch.state import TENSOR_FIELDS

    dev = torch.device("cuda:0")
    _, _, s, _ = cs.bench_developed(dev)
    calls = {}
    for dtype in ("float32", "float64"):
        cfg, grid, _, ffn = benchmark.build(
            benchmark.make_config(dtype=dtype), device=dev)
        state = s.replace(**{k: getattr(s, k).to(grid.h.dtype)
                             for k in TENSOR_FIELDS})
        calls[dtype] = cs.captured_calls(cfg, grid, state, ffn)
    ref = {}

    def run(tag, mod, name, dtype, per_call):
        fn = getattr(mod, name)
        args, kw = calls[dtype][name]
        out = fn(*cs.fresh(args), **kw)
        torch.cuda.synchronize()
        key = (name, dtype)
        same = "ref"
        if key in ref:
            same = all(torch.equal(a, b) for a, b in zip(out, ref[key]))
        else:
            ref[key] = out
        d = cs.profiled_ms(fn, args, kw, per_call)
        d2 = cs.profiled_ms(fn, args, kw, per_call)
        print(f"[uvtime] {tag:28s} {name:12s} {dtype}: device {d:.4f} / "
              f"{d2:.4f} ms, equal to the first tree's: {same}", flush=True)

    for tree in sys.argv[1:]:
        for m in [m for m in sys.modules if m.startswith("roms_tpu_torch")]:
            del sys.modules[m]
        sys.path.insert(0, tree)
        st = importlib.import_module("roms_tpu_torch.ops.step3d_cuda")
        mx = importlib.import_module("roms_tpu_torch.ops.mix3d_cuda")
        importlib.import_module("roms_tpu_torch.ops._kernels").library()
        sys.path.pop(0)
        for dtype in ("float32", "float64"):
            t = getattr(torch, dtype)
            print("[uvtime]", tree, dtype, "uv layout", st.uv_layout(t),
                  "mix layout", mx.uv3dmix2_layout(t), flush=True)
            run(tree + " default", st, "uv_corrector", dtype, False)
            run(tree + " default", mx, "uv3dmix2", dtype, True)
            plan = st.uv_plan
            st.uv_plan = lambda *a: dict(plan(*a), threads=128)
            run(f"{tree} uv 128 threads", st, "uv_corrector", dtype, False)
            st.uv_plan = plan
            if tree != sys.argv[1]:
                continue
            if dtype == "float32":
                def tile16(*a):
                    p = plan(*a)
                    return dict(p, tile=16, blocks=-(-a[2] * a[3] // 16),
                                smem_bytes=p["smem_bytes"] // 2)
                st.uv_plan = tile16
                run(f"{tree} uv tile 16", st, "uv_corrector", dtype, False)
                st.uv_plan = plan
            tile_plan, threads = mx.tile_plan, mx.THREADS
            for rows, th in ((2, 256), (1, 256), (4, 128), (8, 256)):
                mx.tile_plan = lambda make, r=rows: make(32, r)
                mx.THREADS = th
                p = mx.uv3dmix2_plan(t, 30, 70, 518)
                run(f"{tree} mix 32x{rows}x{p['levels']}", mx, "uv3dmix2",
                    dtype, True)
            mx.tile_plan, mx.THREADS = tile_plan, threads
    return 0


if __name__ == "__main__":
    sys.exit(main())
