"""ms/step of roms_tpu_torch on the card with the package of another tree,
so that two commits can be run in turns in one chip call (parent, tree,
tree, parent): chip_smoke.py's phase 5 (1440 float32 UPWELLING steps) and,
by default, phase 10 (200 float32 BENCHMARK1 steps); with
``--upwelling-profile``, phase 5 and phase 6 (torch.profiler over 10
UPWELLING steps: launches, device busy and idle, device time by kernel);
with ``--profiles``, phases 6 and 11 alone (the profiles of UPWELLING and
of 5 BENCHMARK1 steps); with ``--tracer-times``, the time a call of the
three tracer kernels (rows 5, 8 and 9: t3dmix2_geo, tracer_predictor,
tracer_corrector) on the arguments the UPWELLING and BENCHMARK1 steps give
them (row 5 at UPWELLING, which does not call it, on its tracers with
tnu2 = 500 m2/s), float64 and float32, with the host's time (CUDA events)
and the device's alone (torch.profiler), and the kernels' registers and
stack frames; with ``--case-times CASE ...``, the host-clock ms/step of
each case at its published size, float64 and float32, from CASE_START
steps in (``upwelling``, or a case of ``roms_tpu_torch.models.cases``
such as ``kelvin``, whose open boundaries keep the tracer steps plain).

    cd CHECKOUT && python3 scripts/torch_step_times.py TREE
    cd CHECKOUT && python3 scripts/torch_step_times.py TREE \\
        --upwelling-profile
    cd CHECKOUT && python3 scripts/torch_step_times.py TREE --profiles
    cd CHECKOUT && python3 scripts/torch_step_times.py TREE --tracer-times
    cd CHECKOUT && python3 scripts/torch_step_times.py TREE \\
        --case-times upwelling kelvin

TREE holds the roms_tpu_torch to time (a `git archive` checkout of
another commit, or `.`); chip_smoke.py comes from the current directory.
Needs a CUDA card.
"""

import os
import sys
import time

CASE_START = 3      # steps before the timed ones
CASE_STEPS = 40     # timed steps a case and dtype


def tracer_times(dev) -> None:
    """--tracer-times: rows 5, 8 and 9 a call on the UPWELLING and
    BENCHMARK1 steps' arguments, and the kernels' layouts."""
    import torch

    import chip_smoke as cs
    from roms_tpu_torch import stepping
    from roms_tpu_torch.models import benchmark, upwelling
    from roms_tpu_torch.ops import mix3d_cuda, step3d_cuda
    from roms_tpu_torch.state import TENSOR_FIELDS

    for dtype in ("float64", "float32"):
        t = getattr(torch, dtype)
        for name in ("tracer_predictor", "tracer_corrector"):
            lay = step3d_cuda.tracer_layout(name, t)
            print(f"[tracer-times] {name} {dtype}: {lay['registers']} "
                  f"registers and {lay['stack_bytes']} bytes of stack frame "
                  f"a thread", flush=True)
        lay = mix3d_cuda.geo_layout(t)
        print(f"[tracer-times] t3dmix2_geo {dtype}: {lay['registers']} "
              f"registers a thread, {lay['shared_bytes']} bytes of shared "
              f"memory a block", flush=True)
    table = cs.wrappers()
    cfg, grid, s, ffn = upwelling.build(upwelling.make_config(), device=dev)
    developed = {
        "upwelling": (upwelling, stepping.run(cfg.replace(pallas2d=False),
                                              grid, s, 3, ffn)),
        "benchmark1": (benchmark, cs.bench_developed(dev)[2])}
    for case, (model, s) in developed.items():
        for dtype in ("float64", "float32"):
            cfg, grid, _, ffn = model.build(model.make_config(dtype=dtype),
                                            device=dev)
            state = s.replace(**{k: getattr(s, k).to(grid.h.dtype)
                                 for k in TENSOR_FIELDS})
            calls = cs.captured_calls(cfg, grid, state, ffn)
            if "t3dmix2_geo" not in calls:
                calls["t3dmix2_geo"] = (cs.geo_args(cfg, grid, calls), {})
            for name in ("t3dmix2_geo", "tracer_predictor",
                         "tracer_corrector"):
                fn = getattr(*table[name][:2])
                per_call = name in cs.IN_PLACE
                print(f"[tracer-times] {case} {name} {dtype}: kernel "
                      f"{cs.device_ms(fn, *calls[name], per_call):.4f} ms, "
                      f"device "
                      f"{cs.profiled_ms(fn, *calls[name], per_call):.4f} "
                      f"ms", flush=True)


def case_times(dev, names) -> None:
    """--case-times: ms/step of each case, float64 and float32, the mean
    of CASE_STEPS steps after CASE_START, on the host's clock."""
    import torch

    import chip_smoke as cs
    from roms_tpu_torch import stepping
    from roms_tpu_torch.models import upwelling

    for name in names:
        for dtype in ("float64", "float32"):
            if name == "upwelling":
                cfg, grid, s, ffn = upwelling.build(
                    upwelling.make_config(dtype=dtype), device=dev)
            else:
                cfg, grid, s, ffn = cs.regional_case(name, dev, dtype)
            s = stepping.run(cfg, grid, s, CASE_START, ffn)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            s = stepping.run(cfg, grid, s, CASE_STEPS, ffn)
            torch.cuda.synchronize()
            ms = 1e3 * (time.perf_counter() - t0) / CASE_STEPS
            ok = bool(torch.isfinite(s.u).all())
            print(f"[case-times] {name} {cfg.Lm}x{cfg.Mm}x{cfg.N} {dtype}: "
                  f"{ms:.4f} ms/step over {CASE_STEPS} steps, finite {ok}",
                  flush=True)


def main() -> int:
    tree = os.path.abspath(sys.argv[1])
    sys.path.insert(0, tree)
    sys.path.insert(1, os.getcwd())
    import torch

    import chip_smoke
    import roms_tpu_torch

    print("[steps] roms_tpu_torch from",
          os.path.dirname(roms_tpu_torch.__file__), flush=True)
    dev = torch.device("cuda:0")
    name = torch.cuda.get_device_name(0)
    if "--tracer-times" in sys.argv[2:]:
        print(f"[tracer-times] {name}", flush=True)
        tracer_times(dev)
        return 0
    if "--case-times" in sys.argv[2:]:
        print(f"[case-times] {name}", flush=True)
        case_times(dev, sys.argv[sys.argv.index("--case-times") + 1:])
        return 0
    if "--profiles" in sys.argv[2:]:
        chip_smoke.profile(dev)
        chip_smoke.profile(dev, "benchmark")
        return 0
    chip_smoke.long_run(dev, name)
    if "--upwelling-profile" in sys.argv[2:]:
        chip_smoke.profile(dev)
    else:
        chip_smoke.bench_long_run(dev, name)
    return 0


if __name__ == "__main__":
    sys.exit(main())
