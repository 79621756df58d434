"""Smoke run of roms_tpu_torch on one CUDA card: builds the kernels, checks
each against its plain PyTorch version, drives the UPWELLING step through
them, and checks the result.

    python3 chip_smoke.py

Phases, one or more lines each; any failure exits non-zero:
  1. device: card name and power limit (nvidia-smi), torch and CUDA versions;
  2. kernel build (nvcc, sm_90a) and its time;
  3. each kernel against its plain version at UPWELLING's full shapes, in
     float64 and float32, with the max abs error, its tolerance, and the
     median time of kernel and plain version (CUDA events, 20 runs);
  4. the main path: 10 float64 steps of full-size UPWELLING through
     stepping.step, with every kernel's launch count, checked against the
     pinned anchor (tests/data/upwelling_anchor.npz) and against the same
     steps with the kernels off (cfg.pallas2d=False);
  5. the 5-model-day UPWELLING run: 1440 float32 steps, finite fields,
     volume conservation, the upwelling signature, ms/step.
The last two lines are a JSON object of per-kernel results and a JSON
object {"ok": true, "device": {...}}.  Without CUDA it exits non-zero and
prints no result.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
ANCHOR = os.path.join(ROOT, "tests", "data", "upwelling_anchor.npz")

# tests/test_anchor.py:47-66 bounds; the card runs them at 100x (nvcc's
# operation order is kept with --fmad=false, but the card's column sums
# and cumsums run in another order than the CPU's)
ANCHOR_ATOL = {"zeta": 1e-12, "u": 1e-13, "v": 1e-13, "temp": 1e-10}
CARD_FACTOR = 100.0
# kernel against plain version, relative to max|field|: one pass of
# round-off, except the fast loop, which compounds it over nfast substeps
KERNEL_RTOL = {"float64": 1e-12, "float32": 1e-5}
FAST_RTOL = {"float64": 1e-10, "float32": 1e-4}
NRUNS = 20


class SmokeFailure(Exception):
    pass


def check(cond: bool, msg: str):
    if not cond:
        raise SmokeFailure(msg)


def nvidia_smi() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(res.returncode == 0, f"nvidia-smi failed: {res.stderr.strip()}")
    return res.stdout.strip().splitlines()[0]


def median_ms(fn, prepare=None) -> float:
    """Median over NRUNS of fn()'s device time, from CUDA events."""
    import torch
    times = []
    for _ in range(NRUNS + 2):
        args = prepare() if prepare else ()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn(*args)
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    times = sorted(times[2:])          # the first two runs warm up
    return times[len(times) // 2]


def max_err(outs_k, outs_p, rtol):
    """(max abs error, worst error/tolerance) over paired outputs, each
    held to rtol * max|plain field|."""
    worst_abs, worst_ratio = 0.0, 0.0
    for a, b in zip(outs_k, outs_p):
        err = (a - b).abs().max().item()
        tol = rtol * max(b.abs().max().item(), 1e-30)
        worst_abs = max(worst_abs, err)
        worst_ratio = max(worst_ratio, err / tol)
    return worst_abs, worst_ratio


def kernel_checks(results, device):
    """Phase 3: every kernel against its plain version, f64 and f32."""
    import torch
    from roms_tpu_torch import stepping
    from roms_tpu_torch.grid import hc_of
    from roms_tpu_torch.models import upwelling
    from roms_tpu_torch.ops import diag_cuda, step2d_cuda
    from roms_tpu_torch.ops.step2d import Fast2DState, FS_FIELDS

    # a developed state: 3 plain float64 steps from rest
    cfg64, grid64, s, ffn = upwelling.build(upwelling.make_config(),
                                           device=device)
    s = stepping.run(cfg64.replace(pallas2d=False), grid64, s, 3, ffn)
    for dtype in ("float64", "float32"):
        cfg, grid, s0, _ = upwelling.build(
            upwelling.make_config(dtype=dtype), device=device)
        cast = lambda a: a.to(grid.h.dtype)
        zeta, u, v, t = cast(s.zeta), cast(s.u), cast(s.v), cast(s.t)
        hc = hc_of(cfg)
        plain = diag_cuda.grid_flux_plain(cfg, grid, zeta, u, v, hc)
        z_r, z_w, _, Huon, Hvom, _ = plain
        fs_fields = {k: cast(getattr(s, src)) for k, src in (
            ("zeta_n", "zeta"), ("zeta_nm1", "zeta"), ("ubar_n", "ubar"),
            ("ubar_nm1", "ubar"), ("vbar_n", "vbar"), ("vbar_nm1", "vbar"),
            ("rzeta_n", "rzeta"), ("rubar_n", "rubar"),
            ("rvbar_n", "rvbar"))}
        for k in FS_FIELDS:
            fs_fields.setdefault(k, torch.zeros_like(zeta))
        frc = [cast(getattr(s, k)) for k in (
            "rufrc0_prev", "rvfrc0_prev", "rufrc0_prev", "rufrc0_prev2",
            "rvfrc0_prev", "rvfrc0_prev2")]

        def fresh_fs():
            return (Fast2DState(**{k: a.clone()
                                   for k, a in fs_fields.items()}),)

        cases = [
            ("grid_flux", KERNEL_RTOL,
             lambda: diag_cuda.grid_flux(cfg, grid, zeta, u, v, hc),
             lambda: diag_cuda.grid_flux_plain(cfg, grid, zeta, u, v, hc),
             None),
            ("eos", KERNEL_RTOL,
             lambda: diag_cuda.eos(cfg, t, z_r, z_w, False),
             lambda: diag_cuda.eos_plain(cfg, t, z_r, z_w, False), None),
            ("eos[jm95+bvf]", KERNEL_RTOL,
             lambda: diag_cuda.eos(cfg.replace(eos="jm95"), t, z_r, z_w,
                                   True),
             lambda: diag_cuda.eos_plain(cfg.replace(eos="jm95"), t, z_r,
                                         z_w, True), None),
            ("omega", KERNEL_RTOL,
             lambda: diag_cuda.omega(cfg, grid, Huon, Hvom, z_w),
             lambda: diag_cuda.omega_plain(cfg, grid, Huon, Hvom, z_w),
             None),
            ("fast_loop", FAST_RTOL,
             lambda fs: step2d_cuda.fast_loop(cfg, grid, fs, *frc, s.iic),
             lambda fs: step2d_cuda.fast_loop_plain(cfg, grid, fs, *frc,
                                                    s.iic),
             fresh_fs),
        ]
        for name, rtol, kern, ref, prepare in cases:
            args = prepare() if prepare else ()
            out_k = kern(*args)
            torch.cuda.synchronize()
            args = prepare() if prepare else ()
            out_p = ref(*args)
            if name == "fast_loop":
                out_k = [getattr(out_k[0], f) for f in FS_FIELDS] + \
                    list(out_k[1:])
                out_p = [getattr(out_p[0], f) for f in FS_FIELDS] + \
                    list(out_p[1:])
            finite = all(bool(torch.isfinite(a).all()) for a in out_k)
            err, ratio = max_err(out_k, out_p, rtol[dtype])
            ms = median_ms(kern, prepare)
            plain_ms = median_ms(ref, prepare)
            ok = finite and ratio <= 1.0
            print(f"[kernel] {name:14s} {dtype}: max_abs_err={err:.3e} "
                  f"tol={rtol[dtype]:g}*max|field| (worst err/tol "
                  f"{ratio:.3e}) finite={finite} kernel {ms:.4f} ms, plain "
                  f"{plain_ms:.4f} ms  {'OK' if ok else 'FAIL'}",
                  flush=True)
            check(ok, f"{name} {dtype}: kernel disagrees with its plain "
                      "version")
            results.setdefault(name, {})[dtype] = dict(
                max_abs_err=err, ms=ms, plain_ms=plain_ms)


def interior(cfg, a):
    H = cfg.halo
    return a[..., H:H + cfg.Mm, H:H + cfg.Lm]


def main_path(device):
    """Phase 4: 10 float64 steps through stepping.step; returns the
    launch counts of that run."""
    import numpy as np
    import torch
    from roms_tpu_torch import stepping
    from roms_tpu_torch.models import upwelling
    from roms_tpu_torch.ops import diag_cuda, step2d_cuda

    wrappers = {"grid_flux": diag_cuda.grid_flux, "eos": diag_cuda.eos,
                "omega": diag_cuda.omega,
                "fast_loop": step2d_cuda.fast_loop}
    cfg, grid, s0, ffn = upwelling.build(upwelling.make_config(),
                                         device=device)
    for w in wrappers.values():
        w.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    s = stepping.run(cfg, grid, s0, 10, ffn)
    torch.cuda.synchronize()
    ms_step = (time.perf_counter() - t0) * 100.0
    launches = {k: w.launches for k, w in wrappers.items()}
    print(f"[main] 10 float64 UPWELLING steps, kernels on: "
          f"{ms_step:.2f} ms/step (host clock incl. first-call set-up); "
          f"launches {launches}", flush=True)
    check(all(n > 0 for n in launches.values()),
          f"a kernel of the main path was never launched: {launches}")

    s_plain = stepping.run(cfg.replace(pallas2d=False), grid, s0, 10, ffn)
    fields = {"zeta": s.zeta, "u": s.u, "v": s.v, "temp": s.t[0]}
    plain = {"zeta": s_plain.zeta, "u": s_plain.u, "v": s_plain.v,
             "temp": s_plain.t[0]}
    check(all(bool(torch.isfinite(a).all()) for a in fields.values()),
          "non-finite fields after 10 steps")
    ref = np.load(ANCHOR)
    ref_of = {"zeta": ref["zeta"], "u": ref["u_full"], "v": ref["v_full"],
              "temp": ref["temp_full"]}
    for name, a in fields.items():
        bound = CARD_FACTOR * ANCHOR_ATOL[name]
        got = interior(cfg, a).cpu().numpy()
        e_anchor = float(np.abs(got - ref_of[name]).max())
        e_plain = float((interior(cfg, a) -
                         interior(cfg, plain[name])).abs().max())
        ok = e_anchor <= bound and e_plain <= bound
        print(f"[main] {name:5s}: |kernels - anchor| = {e_anchor:.3e}, "
              f"|kernels - kernels off| = {e_plain:.3e}, bound {bound:g} "
              f"{'OK' if ok else 'FAIL'}", flush=True)
        check(ok, f"{name} misses the anchor bound")
    zsum = float(interior(cfg, s.zeta).sum())
    print(f"[main] sum(zeta) over the interior = {zsum:.3e}")
    check(abs(zsum) < CARD_FACTOR * 1e-10, "free-surface volume drifted")
    return launches


def upwelling_signature(cfg, grid, s0, s):
    """(mean zeta over the cell area in m, change of surface temperature
    at the wall that cools most in degC) between states s0 and s."""
    area = interior(cfg, 1.0 / (grid.pm * grid.pn))
    zeta = interior(cfg, s.zeta)
    mean_zeta = float((zeta * area).sum() / area.sum())
    sst0 = interior(cfg, s0.t[0, -1])
    sst = interior(cfg, s.t[0, -1])
    dsst_south = float((sst[0] - sst0[0]).mean())
    dsst_north = float((sst[-1] - sst0[-1]).mean())
    return mean_zeta, min(dsst_south, dsst_north)


def long_run(device, name):
    """Phase 5: 1440 float32 steps (5 model days)."""
    import torch
    from roms_tpu_torch import stepping
    from roms_tpu_torch.models import upwelling

    cfg, grid, s0, ffn = upwelling.build(
        upwelling.make_config(dtype="float32"), device=device)
    s = stepping.run(cfg, grid, s0, 2, ffn)       # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    s = stepping.run(cfg, grid, s, 1438, ffn)
    torch.cuda.synchronize()
    ms_step = (time.perf_counter() - t0) * 1000.0 / 1438
    finite = all(bool(torch.isfinite(getattr(s, k)).all())
                 for k in ("zeta", "ubar", "vbar", "u", "v", "t"))
    mean_zeta, dsst = upwelling_signature(cfg, grid, s0, s)
    pts = cfg.Lm * cfg.Mm * cfg.N
    print(f"[run] 1440 float32 UPWELLING steps (5 days): {ms_step:.3f} "
          f"ms/step on {name}, {pts / ms_step * 1e3:.4e} grid-points/s; "
          f"finite={finite} mean zeta {mean_zeta:.3e} m, SST change at "
          f"the upwelling wall {dsst:.3f} degC", flush=True)
    check(finite, "non-finite fields in the 5-day run")
    check(abs(mean_zeta) < 1e-6, "free-surface volume drifted")
    check(dsst < -1.0, "no upwelling: the surface did not cool at a wall")
    return ms_step


REPLACES = {
    "grid_flux": ("roms_tpu_torch/csrc/diag.cu",
                  "roms_tpu/ops/diag_pallas.py:53"),
    "eos": ("roms_tpu_torch/csrc/diag.cu", "roms_tpu/ops/diag_pallas.py:108"),
    "omega": ("roms_tpu_torch/csrc/diag.cu",
              "roms_tpu/ops/diag_pallas.py:144"),
    "fast_loop": ("roms_tpu_torch/csrc/fast_loop.cu",
                  "roms_tpu/ops/step2d_pallas.py:260"),
}


def main() -> int:
    try:
        import torch
    except ImportError as exc:
        print(f"chip_smoke: torch is not importable ({exc})",
              file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke run needs the card",
              file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    try:
        import roms_tpu_torch  # noqa: F401
        from roms_tpu_torch.ops import _kernels
    except ImportError as exc:
        print(f"chip_smoke: roms_tpu_torch is not importable beside this "
              f"script ({exc})", file=sys.stderr)
        return 2
    if not os.path.exists(ANCHOR):
        print(f"chip_smoke: missing {ANCHOR}", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda:0")
    name = torch.cuda.get_device_name(0)
    try:
        smi = nvidia_smi()
        print(f"[device] {name}; torch {torch.__version__}, CUDA "
              f"{torch.version.cuda}, {torch.cuda.device_count()} device(s)",
              flush=True)

        t0 = time.perf_counter()
        info = _kernels.build()
        _kernels.library()
        print(f"[build] nvcc {' '.join(_kernels.NVCC_FLAGS)}: "
              f"{time.perf_counter() - t0:.1f} s -> {info['path'].name}",
              flush=True)
        for line in info["log"].splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build] {line.strip()}")

        results = {}
        kernel_checks(results, device)
        launches = main_path(device)
        long_run(device, name)
    except SmokeFailure as exc:
        print(f"chip_smoke: FAILED: {exc}", file=sys.stderr)
        return 1
    kernels = []
    for k, (src, rep) in REPLACES.items():
        r = results[k]["float64"]
        kernels.append({"name": k, "route": "cuda", "source": src,
                        "replaces": rep, "launches": launches[k],
                        "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                        "plain_ms": r["plain_ms"]})
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
