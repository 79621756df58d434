"""Write tests/data/torch_benchmark_small.npz: three float64 steps of a small
BENCHMARK (64x32x12, ndtfast 10) through roms_tpu's eager stepping.step on
the CPU, the reference that roms_tpu_torch's small BENCHMARK is held to
(tests/test_torch_benchmark_step.py, tests/test_torch_kernels_gpu.py,
chip_smoke.py).

    JAX_PLATFORMS=cpu python scripts/torch_benchmark_fixture.py [--report]

Importing this file runs nothing and imports no jax: ``errors`` holds a
roms_tpu_torch run to the fixture, with the bounds stated here.
``--report`` writes nothing and prints the measurements the bounds rest
on: roms_tpu's own change after NSTEPS steps when every initial tracer
value moves up by one ulp, roms_tpu_torch's CPU errors against the
fixture, and how torch's CPU sqrt and the port's cbrt round against
libm's (numpy) and XLA's.

The step is run eagerly, not through make_stepper: the jitted step
contracts multiply-adds and differs from the eager one by ~1e-9 relative.
Stored, over the interior points: the initial tracers, and after the third
step every State field the step writes (the AB3 and fast-loop histories
included).  To keep the file small, zeta, ubar, vbar and hsbl are stored
at every point and the other fields at every second point in eta and xi
("<field>", a [..., ::2, ::2] subsample), each with its root mean square
over every interior point ("<field>_rms"); "time" and "iic" of the final
state.
"""

from __future__ import annotations

import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, "tests", "data", "torch_benchmark_small.npz")
CASE = dict(Lm=64, Mm=32, N=12, ndtfast=10)
NSTEPS = 3
# the State fields a BENCHMARK step writes
FIELDS = ("zeta", "ubar", "vbar", "u", "v", "t", "ru_prev", "rv_prev",
          "rufrc0_prev", "rvfrc0_prev", "rzeta", "rubar", "rvbar", "Akv",
          "Akt", "hsbl", "DU_avg1", "DV_avg1", "DU_avg2", "DV_avg2")
FULL = ("zeta", "ubar", "vbar", "hsbl")     # stored at every point
# Pointwise bound on |port - fixture| on the CPU, times max|field|; every
# number below is printed by --report.
# BENCHMARK's steep shelf makes the first steps from rest ill-conditioned:
# roms_tpu itself, with every initial tracer value moved by one ulp,
# changes after three steps ru_prev by 5.6e-10, rzeta by 1.9e-10,
# rvfrc0_prev by 1.7e-10, zeta by 6.5e-11 and hsbl by 6.2e-11 x
# max|field|.  roms_tpu_torch on the CPU rounds a few operations otherwise
# (torch's CPU sqrt, exp and pow are not XLA's) and lands within the same
# spread; measured: rvfrc0_prev 1.354e-09, ru_prev 4.823e-10, rv_prev
# 2.219e-10, DV_avg1 8.520e-11, DV_avg2 6.604e-11, rvbar 6.356e-11, rzeta
# 4.968e-11, hsbl 3.350e-11, v 2.772e-11, zeta 2.440e-11, rufrc0_prev
# 1.358e-11, vbar 9.644e-12, rubar 8.518e-12, ubar 6.263e-12, DU_avg1
# 4.189e-12, DU_avg2 2.954e-12, Akv and Akt 2.832e-12, u 1.996e-13.  The
# tracers, well conditioned, are held to 1e-12 (measured 1.015e-15), as
# is the root mean square of each subsampled field over every interior
# point (measured at most 3.383e-14).
BOUND = 1e-8
BOUND_OF = {"t": 1e-12, "t_initial": 1e-12}
RMS_BOUND = 1e-12


def stored(name, a):
    """{key: array} that the fixture keeps of field `name` (interior a)."""
    if name in FULL:
        return {name: a}
    return {name: a[..., ::2, ::2],
            name + "_rms": np.sqrt(np.mean(a * a, axis=(-2, -1)))}


def errors(cfg, s0, s, ref, factor: float = 1.0) -> dict:
    """{key: (|port - fixture| / max|fixture field|, bound)} of a
    roms_tpu_torch run of CASE: its initial state s0 and the state s after
    NSTEPS steps against the loaded fixture `ref`, every bound times
    `factor`."""
    H = cfg.halo

    def interior(a):
        return a[..., H:H + cfg.Mm, H:H + cfg.Lm].cpu().numpy()

    def rel(got, want):
        return float(np.abs(got - want).max() /
                     max(np.abs(want).max(), 1e-300))

    out = {"t_initial": (rel(interior(s0.t)[..., ::2, ::2],
                             ref["t_initial"]),
                         factor * BOUND_OF["t_initial"])}
    for name in FIELDS:
        a = interior(getattr(s, name))
        for key, got in stored(name, a).items():
            bound = RMS_BOUND if key.endswith("_rms") else \
                BOUND_OF.get(name, BOUND)
            out[key] = (rel(got, ref[key]), factor * bound)
    return out


def report(cfg, grid, s0, ffn) -> None:
    """Print the measurements the bounds of this file rest on."""
    import jax.numpy as jnp
    import torch
    from roms_tpu import stepping
    from roms_tpu_torch import stepping as tstepping
    from roms_tpu_torch.models import benchmark as tbenchmark
    from roms_tpu_torch.ops.vmix import cbrt

    H = cfg.halo

    def interior(a):
        return np.asarray(a)[..., H:H + cfg.Mm, H:H + cfg.Lm]

    up = jnp.asarray(np.nextafter(np.asarray(s0.t), np.inf))
    a, b = s0, s0.replace(t=up, t_prev=up)
    for _ in range(NSTEPS):
        a = stepping.step(cfg, grid, a, ffn)
        b = stepping.step(cfg, grid, b, ffn)
    for name in FIELDS:
        x, y = interior(getattr(a, name)), interior(getattr(b, name))
        print(f"roms_tpu, initial tracers one ulp up: {name:12s} "
              f"{np.abs(x - y).max() / max(np.abs(x).max(), 1e-300):.3e} "
              "x max|field|")

    torch.set_num_threads(1)
    tcfg, tgrid, t0, tffn = tbenchmark.build(
        tbenchmark.make_config(**CASE), device="cpu")
    t = tstepping.run(tcfg, tgrid, t0, NSTEPS, tffn)
    for key, (err, lim) in errors(tcfg, t0, t, np.load(OUT)).items():
        print(f"roms_tpu_torch (CPU) against the fixture: {key:16s} "
              f"{err:.3e} x max|field| (bound {lim:g})")

    x = np.random.default_rng(0).random(100000) * 40.0
    diff = int((torch.sqrt(torch.tensor(x)).numpy() != np.sqrt(x)).sum())
    xla = int((np.asarray(jnp.sqrt(x)) != np.sqrt(x)).sum())
    print(f"sqrt of 1e5 float64 values in [0, 40): torch on the CPU differs "
          f"from libm in {diff}, XLA in {xla}")
    x = 10.0 ** np.random.default_rng(3).uniform(-24, 3, 100000)
    ulp = np.spacing(np.cbrt(x))
    port = cbrt(torch.tensor(x)).numpy()
    ref = np.asarray(jnp.cbrt(x))
    print(f"cbrt of 1e5 float64 values in [1e-24, 1e3): roms_tpu_torch "
          f"within {np.max(np.abs(port - np.cbrt(x)) / ulp):.0f} ulp of "
          f"libm, jnp.cbrt within {np.max(np.abs(ref - np.cbrt(x)) / ulp):.0f}"
          f", the two within {np.max(np.abs(port - ref) / ref):.2e} relative")


def main() -> int:
    sys.path.insert(0, ROOT)
    import jax
    jax.config.update("jax_enable_x64", True)
    from roms_tpu import stepping
    from roms_tpu.models import benchmark

    cfg, grid, s, ffn = benchmark.build(benchmark.make_config(**CASE))
    if "--report" in sys.argv[1:]:
        report(cfg, grid, s, ffn)
        return 0
    H = cfg.halo

    def interior(a):
        return np.asarray(a)[..., H:H + cfg.Mm, H:H + cfg.Lm]

    out = {"t_initial": interior(s.t)[..., ::2, ::2]}
    for _ in range(NSTEPS):
        s = stepping.step(cfg, grid, s, ffn)
    for name in FIELDS:
        out.update(stored(name, interior(getattr(s, name))))
    out["time"] = np.asarray(float(s.time))
    out["iic"] = np.asarray(int(s.iic))
    np.savez_compressed(OUT, **out)
    print(f"wrote {OUT} ({os.path.getsize(OUT)} bytes): {NSTEPS} steps of "
          f"BENCHMARK {CASE}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
