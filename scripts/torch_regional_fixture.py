"""Write tests/data/torch_regional_small.npz: three float64 steps of small
KELVIN, ESTUARY_TEST and RIVERPLUME1 configurations through roms_tpu's
eager stepping.step on the CPU, the reference that roms_tpu_torch's open
boundaries, river source, GLS, logarithmic drag, HSIMT and KPP bottom
layer are held to end to end (tests/test_torch_regional.py,
tests/test_torch_kernels_gpu.py, chip_smoke.py).

    JAX_PLATFORMS=cpu python scripts/torch_regional_fixture.py [--report]

Importing this file runs nothing and imports no jax: ``CASES``, ``NSTEPS``
and ``errors`` hold a roms_tpu_torch run to the fixture, with the bounds
stated here.  ``--report`` writes nothing and prints the measurements the
bounds rest on: roms_tpu's own change after NSTEPS steps when every
initial tracer value moves up by one ulp, and roms_tpu_torch's CPU errors
against the fixture.

The step is run eagerly, not through make_stepper (the jitted step
contracts multiply-adds and differs from the eager one by ~1e-9
relative).  Stored for each case, under "<case>/<key>": the interior of
the initial tracers ("t_initial") and, after the last step, of every
State field the case's step writes; "time" and "iic" of the final state.
"""

from __future__ import annotations

import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, "tests", "data", "torch_regional_small.npz")
# case name -> the builder's sizes (the published widths cut to a small
# grid; RIVERPLUME1 keeps Mm = 67, where its river enters the channel)
CASES = {
    "kelvin": dict(Lm=24, Mm=16, N=4, ndtfast=20),
    "estuary": dict(Lm=40, Mm=3, N=6, ndtfast=20),
    "riverplume": dict(Lm=12, Mm=67, N=6, ndtfast=20),
}
NSTEPS = 3
# the State fields every step writes, and the ones a case adds
FIELDS = ("zeta", "ubar", "vbar", "u", "v", "t", "ru_prev", "rv_prev",
          "rufrc0_prev", "rvfrc0_prev", "rzeta", "rubar", "rvbar",
          "DU_avg1", "DV_avg1", "DU_avg2", "DV_avg2")
EXTRA = {"kelvin": (),
         "estuary": ("Akv", "Akt", "tke", "gls", "Akk", "Akp", "Lscale"),
         "riverplume": ("Akv", "Akt", "hsbl", "hbbl")}
# Pointwise bound on |port - fixture| on the CPU, times max|field|, by
# case and field (BOUND when not listed); every number below is printed by
# --report.  roms_tpu itself, with every initial tracer value moved up by
# one ulp, changes after three steps ESTUARY's GLS fields by up to
# 3.713e-10 (Akt; Akv, Akk, Akp 3.7e-10, Lscale 2.8e-10, gls 4.5e-13) and
# RIVERPLUME1's rvfrc0_prev by 3.211e-10, rufrc0_prev 1.666e-10, rv_prev
# 7.965e-12, ru_prev 3.720e-12; every other field by at most 7.8e-13
# (RIVERPLUME1 rvbar; KELVIN's by at most 8.1e-16).  Those fields are held
# to 1e-9, the others to 1e-11.  roms_tpu_torch on the CPU measures at
# most 5.177e-14 (RIVERPLUME1 rvfrc0_prev), 2.148e-14 on KELVIN and
# 2.324e-15 on ESTUARY_TEST (Akp).
BOUND = 1e-11
BOUND_OF = {("estuary", k): 1e-9 for k in ("Akv", "Akt", "gls", "Akk",
                                            "Akp", "Lscale")}
BOUND_OF.update({("riverplume", k): 1e-9 for k in (
    "ru_prev", "rv_prev", "rufrc0_prev", "rvfrc0_prev")})
# A velocity-like field is measured against the larger of its own and its
# partner's max: ESTUARY_TEST (f = 0, 3 rows) keeps v at round-off noise
# (roms_tpu ~1e-22 m/s, the port exactly 0), which its own max would
# blow up to a relative error of 1.
PARTNER = {"vbar": "ubar", "v": "u", "rv_prev": "ru_prev",
           "rvfrc0_prev": "rufrc0_prev", "rvbar": "rubar",
           "DV_avg1": "DU_avg1", "DV_avg2": "DU_avg2"}
PARTNER.update({b: a for a, b in PARTNER.items()})


def fields_of(case: str) -> tuple:
    return FIELDS + EXTRA[case]


def errors(case: str, cfg, s0, s, ref, factor: float = 1.0) -> dict:
    """{field: (|port - fixture| / max|fixture field|, bound)} of a
    roms_tpu_torch run of CASES[case]: its initial state s0 and the state s
    after NSTEPS steps, against the loaded fixture `ref`, every bound times
    `factor`."""
    H = cfg.halo

    def interior(a):
        return a[..., H:H + cfg.Mm, H:H + cfg.Lm].cpu().numpy()

    out = {}
    for name in ("t_initial",) + fields_of(case):
        got = interior(s0.t if name == "t_initial" else getattr(s, name))
        want = ref[f"{case}/{name}"]
        scale = np.abs(want).max()
        if name in PARTNER:
            scale = max(scale, np.abs(ref[f"{case}/{PARTNER[name]}"]).max())
        bound = BOUND_OF.get((case, name), BOUND)
        out[name] = (float(np.abs(got - want).max() / max(scale, 1e-300)),
                     factor * bound)
    return out


def build_reference(case: str):
    """The JAX case at CASES[case] (imports jax)."""
    from roms_tpu.models import cases
    return getattr(cases, case)(**CASES[case])


def report() -> None:
    """Print the measurements the bounds of this file rest on."""
    import jax.numpy as jnp
    import torch
    from roms_tpu import stepping
    from roms_tpu_torch import stepping as tstepping
    from roms_tpu_torch.models import cases as tcases

    ref = np.load(OUT)
    torch.set_num_threads(1)
    for case in CASES:
        cfg, grid, s0, ffn = build_reference(case)
        H = cfg.halo

        def interior(a):
            return np.asarray(a)[..., H:H + cfg.Mm, H:H + cfg.Lm]

        up = jnp.asarray(np.nextafter(np.asarray(s0.t), np.inf))
        a, b = s0, s0.replace(t=up, t_prev=up)
        for _ in range(NSTEPS):
            a = stepping.step(cfg, grid, a, ffn)
            b = stepping.step(cfg, grid, b, ffn)
        for name in fields_of(case):
            x, y = interior(getattr(a, name)), interior(getattr(b, name))
            scale = np.abs(x).max()
            if name in PARTNER:
                scale = max(scale, np.abs(interior(
                    getattr(a, PARTNER[name]))).max())
            print(f"{case}: roms_tpu, initial tracers one ulp up: "
                  f"{name:12s} "
                  f"{np.abs(x - y).max() / max(scale, 1e-300):.3e}"
                  " x max|field|")
        tcfg, tgrid, t0, tffn = getattr(tcases, case)(
            getattr(tcases, case + "_config")(**CASES[case]), device="cpu")
        t = tstepping.run(tcfg, tgrid, t0, NSTEPS, tffn)
        for key, (err, lim) in errors(case, tcfg, t0, t, ref).items():
            print(f"{case}: roms_tpu_torch (CPU) against the fixture: "
                  f"{key:12s} {err:.3e} x max|field| (bound {lim:g})")


def main() -> int:
    sys.path.insert(0, ROOT)
    import jax
    jax.config.update("jax_enable_x64", True)
    from roms_tpu import stepping

    if "--report" in sys.argv[1:]:
        report()
        return 0
    out = {}
    for case in CASES:
        cfg, grid, s, ffn = build_reference(case)
        H = cfg.halo

        def interior(a):
            return np.asarray(a)[..., H:H + cfg.Mm, H:H + cfg.Lm]

        out[f"{case}/t_initial"] = interior(s.t)
        for _ in range(NSTEPS):
            s = stepping.step(cfg, grid, s, ffn)
        for name in fields_of(case):
            out[f"{case}/{name}"] = interior(getattr(s, name))
        out[f"{case}/time"] = np.asarray(float(s.time))
        out[f"{case}/iic"] = np.asarray(int(s.iic))
    np.savez_compressed(OUT, **out)
    print(f"wrote {OUT} ({os.path.getsize(OUT)} bytes): {NSTEPS} steps of "
          f"{CASES}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
