"""Write tests/data/torch_operators_small.npz: three float64 steps of
roms_tpu's eager stepping.step on small versions of the cases that run the
other pressure-gradient schemes and mixing operators, the reference that
roms_tpu_torch's are held to end to end (tests/test_torch_operator_cases.py,
tests/test_torch_kernels_gpu.py, chip_smoke.py):

  * BASIN, DOUBLE_GYRE, GRAV_ADJ, CANYON3D, OVERFLOW, WINDBASIN and
    CHANNEL_NECK;
  * SEAMOUNT under each pressure-gradient scheme ("seamount_<scheme>");
  * UPWELLING with each option that no case uses ("upw_<option>"):
    Smagorinsky viscosity, biharmonic diffusion rotated to geopotentials
    or to isopycnals, and biharmonic viscosity rotated to geopotentials.

    JAX_PLATFORMS=cpu python scripts/torch_operators_fixture.py [--report]

Importing this file runs nothing and imports no jax: ``CASES``, ``NSTEPS``,
``build_port`` and ``errors`` hold a roms_tpu_torch run to the fixture,
with the bounds stated here.  ``--report`` writes nothing and prints the
measurements the bounds rest on: roms_tpu's own change after NSTEPS steps
when every initial tracer value moves up by one ulp, and roms_tpu_torch's
CPU errors against the fixture.

The step is run eagerly, not through make_stepper (the jitted step
contracts multiply-adds).  Stored for each case, under "<case>/<key>": the
interior of the initial tracers ("t_initial") and, after the last step, of
every State field the step writes; "time" and "iic" of the final state.
"""

from __future__ import annotations

import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, "tests", "data", "torch_operators_small.npz")
NSTEPS = 3
SCHEMES = ("djs", "dj", "pj", "pjq2", "pjq4")
# the options on UPWELLING, as Config changes (coefficients stable on its
# 1 km cells at dt = 300 s)
OPTIONS = {
    "smagorinsky": dict(uv_smagorinsky=True),
    "t4_geo": dict(ts_dif4=True, tnu4=(1.0e7, 1.0e7), ts_mix_geo=True),
    "t4_iso": dict(ts_dif4=True, tnu4=(1.0e7, 1.0e7), ts_mix_iso=True),
    "uv4_geo": dict(uv_vis4=True, visc4=1.0e7, uv_mix_geo=True),
}
# case -> (the package's module and builder, the builder's sizes: the
# published widths cut to a small grid, the Config change); OVERFLOW keeps
# Lm = 4 and GRAV_ADJ Mm = 4, their published narrow directions
_UPW = dict(Lm=10, Mm=12, N=4, ndtfast=10)
CASES = {
    "basin": ("cases", "basin", dict(Lm=12, Mm=10, N=4, ndtfast=10), {}),
    "double_gyre": ("cases", "double_gyre",
                    dict(Lm=10, Mm=12, N=4, ndtfast=10), {}),
    "grav_adj": ("cases", "grav_adj", dict(Lm=16, Mm=4, N=8, ndtfast=10),
                 {}),
    "canyon3d": ("cases", "canyon3d", dict(Lm=12, Mm=10, N=5, ndtfast=10),
                 {}),
    "overflow": ("cases", "overflow", dict(Lm=4, Mm=24, N=6, ndtfast=10),
                 {}),
    "windbasin": ("cases", "windbasin", dict(Lm=12, Mm=8, N=5, ndtfast=10),
                  {}),
    "channel_neck": ("cases4", "channel_neck",
                     dict(Lm=20, Mm=10, N=4, ndtfast=10), {}),
    **{f"seamount_{s}": ("cases", "seamount",
                         dict(Lm=10, Mm=10, N=6, ndtfast=10),
                         dict(prsgrd_scheme=s)) for s in SCHEMES},
    **{f"upw_{k}": ("upwelling", "upwelling", _UPW, ch)
       for k, ch in OPTIONS.items()},
}
FIELDS = ("zeta", "ubar", "vbar", "u", "v", "t", "ru_prev", "rv_prev",
          "rufrc0_prev", "rvfrc0_prev", "rzeta", "rubar", "rvbar",
          "DU_avg1", "DV_avg1", "DU_avg2", "DV_avg2")
# Pointwise bound on |port - fixture| on the CPU, times max|field|, by
# case and field (BOUND when not listed); every number below is printed by
# --report.  roms_tpu itself, with every initial tracer value moved up by
# one ulp, changes after three steps SEAMOUNT-pjq2's fields by up to
# 8.891e-11 (rvbar; rubar 8.9e-11, zeta 2.9e-11, DU/DV_avg2 1.2e-11: the
# WENO and minmod selects flip) and UPWELLING-uv4_geo's by up to 1.315e-10
# (rzeta; v 4.5e-11, zeta 4.2e-11, DV_avg2 2.5e-11, DV_avg1 1.3e-11);
# DOUBLE_GYRE's by up to 4.027e-12 (rufrc0_prev), CHANNEL_NECK's by
# 1.898e-13 (rvfrc0_prev), every other case's fields but t by 0.  Those two
# cases' fields but t are held to 1e-9, the rest to 1e-11.
# roms_tpu_torch on the CPU measures at most 1.300e-13 (CANYON3D rzeta),
# 1.772e-14 on CHANNEL_NECK and 4.7e-15 or less on the others.
BOUND = 1e-11
BOUND_OF = {(case, k): 1e-9 for case in ("seamount_pjq2", "upw_uv4_geo")
            for k in FIELDS if k != "t"}
# A velocity-like field is measured against the larger of its own and its
# partner's max (a field at round-off would blow its own max up: GRAV_ADJ
# and OVERFLOW keep one direction at rest).
PARTNER = {"vbar": "ubar", "v": "u", "rv_prev": "ru_prev",
           "rvfrc0_prev": "rufrc0_prev", "rvbar": "rubar",
           "DV_avg1": "DU_avg1", "DV_avg2": "DU_avg2"}
PARTNER.update({b: a for a, b in PARTNER.items()})


def fields_of(case: str) -> tuple:
    """The State fields the fixture holds for `case` (all cases: FIELDS)."""
    return FIELDS


def build_port(case: str, device="cpu", dtype="float64"):
    """roms_tpu_torch's (cfg, grid, state0, forcing_fn) of CASES[case]."""
    import importlib
    modname, builder, sizes, change = CASES[case]
    mod = importlib.import_module(f"roms_tpu_torch.models.{modname}")
    if modname == "upwelling":
        cfg = mod.make_config(dtype=dtype, **sizes).replace(**change)
        return mod.build(cfg, device=device)
    cfg = getattr(mod, builder + "_config")(dtype=dtype, **sizes)
    return getattr(mod, builder)(cfg.replace(**change), device=device)


def build_reference(case: str):
    """roms_tpu's case at CASES[case] (imports jax)."""
    import importlib
    modname, builder, sizes, change = CASES[case]
    mod = importlib.import_module(f"roms_tpu.models.{modname}")
    if modname == "upwelling":
        return mod.build(mod.make_config(**sizes).replace(**change))
    cfg, grid, s0, ffn = getattr(mod, builder)(**sizes)
    return cfg.replace(**change), grid, s0, ffn


def _interior(cfg, a):
    H = cfg.halo
    return np.asarray(a)[..., H:H + cfg.Mm, H:H + cfg.Lm]


def errors(case: str, cfg, s0, s, ref, factor: float = 1.0) -> dict:
    """{field: (|port - fixture| / max|fixture field|, bound)} of a
    roms_tpu_torch run of CASES[case]: its initial state s0 and the state s
    after NSTEPS steps, against the loaded fixture `ref`, every bound times
    `factor`."""
    def interior(a):
        return _interior(cfg, a.cpu().numpy())

    out = {}
    for name in ("t_initial",) + FIELDS:
        got = interior(s0.t if name == "t_initial" else getattr(s, name))
        want = ref[f"{case}/{name}"]
        scale = np.abs(want).max()
        if name in PARTNER:
            scale = max(scale, np.abs(ref[f"{case}/{PARTNER[name]}"]).max())
        bound = BOUND_OF.get((case, name), BOUND)
        out[name] = (float(np.abs(got - want).max() / max(scale, 1e-300)),
                     factor * bound)
    return out


def _spread(case: str) -> dict:
    """roms_tpu's change after NSTEPS steps of CASES[case] when every
    initial tracer value moves up by one ulp, per field, times max|field|."""
    import jax.numpy as jnp
    from roms_tpu import stepping
    cfg, grid, s0, ffn = build_reference(case)
    up = jnp.asarray(np.nextafter(np.asarray(s0.t), np.inf))
    a, b = s0, s0.replace(t=up, t_prev=up)
    for _ in range(NSTEPS):
        a = stepping.step(cfg, grid, a, ffn)
        b = stepping.step(cfg, grid, b, ffn)
    out = {}
    for name in FIELDS:
        x = _interior(cfg, getattr(a, name))
        y = _interior(cfg, getattr(b, name))
        scale = np.abs(x).max()
        if name in PARTNER:
            scale = max(scale, np.abs(_interior(
                cfg, getattr(a, PARTNER[name]))).max())
        out[name] = float(np.abs(x - y).max() / max(scale, 1e-300))
    return out


def report() -> None:
    """Print the measurements the bounds of this file rest on."""
    import torch
    from roms_tpu_torch import stepping as tstepping

    ref = np.load(OUT)
    torch.set_num_threads(1)
    for case in CASES:
        for name, e in _spread(case).items():
            print(f"{case}: roms_tpu, initial tracers one ulp up: "
                  f"{name:12s} {e:.3e} x max|field|")
        tcfg, tgrid, t0, tffn = build_port(case)
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
        out[f"{case}/t_initial"] = _interior(cfg, s.t)
        for _ in range(NSTEPS):
            s = stepping.step(cfg, grid, s, ffn)
        for name in FIELDS:
            out[f"{case}/{name}"] = _interior(cfg, getattr(s, name))
        out[f"{case}/time"] = np.asarray(float(s.time))
        out[f"{case}/iic"] = np.asarray(int(s.iic))
    np.savez_compressed(OUT, **out)
    print(f"wrote {OUT} ({os.path.getsize(OUT)} bytes): {NSTEPS} steps of "
          f"{sorted(CASES)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
