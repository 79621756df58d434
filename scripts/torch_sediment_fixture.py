"""Write tests/data/torch_sediment_small.npz: three float64 steps of
roms_tpu's eager step on small versions of the sediment cases, the
reference that roms_tpu_torch's MPDATA, MY2.5, SSW/MB/SG bottom boundary
layers and suspended sediment (settling, erosion, bed layers, MPM and
Soulsby bedload, SED_MORPH) are held to end to end
(tests/test_torch_sediment_cases.py, chip_smoke.py):

  sed_toy          SED_TOY, two classes on three bed layers, a 0.05 kg/m3
                   start and a low critical stress (settling, erosion,
                   the borrow and the split), no bottom boundary layer;
  sed_toy_ssw      SED_TOY under waves (Hwave 1.5 m, Pwave 8 s; as
                   tests/test_bbl.py:107-112) with the SSW layer;
  sed_toy_mb       the same with the MB layer;
  sed_toy_sg       the same with the SG layer;
  sed_toy_soulsby  SSW with Soulsby's bedload;
  sed_toy_morph    SSW with MPM bedload and SED_MORPH (morph_fac 10);
  lake_signell     LAKE_SIGNELL at 24 x 8 x 6 from hour 20, wind and waves
                   at full strength (MPDATA, GLS, SSW, sand);
  sed_test1        SED_TEST1 at 24 x 6 x 6 (MY2.5, HSIMT sand, clamped
                   and radiation open ends).

    JAX_PLATFORMS=cpu python scripts/torch_sediment_fixture.py [--report]

Importing this file runs nothing and imports no jax: ``CASES``,
``build_port``, ``run_port`` and ``errors`` hold a roms_tpu_torch run to
the fixture, with the bounds stated here.  ``--report`` writes nothing and
prints the measurements the bounds rest on: roms_tpu's own change after
its steps when every initial tracer value moves up by one ulp, and when
its steps are jitted (XLA then contracts multiply-adds), and
roms_tpu_torch's CPU errors against the fixture.

The steps are eager, not jitted (a jitted step contracts multiply-adds).
Stored for each case, under "<case>/<key>": the repr of roms_tpu's
finished Config ("config"), for the three base cases every grid array over
the padded grid ("grid/<field>") and the forcing at FORCING_TIME
("forcing/<key>", "forcing/bry/<key>"), the interior of the initial
tracers ("t_initial"), and, after the last step, the interior of every
field the case's step writes; "time" and "iic" of the final state.
"""

from __future__ import annotations

import dataclasses
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, "tests", "data", "torch_sediment_small.npz")
NSTEPS = 3
# SED_TOY's sizes (its builder's 8 x 10, N cut to 8 as tests/test_bbl.py
# does); LAKE_SIGNELL and SED_TEST1 cut to Lm <= 32 with their depths and
# boundaries kept
SED_TOY = dict(Lm=8, Mm=10, N=8)
BASE = {"sed_toy": "sed_toy", "sed_toy_ssw": "sed_toy",
        "sed_toy_mb": "sed_toy", "sed_toy_sg": "sed_toy",
        "sed_toy_soulsby": "sed_toy", "sed_toy_morph": "sed_toy",
        "lake_signell": "lake_signell", "sed_test1": "sed_test1"}
CASES = {"lake_signell": dict(Lm=24, Mm=8, N=6),
         "sed_test1": dict(Lm=24, Mm=6, N=6)}
CASES.update({k: SED_TOY for k, b in BASE.items() if b == "sed_toy"})
# the cases whose grid and forcing the fixture holds (the variants share
# SED_TOY's grid)
BUILDERS = ("sed_toy", "lake_signell", "sed_test1")
# LAKE_SIGNELL starts at hour 20, when the wind and the waves have ramped
# up (the builder's ramp is ~3e-7 at hour 0)
LAKE_START = 7.2e4
# the forcing time the builder tests compare at (the ramps under way)
FORCING_TIME = 6.3e4
# the State fields every 3-D step writes, and the ones a case adds
FIELDS = ("zeta", "ubar", "vbar", "u", "v", "t", "ru_prev", "rv_prev",
          "rufrc0_prev", "rvfrc0_prev", "rzeta", "rubar", "rvbar",
          "DU_avg1", "DV_avg1", "DU_avg2", "DV_avg2", "bed_mass")
_BBL = ("rheight", "rlength", "tau_cwmax")
_TURB = ("Akv", "Akt", "tke", "gls", "Akk", "Lscale")
EXTRA = {"sed_toy_ssw": _BBL, "sed_toy_mb": _BBL, "sed_toy_sg": _BBL,
         "sed_toy_soulsby": _BBL, "sed_toy_morph": _BBL,
         "lake_signell": _BBL + _TURB, "sed_test1": _TURB}
# Pointwise bound on |port - fixture| on the CPU, times max|field|, by
# case and field (BOUND when not listed); every number below is printed by
# --report.  The first steps from rest are ill-conditioned in zeta and its
# rhs: roms_tpu itself moves SED_TOY's zeta and rzeta by 2.4e-10 and
# 1.9e-10 when every initial tracer value moves up one ulp (SED_MORPH's
# 4.0e-10 and 3.7e-10, v 3.0e-11), and by 4.0e-10 to 1.3e-9 when its steps
# are jitted instead of eager (SED_MORPH's v 6.9e-11, DV_avg2 1.6e-11).
# LAKE_SIGNELL's GLS fields under the SSW layer move by up to 3.2e-10
# (Lscale; Akv, Akt and Akk 2.3e-10, tke 6.0e-11) jitted against eager.
# roms_tpu_torch on the CPU measures SED_MORPH's zeta 2.5e-10, rzeta
# 2.8e-10, v 1.9e-11, DV_avg2 9.9e-12 and LAKE_SIGNELL's Lscale 2.5e-10,
# Akv 9.8e-11, tke 6.3e-11: those fields are held to 1e-9 (1e-10 for v
# and DV_avg1/2).  Every other field is at most 5.5e-12 (LAKE_SIGNELL
# rv_prev; SED_TEST1 7.0e-13, SED_TOY under SG 1.4e-12, the other SED_TOY
# variants below 3e-15) and is held to 1e-11.
BOUND = 1e-11
BOUND_OF = {("sed_toy_morph", "zeta"): 1e-9,
            ("sed_toy_morph", "rzeta"): 1e-9}
BOUND_OF.update({("sed_toy_morph", k): 1e-10 for k in
                 ("v", "DV_avg1", "DV_avg2")})
BOUND_OF.update({("lake_signell", k): 1e-9 for k in
                 ("tke", "gls", "Akv", "Akt", "Akk", "Lscale")})
# A velocity-like field is measured against the larger of its own and its
# partner's max (a field at round-off would blow its own max up).
PARTNER = {"vbar": "ubar", "v": "u", "rv_prev": "ru_prev",
           "rvfrc0_prev": "rufrc0_prev", "rvbar": "rubar",
           "DV_avg1": "DU_avg1", "DV_avg2": "DU_avg2"}
PARTNER.update({b: a for a, b in PARTNER.items()})
# The least scale a field is measured against
FLOOR: dict = {}


def fields_of(case: str) -> tuple:
    """The fields the fixture holds for `case`."""
    return FIELDS + EXTRA.get(case, ())


def _params(case: str, sed_cls):
    """The sediment parameters of a SED_TOY variant (either package's
    class): for "sed_toy" two classes on three bed layers with a low
    critical stress, so that the first steps erode, settle, borrow and
    split; for the others tests/test_bbl.py's class."""
    if case == "sed_toy":
        return sed_cls(Sd50=(0.00015, 0.0005), Srho=(2650.0, 2650.0),
                       Wsed=(0.001, 0.004), Erate=(5.0e-5, 2.0e-5),
                       tau_ce=(1.0e-7, 2.0e-7), tau_cd=(1.0e-7, 2.0e-7),
                       Nbed=3)
    p = sed_cls(Wsed=(0.0005,), Erate=(5.0e-5,))
    if case == "sed_toy_soulsby":
        p = dataclasses.replace(p, bedload=True, bedload_method="soulsby")
    if case == "sed_toy_morph":
        p = dataclasses.replace(p, bedload=True, sed_morph=True,
                                morph_fac=10.0)
    return p


def _with_bbl(case: str, cfg, bbl_mod):
    """A SED_TOY variant's configuration with its bottom boundary layer
    (either package's module ops/bbl)."""
    if case == "sed_toy":
        return cfg
    kind = {"sed_toy_mb": "mb", "sed_toy_sg": "sg"}.get(case, "ssw")
    params = {"ssw": bbl_mod.BBLParams, "mb": bbl_mod.MBBBLParams,
              "sg": bbl_mod.SGBBLParams}[kind]()
    return cfg.replace(bbl=kind, bbl_params=params)


def _wavy(ffn, ones_like, zeros_like):
    def forcing(cfg, grid, time):
        base = dict(ffn(cfg, grid, time))
        one = ones_like(grid.h)
        base.update(Hwave=1.5 * one, Pwave=8.0 * one, Dwave=zeros_like(one))
        return base
    return forcing


def build_port(case: str, device="cpu", dtype="float64"):
    """roms_tpu_torch's (cfg, grid, state0, forcing_fn) of `case`."""
    import torch
    base = BASE[case]
    if base == "sed_toy":
        from roms_tpu_torch.models import sed_toy
        from roms_tpu_torch.ops import bbl
        from roms_tpu_torch.ops.sediment import SedParams
        cfg = _with_bbl(case, sed_toy.make_config(
            params=_params(case, SedParams), dtype=dtype, **CASES[case]),
            bbl)
        cfg, grid, s, ffn = sed_toy.build(
            cfg, device=device, conc=0.05 if case == "sed_toy" else 0.0)
        if case != "sed_toy":
            ffn = _wavy(ffn, torch.ones_like, torch.zeros_like)
        return cfg, grid, s, ffn
    if base == "lake_signell":
        from roms_tpu_torch.models import cases
        cfg, grid, s, ffn = cases.lake_signell(cases.lake_signell_config(
            dtype=dtype, **CASES[case]), device=device)
        return cfg, grid, s.replace(time=LAKE_START), ffn
    from roms_tpu_torch.models import cases2
    return cases2.sed_test1(cases2.sed_test1_config(dtype=dtype,
                                                    **CASES[case]),
                            device=device)


def run_port(case: str, cfg, grid, s0, ffn):
    from roms_tpu_torch import stepping
    return stepping.run(cfg, grid, s0, NSTEPS, ffn)


def build_reference(case: str):
    """roms_tpu's case (imports jax)."""
    import jax.numpy as jnp
    base = BASE[case]
    if base == "sed_toy":
        from roms_tpu.models import sed_toy
        from roms_tpu.ops import bbl
        from roms_tpu.ops.sediment import SedParams
        cfg = _with_bbl(case, sed_toy.make_config(
            params=_params(case, SedParams), **CASES[case]), bbl)
        cfg, grid, s, ffn = sed_toy.build(
            cfg, conc=0.05 if case == "sed_toy" else 0.0)
        if case != "sed_toy":
            ffn = _wavy(ffn, jnp.ones_like, jnp.zeros_like)
        return cfg, grid, s, ffn
    if base == "lake_signell":
        from roms_tpu.models import cases
        cfg, grid, s, ffn = cases.lake_signell(**CASES[case])
        return cfg, grid, s.replace(time=jnp.asarray(LAKE_START)), ffn
    from roms_tpu.models import cases2
    return cases2.sed_test1(**CASES[case])


def run_reference(case: str, cfg, grid, s, ffn):
    """roms_tpu's eager steps from s."""
    from roms_tpu import stepping
    for _ in range(NSTEPS):
        s = stepping.step(cfg, grid, s, ffn)
    return s


def _interior(cfg, a):
    H = cfg.halo
    return np.asarray(a)[..., H:H + cfg.Mm, H:H + cfg.Lm]


def errors(case: str, cfg, s0, s, ref, factor: float = 1.0) -> dict:
    """{field: (|port - fixture| / max|fixture field|, bound)} of a
    roms_tpu_torch run of `case`: its initial state s0 and the state s after
    its steps, against the loaded fixture `ref`, every bound times
    `factor`."""
    def interior(a):
        return _interior(cfg, a.cpu().numpy())

    out = {}
    for name in ("t_initial",) + fields_of(case):
        got = interior(s0.t if name == "t_initial" else getattr(s, name))
        want = ref[f"{case}/{name}"]
        scale = np.abs(want).max()
        if name in PARTNER:
            scale = max(scale, np.abs(ref[f"{case}/{PARTNER[name]}"]).max())
        scale = max(scale, FLOOR.get((case, name), 0.0))
        bound = BOUND_OF.get((case, name), BOUND)
        out[name] = (float(np.abs(got - want).max() / max(scale, 1e-300)),
                     factor * bound)
    return out


def forcing_arrays(frc: dict, prefix: str = "forcing") -> dict:
    """{"forcing/<key>": array} of a forcing dict, its "bry" dict
    flattened (either package's)."""
    out = {}
    for k, v in frc.items():
        if isinstance(v, dict):
            out.update(forcing_arrays(v, f"{prefix}/{k}"))
        else:
            out[f"{prefix}/{k}"] = v
    return out


def _rel_change(case: str, cfg, a, b) -> dict:
    """{field: max|a - b| / max|a|} over the fields of `case`, a
    velocity-like field against its partner's max too."""
    out = {}
    for name in fields_of(case):
        x = _interior(cfg, getattr(a, name))
        y = _interior(cfg, getattr(b, name))
        scale = np.abs(x).max()
        if name in PARTNER:
            scale = max(scale, np.abs(_interior(
                cfg, getattr(a, PARTNER[name]))).max())
        scale = max(scale, FLOOR.get((case, name), 0.0))
        out[name] = float(np.abs(x - y).max() / max(scale, 1e-300))
    return out


def _spread(case: str) -> dict:
    """roms_tpu's change after the case's steps when every initial tracer
    value moves up by one ulp."""
    import jax.numpy as jnp
    cfg, grid, s0, ffn = build_reference(case)
    up = jnp.asarray(np.nextafter(np.asarray(s0.t), np.inf))
    a = run_reference(case, cfg, grid, s0, ffn)
    b = run_reference(case, cfg, grid, s0.replace(t=up, t_prev=up), ffn)
    return _rel_change(case, cfg, a, b)


def _jit_spread(case: str) -> dict:
    """roms_tpu's jitted steps against its eager ones (XLA contracts
    multiply-adds under jit)."""
    import jax
    from roms_tpu import stepping
    cfg, grid, s0, ffn = build_reference(case)
    a = run_reference(case, cfg, grid, s0, ffn)
    step = jax.jit(lambda s: stepping.step(cfg, grid, s, ffn))
    b = s0
    for _ in range(NSTEPS):
        b = step(b)
    return _rel_change(case, cfg, a, b)


def report() -> None:
    """Print the measurements the bounds of this file rest on."""
    import torch
    ref = np.load(OUT)
    torch.set_num_threads(1)
    cases = [c for c in sys.argv[1:] if c in BASE] or list(BASE)
    for case in cases:
        for name, e in _spread(case).items():
            print(f"{case}: roms_tpu, initial values one ulp up: "
                  f"{name:12s} {e:.3e} x max|field|")
        for name, e in _jit_spread(case).items():
            print(f"{case}: roms_tpu, jitted against eager: "
                  f"{name:12s} {e:.3e} x max|field|")
        tcfg, tgrid, t0, tffn = build_port(case)
        t = run_port(case, tcfg, tgrid, t0, tffn)
        for key, (err, lim) in errors(case, tcfg, t0, t, ref).items():
            print(f"{case}: roms_tpu_torch (CPU) against the fixture: "
                  f"{key:12s} {err:.3e} x max|field| (bound {lim:g})")


def main() -> int:
    sys.path.insert(0, ROOT)
    import jax
    jax.config.update("jax_enable_x64", True)

    if "--report" in sys.argv[1:]:
        report()
        return 0
    out = {}
    for case in BASE:
        cfg, grid, s, ffn = build_reference(case)
        out[f"{case}/config"] = np.asarray(repr(cfg))
        if case in BUILDERS:
            for f in dataclasses.fields(grid):
                a = getattr(grid, f.name)
                if a is not None:
                    out[f"{case}/grid/{f.name}"] = np.asarray(a)
            for k, a in forcing_arrays(ffn(cfg, grid,
                                           FORCING_TIME)).items():
                out[f"{case}/{k}"] = np.asarray(a)
        out[f"{case}/t_initial"] = _interior(cfg, s.t)
        s = run_reference(case, cfg, grid, s, ffn)
        for name in fields_of(case):
            out[f"{case}/{name}"] = _interior(cfg, getattr(s, name))
        out[f"{case}/time"] = np.asarray(float(s.time))
        out[f"{case}/iic"] = np.asarray(int(s.iic))
        print(f"{case}: done", flush=True)
    np.savez_compressed(OUT, **out)
    print(f"wrote {OUT} ({os.path.getsize(OUT)} bytes): {sorted(BASE)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
