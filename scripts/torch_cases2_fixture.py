"""Write tests/data/torch_cases2_small.npz: float64 steps of roms_tpu's
eager step on small versions of CHANNEL, LMD_TEST, MIXED_LAYER, TEST_CHAN,
RIVERPLUME2, WEDDELL, BL_TEST and a 4-tracer UPWELLING with a mean-age
pair (three steps of stepping.step) and of SOLITON (ten steps of
ops.step2d.step_2d_only), the reference that roms_tpu_torch's KPP double
diffusion, ice shelf, mean age, Craig-Banner GLS, ramped open boundaries,
wall sources and 2-D-only step are held to end to end
(tests/test_torch_cases2.py, chip_smoke.py); and the surface fluxes that
roms_tpu's step hands on under WEDDELL's ice shelf
(tests/test_torch_iceshelf.py).

    JAX_PLATFORMS=cpu python scripts/torch_cases2_fixture.py [--report]

Importing this file runs nothing and imports no jax: ``CASES``,
``build_port``, ``run_port`` and ``errors`` hold a roms_tpu_torch run to
the fixture, with the bounds stated here.  ``--report`` writes nothing and
prints the measurements the bounds rest on: roms_tpu's own change after
its steps when every initial tracer value (SOLITON: every initial zeta
value) moves up by one ulp, and roms_tpu_torch's CPU errors against the
fixture.

The steps are run eagerly, not jitted (a jitted step contracts
multiply-adds).  Stored for each case, under "<case>/<key>": the repr of
roms_tpu's finished Config ("config"), every grid array over the padded
grid ("grid/<field>"), the forcing at FORCING_TIME ("forcing/<key>",
"forcing/bry/<key>", "forcing/sources/<field>"), the interior of the
initial tracers ("t_initial"; SOLITON's zeta, "zeta_initial") and, after
the last step, of every field the case's step writes; "time" and "iic" of
the final 3-D state.  Under "under_ice/<drag>/<name>", over the padded
grid: the sustr, svstr, stflx and srflx that roms_tpu's step hands its
tracer and momentum start (captured at its pre_step3d call) on the small
WEDDELL, from the current and fluxes of under_ice_inputs, under each drag
law of ICE_DRAGS.
"""

from __future__ import annotations

import dataclasses
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, "tests", "data", "torch_cases2_small.npz")
# case -> the builder's sizes: the published widths cut to a small grid.
# LMD_TEST keeps its 50 levels; RIVERPLUME2 keeps Mm = 70, where its
# channel (j = Mm - 10) meets the river the builder places at j = 60, and
# its land strip i <= 5; WEDDELL keeps the cavity and the ice front (i <=
# 20); TEST_CHAN and BL_TEST keep their narrow Mm = 3 and 4.
# "upwelling_age" is UPWELLING with a uniform third tracer and its mean age
# (AGE_MEAN), as tests/test_step3d.py::test_mean_age_tracer_pair sets it up.
CASES = {
    "channel": dict(Lm=12, Mm=10, N=4, ndtfast=10),
    "lmd_test": dict(Lm=6, Mm=6, N=50, ndtfast=10),
    "mixed_layer": dict(Lm=6, Mm=5, N=8),
    "test_chan": dict(Lm=20, Mm=3, N=6),
    "riverplume2": dict(Lm=10, Mm=70, N=4, ndtfast=10),
    "weddell": dict(Lm=24, Mm=4, N=6, ndtfast=10),
    "bl_test": dict(Lm=12, Mm=4, N=8, ndtfast=10),
    "soliton": dict(Lm=24, Mm=8),
    "upwelling_age": dict(Lm=10, Mm=12, N=4, ndtfast=10),
}
NSTEPS = 3
SOLITON_STEPS = 10
# a time at which the ramps, the wind burst, the tide and the diurnal
# shortwave are all under way (12 h)
FORCING_TIME = 4.32e4
# the State fields every 3-D step writes, and the ones a case adds
FIELDS = ("zeta", "ubar", "vbar", "u", "v", "t", "ru_prev", "rv_prev",
          "rufrc0_prev", "rvfrc0_prev", "rzeta", "rubar", "rvbar",
          "DU_avg1", "DV_avg1", "DU_avg2", "DV_avg2")
_KPP = ("Akv", "Akt", "hsbl", "hbbl")
EXTRA = {"lmd_test": _KPP, "bl_test": _KPP, "riverplume2": _KPP,
         "mixed_layer": ("Akv", "Akt", "tke", "gls", "Akk", "Akp",
                         "Lscale"),
         # the uniform tracer and its age, each against its own max
         "upwelling_age": ("t[2]", "t[3]")}
# the 2-D-only state (ops/step2d.py FS_FIELDS)
FS_FIELDS = ("zeta_n", "zeta_nm1", "ubar_n", "ubar_nm1", "vbar_n",
             "vbar_nm1", "rzeta_n", "rzeta_nm1", "rubar_n", "rubar_nm1",
             "rvbar_n", "rvbar_nm1", "Zt_avg1", "DU_avg1", "DV_avg1",
             "DU_avg2", "DV_avg2")
# Pointwise bound on |port - fixture| on the CPU, times max|field|, by
# case and field (BOUND when not listed); every number below is printed by
# --report.  roms_tpu itself, with every initial tracer value moved up by
# one ulp, changes after its steps MIXED_LAYER's barotropic fields by up
# to 3.507e-10 (rzeta; ubar and DU_avg1 2.7e-10, ru_prev 2.4e-10, DU_avg2
# 2.2e-10, rubar 1.3e-10, rufrc0_prev 4.5e-11, zeta 1.9e-11: GLS's
# Craig-Banner surface flux and Charnok roughness amplify it) and
# RIVERPLUME2's rvfrc0_prev by 1.548e-10 (rufrc0_prev 5.9e-11, rv_prev
# 1.3e-11); those fields are held to 1e-9.  Every other field moves by at
# most 6.1e-12 (BL_TEST v; WEDDELL 1.3e-12, CHANNEL, LMD_TEST, TEST_CHAN,
# UPWELLING with the age pair and SOLITON's zeta below 1e-15) and is held
# to 1e-11.  roms_tpu_torch on the CPU measures at most 4.139e-12
# (RIVERPLUME2 rvfrc0_prev), 1.8e-14 on CHANNEL, 3.8e-15 on BL_TEST,
# 1.7e-15 on MIXED_LAYER, 4.9e-15 on TEST_CHAN, 1.5e-15 on UPWELLING with
# the age pair (its tracers, the age pair's included, bitwise), 5.1e-16 on
# LMD_TEST, 2.0e-16 on WEDDELL, and 0 on SOLITON (its ten 2-D steps
# bitwise roms_tpu's).
BOUND = 1e-11
BOUND_OF = {("mixed_layer", k): 1e-9 for k in (
    "zeta", "ubar", "ru_prev", "rufrc0_prev", "rzeta", "rubar", "DU_avg1",
    "DU_avg2")}
BOUND_OF.update({("riverplume2", k): 1e-9 for k in (
    "rv_prev", "rufrc0_prev", "rvfrc0_prev")})
# A velocity-like field is measured against the larger of its own and its
# partner's max (a field at round-off would blow its own max up).
PARTNER = {"vbar": "ubar", "v": "u", "rv_prev": "ru_prev",
           "rvfrc0_prev": "rufrc0_prev", "rvbar": "rubar",
           "DV_avg1": "DU_avg1", "DV_avg2": "DU_avg2",
           "vbar_n": "ubar_n", "vbar_nm1": "ubar_nm1",
           "rvbar_n": "rubar_n", "rvbar_nm1": "rubar_nm1"}
PARTNER.update({b: a for a, b in PARTNER.items()})
# The least scale a field is measured against: LMD_TEST's doubly periodic
# columns under a uniform wind keep zeta and its rhs at round-off
# (roms_tpu 2.1e-24 m and 3.7e-17 m3/s after three steps, the port
# exactly 0), so they are held against 1 m and 1 m3/s.
FLOOR = {("lmd_test", "zeta"): 1.0, ("lmd_test", "rzeta"): 1.0}


# the drag laws the under-ice fluxes are captured under, and the bound on
# |port - fixture| / max|field| of those fluxes (a product, a square root
# and a select a point: the port matches to the last bit or one ulp)
ICE_DRAGS = ("quadratic", "linear")
ICE_BOUND = 1e-15


def fields_of(case: str) -> tuple:
    """The fields the fixture holds for `case`."""
    if case == "soliton":
        return FS_FIELDS
    return FIELDS + EXTRA.get(case, ())


def field(s, name: str):
    """State s's field `name`; "t[i]" is tracer i."""
    if name.startswith("t["):
        return s.t[int(name[2:-1])]
    return getattr(s, name)


def age_pair(cfg, s, cat):
    """UPWELLING's (cfg, state) with a uniform third tracer (1) and its
    mean age (0) appended, either package's; cat joins arrays along the
    first axis."""
    cfg = cfg.replace(ntracers=4, inert_age=((2, 3),), t_hadv=4 * ("U3",),
                      t_vadv=4 * ("C4",), tnu2=(0.0,) * 4,
                      akt_bak=(1e-6,) * 4)
    one = s.t[:1] * 0.0 + 1.0
    return cfg, s.replace(t=cat([s.t, one, one * 0.0]),
                          t_prev=cat([s.t, one, one * 0.0]),
                          Akt=cat([s.Akt, s.Akt[:1], s.Akt[:1]]))


def under_ice_inputs(s) -> dict:
    """A sheared current under and beyond WEDDELL's ice (u, v) and surface
    fluxes (sustr, svstr, stflux, srflx) for state s's grid, made with
    numpy from a seed."""
    rng = np.random.default_rng(11)
    shp, shp2 = tuple(s.u.shape), tuple(s.zeta.shape)
    return dict(u=0.2 * rng.standard_normal(shp),
                v=0.2 * rng.standard_normal(shp),
                sustr=1e-4 * rng.standard_normal(shp2),
                svstr=1e-4 * rng.standard_normal(shp2),
                stflux=1e-5 * rng.standard_normal((2,) + shp2),
                srflx=1e-5 * rng.random(shp2))


def under_ice_port(drag: str):
    """roms_tpu_torch's (grid, inputs, {name: flux}) under the small
    WEDDELL's ice with `drag`: stepping._under_ice, then set_vbc's stflx,
    on the CPU."""
    import torch
    from roms_tpu_torch import stepping
    from roms_tpu_torch.ops.vbc import set_vbc
    cfg, grid, s, _ = build_port("weddell")
    cfg = cfg.replace(bottom_drag=drag, rdrg=3.0e-4)
    a = {k: torch.tensor(v) for k, v in under_ice_inputs(s).items()}
    s = s.replace(u=a["u"], v=a["v"])
    sustr, svstr, stflux, srflx = stepping._under_ice(
        cfg, grid, s, a["sustr"], a["svstr"], a["stflux"], a["srflx"])
    stflx = set_vbc(cfg, grid, s.u, s.v, s.t, stflux,
                    torch.zeros_like(stflux))[2]
    return grid, a, dict(sustr=sustr, svstr=svstr, stflx=stflx, srflx=srflx)


class _Captured(Exception):
    pass


def under_ice_reference(drag: str) -> dict:
    """roms_tpu's {name: flux} under the small WEDDELL's ice with `drag`,
    as its eager step hands them to pre_step3d (imports jax)."""
    import jax.numpy as jnp
    from roms_tpu import stepping
    cfg, grid, s, _ = build_reference("weddell")
    cfg = cfg.replace(bottom_drag=drag, rdrg=3.0e-4)
    a = {k: jnp.asarray(v) for k, v in under_ice_inputs(s).items()}
    s = s.replace(u=a["u"], v=a["v"])
    frc = {k: a[k] for k in ("sustr", "svstr", "stflux", "srflx")}

    def capture(*args, **kw):
        raise _Captured(dict(sustr=args[13], svstr=args[14],
                             stflx=args[17], srflx=kw["srflx"]))

    real = stepping.pre_step3d
    stepping.pre_step3d = capture
    try:
        stepping.step(cfg, grid, s, lambda c, g, t: frc)
    except _Captured as e:
        return {k: np.asarray(v) for k, v in e.args[0].items()}
    finally:
        stepping.pre_step3d = real
    raise AssertionError("roms_tpu's step did not reach pre_step3d")


def _initial_key(case: str) -> str:
    return "zeta_initial" if case == "soliton" else "t_initial"


def build_port(case: str, device="cpu", dtype="float64"):
    """roms_tpu_torch's (cfg, grid, state0, forcing_fn) of CASES[case];
    SOLITON's state0 is its Fast2DState and forcing_fn None."""
    if case == "upwelling_age":
        import torch
        from roms_tpu_torch.models import upwelling
        cfg, grid, s, ffn = upwelling.build(upwelling.make_config(
            dtype=dtype, **CASES[case]), device=device)
        cfg, s = age_pair(cfg, s, torch.cat)
        return cfg, grid, s, ffn
    if case == "soliton":
        from roms_tpu_torch.models import soliton
        cfg, grid, fs = soliton.build(
            soliton.make_config(dtype=dtype, **CASES[case]), device=device)
        return cfg, grid, fs, None
    from roms_tpu_torch.models import cases2
    cfg = getattr(cases2, case + "_config")(dtype=dtype, **CASES[case])
    return getattr(cases2, case)(cfg, device=device)


def run_port(case: str, cfg, grid, s0, ffn):
    """The state after the case's steps: NSTEPS of stepping.run, or
    SOLITON_STEPS of step_2d_only (the first one forward Euler)."""
    if case == "soliton":
        from roms_tpu_torch.ops import step2d
        fs = s0
        for n in range(SOLITON_STEPS):
            fs = step2d.step_2d_only(cfg, grid, fs, n == 0)
        return fs
    from roms_tpu_torch import stepping
    return stepping.run(cfg, grid, s0, NSTEPS, ffn)


def build_reference(case: str):
    """roms_tpu's case at CASES[case] (imports jax)."""
    if case == "upwelling_age":
        import jax.numpy as jnp
        from roms_tpu.models import upwelling
        cfg, grid, s, ffn = upwelling.build(upwelling.make_config(
            **CASES[case]))
        cfg, s = age_pair(cfg, s, jnp.concatenate)
        return cfg, grid, s, ffn
    if case == "soliton":
        from roms_tpu.models import soliton
        cfg, grid, fs = soliton.build(soliton.make_config(**CASES[case]))
        return cfg, grid, fs, None
    from roms_tpu.models import cases2
    return getattr(cases2, case)(**CASES[case])


def run_reference(case: str, cfg, grid, s, ffn):
    """roms_tpu's eager steps of `case` from s."""
    if case == "soliton":
        from roms_tpu.ops import step2d
        for n in range(SOLITON_STEPS):
            s = step2d.step_2d_only(cfg, grid, s, n == 0)
        return s
    from roms_tpu import stepping
    for _ in range(NSTEPS):
        s = stepping.step(cfg, grid, s, ffn)
    return s


def _interior(cfg, a):
    H = cfg.halo
    return np.asarray(a)[..., H:H + cfg.Mm, H:H + cfg.Lm]


def _initial(case: str, s):
    return s.zeta_n if case == "soliton" else s.t


def errors(case: str, cfg, s0, s, ref, factor: float = 1.0) -> dict:
    """{field: (|port - fixture| / max|fixture field|, bound)} of a
    roms_tpu_torch run of CASES[case]: its initial state s0 and the state s
    after its steps, against the loaded fixture `ref`, every bound times
    `factor`."""
    def interior(a):
        return _interior(cfg, a.cpu().numpy())

    out = {}
    first = _initial_key(case)
    for name in (first,) + fields_of(case):
        got = interior(_initial(case, s0) if name == first
                       else field(s, name))
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
    """{"forcing/<key>": array} of a forcing dict, its "bry" dict and its
    point sources' fields flattened (either package's)."""
    out = {}
    for k, v in frc.items():
        if isinstance(v, dict):
            out.update(forcing_arrays(v, f"{prefix}/{k}"))
        elif hasattr(v, "_asdict"):
            out.update({f"{prefix}/{k}/{f}": a for f, a in
                        v._asdict().items() if a is not None})
        else:
            out[f"{prefix}/{k}"] = v
    return out


def _spread(case: str) -> dict:
    """roms_tpu's change after the case's steps when every initial tracer
    (SOLITON: zeta) value moves up by one ulp, per field, times
    max|field|."""
    import jax.numpy as jnp
    cfg, grid, s0, ffn = build_reference(case)
    if case == "soliton":
        up = jnp.asarray(np.nextafter(np.asarray(s0.zeta_n), np.inf))
        b = s0.replace(zeta_n=up, zeta_nm1=up, Zt_avg1=up)
    else:
        up = jnp.asarray(np.nextafter(np.asarray(s0.t), np.inf))
        b = s0.replace(t=up, t_prev=up)
    a = run_reference(case, cfg, grid, s0, ffn)
    b = run_reference(case, cfg, grid, b, ffn)
    out = {}
    for name in fields_of(case):
        x = _interior(cfg, field(a, name))
        y = _interior(cfg, field(b, name))
        scale = np.abs(x).max()
        if name in PARTNER:
            scale = max(scale, np.abs(_interior(
                cfg, getattr(a, PARTNER[name]))).max())
        scale = max(scale, FLOOR.get((case, name), 0.0))
        out[name] = float(np.abs(x - y).max() / max(scale, 1e-300))
    return out


def report() -> None:
    """Print the measurements the bounds of this file rest on."""
    import torch
    ref = np.load(OUT)
    torch.set_num_threads(1)
    cases = [c for c in sys.argv[1:] if c in CASES] or list(CASES)
    for case in cases:
        for name, e in _spread(case).items():
            print(f"{case}: roms_tpu, initial values one ulp up: "
                  f"{name:12s} {e:.3e} x max|field|")
        tcfg, tgrid, t0, tffn = build_port(case)
        t = run_port(case, tcfg, tgrid, t0, tffn)
        for key, (err, lim) in errors(case, tcfg, t0, t, ref).items():
            print(f"{case}: roms_tpu_torch (CPU) against the fixture: "
                  f"{key:12s} {err:.3e} x max|field| (bound {lim:g})")
    for drag in ICE_DRAGS:
        _, _, got = under_ice_port(drag)
        for name, x in got.items():
            want = ref[f"under_ice/{drag}/{name}"]
            print(f"under the ice, {drag} drag: roms_tpu_torch (CPU) "
                  f"against the fixture: {name:6s} "
                  f"{np.abs(x.numpy() - want).max() / np.abs(want).max():.3e}"
                  f" x max|field| (bound {ICE_BOUND:g})")


def main() -> int:
    sys.path.insert(0, ROOT)
    import jax
    jax.config.update("jax_enable_x64", True)

    if "--report" in sys.argv[1:]:
        report()
        return 0
    out = {}
    for case in CASES:
        cfg, grid, s, ffn = build_reference(case)
        out[f"{case}/config"] = np.asarray(repr(cfg))
        for f in dataclasses.fields(grid):
            a = getattr(grid, f.name)
            if a is not None:
                out[f"{case}/grid/{f.name}"] = np.asarray(a)
        if ffn is not None:
            for k, a in forcing_arrays(ffn(cfg, grid, FORCING_TIME)).items():
                out[f"{case}/{k}"] = np.asarray(a)
        out[f"{case}/{_initial_key(case)}"] = _interior(cfg,
                                                        _initial(case, s))
        s = run_reference(case, cfg, grid, s, ffn)
        for name in fields_of(case):
            out[f"{case}/{name}"] = _interior(cfg, field(s, name))
        if case != "soliton":
            out[f"{case}/time"] = np.asarray(float(s.time))
            out[f"{case}/iic"] = np.asarray(int(s.iic))
    for drag in ICE_DRAGS:
        for name, a in under_ice_reference(drag).items():
            out[f"under_ice/{drag}/{name}"] = a
    np.savez_compressed(OUT, **out)
    print(f"wrote {OUT} ({os.path.getsize(OUT)} bytes): {sorted(CASES)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
