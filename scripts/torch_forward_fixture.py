"""Write tests/data/torch_forward_small.npz: float64 steps of roms_tpu's
eager step on the last branches of its forward model, the reference that
roms_tpu_torch's BODYFORCE, floats, nearshore radiation stress with the
Stokes drift and budget diagnostics are held to end to end
(tests/test_torch_forward_cases.py, chip_smoke.py):

  flt_test      FLT_TEST at its published 14 x 12 x 4 (BODYFORCE), five
                steps, with a 3 x 3 cluster of floats at mid-depth stepped
                after each (floats.step_floats from the step's u, v, W
                and Hz; the last two take the Milne/Hamming ladder);
  shoreface05   SHOREFACE cut to 20 x 4 x 8 (wet/dry, GLS, the SSW bottom
                boundary layer, sand, Chapman/Flather west end) under the
                Mellor05 radiation stress, three steps;
  shoreface08   the same under Mellor08;
  upwelling_dia UPWELLING at 10 x 12 x 10 with tnu2 = 5 and visc2 = 20
                m2/s (hdiff and hvisc active, tests/test_diags.py:15, :58)
                and a seeded velocity perturbation (the x terms active),
                two steps with collect_diags; every key of the last
                step's budget dict.

    JAX_PLATFORMS=cpu python scripts/torch_forward_fixture.py [--report]

Importing this file runs nothing and imports no jax: ``CASES``,
``build_port``, ``run_port`` and ``errors`` hold a roms_tpu_torch run to
the fixture, with the bounds stated here.  ``--report`` writes nothing and
prints what the bounds rest on: roms_tpu's own change when every initial
tracer value moves up by one ulp, and roms_tpu_torch's CPU errors against
the fixture.

Stored under "<case>/<key>": the repr of roms_tpu's finished Config
("config"), the interior of the initial tracers ("t_initial") and of every
field the case's step writes after the last step, "time" and "iic";
"fl/<field>" the floats' (4, 9) histories; "dia/<key>" the interior of a
budget term.
"""

from __future__ import annotations

import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, "tests", "data", "torch_forward_small.npz")
# case -> (builder, sizes, steps)
CASES = {
    "flt_test": ("flt_test", {}, 5),
    "shoreface05": ("shoreface", dict(Lm=20, Mm=4, N=8), 3),
    "shoreface08": ("shoreface", dict(Lm=20, Mm=4, N=8), 3),
    "upwelling_dia": ("upwelling", dict(Lm=10, Mm=12, N=10), 2),
}
FIELDS = ("zeta", "ubar", "vbar", "u", "v", "t", "ru_prev", "rv_prev",
          "rufrc0_prev", "rvfrc0_prev", "rzeta", "rubar", "rvbar",
          "DU_avg1", "DV_avg1", "DU_avg2", "DV_avg2")
_SHORE = ("Akv", "Akt", "tke", "gls", "bed_mass", "rheight", "rlength",
          "tau_cwmax")
EXTRA = {"shoreface05": _SHORE, "shoreface08": _SHORE}
FLOAT_FIELDS = ("xg", "yg", "zg", "ug", "vg", "wg")
# the seeded velocity perturbation of upwelling_dia (m/s)
PERTURBATION = 0.02
# Pointwise bound on |port - fixture| on the CPU, times max|field| (each
# tracer against its own, each budget term against the largest of its
# direction's or its tracers' terms); every number is printed by --report.
# roms_tpu_torch on the CPU measures at most 4.5e-14 on FLT_TEST and
# UPWELLING's budgets.  SHOREFACE is ill-conditioned at its closed east
# wall: the dry halo column's D_u is negative, so the wall face divides the
# Stokes transport by max(D_u, 1e-14), and a one-ulp change of zeta at the
# dry cell beside it (which the fast loop's averaging already makes between
# roms_tpu's compiled loop and any other) moves roms_tpu's own zeta by
# 6.2e-7, the sand by 1.4e-5, tke by 1.7e-5 (Mellor05; 1.2e-5 Mellor08),
# gls by 9.2e-6, Akv and Akt by 5.0e-6 and the bed by 8.1e-12 of their
# maxima in three steps.  The port measures 5.3e-8, 1.2e-6, 1.5e-6,
# 7.8e-7, 4.3e-7 and 6.9e-13 there, and at most 1.3e-14 elsewhere.
BOUND = 1e-12
WALL_BOUND = {"zeta": 1e-6, "t[2]": 2e-5, "tke": 2e-5, "gls": 1e-5,
              "Akv": 1e-5, "Akt": 1e-5, "bed_mass": 1e-11}
BOUND_OF = {(case, k): b for case in ("shoreface05", "shoreface08")
            for k, b in WALL_BOUND.items()}
# A velocity-like field is measured against the larger of its own and its
# partner's max (a field at round-off would blow its own max up); the
# floats' grid velocity (ug, vg, wg) is one vector in grid units a second,
# and wg is at round-off where a float sits on a closed level.
PARTNER = {"vbar": "ubar", "v": "u", "rv_prev": "ru_prev",
           "rvfrc0_prev": "rufrc0_prev", "rvbar": "rubar",
           "DV_avg1": "DU_avg1", "DV_avg2": "DU_avg2", "fl/vg": "fl/ug"}
PARTNER.update({b: a for a, b in PARTNER.items()})
PARTNER["fl/wg"] = "fl/ug"
PER_TRACER = True


def fields_of(case: str) -> tuple:
    return FIELDS + EXTRA.get(case, ())


def float_seeds(cfg):
    """The floats of flt_test: a 3 x 3 cluster away from the island
    (tests/test_cases3.py:55-59) at mid-depth."""
    H = cfg.halo
    x0, y0 = np.meshgrid(np.arange(3.0, 6.0), np.arange(4.0, 7.0))
    return (x0.ravel() + H - 0.5, y0.ravel() + H - 0.5,
            np.full(9, 0.5 * cfg.N))


def perturbation(cfg):
    """upwelling_dia's seeded (du, dv) over the padded grid."""
    rng = np.random.default_rng(7)
    shape = (cfg.N, cfg.ny_tot, cfg.nx_tot)
    return (PERTURBATION * rng.standard_normal(shape),
            PERTURBATION * rng.standard_normal(shape))


def _configure(case, cfg):
    if case == "shoreface08":
        return cfg.replace(nearshore="mellor08")
    if case == "upwelling_dia":
        return cfg.replace(tnu2=(5.0, 5.0), visc2=20.0, uv_vis2=True)
    return cfg


def build_port(case: str, device="cpu", dtype="float64"):
    """roms_tpu_torch's (cfg, grid, state0, forcing_fn) of `case`."""
    import torch
    from roms_tpu_torch.models import cases2, upwelling
    from roms_tpu_torch.ops import bc
    builder, sizes, _ = CASES[case]
    if builder == "upwelling":
        cfg = _configure(case, upwelling.make_config(dtype=dtype, **sizes))
        cfg, grid, s, ffn = upwelling.build(cfg, device=device)
        du, dv = (torch.tensor(a, dtype=grid.h.dtype, device=device)
                  for a in perturbation(cfg))
        s = s.replace(u=bc.fill_halo(cfg, du * grid.umask),
                      v=bc.fill_halo(cfg, dv * grid.vmask))
        return cfg, grid, s, ffn
    cfg = _configure(case, getattr(cases2, builder + "_config")(
        dtype=dtype, **sizes))
    return getattr(cases2, builder)(cfg, device=device)


def run_port(case: str, cfg, grid, s, ffn):
    """{name: tensor} after the case's steps: the state's fields, the
    floats' histories ("fl/<field>") and the last budget dict
    ("dia/<key>")."""
    from roms_tpu_torch import floats, stepping, vgrid
    from roms_tpu_torch.grid import hc_of
    from roms_tpu_torch.ops.omega import omega, set_massflux
    out, fl = {}, None
    if case == "flt_test":
        fl = floats.init_floats(*float_seeds(cfg), device=grid.h.device)
    for _ in range(CASES[case][2]):
        if case == "upwelling_dia":
            s, dia = stepping.step(cfg, grid, s, ffn, collect_diags=True)
        else:
            s = stepping.step(cfg, grid, s, ffn)
        if fl is not None:
            _, z_w, Hz = vgrid.set_depth(grid.h, s.zeta, hc_of(cfg),
                                         grid.sc_r, grid.Cs_r, grid.sc_w,
                                         grid.Cs_w, cfg.vtransform)
            Huon, Hvom = set_massflux(cfg, grid, s.u, s.v, Hz)
            W = omega(cfg, grid, Huon, Hvom, z_w)
            fl = floats.step_floats(cfg, grid, s.u, s.v, W, Hz, fl)
    out.update({k: getattr(s, k) for k in fields_of(case)})
    if fl is not None:
        out.update({f"fl/{k}": getattr(fl, k) for k in FLOAT_FIELDS})
    if case == "upwelling_dia":
        out.update({f"dia/{k}": v for k, v in dia.items()})
    return s, out


def build_reference(case: str):
    """roms_tpu's case (imports jax)."""
    import jax.numpy as jnp
    from roms_tpu.models import cases2, upwelling
    from roms_tpu.ops import bc
    builder, sizes, _ = CASES[case]
    if builder == "upwelling":
        cfg = _configure(case, upwelling.make_config(**sizes))
        cfg, grid, s, ffn = upwelling.build(cfg)
        du, dv = (jnp.asarray(a) for a in perturbation(cfg))
        s = s.replace(u=bc.fill_halo(cfg, du * grid.umask),
                      v=bc.fill_halo(cfg, dv * grid.vmask))
        return cfg, grid, s, ffn
    cfg, grid, s, ffn = getattr(cases2, builder)(**sizes)
    return _configure(case, cfg), grid, s, ffn


def run_reference(case: str, cfg, grid, s, ffn):
    """roms_tpu's eager steps of `case` from s, as run_port's."""
    from roms_tpu import floats, stepping, vgrid
    from roms_tpu.grid import hc_of
    from roms_tpu.ops.omega import omega, set_massflux
    out, fl = {}, None
    if case == "flt_test":
        fl = floats.init_floats(*float_seeds(cfg))
    for _ in range(CASES[case][2]):
        if case == "upwelling_dia":
            s, dia = stepping.step(cfg, grid, s, ffn, collect_diags=True)
        else:
            s = stepping.step(cfg, grid, s, ffn)
        if fl is not None:
            _, z_w, Hz = vgrid.set_depth(grid.h, s.zeta, hc_of(cfg),
                                         grid.sc_r, grid.Cs_r, grid.sc_w,
                                         grid.Cs_w, cfg.vtransform)
            Huon, Hvom = set_massflux(cfg, grid, s.u, s.v, Hz)
            W = omega(cfg, grid, Huon, Hvom, z_w)
            fl = floats.step_floats(cfg, grid, s.u, s.v, W, Hz, fl)
    out.update({k: getattr(s, k) for k in fields_of(case)})
    if fl is not None:
        out.update({f"fl/{k}": getattr(fl, k) for k in FLOAT_FIELDS})
    if case == "upwelling_dia":
        out.update({f"dia/{k}": v for k, v in dia.items()})
    return s, out


def _interior(cfg, a):
    H = cfg.halo
    return np.asarray(a)[..., H:H + cfg.Mm, H:H + cfg.Lm]


def _numpy(cfg, name, a):
    """The stored form of output `name`: the floats whole, else the
    interior."""
    a = a.cpu().numpy() if hasattr(a, "cpu") else np.asarray(a)
    return a if name.startswith("fl/") else _interior(cfg, a)


def _scale(name, want, ref_of):
    """The max|.| a field's error is measured against: its own, its
    partner's too for a velocity-like field, and for a budget term the
    largest of its direction's momentum terms or its tracer's terms."""
    scale = np.abs(want).max()
    if name in PARTNER:
        scale = max(scale, np.abs(ref_of(PARTNER[name])).max())
    if name.startswith("dia/"):
        key = name[4:]
        if key[:2] in ("u_", "v_"):
            group = [k for k in ref_of(None) if k.startswith("dia/" +
                                                             key[:2])]
        else:
            group = [k for k in ref_of(None) if k.startswith("dia/") and
                     k[4:6] not in ("u_", "v_")]
        scale = max(np.abs(ref_of(k)).max() for k in group)
    return scale


def _compare(cfg, got: dict, want: dict, bound_of) -> dict:
    """{name: (error / scale, bound)} of every output, the tracers and the
    tracer budget terms one tracer at a time ("<name>[<n>]")."""
    out = {}

    def ref_of(name):
        return list(want) if name is None else want[name]

    for name, w in want.items():
        g = got[name]
        per_tracer = name in ("t", "t_initial") or (
            name.startswith("dia/") and w.ndim == 4)
        if per_tracer:
            for n in range(len(w)):
                if name.startswith("dia/"):
                    scale = max(np.abs(want[k][n]).max() for k in want
                                if k.startswith("dia/") and
                                want[k].ndim == 4)
                else:
                    scale = np.abs(w[n]).max()
                key = f"{name}[{n}]"
                out[key] = (
                    float(np.abs(g[n] - w[n]).max() / max(scale, 1e-300)),
                    bound_of(key))
            continue
        scale = _scale(name, w, ref_of)
        out[name] = (float(np.abs(g - w).max() / max(scale, 1e-300)),
                     bound_of(name))
    return out


def errors(case: str, cfg, s0, outputs: dict, ref,
           factor: float = 1.0) -> dict:
    """{name: (|port - fixture| / scale, bound)} of a roms_tpu_torch run
    of `case` (its initial state s0 and run_port's outputs) against the
    loaded fixture `ref`, every bound times `factor`."""
    got = {k: _numpy(cfg, k, v) for k, v in outputs.items()}
    got["t_initial"] = _interior(cfg, s0.t.cpu().numpy())
    want = {k: ref[f"{case}/{k}"] for k in got}
    return _compare(cfg, got, want,
                    lambda n: factor * BOUND_OF.get((case, n), BOUND))


def _spread(case: str, field: str = "t") -> dict:
    """roms_tpu's change after the steps when every initial value of
    `field` (the tracers or zeta) moves up by one ulp."""
    import jax.numpy as jnp
    cfg, grid, s0, ffn = build_reference(case)
    up = jnp.asarray(np.nextafter(np.asarray(getattr(s0, field)), np.inf))
    moved = s0.replace(t=up, t_prev=up) if field == "t" else \
        s0.replace(zeta=up)
    _, a = run_reference(case, cfg, grid, s0, ffn)
    _, b = run_reference(case, cfg, grid, moved, ffn)
    a = {k: _numpy(cfg, k, v) for k, v in a.items()}
    b = {k: _numpy(cfg, k, v) for k, v in b.items()}
    return {k: e for k, (e, _) in _compare(cfg, b, a,
                                           lambda n: 0.0).items()}


def _wave_spread(case: str) -> dict:
    """roms_tpu's change after the steps when the wave height moves up by
    one ulp everywhere: the size of a one-ulp difference of the
    transcendental functions of the radiation stress and the Stokes drift
    (torch's CPU tanh, cosh and sinh round otherwise than XLA's)."""
    import jax.numpy as jnp
    cfg, grid, s0, ffn = build_reference(case)

    def up(cfg_, grid_, time):
        frc = dict(ffn(cfg_, grid_, time))
        frc["Hwave"] = jnp.asarray(np.nextafter(np.asarray(frc["Hwave"]),
                                                np.inf))
        return frc

    _, a = run_reference(case, cfg, grid, s0, ffn)
    _, b = run_reference(case, cfg, grid, s0, up)
    a = {k: _numpy(cfg, k, v) for k, v in a.items()}
    b = {k: _numpy(cfg, k, v) for k, v in b.items()}
    return {k: e for k, (e, _) in _compare(cfg, b, a,
                                           lambda n: 0.0).items()}


def report() -> None:
    """Print the measurements the bounds of this file rest on."""
    import torch
    ref = np.load(OUT)
    torch.set_num_threads(1)
    cases = [c for c in sys.argv[1:] if c in CASES] or list(CASES)
    for case in cases:
        for key, e in _spread(case).items():
            print(f"{case}: roms_tpu, initial tracers one ulp up: "
                  f"{key:16s} {e:.3e}")
        for key, e in _spread(case, "zeta").items():
            print(f"{case}: roms_tpu, initial zeta one ulp up: "
                  f"{key:16s} {e:.3e}")
        if case.startswith("shoreface"):
            for key, e in _wave_spread(case).items():
                print(f"{case}: roms_tpu, Hwave one ulp up: "
                      f"{key:16s} {e:.3e}")
        cfg, grid, s0, ffn = build_port(case)
        _, outs = run_port(case, cfg, grid, s0, ffn)
        for key, (err, lim) in errors(case, cfg, s0, outs, ref).items():
            print(f"{case}: roms_tpu_torch (CPU) against the fixture: "
                  f"{key:16s} {err:.3e} (bound {lim:g})")


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
        out[f"{case}/t_initial"] = _interior(cfg, s.t)
        s, outs = run_reference(case, cfg, grid, s, ffn)
        for k, v in outs.items():
            out[f"{case}/{k}"] = _numpy(cfg, k, v)
        out[f"{case}/time"] = np.asarray(float(s.time))
        out[f"{case}/iic"] = np.asarray(int(s.iic))
        print(f"{case}: done", flush=True)
    np.savez_compressed(OUT, **out)
    print(f"wrote {OUT} ({os.path.getsize(OUT)} bytes)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
