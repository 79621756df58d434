"""Write tests/data/torch_coastal_small.npz: roms_tpu's results on small
versions of the coastal path, the reference that roms_tpu_torch's
curvilinear grids, wetting-drying, tide-generating force and file grids
are held to (tests/test_torch_coastal.py, tests/test_torch_wetdry.py,
chip_smoke.py):

  * three float64 steps of roms_tpu's eager stepping.step on a small
    LAB_CANYON (polar annulus, north-south periodic), INLET_TEST and
    TEST_HEAD (wetting-drying, open-boundary tide, GLS) on grid files this
    script generates, and BENCHMARK with the tide-generating force;
  * one eager roms_tpu step2d.fast_loop with wetting-drying on the small
    inlet from a state with dry flats ("wetdry/...").

    JAX_PLATFORMS=cpu python scripts/torch_coastal_fixture.py [--report]

Importing this file runs nothing and imports no jax: ``CASES``,
``NSTEPS``, the grid-file makers ``inlet_grid`` and ``head_grid`` and
``errors`` hold a roms_tpu_torch run to the fixture, with the bounds
stated here.  The grid files are written with roms_tpu_torch's
io.gridfile.save_grid and read by each package's own load_grid.
``--report`` writes nothing and prints the measurements the bounds rest
on: roms_tpu's own change after NSTEPS steps when every initial tracer
value moves up by one ulp, and roms_tpu_torch's CPU errors against the
fixture.

Stored for each case, under "<case>/<key>": the interior of the initial
tracers ("t_initial") and, after the last step, of every State field the
case's step writes; "time" and "iic" of the final state.
"""

from __future__ import annotations

import os
import sys
import tempfile

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, "tests", "data", "torch_coastal_small.npz")
NSTEPS = 3
# case -> its sizes: the builder's keywords, and for the file-grid cases
# the grid file's interior size ("grid": (Lm, Mm))
CASES = {
    "lab_canyon": dict(Lm=24, Mm=32, N=4, ndtfast=10),
    "inlet_test": dict(grid=(16, 20), N=4, dt=8.0, ndtfast=16),
    "test_head": dict(grid=(16, 12), N=4, dt=8.0, ndtfast=16),
    "tide": dict(Lm=24, Mm=8, N=4),
}
# the settings of roms_tpu's tests/test_tides_avg.py::
# test_equilibrium_tide_in_step: BENCHMARK with the tide-generating force
TIDE_CHANGE = dict(tide_gen_forces=True, vmix="none", bulk_fluxes=False,
                   ts_dif2=False, tnu2=(0.0, 0.0), uv_vis2=False,
                   visc2=0.0)
FIELDS = ("zeta", "ubar", "vbar", "u", "v", "t", "ru_prev", "rv_prev",
          "rufrc0_prev", "rvfrc0_prev", "rzeta", "rubar", "rvbar",
          "DU_avg1", "DV_avg1", "DU_avg2", "DV_avg2")
GLS = ("Akv", "Akt", "tke", "gls", "Akk", "Akp", "Lscale")
EXTRA = {"lab_canyon": (), "tide": (), "inlet_test": GLS, "test_head": GLS}
# the fast-loop fixture's outputs
FS_FIELDS = ("zeta_n", "zeta_nm1", "ubar_n", "ubar_nm1", "vbar_n",
             "vbar_nm1", "rzeta_n", "rzeta_nm1", "rubar_n", "rubar_nm1",
             "rvbar_n", "rvbar_nm1", "Zt_avg1", "DU_avg1", "DV_avg1",
             "DU_avg2", "DV_avg2")
WET = ("rmask_wet", "umask_wet", "vmask_wet")
WETDRY_IIC = 2
# Pointwise bound on |port - fixture| on the CPU, times max|field|, by
# case and field (BOUND when not listed); every number below is printed by
# --report.  roms_tpu itself, with every initial tracer value moved up by
# one ulp, changes after three steps LAB_CANYON's fields by up to 1.812e-8
# (rzeta; rufrc0_prev 6.3e-9, zeta 4.7e-9, DU_avg1 3.8e-9, DU_avg2 3.3e-9,
# rubar 2.4e-9, ru_prev 2.1e-9, ubar and vbar 1.1e-9, every other field
# but t between 1.8e-10 and 5.5e-10: the stratified rest state of the
# annulus is ill-conditioned), BENCHMARK-with-tides' by up to 3.354e-11
# (rv_prev; u, ubar, DU/DV_avg 8.6e-13 to 1.2e-11), the tracers by at most
# 8.1e-16; INLET_TEST's and TEST_HEAD's uniform tracer leaves their
# dynamics unchanged (0), so their spread says nothing.  LAB_CANYON's
# fields but t are held to 1e-7, BENCHMARK-with-tides' to 1e-9, the rest
# to 1e-11.  roms_tpu_torch on the CPU measures at most 1.129e-13
# (INLET_TEST's tke; TEST_HEAD 1.068e-14, LAB_CANYON 9.12e-16, tides
# 6.902e-16), and 1.062e-15 on the wet/dry fast loop, whose masks are
# exact.
BOUND = 1e-11
BOUND_OF = {("lab_canyon", k): 1e-7 for k in FIELDS if k != "t"}
BOUND_OF.update({("tide", k): 1e-9 for k in FIELDS if k != "t"})
WETDRY_BOUND = 1e-11
# A velocity-like field is measured against the larger of its own and its
# partner's max (a field at round-off would blow its own max up).
PARTNER = {"vbar": "ubar", "v": "u", "rv_prev": "ru_prev",
           "rvfrc0_prev": "rufrc0_prev", "rvbar": "rubar",
           "DV_avg1": "DU_avg1", "DV_avg2": "DU_avg2"}
PARTNER.update({b: a for a, b in PARTNER.items()})


def fields_of(case: str) -> tuple:
    return FIELDS + EXTRA[case]


def _cartesian_grid(path: str, Lm: int, Mm: int, Xsize: float,
                    Esize: float, depth_fn, mask_fn):
    """Write a Cartesian grid of Lm x Mm cells with roms_tpu_torch's
    builder and save_grid."""
    from roms_tpu_torch.config import Config
    from roms_tpu_torch.grid import build_grid
    from roms_tpu_torch.io.gridfile import save_grid
    cfg = Config(name="grid", Lm=Lm, Mm=Mm, N=2, ew_periodic=False,
                 ns_periodic=False)
    grid, cfg = build_grid(cfg, Xsize, Esize, f0=0.0, beta=0.0,
                           depth_fn=depth_fn, mask_fn=mask_fn, device="cpu")
    save_grid(path, cfg, grid)
    return path


def inlet_grid(path: str, Lm: int = 100, Mm: int = 100,
               dx: float = 20.0) -> str:
    """An INLET_TEST-like grid file of Lm x Mm cells dx metres square: an
    ocean over the northern 40% (4 m at the barrier to 10 m at the open
    north edge), a land barrier over 50-60% of the height cut by a 3 m
    deep throat in the middle fifth, a bay to the south shoaling from 3 m
    at the barrier to 0.13 m at the south wall, and beaches along the east
    and west walls whose first cells stand a few millimetres above the
    critical depth (0.1 + 0.6 w + 400 w^2 m at w, the distance from the
    wall over the width): the beaches near the open edge dry within
    minutes of a falling tide."""
    def depth(x, y, i, j, c):
        # the boundary ring's centres lie outside [0, 1]: clip them in
        xs = np.clip(x / (dx * Lm), 0.0, 1.0)
        ys = np.clip(y / (dx * Mm), 0.0, 1.0)
        wall = np.minimum(xs, 1.0 - xs)
        beach = 0.1 + 0.6 * wall + 400.0 * wall ** 2
        ocean = 4.0 + 6.0 * (ys - 0.6) / 0.4
        bay = 0.1 + 6.0 * ys
        return np.minimum(beach, np.where(ys > 0.6, ocean,
                                          np.where(ys >= 0.5, 3.0, bay)))

    def mask(x, y, i, j, c):
        xs, ys = x / (dx * Lm), y / (dx * Mm)
        barrier = (ys >= 0.5) & (ys <= 0.6) & (np.abs(xs - 0.5) > 0.1)
        return np.where(barrier, 0.0, 1.0)

    return _cartesian_grid(path, Lm, Mm, dx * Lm, dx * Mm, depth, mask)


def head_grid(path: str, Lm: int = 100, Mm: int = 60) -> str:
    """A TEST_HEAD-like curvilinear grid file: a coastal strip 100 m a cell
    (scaled with Lm, Mm) whose cells widen northward by up to 30% and lean
    by up to 0.05 rad (pm, pn and angle vary, so dndx and dmde are not
    zero), 8 m deep at the open west edge and the north wall, shoaling to
    a 0.12 m beach along the south wall, with a land headland over the
    middle fifth of the south coast."""
    from roms_tpu_torch.config import Config
    from roms_tpu_torch.grid import _padded_index_grids, \
        build_curvilinear_grid
    from roms_tpu_torch.io.gridfile import save_grid
    cfg = Config(name="grid", Lm=Lm, Mm=Mm, N=2, ew_periodic=False,
                 ns_periodic=False, curvgrid=True)
    i, j = _padded_index_grids(cfg)
    xs, ys = (i - 0.5) / Lm, (j - 0.5) / Mm
    stretch = 1.0 + 0.3 * ys
    pm = 1.0 / (100.0 * stretch)
    pn = 1.0 / (100.0 * (1.0 + 0.1 * np.cos(np.pi * xs)))
    xr = 100.0 * Lm * xs * stretch
    yr = 100.0 * Mm * ys
    h = 0.12 + 7.88 * np.clip(ys / 0.6, 0.0, 1.0) ** 2
    head = (np.abs(xs - 0.5) < 0.1) & (ys < 0.3 - 2.0 * np.abs(xs - 0.5))
    rmask = np.where(head, 0.0, 1.0)
    grid, cfg = build_curvilinear_grid(cfg, xr, yr, pm, pn,
                                       np.zeros_like(xr), h, rmask=rmask,
                                       angler=0.05 * xs, device="cpu")
    save_grid(path, cfg, grid)
    return path


GRID_MAKERS = {"inlet_test": inlet_grid, "test_head": head_grid}


def grid_file(case: str, tmp: str, sizes=None) -> str:
    """Write the grid file of a file-grid case into directory tmp at
    CASES[case]'s size (or `sizes` (Lm, Mm)); returns its path."""
    Lm, Mm = sizes or CASES[case]["grid"]
    return GRID_MAKERS[case](os.path.join(tmp, f"{case}_grd.nc"), Lm, Mm)


def build_port(case: str, tmp: str, device="cpu", dtype="float64"):
    """roms_tpu_torch's (cfg, grid, state0, forcing_fn) of CASES[case];
    the file-grid cases write their grid file into tmp."""
    from roms_tpu_torch.models import benchmark, cases4
    kw = {k: v for k, v in CASES[case].items() if k != "grid"}
    if case == "tide":
        cfg, grid, s0, _ = benchmark.build(
            benchmark.make_config(dtype=dtype, **kw), device=device)
        return cfg.replace(**TIDE_CHANGE), grid, s0, None
    cfg = getattr(cases4, case + "_config")(dtype=dtype, **kw)
    if case == "lab_canyon":
        return cases4.lab_canyon(cfg, device=device)
    return getattr(cases4, case)(cfg, device=device,
                                 grid_path=grid_file(case, tmp))


def build_reference(case: str, tmp: str):
    """roms_tpu's case at CASES[case] (imports jax)."""
    from roms_tpu.models import benchmark, cases4
    kw = {k: v for k, v in CASES[case].items() if k != "grid"}
    if case == "tide":
        cfg, grid, s0, _ = benchmark.build(
            benchmark.make_config(dtype="float64", **kw))
        return cfg.replace(**TIDE_CHANGE), grid, s0, None
    if case == "lab_canyon":
        return cases4.lab_canyon(**kw)
    return getattr(cases4, case)(grid_path=grid_file(case, tmp), **kw)


def wetdry_inputs(cfg, h):
    """The fast-loop fixture's inputs on the padded depth h (numpy): zeta
    0.05 m below rest but no lower than Dcrit - h (the flats and beaches
    then sit dry at the critical depth), small seeded velocities and slow
    forcing; numpy float64 arrays, {name: array}."""
    rng = np.random.default_rng(14)
    shape = h.shape
    out = {"zeta": np.maximum(-0.05, cfg.dcrit - h),
           "ubar": 0.01 * rng.standard_normal(shape),
           "vbar": 0.01 * rng.standard_normal(shape)}
    for k in ("rufrc", "rvfrc", "ru0_nm1", "ru0_nm2", "rv0_nm1", "rv0_nm2"):
        out[k] = 1e-3 * rng.standard_normal(shape)
    return out


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


def wetdry_errors(out, ref, factor: float = 1.0) -> dict:
    """{output: (|port - fixture| / max|fixture|, bound)} of the fast loop
    with wetting-drying: out = (fs, rufrc_c, rvfrc_c, wet) of the port."""
    fs, ruc, rvc, wet = out
    got = {**{k: getattr(fs, k) for k in FS_FIELDS},
           "rufrc_c": ruc, "rvfrc_c": rvc, **wet}
    res = {}
    for k, v in got.items():
        want = ref[f"wetdry/{k}"]
        scale = max(np.abs(want).max(), 1e-300)
        res[k] = (float(np.abs(v.cpu().numpy() - want).max() / scale),
                  factor * WETDRY_BOUND)
    return res


def _run_reference(case, tmp):
    from roms_tpu import stepping
    cfg, grid, s, ffn = build_reference(case, tmp)
    out = {f"{case}/t_initial": _interior(cfg, s.t)}
    for _ in range(NSTEPS):
        s = stepping.step(cfg, grid, s, ffn)
    for name in fields_of(case):
        out[f"{case}/{name}"] = _interior(cfg, getattr(s, name))
    out[f"{case}/time"] = np.asarray(float(s.time))
    out[f"{case}/iic"] = np.asarray(int(s.iic))
    return out


def _wetdry_reference(tmp):
    """One eager roms_tpu fast loop with wetting-drying on the small
    inlet (padded arrays: the loop's outputs, halos included)."""
    import jax.numpy as jnp
    from roms_tpu.ops import step2d
    cfg, grid, _, _ = build_reference("inlet_test", tmp)
    inp = {k: jnp.asarray(v) for k, v in
           wetdry_inputs(cfg, np.asarray(grid.h)).items()}
    z = inp["zeta"]
    fs = step2d.Fast2DState(
        zeta_n=z, zeta_nm1=z, ubar_n=inp["ubar"], ubar_nm1=inp["ubar"],
        vbar_n=inp["vbar"], vbar_nm1=inp["vbar"],
        **{k: jnp.zeros_like(z) for k in FS_FIELDS
           if k not in ("zeta_n", "zeta_nm1", "ubar_n", "ubar_nm1",
                        "vbar_n", "vbar_nm1")})
    fs, ruc, rvc, wet = step2d.fast_loop(
        cfg, grid, fs, rufrc=inp["rufrc"], rvfrc=inp["rvfrc"],
        ru0_nm1=inp["ru0_nm1"], ru0_nm2=inp["ru0_nm2"],
        rv0_nm1=inp["rv0_nm1"], rv0_nm2=inp["rv0_nm2"], iic=WETDRY_IIC)
    out = {f"wetdry/{k}": np.asarray(getattr(fs, k)) for k in FS_FIELDS}
    out["wetdry/rufrc_c"] = np.asarray(ruc)
    out["wetdry/rvfrc_c"] = np.asarray(rvc)
    out.update({f"wetdry/{k}": np.asarray(v) for k, v in wet.items()})
    return out


def report() -> None:
    """Print the measurements the bounds of this file rest on."""
    import jax.numpy as jnp
    import torch
    from roms_tpu import stepping
    from roms_tpu_torch import stepping as tstepping
    from roms_tpu_torch.ops import step2d as tstep2d

    ref = np.load(OUT)
    torch.set_num_threads(1)
    with tempfile.TemporaryDirectory() as tmp:
        for case in CASES:
            cfg, grid, s0, ffn = build_reference(case, tmp)
            up = jnp.asarray(np.nextafter(np.asarray(s0.t), np.inf))
            a, b = s0, s0.replace(t=up, t_prev=up)
            for _ in range(NSTEPS):
                a = stepping.step(cfg, grid, a, ffn)
                b = stepping.step(cfg, grid, b, ffn)
            for name in fields_of(case):
                x = _interior(cfg, getattr(a, name))
                y = _interior(cfg, getattr(b, name))
                scale = np.abs(x).max()
                if name in PARTNER:
                    scale = max(scale, np.abs(_interior(
                        cfg, getattr(a, PARTNER[name]))).max())
                print(f"{case}: roms_tpu, initial tracers one ulp up: "
                      f"{name:12s} "
                      f"{np.abs(x - y).max() / max(scale, 1e-300):.3e}"
                      " x max|field|")
            tcfg, tgrid, t0, tffn = build_port(case, tmp)
            t = tstepping.run(tcfg, tgrid, t0, NSTEPS, tffn)
            for key, (err, lim) in errors(case, tcfg, t0, t, ref).items():
                print(f"{case}: roms_tpu_torch (CPU) against the fixture: "
                      f"{key:12s} {err:.3e} x max|field| (bound {lim:g})")
        tcfg, tgrid, _, _ = build_port("inlet_test", tmp)
        out = port_wetdry_loop(tstep2d, tcfg, tgrid)
        for key, (err, lim) in wetdry_errors(out, ref).items():
            print(f"wetdry fast loop: roms_tpu_torch (CPU) against the "
                  f"fixture: {key:10s} {err:.3e} (bound {lim:g})")


def port_wetdry_loop(tstep2d, cfg, grid):
    """roms_tpu_torch's general fast loop on the fixture's inputs (the
    module tstep2d is roms_tpu_torch.ops.step2d)."""
    import torch
    inp = {k: torch.tensor(v, dtype=grid.h.dtype, device=grid.h.device)
           for k, v in wetdry_inputs(
               cfg, grid.h.cpu().numpy().astype(np.float64)).items()}
    z = inp["zeta"]
    fs = tstep2d.Fast2DState(
        zeta_n=z, zeta_nm1=z.clone(), ubar_n=inp["ubar"],
        ubar_nm1=inp["ubar"].clone(), vbar_n=inp["vbar"],
        vbar_nm1=inp["vbar"].clone(),
        **{k: torch.zeros_like(z) for k in FS_FIELDS
           if k not in ("zeta_n", "zeta_nm1", "ubar_n", "ubar_nm1",
                        "vbar_n", "vbar_nm1")})
    return tstep2d.fast_loop(cfg, grid, fs, inp["rufrc"], inp["rvfrc"],
                             inp["ru0_nm1"], inp["ru0_nm2"], inp["rv0_nm1"],
                             inp["rv0_nm2"], WETDRY_IIC)


def main() -> int:
    sys.path.insert(0, ROOT)
    import jax
    jax.config.update("jax_enable_x64", True)

    if "--report" in sys.argv[1:]:
        report()
        return 0
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        for case in CASES:
            out.update(_run_reference(case, tmp))
        out.update(_wetdry_reference(tmp))
    np.savez_compressed(OUT, **out)
    print(f"wrote {OUT} ({os.path.getsize(OUT)} bytes): {NSTEPS} steps of "
          f"{CASES} and the wet/dry fast loop")
    return 0


if __name__ == "__main__":
    sys.exit(main())
