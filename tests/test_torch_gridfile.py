"""roms_tpu_torch's file-driven domains on the CPU (io/gridfile.py and the
`case: file` run configuration), the analogs of tests/test_gridfile.py and
tests/test_cases_file.py: a grid written with save_grid reads back equal
to the analytic one, roms_tpu's load_grid and the port's read the same
file to the same grid, a file-driven run equals the analytic run, an
initial or history file loads into the State as roms_tpu's load_state
loads it, `case: file` builds what roms_tpu's build_from_dict builds, and
`python -m roms_tpu_torch run` runs a generated file_driven.yaml."""

import dataclasses
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
import yaml
from scipy.io import netcdf_file

from roms_tpu.io import gridfile as jgridfile
from roms_tpu.utils import yamlcfg as jyamlcfg
from roms_tpu_torch import stepping
from roms_tpu_torch.config import Config
from roms_tpu_torch.grid import Grid, build_spherical_grid
from roms_tpu_torch.io import gridfile
from roms_tpu_torch.io.netcdf import HistoryWriter, read_history
from roms_tpu_torch.models import cases4, upwelling
from roms_tpu_torch.ops import bc
from roms_tpu_torch.state import TENSOR_FIELDS, initial_state
from roms_tpu_torch.utils import yamlcfg
from chip_smoke import coastal_fixture_script

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GRID_FIELDS = [f.name for f in dataclasses.fields(Grid) if f.name != "zice"]
TABLES = ("sc_r", "Cs_r", "sc_w", "Cs_w", "weight1", "weight2")
# compared over the interior only: the curvature terms at the boundary
# ring read the analytic formula one cell beyond it, where a file holds the
# ring's value again; and a builder leaves xr, yr and angler unwrapped on a
# periodic axis, where load_grid wraps every field
INTERIOR_ONLY = ("dndx", "dmde", "xr", "yr", "angler")


def _upwelling():
    cfg = upwelling.make_config(Lm=16, Mm=18, N=4, ndtfast=6)
    return upwelling.build(cfg, device="cpu")


def _lab_canyon():
    return cases4.lab_canyon(cases4.lab_canyon_config(Lm=12, Mm=16, N=4,
                                                      ndtfast=10),
                             device="cpu")


CASES = {"upwelling": _upwelling, "lab_canyon": _lab_canyon}
VERT = ("N", "dt", "ndtfast", "ew_periodic", "ns_periodic", "theta_s",
        "theta_b", "tcline", "vtransform", "vstretching", "curvgrid")


@pytest.fixture(scope="module", params=sorted(CASES))
def analytic(request, tmp_path_factory):
    """An analytic case and its grid written with save_grid."""
    cfg, grid, s0, ffn = CASES[request.param]()
    path = str(tmp_path_factory.mktemp("grd") / "grd.nc")
    gridfile.save_grid(path, cfg, grid)
    return request.param, cfg, grid, s0, ffn, path


def test_grid_roundtrip(analytic):
    """The file holds the grid over the boundary ring: read back with the
    vertical settings, every field equals the analytic one over the ring
    (INTERIOR_ONLY's over the interior), the vertical tables and weights
    everywhere."""
    _, cfg, grid, _, _, path = analytic
    grid2, cfg2 = gridfile.load_grid(
        path, device="cpu", **{k: getattr(cfg, k) for k in VERT})
    assert (cfg2.Lm, cfg2.Mm, cfg2.hmin, cfg2.nfast) == \
        (cfg.Lm, cfg.Mm, cfg.hmin, cfg.nfast)
    H = cfg.halo
    ring = (slice(H - 1, H + cfg.Mm + 1), slice(H - 1, H + cfg.Lm + 1))
    inside = (slice(H, H + cfg.Mm), slice(H, H + cfg.Lm))
    for k in GRID_FIELDS:
        a, b = getattr(grid2, k), getattr(grid, k)
        if k not in TABLES:
            sl = inside if k in INTERIOR_ONLY else ring
            a, b = a[sl], b[sl]
        assert torch.equal(a, b), k


def test_load_grid_matches_jax(analytic):
    """roms_tpu's load_grid and the port's read one file to the same
    grid, every field bitwise, and the same finished configuration."""
    _, cfg, _, _, _, path = analytic
    kw = {k: getattr(cfg, k) for k in VERT}
    grid_t, cfg_t = gridfile.load_grid(path, device="cpu", **kw)
    grid_j, cfg_j = jgridfile.load_grid(path, **kw)
    assert (cfg_t.hmin, cfg_t.nfast) == (cfg_j.hmin, cfg_j.nfast)
    for k in GRID_FIELDS:
        np.testing.assert_array_equal(getattr(grid_t, k).numpy(),
                                      np.asarray(getattr(grid_j, k)),
                                      err_msg=k)


def test_file_driven_run_matches_analytic(analytic):
    """Three steps on the grid read from the file equal three on the
    analytic grid within roms_tpu's own bound (1e-10,
    tests/test_gridfile.py); in the port they are bitwise equal."""
    name, cfg, grid, s0, ffn, path = analytic
    grid2, cfg2 = gridfile.load_grid(
        path, cfg=cfg.replace(nfast=0, hmin=0.0), device="cpu")
    a = stepping.run(cfg, grid, s0, 3, ffn)
    b = stepping.run(cfg2, grid2, s0, 3, ffn)
    for k in ("zeta", "u", "v", "t"):
        err = float((getattr(a, k) - getattr(b, k)).abs().max())
        assert err <= 1e-10, (name, k, err)
        assert torch.equal(getattr(a, k), getattr(b, k)), (name, k)


def test_load_state_matches_jax(tmp_path):
    """A history record of a stepped state loads back into the interior
    as written, the time as a host float, and equal to roms_tpu's
    load_state of the same file at every padded point; a restart-style
    N-level AKv fills the N+1-level Akv with its top level repeated."""
    cfg, grid, s0, ffn = _upwelling()
    s1 = stepping.run(cfg, grid, s0, 2, ffn)
    path = str(tmp_path / "his.nc")
    w = HistoryWriter(path, cfg, grid=grid)
    w.write(s1)
    w.close()
    # add an N-level AKv record to the file
    rng = np.random.default_rng(5)
    akv = 1e-4 + 1e-5 * rng.random((1, cfg.N, cfg.Mm, cfg.Lm))
    with netcdf_file(path, "a") as f:
        v = f.createVariable("AKv", "d",
                             ("ocean_time", "s_rho", "eta_rho", "xi_rho"))
        v[:] = akv
    s2 = gridfile.load_state(cfg, path, device="cpu")
    H = cfg.halo
    sl = (Ellipsis, slice(H, H + cfg.Mm), slice(H, H + cfg.Lm))
    for k in ("zeta", "t"):
        assert torch.equal(getattr(s2, k)[sl], getattr(s1, k)[sl]), k
    assert isinstance(s2.time, float) and s2.time == s1.time
    assert torch.equal(s2.Akv[-1], s2.Akv[-2])
    from roms_tpu.models import upwelling as jup
    cfg_j, *_ = jup.build(jup.make_config(Lm=16, Mm=18, N=4, ndtfast=6))
    sj = jgridfile.load_state(cfg_j, path)
    assert float(sj.time) == s2.time
    for k in TENSOR_FIELDS:
        np.testing.assert_array_equal(getattr(s2, k).numpy(),
                                      np.asarray(getattr(sj, k)),
                                      err_msg=k)
    # the loaded state steps
    s3 = stepping.step(cfg, grid, s2, ffn)
    assert torch.isfinite(s3.zeta).all()


def _damee_crop(tmp):
    """tests/test_cases_file.py's cropped spherical domain (damee_4.h
    class) built with the port, its grid, initial and forcing files
    written into tmp; returns (cfg, grid, files, the run's config)."""
    settings = dict(
        name="damee_crop", N=6, ntracers=2, dt=600.0, ndtfast=20,
        vtransform=2, vstretching=4, theta_s=5.0, theta_b=0.4, tcline=200.0,
        uv_adv=True, uv_cor=True, curvgrid=True, spherical=True,
        uv_vis2=True, visc2=1000.0, ts_dif2=True, tnu2=[100.0, 100.0],
        ts_mix_geo=True, splines_vdiff=True, splines_vvisc=True,
        bottom_drag="quadratic", rdrg2=3.0e-3, vmix="gls", eos="jm95",
        rho0=1025.0, t_hadv=["U3", "U3"], t_vadv=["C4", "C4"],
        dtype="float64")
    cfg = Config(Lm=20, Mm=16, ew_periodic=False, ns_periodic=False,
                 **{k: tuple(v) if isinstance(v, list) else v
                    for k, v in settings.items()})

    def depth(lonr, latr, i, j, c):
        return 200.0 + 4300.0 * 0.5 * (1.0 + np.tanh((lonr + 70.0) / 3.0))

    grid, cfg = build_spherical_grid(cfg, lon_size=10.0, lat_min=30.0,
                                     lat_size=8.0, depth_fn=depth,
                                     device="cpu")
    from roms_tpu_torch import vgrid
    from roms_tpu_torch.grid import hc_of
    z_r, _, _ = vgrid.set_depth(grid.h, torch.zeros_like(grid.h),
                                hc_of(cfg), grid.sc_r, grid.Cs_r, grid.sc_w,
                                grid.Cs_w, cfg.vtransform)
    t0 = torch.stack([bc.fill_halo(cfg, 4.0 + 18.0 * torch.exp(z_r / 800.0)),
                      bc.fill_halo(cfg, 35.0 - 0.5 * torch.exp(z_r / 500.0))])
    files = {k: os.path.join(tmp, f"crop_{k}.nc")
             for k in ("grd", "ini", "frc", "his")}
    gridfile.save_grid(files["grd"], cfg, grid)
    w = HistoryWriter(files["ini"], cfg, grid)
    w.write(initial_state(cfg, device="cpu", t=t0))
    w.close()
    H = cfg.halo
    with netcdf_file(files["frc"], "w") as f:
        f.createDimension("sms_time", 2)
        f.createDimension("shf_time", 2)
        f.createDimension("eta_rho", cfg.Mm)
        f.createDimension("xi_rho", cfg.Lm)
        for tname in ("sms_time", "shf_time"):
            f.createVariable(tname, "d", (tname,))[:] = np.array([0.0, 1.0])
        lat = grid.yr[H:H + cfg.Mm, H:H + cfg.Lm].numpy()
        su = f.createVariable("sustr", "d", ("sms_time", "eta_rho",
                                             "xi_rho"))
        su[:] = np.stack([1e-4 * np.cos(np.pi * (lat - 34.0) / 8.0)] * 2)
        f.createVariable("svstr", "d", ("sms_time", "eta_rho",
                                        "xi_rho"))[:] = 0.0
        f.createVariable("shflux", "d", ("shf_time", "eta_rho",
                                         "xi_rho"))[:] = np.stack(
            [np.full((cfg.Mm, cfg.Lm), -50.0),
             np.full((cfg.Mm, cfg.Lm), 20.0)])
    doc = {"case": "file", "grid_file": files["grd"],
           "ini_file": files["ini"], "frc_file": files["frc"],
           "frc_cycle": 2.0 * 86400.0, "nsteps": 3, "config": settings,
           "output": {"his_file": files["his"], "nhis": 3, "ninfo": 1}}
    return cfg, grid, files, doc


def test_file_case_matches_jax(tmp_path):
    """`case: file` builds the grid, initial state and forcing roms_tpu's
    build_from_dict builds from the same files (the forcing, heat flux
    into stflux[0] / (rho0 * 3985), at a time between its records, under
    jax.jit) within 1e-12 x max|field|, and its first step is finite."""
    _, _, _, doc = _damee_crop(str(tmp_path))
    cfg, grid, s0, ffn, opts = yamlcfg.build_from_dict(doc, device="cpu")
    cfg_j, grid_j, s0_j, ffn_j, opts_j = jyamlcfg.build_from_dict(doc)
    assert opts["nsteps"] == opts_j["nsteps"] == 3
    assert (cfg.Lm, cfg.Mm, cfg.hmin, cfg.nfast, cfg.spherical) == \
        (cfg_j.Lm, cfg_j.Mm, cfg_j.hmin, cfg_j.nfast, cfg_j.spherical)
    for k in GRID_FIELDS:
        np.testing.assert_array_equal(getattr(grid, k).numpy(),
                                      np.asarray(getattr(grid_j, k)), k)
    for k in TENSOR_FIELDS:
        np.testing.assert_array_equal(getattr(s0, k).numpy(),
                                      np.asarray(getattr(s0_j, k)), k)
    t = 0.3 * 86400.0
    frc = ffn(cfg, grid, t)
    frc_j = jax.jit(lambda tt: ffn_j(cfg_j, grid_j, tt))(t)
    assert set(frc) == set(frc_j) == {"sustr", "svstr", "stflux"}
    for k in frc:
        want = np.asarray(frc_j[k])
        err = np.abs(frc[k].numpy() - want).max()
        assert err <= 1e-12 * np.abs(want).max(), (k, err)
    s1 = stepping.step(cfg, grid, s0, ffn)
    assert all(bool(torch.isfinite(getattr(s1, k)).all())
               for k in ("zeta", "u", "v", "t"))


def test_cli_runs_a_file_driven_yaml(tmp_path):
    """`python -m roms_tpu_torch run crop.yaml --device cpu` (GRDNAME,
    ININAME and FRCNAME files) exits 0 and writes its history record,
    finite with a wind-driven current."""
    _, _, files, doc = _damee_crop(str(tmp_path))
    ypath = str(tmp_path / "crop.yaml")
    with open(ypath, "w") as f:
        yaml.safe_dump(doc, f)
    res = subprocess.run(
        [sys.executable, "-m", "roms_tpu_torch", "run", ypath, "--device",
         "cpu"], capture_output=True, text=True, cwd=ROOT, timeout=300,
        env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert res.returncode == 0, res.stderr[-2000:]
    assert "case=damee_crop grid=20x16x6" in res.stdout
    h = read_history(files["his"])
    assert h["zeta"].shape[0] == 1 and h["ocean_time"][0] == 3 * 600.0
    assert np.isfinite(h["zeta"]).all() and np.isfinite(h["temp"]).all()
    assert 1e-9 < np.abs(h["u"]).max() < 5.0


def test_file_grid_cases_need_their_file(tmp_path):
    """INLET_TEST and TEST_HEAD without their grid file raise
    FileNotFoundError naming it; they run no stand-in grid."""
    for build in (cases4.inlet_test, cases4.test_head):
        missing = str(tmp_path / "no_such_grid.nc")
        with pytest.raises(FileNotFoundError, match="no_such_grid.nc"):
            build(device="cpu", grid_path=missing)
        default = build.__defaults__[-1]
        assert default.startswith(cases4.REF_GRID_DIR)
        if not os.path.isfile(default):
            with pytest.raises(FileNotFoundError, match=default):
                build(device="cpu")


def test_file_grid_case_through_build_from_dict(tmp_path):
    """A registered file-grid case takes its grid from `grid_file`."""
    fx = coastal_fixture_script()
    path = fx.inlet_grid(str(tmp_path / "inlet.nc"), 12, 14)
    cfg, grid, s0, ffn, _ = yamlcfg.build_from_dict(
        {"case": "inlet_test", "grid_file": path, "config": {"N": 4}},
        device="cpu")
    assert (cfg.Lm, cfg.Mm, cfg.N, cfg.wetdry) == (12, 14, 4, True)
    assert "zeta_north" in ffn(cfg, grid, 600.0)["bry"]
