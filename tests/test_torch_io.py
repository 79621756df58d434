"""roms_tpu_torch I/O and utilities against roms_tpu: the NetCDF writers
(history, averages, quick-save, file ring, diagnostics, floats, stations)
fed the same numpy arrays write the same variables bitwise, the same
checksums and the same attributes but `history`; the varinfo registry,
dateclock, the forcing series, the field utilities, the diagnostics and
the grid stiffness match; restart files round-trip bitwise."""

import dataclasses
import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.io import netcdf_file

from roms_tpu import forcing as jforcing
from roms_tpu.grid import build_grid as jbuild_grid
from roms_tpu.io import netcdf as jnc, stations as jsta, \
    varinfo as jvarinfo
from roms_tpu.models import upwelling as jup
from roms_tpu.utils import dateclock as jdc, diag as jdiag, \
    fields as jfields
from roms_tpu_torch import convert, forcing as tforcing
from roms_tpu_torch.driver import Simulation
from roms_tpu_torch.io import checkpoint, netcdf as tnc, \
    stations as tsta, varinfo as tvarinfo
from roms_tpu_torch.models import upwelling as tup
from roms_tpu_torch.state import TENSOR_FIELDS, initial_state
from roms_tpu_torch.utils import dateclock as tdc, diag as tdiag, \
    fields as tfields, timers

torch.set_num_threads(1)

RTOL = 1e-12


def _pair(ntracers=2):
    """A small UPWELLING configuration and grid in both packages, each
    built by its own package (roms_tpu builds only its grid)."""
    cfg = jup.make_config(Lm=12, Mm=10, N=4, ndtfast=6)
    if ntracers != 2:
        cfg = dataclasses.replace(cfg, ntracers=ntracers)
    grid_j, cfg_j = jbuild_grid(cfg, 1000.0 * cfg.Lm, 1000.0 * cfg.Mm,
                                f0=-8.26e-5, beta=0.0,
                                depth_fn=jup._depth_fn)
    cfg_t, grid_t, _, _ = tup.build(convert.config_from_reference(cfg),
                                    device="cpu")
    assert convert.config_from_reference(cfg_j) == cfg_t
    return cfg_j, grid_j, cfg_t, grid_t


@pytest.fixture(scope="module")
def pair():
    return _pair()


def _random_state(cfg_t, seed, time=600.0, iic=2):
    """{field: array} of a State, every field drawn from a seed."""
    rng = np.random.default_rng(seed)
    out = {k: rng.standard_normal(v.shape) for k, v in
           convert.state_to_numpy(initial_state(cfg_t, device="cpu")).items()
           if k not in ("time", "iic")}
    out["t"][0] += 14.0
    out["t"][1] += 35.0
    out["time"] = np.asarray(time)
    out["iic"] = np.asarray(iic)
    return out


def _grid_ns(grid_t):
    """The port's grid as numpy arrays, for roms_tpu's writer."""
    return types.SimpleNamespace(**{
        k: v.numpy() for k, v in vars(grid_t).items() if v is not None})


def _same_files(path_j, path_t):
    """Every variable bitwise equal with equal attributes, and the global
    attributes equal but for `history`."""
    fj = netcdf_file(path_j, "r", mmap=False)
    ft = netcdf_file(path_t, "r", mmap=False)
    try:
        assert sorted(fj.variables) == sorted(ft.variables)
        for k, vj in fj.variables.items():
            vt = ft.variables[k]
            assert vj.dimensions == vt.dimensions, k
            assert vj.data.dtype == vt.data.dtype, k
            assert vj.data.tobytes() == vt.data.tobytes(), k
            assert vj._attributes == vt._attributes, k
        attrs_j = dict(fj._attributes)
        attrs_t = dict(ft._attributes)
        attrs_j.pop("history", None)
        attrs_t.pop("history", None)
        assert attrs_j == attrs_t
        assert fj.dimensions == ft.dimensions
    finally:
        fj.close()
        ft.close()


@pytest.mark.parametrize("stream", ["his", "avg", "qck", "his3"])
def test_history_writer_matches_reference(tmp_path, stream):
    cfg_j, grid_j, cfg_t, grid_t = _pair(3) if stream == "his3" else \
        _pair()
    fields = {"avg": Simulation.AVG_OUT, "qck": Simulation.QCK_FIELDS}
    kw = {"fields": fields[stream]} if stream in fields else {}
    pj, pt = str(tmp_path / "j.nc"), str(tmp_path / "t.nc")
    wj = jnc.HistoryWriter(pj, cfg_j, _grid_ns(grid_t), **kw)
    wt = tnc.HistoryWriter(pt, cfg_t, grid_t, **kw)
    for rec in range(2):
        arrays = _random_state(cfg_t, rec, time=300.0 * (rec + 1))
        wkw = {}
        if stream == "avg":
            # the derived averages, shaped by their registered grid
            rng = np.random.default_rng(10 + rec)
            shape = {"r2": arrays["zeta"].shape, "u2": arrays["zeta"].shape,
                     "v2": arrays["zeta"].shape, "r3": arrays["u"].shape,
                     "w3": arrays["Akv"].shape}
            extra = {k: rng.standard_normal(
                shape[jvarinfo.REGISTRY[k].grid]) for k in
                Simulation.AVG_OUT if k not in tnc.HistoryWriter.ATTR_OF
                and k not in ("temp", "salt") and k not in arrays}
            assert len(extra) == 9
            wkw = {"time": 150.0 * rec, "extra": extra}
        wj.write(types.SimpleNamespace(**arrays), **wkw)
        wt.write(arrays, **wkw)
    wj.close()
    wt.close()
    assert wj.checksums == wt.checksums and len(wt.checksums) == 2
    _same_files(pj, pt)


def test_file_ring_matches_reference(tmp_path, pair):
    cfg_j, _, cfg_t, grid_t = pair
    rj = jnc.FileRing(jnc.HistoryWriter, str(tmp_path / "j.nc"), 2, cfg_j,
                      _grid_ns(grid_t))
    rt = tnc.FileRing(tnc.HistoryWriter, str(tmp_path / "t.nc"), 2, cfg_t,
                      grid_t)
    for rec in range(5):
        arrays = _random_state(cfg_t, rec, time=300.0 * rec)
        rj.write(types.SimpleNamespace(**arrays))
        rt.write(arrays)
    rj.close()
    rt.close()
    assert len(rt.paths) == 3
    for pj, pt in zip(rj.paths, rt.paths):
        _same_files(pj, pt)


def test_diag_writer_matches_reference(tmp_path, pair):
    cfg_j, _, cfg_t, _ = pair
    rng = np.random.default_rng(3)
    shp = (cfg_t.N, cfg_t.ny_tot, cfg_t.nx_tot)
    pj, pt = str(tmp_path / "j.nc"), str(tmp_path / "t.nc")
    wj, wt = jnc.DiagWriter(pj, cfg_j), tnc.DiagWriter(pt, cfg_t)
    for rec in range(2):
        dia = {"xadv": rng.standard_normal((2,) + shp),
               "rate": rng.standard_normal((2,) + shp),
               "u_prsgrd": rng.standard_normal(shp),
               "v_cor": rng.standard_normal(shp)}
        for w in (wj, wt):
            w.write(dia, time=300.0 * rec, scale=0.25)
    wj.close()
    wt.close()
    _same_files(pj, pt)


def test_floats_writer_matches_reference(tmp_path, pair):
    cfg_j, _, cfg_t, _ = pair
    rng = np.random.default_rng(4)
    pj, pt = str(tmp_path / "j.nc"), str(tmp_path / "t.nc")
    wj = jnc.FloatsWriter(pj, cfg_j, nfloats=3)
    wt = tnc.FloatsWriter(pt, cfg_t, nfloats=3)
    for rec in range(2):
        fl = types.SimpleNamespace(xg=rng.standard_normal((4, 3)),
                                   yg=rng.standard_normal((4, 3)),
                                   zg=rng.standard_normal((4, 3)))
        wj.write(fl, 300.0 * rec)
        wt.write(fl, 300.0 * rec)
    wj.close()
    wt.close()
    _same_files(pj, pt)


def test_station_writer_matches_reference(tmp_path, pair):
    cfg_j, _, cfg_t, _ = pair
    stations = [(1, 1), (5, 7), (12, 10)]
    fields = ("zeta", "ubar", "vbar", "u", "v", "temp", "salt", "AKv",
              "hsbl")
    pj, pt = str(tmp_path / "j.nc"), str(tmp_path / "t.nc")
    wj = jsta.StationWriter(pj, cfg_j, stations, fields=fields)
    wt = tsta.StationWriter(pt, cfg_t, stations, fields=fields)
    for rec in range(2):
        arrays = _random_state(cfg_t, 20 + rec, time=300.0 * rec)
        wj.write(types.SimpleNamespace(**arrays))
        wt.write(arrays)
    wj.close()
    wt.close()
    _same_files(pj, pt)
    got = tsta.read_stations(pt)
    assert got["temp"].shape == (2, cfg_t.N, 3)
    with pytest.raises(ValueError):
        tsta.StationWriter(str(tmp_path / "x.nc"), cfg_t, [(0, 1)])


def test_registry_matches_reference(pair):
    cfg_j, _, cfg_t, _ = pair
    for cfg in (cfg_j, dataclasses.replace(cfg_j, ntracers=4)):
        assert jvarinfo.tracer_names(cfg) == tvarinfo.tracer_names(
            convert.config_from_reference(cfg))
    assert sorted(jvarinfo.REGISTRY) == sorted(tvarinfo.REGISTRY)
    for k, info in jvarinfo.REGISTRY.items():
        assert dataclasses.asdict(info) == \
            dataclasses.asdict(tvarinfo.REGISTRY[k]), k
    assert jvarinfo.DIA_TERMS == tvarinfo.DIA_TERMS


@pytest.mark.parametrize("calendar", ["standard", "360_day"])
def test_dateclock_matches_reference(calendar):
    rng = np.random.default_rng(5)
    for y, m, d, h in [(2001, 1, 1, 0), (1968, 5, 23, 12), (2020, 2, 29, 6),
                       (3, 2, 16, 23), (-4713, 11, 24, 0)]:
        dn = tdc.datenum(y, m, d, hour=h, calendar=calendar)
        assert abs(dn - jdc.datenum(y, m, d, hour=h, calendar=calendar)) \
            <= RTOL * max(abs(dn), 1.0)
    for tday in 2.45e6 * rng.random(8):
        for fn in ("caldate", "yearday", "time_string"):
            a = getattr(tdc, fn)(tday, calendar=calendar)
            b = getattr(jdc, fn)(tday, calendar=calendar)
            if fn == "yearday":
                assert abs(a - b) <= RTOL * abs(b)
            elif fn == "caldate":
                assert dataclasses.asdict(a) == dataclasses.asdict(b)
            else:
                assert a == b, fn
        assert tdc.time_units(tday, calendar=calendar) == \
            jdc.time_units(tday, calendar=calendar)
    for ds in (20010115.5, 19680523.25):
        assert tdc.dstart_to_datenum(ds, calendar=calendar) == \
            jdc.dstart_to_datenum(ds, calendar=calendar)
    for year in (1900, 2000, 2023, 2024):
        assert tdc.is_leap(year, calendar) == jdc.is_leap(year, calendar)


@pytest.mark.parametrize("cycle", [None, 50.0])
def test_series_interp_matches_reference(cycle):
    rng = np.random.default_rng(6)
    times = np.array([10.0, 20.0, 40.0])
    data = rng.standard_normal((3, 4, 5))
    fj = jforcing.make_series(jnp.asarray(times), jnp.asarray(data),
                              cycle=cycle)
    ft = tforcing.make_series(times, data, cycle=cycle, device="cpu")
    assert ft.data.dtype == torch.float64
    # under jit: one compile, where the eager form compiles every operation
    interp = jax.jit(lambda t: jforcing.series_interp(fj, t))
    for t in (0.0, 10.0, 15.0, 20.0, 33.3, 40.0, 45.0, 55.0, 65.0, 99.0,
              137.5):
        want = np.asarray(interp(t))
        got = ft.at(t).numpy()
        scale = np.abs(want).max()
        assert np.abs(got - want).max() <= RTOL * scale, t
    ffn = tforcing.make_forcing_fn({"sustr": ft},
                                   statics={"btflux": torch.zeros(2)})
    frc = ffn(None, None, 15.0)
    assert torch.equal(frc["sustr"], ft.at(15.0)) and "btflux" in frc
    with pytest.raises(ValueError):
        tforcing.make_series(times, data[:2], device="cpu")


def test_series_from_netcdf_matches_reference(tmp_path, pair):
    cfg_j, _, cfg_t, _ = pair
    rng = np.random.default_rng(7)
    path = str(tmp_path / "frc.nc")
    with netcdf_file(path, "w") as f:
        f.createDimension("sms_time", 3)
        f.createDimension("eta_rho", cfg_t.Mm + 2)
        f.createDimension("xi_rho", cfg_t.Lm + 2)
        f.createDimension("eta", cfg_t.Mm)
        f.createDimension("xi", cfg_t.Lm)
        f.createVariable("sms_time", "d", ("sms_time",))[:] = [0., 1., 3.]
        f.createVariable("sustr", "d", ("sms_time", "eta_rho", "xi_rho"))[
            :] = rng.standard_normal((3, cfg_t.Mm + 2, cfg_t.Lm + 2))
        f.createVariable("svstr", "d", ("sms_time", "eta", "xi"))[
            :] = rng.standard_normal((3, cfg_t.Mm, cfg_t.Lm))
    for var in ("sustr", "svstr"):
        fj = jforcing.series_from_netcdf(path, var, "sms_time", cfg=cfg_j)
        ft = tforcing.series_from_netcdf(path, var, "sms_time", cfg=cfg_t,
                                         device="cpu")
        assert np.array_equal(np.asarray(fj.times), ft.times.numpy())
        assert np.array_equal(np.asarray(fj.data), ft.data.numpy())


def _fields_state(cfg_t, seed=8):
    arrays = _random_state(cfg_t, seed)
    arrays["zeta"] *= 0.3
    for k in ("ubar", "vbar", "u", "v"):
        arrays[k] *= 0.2
    return arrays


def test_fields_match_reference(pair):
    cfg_j, grid_j, cfg_t, grid_t = pair
    a = _fields_state(cfg_t)
    tj = {k: jnp.asarray(v) for k, v in a.items()}
    tt = {k: torch.as_tensor(v) for k, v in a.items()}
    z_r = np.asarray(jnp.cumsum(jnp.ones_like(tj["u"]), 0)) - 10.0
    pden = a["t"][0]

    def close(got, want):
        for g, w in zip(got, want):
            w = np.asarray(w)
            assert np.abs(g.numpy() - w).max() <= \
                RTOL * np.abs(w).max()

    # roms_tpu's functions under jit: one compile each, where the eager
    # form compiles every operation
    jit = lambda fn: jax.jit(functools.partial(fn, cfg_j, grid_j))
    close(tfields.vorticity_bar(cfg_t, grid_t, tt["zeta"], tt["ubar"],
                                tt["vbar"]),
          jit(jfields.vorticity_bar)(tj["zeta"], tj["ubar"], tj["vbar"]))
    close(tfields.vorticity3d(cfg_t, grid_t, tt["u"], tt["v"],
                              torch.as_tensor(pden), torch.as_tensor(z_r)),
          jit(jfields.vorticity3d)(tj["u"], tj["v"], jnp.asarray(pden),
                                   jnp.asarray(z_r)))
    close([tfields.shapiro2d(tt["zeta"]),
           tfields.shapiro2d(tt["zeta"], grid_t.rmask)],
          jax.jit(lambda z: (jfields.shapiro2d(z),
                             jfields.shapiro2d(z, grid_j.rmask)))(
                                 tj["zeta"]))
    rng = np.random.default_rng(9)
    gi = rng.uniform(0.0, cfg_t.nx_tot, 6)
    gj = rng.uniform(0.0, cfg_t.ny_tot, 6)
    close([tfields.linterp2d(tt["u"], torch.as_tensor(gi),
                             torch.as_tensor(gj))],
          [jax.jit(jfields.linterp2d)(tj["u"], jnp.asarray(gi),
                                      jnp.asarray(gj))])


def test_diagnostics_and_stiffness_match_reference(pair):
    cfg_j, grid_j, cfg_t, grid_t = pair
    a = _fields_state(cfg_t)
    st = convert.state_from_numpy(cfg_t, a, device="cpu")
    dj = jax.jit(lambda z, u, v, t: jdiag.diagnostics(
        cfg_j, grid_j, types.SimpleNamespace(zeta=z, u=u, v=v, t=t)))(
            a["zeta"], a["u"], a["v"], a["t"])
    dt = tdiag.diagnostics(cfg_t, grid_t, st)
    assert sorted(dj) == sorted(dt)
    for k, v in dj.items():
        assert dt[k].ndim == 0, k
        if k == "finite":
            assert bool(dt[k]) == bool(v)
        else:
            assert abs(float(dt[k]) - float(v)) <= RTOL * abs(float(v)), k
    assert not bool(tdiag.blowup(cfg_t, dt))
    st.u[1, 3, 3] = float("nan")
    assert bool(tdiag.blowup(cfg_t, tdiag.diagnostics(cfg_t, grid_t, st)))
    for got, want in zip(tdiag.stiffness(cfg_t, grid_t),
                         jax.jit(jdiag.stiffness, static_argnums=0)(
                             cfg_j, grid_j)):
        assert abs(float(got) - float(want)) <= RTOL * abs(float(want))


def test_checkpoint_round_trip_bitwise(tmp_path, pair):
    _, _, cfg_t, _ = pair
    s = convert.state_from_numpy(cfg_t, _random_state(cfg_t, 30, 900.0, 3),
                                 device="cpu")
    path = str(tmp_path / "rst.pt")
    checkpoint.save(path, s)
    template = initial_state(cfg_t, device="cpu")
    r = checkpoint.restore(path, template)
    assert (r.time, r.iic) == (900.0, 3)
    for k in TENSOR_FIELDS:
        a, b = getattr(s, k), getattr(r, k)
        assert a.dtype == b.dtype and a.shape == b.shape, k
        assert a.numpy().tobytes() == b.numpy().tobytes(), k
    cfg1 = tup.make_config(Lm=8, Mm=10, N=4, ndtfast=6)
    with pytest.raises(ValueError):
        checkpoint.restore(path, initial_state(cfg1, device="cpu"))


def test_profiler_regions():
    prof = timers.Profiler()
    for _ in range(2):
        with prof.region("output: history", sync=True):
            torch.ones(4).sum()
    assert prof.calls["output: history"] == 2
    assert prof.acc["output: history"] > 0.0
    assert "output: history" in prof.report()
