"""roms_tpu_torch's run driver on a small UPWELLING, on the CPU: analogs of
tests/test_io.py and tests/test_output_streams.py (the DIA stream is not
ported and raises).  A history record equals stepping.run's state bitwise,
a restart continues bitwise, the averages sample every step, and their
derived fields match roms_tpu's driver (its step is not run: the
reference's derived functions and writer are fed the port's states)."""

import types

import jax
import numpy as np
import pytest
import torch

from roms_tpu.driver import Simulation as JSimulation
from roms_tpu.grid import build_grid as jbuild_grid
from roms_tpu.io import netcdf as jnc
from roms_tpu.models import upwelling as jup
from roms_tpu_torch import convert, stepping
from roms_tpu_torch.driver import BlowupError, Simulation, restart
from roms_tpu_torch.io.netcdf import read_history
from roms_tpu_torch.models import upwelling
from roms_tpu_torch.state import TENSOR_FIELDS, initial_state

torch.set_num_threads(1)

QUIET = dict(ninfo=0, log=lambda *a: None)


@pytest.fixture(scope="module")
def small():
    cfg = upwelling.make_config(Lm=12, Mm=14, N=4, ndtfast=6)
    return upwelling.build(cfg, device="cpu")


@pytest.fixture(scope="module")
def straight(small):
    """The states of 8 steps of stepping.run from the initial state."""
    cfg, grid, s, ffn = small
    out = [s]
    for _ in range(8):
        out.append(stepping.step(cfg, grid, out[-1], ffn))
    return out


def interior(cfg, a):
    H = cfg.halo
    return a[..., H:H + cfg.Mm, H:H + cfg.Lm].numpy()


def bitwise(a, b) -> bool:
    """Equal bit for bit as float64 (NetCDF reads back big-endian)."""
    return np.asarray(a, "<f8").tobytes() == np.asarray(b, "<f8").tobytes()


def test_history_writer_roundtrip(tmp_path, small):
    cfg, grid, s0, ffn = small
    path = str(tmp_path / "his.nc")
    sim = Simulation(cfg, grid, s0, ffn, his_file=path, nhis=2, **QUIET)
    sim.run(6)
    sim.finalize()
    data = read_history(path)
    assert data["zeta"].shape == (3, cfg.Mm, cfg.Lm)
    assert data["temp"].shape == (3, cfg.N, cfg.Mm, cfg.Lm)
    assert np.isfinite(data["temp"]).all()
    np.testing.assert_allclose(data["ocean_time"],
                               [2 * cfg.dt, 4 * cfg.dt, 6 * cfg.dt])
    assert data["h"].shape == (cfg.Mm, cfg.Lm)
    assert len(sim.writer.checksums) == 3


def test_history_record_equals_stepping_run(tmp_path, small, straight):
    """Every HIS record is stepping.run's state, bitwise, and the caller's
    state is left as it was."""
    cfg, grid, s0, ffn = small
    before = {k: getattr(s0, k).clone() for k in TENSOR_FIELDS}
    path = str(tmp_path / "his.nc")
    sim = Simulation(cfg, grid, s0, ffn, his_file=path, nhis=4, **QUIET)
    sim.run(8)
    sim.finalize()
    data = read_history(path)
    for rec, n in enumerate((4, 8)):
        s = straight[n]
        want = {"zeta": s.zeta, "ubar": s.ubar, "vbar": s.vbar, "u": s.u,
                "v": s.v, "temp": s.t[0], "salt": s.t[1]}
        for k, a in want.items():
            assert bitwise(data[k][rec], interior(cfg, a)), k
    for k in TENSOR_FIELDS:
        assert torch.equal(getattr(s0, k), before[k]), k
        assert torch.equal(getattr(sim.state, k), getattr(straight[8], k)), k


def test_restart_continues_bitwise(tmp_path, small, straight):
    cfg, grid, s0, ffn = small
    base = str(tmp_path / "rst")
    sim = Simulation(cfg, grid, s0, ffn, rst_file=base, nrst=3, **QUIET)
    sim.run(6)
    sim.finalize()
    assert sim.rst_paths == [f"{base}_0000003.pt", f"{base}_0000006.pt"]
    s3 = restart(cfg, sim.rst_paths[0], s0)
    assert (s3.iic, s3.time) == (3, 3 * cfg.dt)
    s5 = stepping.run(cfg, grid, s3, 5, ffn)
    for k in TENSOR_FIELDS:
        assert torch.equal(getattr(s3, k), getattr(straight[3], k)), k
        assert torch.equal(getattr(s5, k), getattr(straight[8], k)), k
    assert (s5.iic, s5.time) == (straight[8].iic, straight[8].time)


def test_driver_blowup_detection(tmp_path, small):
    cfg, grid, s0, ffn = small
    u = s0.u.clone()
    u[2, 8, 8] = float("nan")
    lines = []
    sim = Simulation(cfg, grid, s0.replace(u=u), ffn, ninfo=1,
                     log=lines.append, rst_file=str(tmp_path / "rst"),
                     nrst=100)
    with pytest.raises(BlowupError):
        sim.run(3)
    assert len(lines) == 1 and "KE=" in lines[0]
    assert sim.rst_paths == [str(tmp_path / "rst_0000001.pt")]


def test_avg_equals_hand_mean(small, straight, tmp_path):
    cfg, grid, s0, ffn = small
    path = str(tmp_path / "avg.nc")
    sim = Simulation(cfg, grid, s0, ffn, avg_file=path, navg=3, **QUIET)
    sim.run(6)
    sim.finalize()
    a = read_history(path)
    np.testing.assert_allclose(a["ocean_time"],
                               [1.5 * cfg.dt, 4.5 * cfg.dt])
    for rec, first in enumerate((1, 4)):
        zs = [straight[n].zeta.numpy() for n in range(first, first + 3)]
        want = interior(cfg, torch.as_tensor(np.mean(zs, axis=0)))
        np.testing.assert_allclose(a["zeta"][rec], want, atol=1e-13)


DERIVED = ("zeta2", "ubar2", "vbar2", "uu", "vv", "uv", "Huon", "Hvom",
           "rho")


@pytest.fixture(scope="module")
def ref(small):
    """roms_tpu's configuration and grid of `small`, built by roms_tpu as
    its upwelling.build does, and its derived averages, each under
    jax.jit, as functions of a State's numpy arrays."""
    cfg_t = small[0]
    grid_j, cfg_j = jbuild_grid(
        jup.make_config(Lm=12, Mm=14, N=4, ndtfast=6), 12000.0, 14000.0,
        f0=-8.26e-5, beta=0.0, depth_fn=jup._depth_fn)
    assert convert.config_from_reference(cfg_j) == cfg_t
    keys = ("zeta", "ubar", "vbar", "u", "v", "t")

    def jitted(fn):
        f = jax.jit(lambda a: fn(cfg_j, grid_j, types.SimpleNamespace(**a)))
        return lambda arrays: np.asarray(f({k: arrays[k] for k in keys}))

    drv = JSimulation._avg_derived()
    assert sorted(drv) == sorted(DERIVED)
    return cfg_j, {k: jitted(fn) for k, fn in drv.items()}


def _random_state(cfg, seed):
    """A State of `cfg` on the CPU, every field drawn from a seed: zeta and
    the velocities of the size a run reaches, the tracers about upwelling's
    14 degC and 35."""
    rng = np.random.default_rng(seed)
    out = {k: rng.standard_normal(v.shape) for k, v in
           convert.state_to_numpy(initial_state(cfg, device="cpu")).items()
           if k not in ("time", "iic")}
    out["zeta"] *= 0.3
    for k in ("ubar", "vbar", "u", "v"):
        out[k] *= 0.2
    out["t"][0] += 14.0
    out["t"][1] += 35.0
    out["time"], out["iic"] = np.asarray(600.0), np.asarray(2)
    return convert.state_from_numpy(cfg, out, device="cpu")


@pytest.mark.parametrize("name", DERIVED)
def test_avg_derived_matches_reference(small, ref, name):
    """Each derived average of one State equals roms_tpu's
    Simulation._avg_derived entry at 1e-12 x max|field|."""
    cfg, grid, _, _ = small
    s = _random_state(cfg, 5)
    got = Simulation._avg_derived()[name](cfg, grid, s).numpy()
    want = ref[1][name](convert.state_to_numpy(s))
    assert got.shape == want.shape
    assert np.abs(want).max() > 0
    assert np.abs(got - want).max() <= 1e-12 * np.abs(want).max()


def test_avg_quadratic_fields_match_reference(small, straight, ref,
                                              tmp_path):
    """An AVG record of three steps against the record roms_tpu's driver
    makes of the same three states: its derived functions and its
    writer.  The State's means are bitwise; the derived ones within
    1e-12 x max|field|."""
    cfg, grid, s0, ffn = small
    cfg_j, jderived = ref
    path, path_j = str(tmp_path / "avg.nc"), str(tmp_path / "avg_j.nc")
    sim = Simulation(cfg, grid, s0, ffn, avg_file=path, navg=3, **QUIET)
    sim.run(3)
    sim.finalize()
    acc = {}
    for n in (1, 2, 3):
        arrays = convert.state_to_numpy(straight[n])
        vals = {**{k: arrays[k] for k in Simulation.AVG_FIELDS},
                **{k: fn(arrays) for k, fn in jderived.items()}}
        for k, v in vals.items():
            acc[k] = acc.get(k, np.zeros_like(v)) + v
    mean = {k: a / 3 for k, a in acc.items()}
    grid_ns = types.SimpleNamespace(**{
        k: v.numpy() for k, v in vars(grid).items() if v is not None})
    w = jnc.HistoryWriter(path_j, cfg_j, grid_ns, fields=JSimulation.AVG_OUT)
    w.write(types.SimpleNamespace(
        **{**convert.state_to_numpy(straight[3]),
           **{k: mean[k] for k in Simulation.AVG_FIELDS}}),
        time=straight[3].time - 1.5 * cfg.dt,
        extra={k: mean[k] for k in DERIVED})
    w.close()
    got, want = read_history(path), read_history(path_j)
    assert Simulation.AVG_OUT == JSimulation.AVG_OUT
    assert np.array_equal(got["ocean_time"], want["ocean_time"])
    for k in Simulation.AVG_OUT:
        assert got[k].shape == want[k].shape == (1,) + want[k].shape[1:], k
        if k in DERIVED:
            scale = np.abs(want[k]).max()
            assert scale > 0, k
            assert np.abs(got[k] - want[k]).max() <= 1e-12 * scale, k
        else:
            assert bitwise(got[k], want[k]), k


def test_run_accum_sums_every_step(small, straight):
    cfg, grid, s0, ffn = small
    drv = Simulation._avg_derived()
    s, sums = stepping.run_accum(cfg, grid, s0, 3, ffn, fields=("zeta",),
                                 derived={"zeta2": drv["zeta2"]})
    z = [straight[n].zeta for n in (1, 2, 3)]
    want = torch.zeros_like(z[0]) + z[0] + z[1] + z[2]
    assert torch.equal(sums["zeta"], want)
    assert torch.equal(sums["zeta2"], torch.zeros_like(z[0]) + z[0] * z[0]
                       + z[1] * z[1] + z[2] * z[2])
    assert torch.equal(s.t, straight[3].t)


def test_qck_stream(small, tmp_path):
    cfg, grid, s0, ffn = small
    path = str(tmp_path / "qck.nc")
    sim = Simulation(cfg, grid, s0, ffn, qck_file=path, nqck=2, **QUIET)
    sim.run(4)
    sim.finalize()
    q = read_history(path)
    assert q["temp_sur"].shape == (2, cfg.Mm, cfg.Lm)
    s = sim.state
    assert bitwise(q["temp_sur"][-1], interior(cfg, s.t[0, -1]))
    assert bitwise(q["u_sur"][-1], interior(cfg, s.u[-1]))


def test_his_file_ring(small, tmp_path):
    cfg, grid, s0, ffn = small
    base = str(tmp_path / "his.nc")
    sim = Simulation(cfg, grid, s0, ffn, his_file=base, nhis=1,
                     ndef_his=2, **QUIET)
    sim.run(5)
    sim.finalize()
    paths = sim.writer.paths
    assert len(paths) == 3
    assert read_history(paths[0])["zeta"].shape[0] == 2
    assert read_history(paths[2])["zeta"].shape[0] == 1


def test_dia_stream_is_not_ported(small, tmp_path):
    cfg, grid, s0, ffn = small
    with pytest.raises(NotImplementedError, match="collect_diags"):
        Simulation(cfg, grid, s0, ffn, dia_file=str(tmp_path / "dia.nc"),
                   ndia=2, **QUIET)
    assert not (tmp_path / "dia.nc").exists()


def test_steppers_refuse_an_empty_fast_loop(small):
    cfg, grid, s0, ffn = small
    bad = cfg.replace(nfast=0)
    for fn in (lambda: stepping.make_stepper(bad, grid, ffn),
               lambda: stepping.run_accum(bad, grid, s0, 1, ffn)):
        with pytest.raises(ValueError, match="nfast"):
            fn()
