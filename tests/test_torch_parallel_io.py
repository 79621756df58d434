"""roms_tpu_torch's blocked runs on the CPU: sharded history output
(io/pio.py) against the gathered HistoryWriter and across the two
packages' part files (tests/test_pio.py), floats on the fields of a
blocked run (tests/test_floats.py's sharded test), and a run over two
gloo ranks (parallel/run.py with halo.Distributed), whose processes import
no jax, equal to the same run in process."""

import os
import socket
import subprocess
import sys
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

import torch

from roms_tpu.io import pio as jpio
from roms_tpu_torch import floats, stepping, vgrid
from roms_tpu_torch.config import Config
from roms_tpu_torch.grid import hc_of
from roms_tpu_torch.io import pio
from roms_tpu_torch.io.netcdf import HistoryWriter, read_history
from roms_tpu_torch.models import upwelling
from roms_tpu_torch.ops.omega import omega, set_massflux
from roms_tpu_torch.parallel import run as prun, smap

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LAYOUT = (2, 4)


def test_sharded_write_matches_gathered(tmp_path):
    """UPWELLING 26 x 26 x 4 float32 on 2 x 4 blocks: the assembled
    sharded stream equals the HistoryWriter records of the unblocked
    states bitwise, and assemble() writes a loadable canonical file."""
    cfg, grid, s0, ffn = upwelling.build(
        upwelling.make_config(Lm=26, Mm=26, N=4, dtype="float32"),
        device="cpu")
    lay = smap.Layout(*LAYOUT)
    step = smap.make_smap_stepper(cfg, grid, lay, ffn)
    sb = smap.block(cfg, lay, s0)
    base = str(tmp_path / "his_pio")
    w = pio.ShardedHistoryWriter(base, cfg, lay)
    his = HistoryWriter(str(tmp_path / "his.nc"), cfg)
    times = []
    for _ in range(3):
        sb = step(sb)
        s = smap.unblock(cfg, lay, sb)
        w.write(sb, s.time)
        his.write(s)
        times.append(s.time)
    w.close()
    his.close()
    assert w.path == base + ".p000.nc"

    data = pio.read_sharded(base)
    ref = read_history(str(tmp_path / "his.nc"))
    np.testing.assert_array_equal(data["time"], times)
    np.testing.assert_array_equal(ref["ocean_time"], times)
    for name in ("zeta", "ubar", "vbar", "u", "v"):
        assert data[name].shape == ref[name].shape, name
        np.testing.assert_array_equal(data[name], ref[name], err_msg=name)
    np.testing.assert_array_equal(data["t"][:, 0], ref["temp"])
    np.testing.assert_array_equal(data["t"][:, 1], ref["salt"])

    out = pio.assemble(base)
    from scipy.io import netcdf_file
    nc = netcdf_file(out, "r", mmap=False)
    np.testing.assert_array_equal(np.asarray(nc.variables["zeta"][:]),
                                  ref["zeta"])
    nc.close()


def test_part_files_cross_read(tmp_path):
    """The port's part file read by roms_tpu's read_sharded, and a part
    file of roms_tpu's writer (its NamedSharding over the 8 CPU devices)
    read by the port's."""
    cfg = Config(Lm=12, Mm=8, N=3, ntracers=2)
    H = cfg.halo
    rng = np.random.default_rng(11)
    g = SimpleNamespace(
        zeta=rng.standard_normal((cfg.ny_tot, cfg.nx_tot)),
        u=rng.standard_normal((cfg.N, cfg.ny_tot, cfg.nx_tot)))
    jj, ii = slice(H, H + cfg.Mm), slice(H, H + cfg.Lm)

    lay = smap.Layout(2, 2)
    blocks = {pos: SimpleNamespace(**b) for pos, b in smap.block(
        cfg, lay, {k: torch.as_tensor(v) for k, v in vars(g).items()})
        .items()}
    w = pio.ShardedHistoryWriter(str(tmp_path / "port"), cfg, lay,
                                 fields=("zeta", "u"))
    w.write(blocks, 60.0)
    w.close()
    got = jpio.read_sharded(str(tmp_path / "port"))
    np.testing.assert_array_equal(got["zeta"][0], g.zeta[jj, ii])
    np.testing.assert_array_equal(got["u"][0], g.u[:, jj, ii])
    np.testing.assert_array_equal(got["time"], [60.0])

    mesh = Mesh(np.array(jax.devices()[:4]).reshape(2, 2), ("eta", "xi"))
    # the padded extents split evenly over 2 x 2 devices
    assert cfg.ny_tot % 2 == 0 and cfg.nx_tot % 2 == 0
    js = SimpleNamespace(
        zeta=jax.device_put(jnp.asarray(g.zeta),
                            NamedSharding(mesh, P("eta", "xi"))),
        u=jax.device_put(jnp.asarray(g.u),
                         NamedSharding(mesh, P(None, "eta", "xi"))))
    jw = jpio.ShardedHistoryWriter(str(tmp_path / "jax"), cfg,
                                   fields=("zeta", "u"))
    jw.write(js, 120.0)
    jw.close()
    got = pio.read_sharded(str(tmp_path / "jax"))
    np.testing.assert_array_equal(got["zeta"][0], g.zeta[jj, ii])
    np.testing.assert_array_equal(got["u"][0], g.u[:, jj, ii])
    np.testing.assert_array_equal(got["time"], [120.0])


def test_floats_on_blocked_fields_match_one_block():
    """The mp_collect analog: floats stepped on the unblocked fields of a
    2 x 2 blocked UPWELLING run follow the same tracks as on one block's
    (tests/test_floats.py's bounds; 2 x 2 rather than its 8 devices, as a
    block costs its plain step's time on the CPU)."""
    cfg, grid, s0, ffn = upwelling.build(
        upwelling.make_config(Lm=26, Mm=26, N=4), device="cpu")
    H = cfg.halo
    hc = hc_of(cfg)
    fl0 = floats.init_floats(
        np.asarray([6.0, 12.0, 20.0]) + H - 0.5,
        np.asarray([8.0, 14.0, 20.0]) + H - 0.5,
        np.asarray([-5.0, -40.0, -80.0]))

    def float_step(s, fl):
        z_r, z_w, Hz = vgrid.set_depth(grid.h, s.zeta, hc, grid.sc_r,
                                       grid.Cs_r, grid.sc_w, grid.Cs_w,
                                       cfg.vtransform)
        Huon, Hvom = set_massflux(cfg, grid, s.u, s.v, Hz)
        W = omega(cfg, grid, Huon, Hvom, z_w)
        return floats.step_floats(cfg, grid, s.u, s.v, W, Hz, fl)

    s, fl_ref = s0, fl0
    lay = smap.Layout(2, 2)
    step = smap.make_smap_stepper(cfg, grid, lay, ffn)
    sb, fl_par = smap.block(cfg, lay, s0), fl0
    for _ in range(6):
        s = stepping.step(cfg, grid, s, ffn)
        fl_ref = float_step(s, fl_ref)
        sb = step(sb)
        fl_par = float_step(smap.unblock(cfg, lay, sb), fl_par)
    assert torch.isfinite(fl_ref.xg).all()
    torch.testing.assert_close(fl_par.xg, fl_ref.xg, rtol=0, atol=1e-10)
    torch.testing.assert_close(fl_par.yg, fl_ref.yg, rtol=0, atol=1e-10)
    torch.testing.assert_close(fl_par.zg, fl_ref.zg, rtol=0, atol=1e-8)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_gloo_ranks_equal_in_process(tmp_path):
    """UPWELLING 24 x 16 x 4 on 1 x 2 blocks, 3 steps, once as two gloo
    ranks (a process each, neither importing jax) and once in process:
    the part files hold the same records bitwise."""
    sizes = '{"Lm": 24, "Mm": 16, "N": 4, "ndtfast": 8}'
    common = ["--case", "upwelling", "--config", sizes, "--layout", "1x2",
              "--nsteps", "3", "--device", "cpu"]
    child = (
        "import runpy, sys\n"
        "sys.argv = ['run'] + sys.argv[1:]\n"
        "try:\n"
        "    runpy.run_module('roms_tpu_torch.parallel.run',"
        " run_name='__main__')\n"
        "except SystemExit as exc:\n"
        "    assert not exc.code, exc.code\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in"
        " ('jax', 'jaxlib', 'roms_tpu'))\n"
        "assert not bad, bad\n")
    init = f"tcp://127.0.0.1:{_free_port()}"
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env.pop("XLA_FLAGS", None)
    procs = [subprocess.Popen(
        [sys.executable, "-c", child] + common +
        ["--out", str(tmp_path / "dist"), "--init", init, "--rank",
         str(r), "--world", "2"], cwd=ROOT, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(2)]
    for p in procs:
        out, err = p.communicate(timeout=240)
        assert p.returncode == 0, err[-3000:]
    assert sorted(os.listdir(tmp_path)) == ["dist.p000.nc", "dist.p001.nc"]

    assert prun.main(common + ["--out", str(tmp_path / "local")]) == 0
    a = pio.read_sharded(str(tmp_path / "dist"))
    b = pio.read_sharded(str(tmp_path / "local"))
    assert set(a) == set(b) == {"zeta", "ubar", "vbar", "u", "v", "t",
                                "time"}
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert np.isfinite(a["zeta"]).all() and np.abs(a["u"]).max() > 0
