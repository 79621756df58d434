"""roms_tpu_torch's NPZD Powell model (ops/biology.py) against roms_tpu's, in
float64 on the CPU, and analogs of tests/test_biology.py on the port.

(a) _positive_definite on pools with negative cells and with tied maxima
    (both packages take the first of equal maxima), _light, and
    npzd_powell with sinking phytoplankton and detritus and two BioIter
    passes, against roms_tpu's functions under jax.jit, each within
    RTOL x max|output|;
(b) tests/test_biology.py's checks on BIO_TOY at 6 x 8 x 10: with no
    sinking, 40 steps conserve total nitrogen to rtol 1e-9 while the
    phytoplankton grows and nitrate falls at the surface; with wDet = 80
    m/day, 30 steps export nitrogen through the seabed, monotonically.

RTOL 1e-12 (measured at most 2.4e-16: one pass of arithmetic with exp
and sqrt).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from roms_tpu.config import Config as JConfig
from roms_tpu.ops import biology as jbio
from roms_tpu_torch import convert, stepping, vgrid
from roms_tpu_torch.grid import hc_of
from roms_tpu_torch.models import bio_toy
from roms_tpu_torch.ops import biology as tbio
from test_torch_obc import jit

torch.set_num_threads(1)

RTOL = 1e-12
T = lambda a: torch.tensor(np.asarray(a))      # noqa: E731


def _close(got, ref, name=""):
    got, ref = got.numpy(), np.asarray(ref)
    assert got.shape == ref.shape, name
    scale = max(np.abs(ref).max(), 1e-300)
    np.testing.assert_allclose(got, ref, rtol=0, atol=RTOL * scale,
                               err_msg=name)


def _column(rng, N=10, Ny=5, Nx=6):
    hz = rng.uniform(1.0, 8.0, (N, Ny, Nx))
    z_w = np.concatenate([-hz.sum(0)[None],
                          -hz.sum(0)[None] + np.cumsum(hz, 0)])
    return z_w[1:] - z_w[:-1], z_w


def test_positive_definite_with_ties():
    rng = np.random.default_rng(3)
    bio = rng.uniform(0.0, 2.0, (4, 6, 5, 6))
    bio[1, :2] = -0.05                    # deficits
    bio[0, 0] = bio[2, 0] = 5.0           # tied maxima: the first gives
    bio[:, 4, 0, 0] = -1e-3               # every pool short: nothing given
    bio[3, 5, 1, 1] = 1e-7                # short by less than MinVal
    got = tbio._positive_definite(T(bio))
    ref = jit(jbio._positive_definite, jnp.asarray(bio))
    assert np.array_equal(got.numpy(), np.asarray(ref))
    assert float(got[0, 0, 0, 0]) < 5.0 and float(got[2, 0, 0, 0]) == 5.0


def test_light():
    rng = np.random.default_rng(4)
    Hz, z_w = _column(rng)
    phy = rng.uniform(0.0, 3.0, Hz.shape)
    par = rng.uniform(0.0, 300.0, Hz.shape[1:])
    par[0, :2] = 0.0                      # night columns
    p = tbio.NPZDParams()
    got = tbio._light(p, T(phy), T(z_w), T(par))
    ref = jit(lambda *a: jbio._light(jbio.NPZDParams(), *a),
              jnp.asarray(phy), jnp.asarray(z_w), jnp.asarray(par))
    _close(got, ref)
    assert float(got[:, 0, :2].abs().max()) == 0.0


@pytest.mark.parametrize("iters", [1, 2])
def test_npzd_powell(iters):
    rng = np.random.default_rng(5 + iters)
    Hz, z_w = _column(rng)
    nt = 6
    t_old = rng.uniform(0.02, 2.0, (nt,) + Hz.shape)
    t_old[3, :2, 0, 0] = -0.01
    t_new = t_old + rng.uniform(-0.01, 0.01, t_old.shape)
    srflx = rng.uniform(0.0, 400.0, Hz.shape[1:]) / (1025.0 * 3985.0)
    cfg_j = JConfig(Lm=6, Mm=5, N=10, ntracers=nt, biology="npzd_powell",
                    ibio=(2, 3, 4, 5), dt=1800.0)
    kw = dict(BioIter=iters, wPhy=3.0, wDet=12.0)
    pj, pt = jbio.NPZDParams(**kw), tbio.NPZDParams(**kw)
    cfg_t = convert.config_from_reference(cfg_j)
    ref = jit(lambda *a: jbio.npzd_powell(cfg_j, pj, *a),
              jnp.asarray(t_old), jnp.asarray(t_new), jnp.asarray(Hz),
              jnp.asarray(z_w), jnp.asarray(srflx))
    got = tbio.npzd_powell(cfg_t, pt, T(t_old), T(t_new), T(Hz), T(z_w),
                           T(srflx))
    for n in range(nt):
        _close(got[n], ref[n], f"tracer {n}")


def _totals(cfg, grid, s):
    """The column inventories sum t Hz area of each bio compartment."""
    H = cfg.halo
    _, _, Hz = vgrid.set_depth(grid.h, s.zeta, hc_of(cfg), grid.sc_r,
                               grid.Cs_r, grid.sc_w, grid.Cs_w,
                               cfg.vtransform)
    jj, ii = slice(H, H + cfg.Mm), slice(H, H + cfg.Lm)
    area = grid.omn[jj, ii]
    return np.array([float((s.t[i][:, jj, ii] * Hz[:, jj, ii] *
                            area).sum()) for i in cfg.ibio])


def test_npzd_nitrogen_conservation_and_bloom():
    # no sinking: every stage conserves, so total N stays while a bloom
    # grows under constant PAR
    p = tbio.NPZDParams(const_par=158.075, wPhy=0.0, wDet=0.0)
    cfg, grid, s0, ffn = bio_toy.build(
        bio_toy.make_config(Lm=6, Mm=8, N=10, params=p), device="cpu")
    tot0 = _totals(cfg, grid, s0)
    s = stepping.run(cfg, grid, s0, 40, ffn)
    tot1 = _totals(cfg, grid, s)
    assert np.isfinite(tot1).all()
    H = cfg.halo
    assert float(s.t[3][-1, H + 4, H + 3]) > bio_toy.BIO_INI[1]
    assert float(s.t[2][-1, H + 4, H + 3]) < bio_toy.BIO_INI[0]
    np.testing.assert_allclose(tot1.sum(), tot0.sum(), rtol=1e-9)


def test_npzd_detritus_sinking_exports():
    # wDet = 80 m/day carries detritus through the seabed: total N falls,
    # step by step
    p = tbio.NPZDParams(const_par=0.0, wPhy=0.0, wDet=80.0, DetRR=0.0,
                        ZooGR=0.0, PhyMRD=0.0, ZooMRD=0.0)
    cfg, grid, s, ffn = bio_toy.build(
        bio_toy.make_config(Lm=6, Mm=8, N=10, params=p), device="cpu")
    tots = [_totals(cfg, grid, s).sum()]
    for _ in range(30):
        s = stepping.step(cfg, grid, s, ffn)
        tots.append(_totals(cfg, grid, s).sum())
    assert np.isfinite(np.array(tots)).all()
    assert tots[-1] < tots[0]
    assert (np.diff(tots) <= 1e-9).all()
