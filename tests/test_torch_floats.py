"""roms_tpu_torch: Lagrangian floats and their behaviours against roms_tpu's,
on the CPU in float64.

(a) step_floats over five steps (the Euler start-up and the Milne/Hamming
    ladder), with and without a vertical random walk, on seeded velocity,
    omega and thickness fields, each history within 1e-12 x max|field| of
    roms_tpu's step_floats under jax.jit, periodic and closed;
    vwalk_velocity on a seeded diffusivity with draws from a numpy seed;
    diel_migration_w and oyster_behavior on seeded inputs;
(b) the analogs of tests/test_floats.py on the port alone: floats in a
    uniform zonal flow travel u t, floats in an UPWELLING run stay inside
    and finite, and the oyster and diel behaviours keep their signs.
"""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from roms_tpu import float_behavior as jfb, floats as jfl
from roms_tpu.config import Config as JConfig
from roms_tpu_torch import float_behavior as tfb, floats as tfl, stepping, \
    vgrid
from roms_tpu_torch.config import Config
from roms_tpu_torch.grid import hc_of
from roms_tpu_torch.models import upwelling
from roms_tpu_torch.ops.omega import omega, set_massflux

torch.set_num_threads(1)

RTOL = 1e-12          # times max|field|
SIZE = dict(Lm=12, Mm=10, N=6, dt=300.0)
NF = 16


def _close(got, ref, name):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape, name
    scale = max(np.abs(ref).max(), 1e-300)
    np.testing.assert_allclose(got, ref, rtol=0, atol=RTOL * scale,
                               err_msg=name)


def _fields(periodic: bool, seed: int = 3):
    """Both packages' configurations and seeded (pm, pn, u, v, W, Hz, Akt_w)
    as numpy: smooth velocities of a few cm/s, omega zero at the bottom
    and top, uneven layers."""
    kw = dict(SIZE, ew_periodic=periodic, ns_periodic=False)
    cfg, cfg_j = Config(**kw), JConfig(**kw)
    rng = np.random.default_rng(seed)
    N, ny, nx = cfg.N, cfg.ny_tot, cfg.nx_tot
    f = dict(pm=1e-3 * rng.uniform(0.9, 1.1, (ny, nx)),
             pn=1e-3 * rng.uniform(0.9, 1.1, (ny, nx)),
             u=0.05 * rng.standard_normal((N, ny, nx)),
             v=0.05 * rng.standard_normal((N, ny, nx)),
             W=rng.standard_normal((N + 1, ny, nx)),
             Hz=rng.uniform(2.0, 8.0, (N, ny, nx)),
             Akt_w=1e-3 * rng.uniform(0.0, 1.0, (N + 1, ny, nx)))
    f["W"][0] = f["W"][-1] = 0.0
    return cfg, cfg_j, f


def _seeds(cfg, seed=4):
    rng = np.random.default_rng(seed)
    return (rng.uniform(1.0, cfg.Lm, NF), rng.uniform(1.0, cfg.Mm, NF),
            rng.uniform(0.0, cfg.N, NF))


def _pair_of(f):
    t = {k: torch.tensor(v) for k, v in f.items()}
    j = {k: jnp.asarray(v) for k, v in f.items()}
    return (SimpleNamespace(pm=t["pm"], pn=t["pn"]), t,
            SimpleNamespace(pm=j["pm"], pn=j["pn"]), j)


@pytest.mark.parametrize("periodic", [True, False])
@pytest.mark.parametrize("vwalk", [False, True])
def test_step_floats_matches_jax(periodic, vwalk):
    cfg, cfg_j, f = _fields(periodic)
    g_t, t, g_j, j = _pair_of(f)
    x0, y0, z0 = _seeds(cfg)
    fl_t = tfl.init_floats(x0, y0, z0)
    fl_j = jfl.init_floats(jnp.asarray(x0), jnp.asarray(y0),
                           jnp.asarray(z0))

    def step_j(fl, w):
        return jfl.step_floats(cfg_j, g_j, j["u"], j["v"], j["W"], j["Hz"],
                               fl, w_vwalk=w)
    step_j = jax.jit(step_j)
    rng = np.random.default_rng(9)
    for n in range(5):
        w = 1e-4 * rng.standard_normal(NF) if vwalk else None
        fl_t = tfl.step_floats(cfg, g_t, t["u"], t["v"], t["W"], t["Hz"],
                               fl_t, w_vwalk=None if w is None
                               else torch.tensor(w))
        fl_j = step_j(fl_j, None if w is None else jnp.asarray(w))
        assert fl_t.nsteps == int(fl_j.nsteps) == n + 1
        for k in ("xg", "yg", "zg", "ug", "vg", "wg"):
            _close(getattr(fl_t, k), getattr(fl_j, k), f"step {n} {k}")


def test_vwalk_velocity_matches_jax():
    cfg, cfg_j, f = _fields(True)
    g_t, t, g_j, j = _pair_of(f)
    fl_t = tfl.init_floats(*_seeds(cfg))
    fl_j = jfl.init_floats(*(jnp.asarray(a) for a in _seeds(cfg)))
    rwalk = np.random.default_rng(11).standard_normal(NF)
    got = tfl.vwalk_velocity(cfg, g_t, t["Akt_w"], t["Hz"], fl_t,
                             torch.tensor(rwalk))
    ref = jax.jit(lambda a, h, fl, r: jfl.vwalk_velocity(
        cfg_j, g_j, a, h, fl, r))(j["Akt_w"], j["Hz"], fl_j,
                                  jnp.asarray(rwalk))
    _close(got, ref, "w_rw")
    assert float(got.abs().max()) > 0.0


@pytest.mark.parametrize("hour", [0.0, 6.0, 12.5, 23.9, 30.0])
def test_diel_migration_matches_jax(hour):
    cfg = Config(**SIZE)
    z = -np.linspace(0.5, 60.0, NF)
    got = tfb.diel_migration_w(cfg, torch.tensor(z), hour * 3600.0)
    ref = jfb.diel_migration_w(JConfig(**SIZE), jnp.asarray(z),
                               jnp.asarray(hour * 3600.0))
    _close(got, ref, "w")


def test_oyster_behavior_matches_jax():
    cfg, cfg_j = Config(**SIZE), JConfig(**SIZE)
    rng = np.random.default_rng(13)
    size = rng.uniform(60.0, 340.0, NF)
    swim = rng.uniform(0.2, 1.0, NF)
    settled = (rng.uniform(size=NF) > 0.8).astype(float)
    ins = [rng.uniform(15.0, 30.0, NF), rng.uniform(10.0, 30.0, NF),
           rng.uniform(-1.0, 1.0, NF), -rng.uniform(0.5, 20.0, NF),
           np.full(NF, 20.0)]
    got_st, got_w = tfb.oyster_behavior(
        cfg, tfb.OysterParams(), tfb.OysterState(
            *(torch.tensor(a) for a in (size, swim, settled))),
        *(torch.tensor(a) for a in ins))
    ref_st, ref_w = jax.jit(lambda st, *a: jfb.oyster_behavior(
        cfg_j, jfb.OysterParams(), st, *a))(
        jfb.OysterState(*(jnp.asarray(a) for a in (size, swim, settled))),
        *(jnp.asarray(a) for a in ins))
    for k in ("size", "swim_time", "settled"):
        _close(getattr(got_st, k), getattr(ref_st, k), k)
    _close(got_w, ref_w, "w_bio")
    init = tfb.init_oysters(NF, tfb.OysterParams())
    ref_init = jfb.init_oysters(NF, jfb.OysterParams())
    for k in ("size", "swim_time", "settled"):
        _close(getattr(init, k), getattr(ref_init, k), k)


def _model_w(cfg, grid, s):
    _, z_w, Hz = vgrid.set_depth(grid.h, s.zeta, hc_of(cfg), grid.sc_r,
                                 grid.Cs_r, grid.sc_w, grid.Cs_w,
                                 cfg.vtransform)
    Huon, Hvom = set_massflux(cfg, grid, s.u, s.v, Hz)
    return omega(cfg, grid, Huon, Hvom, z_w), Hz


def test_floats_uniform_flow_advection():
    """tests/test_floats.py:15's analog: floats in a prescribed uniform
    zonal flow travel u t."""
    cfg, grid, s0, _ = upwelling.build(upwelling.make_config(
        Lm=24, Mm=16, N=6, ndtfast=8), device="cpu")
    u0 = 0.3
    s = s0.replace(u=torch.full_like(s0.u, u0))
    W, Hz = _model_w(cfg, grid, s)
    fl = tfl.init_floats(torch.tensor([5.0, 12.0]),
                         torch.tensor([8.0, 8.0]), torch.tensor([3.0, 5.0]))
    nsteps = 20
    for _ in range(nsteps):
        fl = tfl.step_floats(cfg, grid, s.u, s.v, W, Hz, fl)
    dx = fl.xg[3].numpy() - np.array([5.0, 12.0])
    np.testing.assert_allclose(dx, u0 * nsteps * cfg.dt / 1000.0, rtol=1e-3)
    assert float((fl.yg[3] - 8.0).abs().max()) < 1e-6
    assert bool(torch.isfinite(fl.zg).all())


def test_floats_follow_model_flow():
    """tests/test_floats.py:45's analog: floats advected by an evolving
    UPWELLING run stay inside and finite."""
    cfg, grid, s, ffn = upwelling.build(upwelling.make_config(
        Lm=16, Mm=24, N=6, ndtfast=8), device="cpu")
    fl = tfl.init_floats(torch.linspace(2.0, 14.0, 5, dtype=torch.float64),
                         torch.full((5,), 12.0, dtype=torch.float64),
                         torch.full((5,), 5.0, dtype=torch.float64))
    for _ in range(15):
        s = stepping.step(cfg, grid, s, ffn)
        W, Hz = _model_w(cfg, grid, s)
        fl = tfl.step_floats(cfg, grid, s.u, s.v, W, Hz, fl)
    assert bool(torch.isfinite(fl.xg).all())
    x, y = fl.xg[3], fl.yg[3]
    assert bool(((x > 0) & (x < cfg.Lm + 1)).all())
    assert bool(((y > 0) & (y < cfg.Mm + 1)).all())


def test_float_behaviors():
    """tests/test_floats.py:119's analog: the diel migration flips day and
    night; oyster larvae grow, swim up in rising salinity, sink faster as
    they grow and settle near the bed at settlement size."""
    cfg = Config(**SIZE)
    z = torch.full((5,), -20.0, dtype=torch.float64)
    assert float(tfb.diel_migration_w(cfg, z, 12.0 * 3600.0).max()) < 0.0
    assert float(tfb.diel_migration_w(cfg, z, 0.0).min()) > 0.0
    p = tfb.OysterParams()
    st = tfb.init_oysters(4, p)

    def full(v):
        return torch.full((4,), v, dtype=torch.float64)

    temp, salt, hf = full(p.temp_opt), full(p.salt_opt), full(75.0)
    zf = torch.tensor([-5.0, -5.0, -74.5, -5.0], dtype=torch.float64)
    st1, _ = tfb.oyster_behavior(cfg, p, st, temp, salt, full(0.0), zf, hf)
    assert bool((st1.size > st.size).all())
    _, w_up = tfb.oyster_behavior(cfg, p, st, temp, salt, full(0.5), zf, hf)
    _, w_dn = tfb.oyster_behavior(cfg, p, st, temp, salt, full(-0.5), zf,
                                  hf)
    assert bool((w_up > w_dn).all())
    big = st._replace(size=full(320.0), swim_time=full(p.swim_Tmin))
    sml = st._replace(size=full(120.0), swim_time=full(p.swim_Tmin))
    _, w_big = tfb.oyster_behavior(cfg, p, big, temp, salt, full(0.0), zf,
                                   hf)
    _, w_sml = tfb.oyster_behavior(cfg, p, sml, temp, salt, full(0.0), zf,
                                   hf)
    assert bool((w_big < w_sml).all())
    ready = st._replace(size=full(p.size_settle + 1.0))
    st2, w2 = tfb.oyster_behavior(cfg, p, ready, temp, salt, full(0.0), zf,
                                  hf)
    assert float(st2.settled[2]) == 1.0 and float(w2[2]) == 0.0
    assert float(st2.settled[0]) == 0.0
