"""roms_tpu_torch: the nearshore radiation stress and the Stokes drift
against roms_tpu's, on the CPU in float64.

(a) radiation_stress (Mellor05) and radiation_stress08 (Mellor08, its
    copied 2x near-surface term included) on a small UPWELLING grid with a
    seeded free surface and an oblique, shoaling wave field, every output
    within 1e-12 x max|field| of roms_tpu's; stokes_transport, and the
    general fast loop carrying a Stokes transport (us2d), likewise;
(b) the analogs of tests/test_nearshore.py on the port alone: uniform
    waves along the periodic channel give no along-channel force, the
    column Stokes transport is E/c, a wave height falling toward +y
    pushes toward +y under either kernel, and a constant tracer stays
    constant under an oblique wave field whose Stokes flux enters the
    step.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from roms_tpu import constants as JC, vgrid as jvgrid
from roms_tpu.grid import hc_of as jhc_of
from roms_tpu.models import upwelling as jup
from roms_tpu.ops import nearshore as jns, step2d as jstep2d
from roms_tpu_torch import constants as C, stepping, vgrid
from roms_tpu_torch.grid import hc_of
from roms_tpu_torch.models import upwelling as tup
from roms_tpu_torch.ops import nearshore as tns, step2d as tstep2d

torch.set_num_threads(1)

RTOL = 1e-12          # times max|field|
SIZE = dict(Lm=16, Mm=14, N=6, ndtfast=6)


def _close(got, ref, name):
    got, ref = got.numpy(), np.asarray(ref)
    assert got.shape == ref.shape, name
    scale = max(np.abs(ref).max(), 1e-300)
    np.testing.assert_allclose(got, ref, rtol=0, atol=RTOL * scale,
                               err_msg=name)


@pytest.fixture(scope="module")
def pair():
    """UPWELLING at SIZE in both packages, with a seeded free surface, its
    depths, and an oblique wave field shoaling toward +y."""
    cfg_t, grid_t, s_t, _ = tup.build(tup.make_config(**SIZE), device="cpu")
    cfg_j, grid_j, s_j, _ = jup.build(jup.make_config(**SIZE))
    rng = np.random.default_rng(21)
    zeta = 0.2 * rng.standard_normal(np.asarray(grid_j.h).shape)
    yy = np.arange(cfg_t.ny_tot)[:, None] * np.ones(cfg_t.nx_tot)
    waves = (np.clip(1.2 - 0.05 * yy, 0.2, None) *
             rng.uniform(0.9, 1.1, yy.shape),
             np.full(yy.shape, 200.0 * math.pi / 180.0),
             rng.uniform(40.0, 90.0, yy.shape))
    zr, zw, Hz = vgrid.set_depth(grid_t.h, torch.tensor(zeta), hc_of(cfg_t),
                                 grid_t.sc_r, grid_t.Cs_r, grid_t.sc_w,
                                 grid_t.Cs_w, cfg_t.vtransform)
    zrj, _, Hzj = jvgrid.set_depth(grid_j.h, jnp.asarray(zeta),
                                   jhc_of(cfg_j), grid_j.sc_r, grid_j.Cs_r,
                                   grid_j.sc_w, grid_j.Cs_w,
                                   cfg_j.vtransform)
    port = (cfg_t, grid_t, torch.tensor(zeta), Hz, zr,
            [torch.tensor(w) for w in waves])
    ref = (cfg_j, grid_j, jnp.asarray(zeta), Hzj, zrj,
           [jnp.asarray(w) for w in waves])
    return port, ref


@pytest.mark.parametrize("kernel", ["mellor05", "mellor08"])
def test_radiation_stress_matches_jax(pair, kernel):
    (cfg, grid, zeta, Hz, z_r, w), (cfg_j, grid_j, zj, Hzj, zrj, wj) = pair
    if kernel == "mellor05":
        got = tns.radiation_stress(cfg, grid, zeta, Hz, grid.Cs_r,
                                   grid.Cs_w, *w)
        ref = jns.radiation_stress(cfg_j, grid_j, zj, Hzj, grid_j.Cs_r,
                                   grid_j.Cs_w, *wj)
    else:
        got = tns.radiation_stress08(cfg, grid, zeta, Hz, z_r, grid.Cs_r,
                                     grid.Cs_w, *w)
        ref = jns.radiation_stress08(cfg_j, grid_j, zj, Hzj, zrj,
                                     grid_j.Cs_r, grid_j.Cs_w, *wj)
    for name in ref._fields:
        _close(getattr(got, name), getattr(ref, name), name)
    assert float(got.rvstr3d.abs().max()) > 0.0


@pytest.mark.parametrize("wetdry", [False, True])
def test_wet_dry_taper_matches_jax(pair, wetdry):
    """The Stokes drift tapered as a column dries (cfg.wetdry), on a free
    surface that leaves some columns near and below Dcrit."""
    (cfg, grid, zeta, Hz, _, w), (cfg_j, grid_j, zj, Hzj, _, wj) = pair
    low = -grid.h.numpy() + np.linspace(0.0, 1.0, grid.h.numel()).reshape(
        grid.h.shape)
    zeta, zj = torch.tensor(low), jnp.asarray(low)
    got = tns.radiation_stress(cfg.replace(wetdry=wetdry), grid, zeta, Hz,
                               grid.Cs_r, grid.Cs_w, *w)
    ref = jns.radiation_stress(cfg_j.replace(wetdry=wetdry), grid_j, zj,
                               Hzj, grid_j.Cs_r, grid_j.Cs_w, *wj)
    for name in ("u_stokes", "v_stokes", "ubar_stokes", "vbar_stokes"):
        _close(getattr(got, name), getattr(ref, name), name)


def test_stokes_transport_and_fast_loop_match_jax(pair):
    """stokes_transport, then the general fast loop of one slow step
    carrying it, from UPWELLING's rest state with the seeded surface."""
    (cfg, grid, zeta, Hz, _, w), (cfg_j, grid_j, zj, Hzj, _, wj) = pair
    ns = tns.radiation_stress(cfg, grid, zeta, Hz, grid.Cs_r, grid.Cs_w, *w)
    ns_j = jns.radiation_stress(cfg_j, grid_j, zj, Hzj, grid_j.Cs_r,
                                grid_j.Cs_w, *wj)
    us2d = tstep2d.stokes_transport(grid, zeta,
                                    (ns.ubar_stokes, ns.vbar_stokes))
    us2d_j = jstep2d.stokes_transport(grid_j, zj, (ns_j.ubar_stokes,
                                                   ns_j.vbar_stokes))
    for a, b, name in zip(us2d, us2d_j, ("TSu", "TSv")):
        _close(a, b, name)
    zero = torch.zeros_like(zeta)
    fs, ru_c, rv_c, wet = tstep2d.fast_loop(
        cfg, grid, tstep2d.make_fast_state(cfg, zeta, zero, zero),
        rufrc=ns.rustr2d, rvfrc=ns.rvstr2d, ru0_nm1=zero, ru0_nm2=zero,
        rv0_nm1=zero, rv0_nm2=zero, iic=0, us2d=us2d)
    zj0 = jnp.zeros_like(zj)
    fs_j, ru_j, rv_j, _ = jstep2d.fast_loop(
        cfg_j, grid_j, jstep2d.make_fast_state(cfg_j, zj, zj0, zj0),
        rufrc=ns_j.rustr2d, rvfrc=ns_j.rvstr2d, ru0_nm1=zj0, ru0_nm2=zj0,
        rv0_nm1=zj0, rv0_nm2=zj0, iic=0, us2d=us2d_j)
    assert wet is None
    for name in tstep2d.FS_FIELDS:
        _close(getattr(fs, name), getattr(fs_j, name), name)
    _close(ru_c, ru_j, "rufrc_c")
    _close(rv_c, rv_j, "rvfrc_c")


@pytest.fixture(scope="module")
def upw():
    cfg, grid, s0, ffn = tup.build(tup.make_config(**SIZE), device="cpu")
    _, _, Hz = vgrid.set_depth(grid.h, s0.zeta, hc_of(cfg), grid.sc_r,
                               grid.Cs_r, grid.sc_w, grid.Cs_w,
                               cfg.vtransform)
    return cfg, grid, s0, ffn, Hz


def _waves(grid, Hw=1.0, Lw=80.0, toward_x=True):
    # Dwave is the direction the waves travel toward (nautical): 1.5 pi
    # gives cos(cdir) = 1, toward +x
    return (torch.full_like(grid.h, Hw),
            torch.full_like(grid.h, 1.5 * math.pi if toward_x else math.pi),
            torch.full_like(grid.h, Lw))


def test_uniform_waves_no_force(upw):
    cfg, grid, s0, _, Hz = upw
    ns = tns.radiation_stress(cfg, grid, s0.zeta, Hz, grid.Cs_r, grid.Cs_w,
                              *_waves(grid))
    H = cfg.halo
    assert float(ns.rustr3d[:, H:H + cfg.Mm, H:H + cfg.Lm].abs().max()) \
        < 1e-10
    assert bool(torch.isfinite(ns.rvstr3d).all())


def test_stokes_transport_classic(upw):
    """The column Stokes transport is E/c (Longuet-Higgins), to 12%."""
    cfg, grid, s0, _, Hz = upw
    ns = tns.radiation_stress(cfg, grid, s0.zeta, Hz, grid.Cs_r, grid.Cs_w,
                              *_waves(grid, Hw=0.8, Lw=500.0))
    H = cfg.halo
    j, i = H + 7, H + 8
    Hz_u = 0.5 * (Hz[:, j, i - 1] + Hz[:, j, i])
    transport = float((Hz_u * ns.u_stokes[:, j, i]).sum())
    k = 2 * math.pi / 500.0
    kD = min(k * float(grid.h[j, i] + s0.zeta[j, i]), 5.0)
    c = math.sqrt(C.g / k * math.tanh(kD))
    assert transport == pytest.approx(0.0625 * C.g * 0.8 ** 2 / c, rel=0.12)
    ust = ns.u_stokes[:, j, i]
    assert float(ust[-1]) > float(ust[0]) > 0.0


@pytest.mark.parametrize("kernel", ["mellor05", "mellor08"])
def test_shoaling_gradient_force_sign(upw, kernel):
    """Hwave falling toward +y: -rvstr pushes toward +y on average."""
    cfg, grid, s0, _, Hz = upw
    H = cfg.halo
    yy = torch.arange(cfg.ny_tot, dtype=grid.h.dtype)[:, None]
    Hwave = torch.clamp(1.2 - 0.05 * (yy - H) * torch.ones_like(grid.h),
                        min=0.2)
    waves = (Hwave, torch.full_like(grid.h, math.pi),
             torch.full_like(grid.h, 80.0))
    if kernel == "mellor05":
        ns = tns.radiation_stress(cfg, grid, s0.zeta, Hz, grid.Cs_r,
                                  grid.Cs_w, *waves)
    else:
        z_r = vgrid.set_depth(grid.h, s0.zeta, hc_of(cfg), grid.sc_r,
                              grid.Cs_r, grid.sc_w, grid.Cs_w,
                              cfg.vtransform)[0]
        ns = tns.radiation_stress08(cfg, grid, s0.zeta, Hz, z_r, grid.Cs_r,
                                    grid.Cs_w, *waves)
    rv = ns.rvstr2d[H + 4:H + cfg.Mm - 4, H + 2:H + cfg.Lm - 2]
    assert float(rv.mean()) < 0.0
    torch.testing.assert_close(ns.rustr2d, ns.rustr3d.sum(0), rtol=1e-12,
                               atol=1e-12)


def test_stokes_flux_keeps_a_constant_tracer():
    """tests/test_nearshore.py:119's analog: a constant tracer under a
    steady oblique wave field stays constant to 1e-5 a step, and the
    waves move the mean flow."""
    cfg = tup.make_config(Lm=24, Mm=16, N=8).replace(nearshore="mellor05",
                                                     vmix=None)
    cfg, grid, s, ffn0 = tup.build(cfg, device="cpu")
    one = torch.ones_like(grid.h)

    def ffn(cfg_, grid_, time):
        return {**ffn0(cfg_, grid_, time), "Hwave": 0.8 * one,
                "Pwave": 8.0 * one, "Dwave": 225.0 * C.deg2rad * one,
                "Lwave": 60.0 * one}

    t = s.t.clone()
    t[0] = 17.0
    s = s.replace(t=t)
    nst = 10
    s = stepping.run(cfg, grid, s, nst, ffn)
    H = cfg.halo
    inner = s.t[0][:, H:H + cfg.Mm, H:H + cfg.Lm]
    assert bool(torch.isfinite(inner).all())
    assert float((inner - 17.0).abs().max()) < 1.0e-5 * nst
    assert float(s.vbar.abs().max()) > 1.0e-5
    assert JC.deg2rad == C.deg2rad
