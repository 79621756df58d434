"""roms_tpu_torch's Mellor-Yamada 2.5 closure against roms_tpu's, in float64
on the CPU, and analogs of tests/test_my25.py on the port's step.

(a) _spline_shear2 and my25_corstep (after gls_prestep, which the step
    shares with GLS) on a small closed grid with a turbulent state:
    positive, varied tke, q2l and mixing coefficients, a stratification of
    both signs (the ignored small negative buoyancy included), sheared
    currents and stresses; with Galperin's and with Kantha & Clayson's
    stability functions;
(b) the closure constants equal roms_tpu's (mod_scalars.F:4475-4490);
(c) tests/test_my25.py's MIXED_LAYER-style column on the port's step: the
    surface q2 is B1^(2/3) u*^2, the near-surface mixing grows while the
    interior stays quiet, and the two stability functions differ.

Tolerance 1e-12 x max|field| over the whole padded array (one pass of
arithmetic: a tridiagonal solve, square roots and quotients; measured at
most a few 1e-16 here).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from roms_tpu import vgrid as jvgrid
from roms_tpu.config import Config as JConfig
from roms_tpu.grid import hc_of
from roms_tpu.ops import gls as jgls, my25 as jmy25
from roms_tpu.ops.omega import omega as jomega, set_massflux as jmassflux
from roms_tpu_torch import stepping, vgrid
from roms_tpu_torch.config import Config, LBC
from roms_tpu_torch.grid import build_grid, hc_of as thc_of
from roms_tpu_torch.ops import bc, my25 as tmy25
from roms_tpu_torch.state import initial_state
from test_torch_obc import J, T, _close, jit, regional_pair

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def case():
    """A closed 12 x 6 x 6 grid 5-10 m deep, MY2.5, and a turbulent state;
    roms_tpu's gls_prestep outputs (the predictor the step shares)."""
    cfg = JConfig(name="my25", Lm=12, Mm=6, N=6, ntracers=2,
                  ew_periodic=False, ns_periodic=False, dt=30.0,
                  ndtfast=10, vmix="my25", bottom_drag="logarithmic",
                  zob=0.005, theta_s=1.0, theta_b=1.0, tcline=1.0,
                  vtransform=1, vstretching=1, akv_bak=5.0e-5,
                  akt_bak=(5.0e-6, 5.0e-6))
    cfg_j, grid_j, cfg_t, grid_t = regional_pair(
        cfg, 12 * 25.0, 6 * 6.0, 0.0,
        lambda x, y, i, j, c: 5.0 + 5.0 * x / 300.0)
    rng = np.random.default_rng(41)
    N = cfg_j.N
    s2 = (cfg_j.ny_tot, cfg_j.nx_tot)
    s3, sw = (N,) + s2, (N + 1,) + s2

    def flow(zeta, u, v):
        z_r, z_w, Hz = jvgrid.set_depth(
            grid_j.h, zeta, hc_of(cfg_j), grid_j.sc_r, grid_j.Cs_r,
            grid_j.sc_w, grid_j.Cs_w, cfg_j.vtransform)
        Huon, Hvom = jmassflux(cfg_j, grid_j, u, v, Hz)
        return z_r, z_w, Hz, Huon, Hvom, jomega(cfg_j, grid_j, Huon, Hvom,
                                                z_w)

    u = 0.5 * rng.standard_normal(s3)
    v = 0.2 * rng.standard_normal(s3)
    out = jit(flow, J(0.05 * rng.standard_normal(s2)), J(u), J(v))
    f = dict(zip(("z_r", "z_w", "Hz", "Huon", "Hvom", "W"),
                 map(np.asarray, out)))
    pos = lambda lo, hi, shape: lo * (hi / lo) ** rng.random(shape)  # noqa
    bvf = 1e-3 * rng.standard_normal(sw)
    bvf[2, :, :6] = -2e-5                 # small negative: ignored
    f.update(
        u=u, v=v, tke=pos(1e-6, 1e-3, sw), gls=pos(1e-8, 1e-4, sw),
        tke_prev=pos(1e-6, 1e-3, sw), gls_prev=pos(1e-8, 1e-4, sw),
        bvf=bvf, Akv=pos(1e-5, 1e-2, sw), Akt=pos(1e-5, 1e-2, (2,) + sw),
        Akk=pos(1e-5, 1e-2, sw), Lscale=pos(1e-2, 1.0, sw),
        sustr=1e-4 * rng.standard_normal(s2),
        svstr=1e-4 * rng.standard_normal(s2),
        bustr=1e-3 * rng.standard_normal(s2),
        bvstr=1e-3 * rng.standard_normal(s2))
    pre = jit(lambda *a: jgls.gls_prestep(cfg_j, grid_j, cfg_j.gls_params,
                                          3, *a),
              *(J(f[k]) for k in ("tke", "gls", "tke_prev", "gls_prev",
                                  "Hz", "Huon", "Hvom", "W")))
    f.update(zip(("tke3", "gls3", "tke_nnew", "gls_nnew"),
                 map(np.asarray, pre)))
    return cfg_j, grid_j, cfg_t, grid_t, f


_COR = ("tke", "gls", "tke3", "gls3", "tke_nnew", "gls_nnew", "u", "v",
        "bvf", "Hz", "z_r", "z_w", "Huon", "Hvom", "W", "Akv", "Akt", "Akk",
        "Lscale", "sustr", "svstr", "bustr", "bvstr")


def test_spline_shear2(case):
    _, _, _, _, f = case
    ref = jit(jmy25._spline_shear2, J(f["u"]), J(f["v"]), J(f["Hz"]))
    _close(tmy25._spline_shear2(T(f["u"]), T(f["v"]), T(f["Hz"])), ref,
           "shear2")


@pytest.fixture(scope="module")
def reference_corstep(case):
    """roms_tpu's my25_corstep with each stability function, compiled once
    with the variant's switch closed over."""
    cfg_j, grid_j, _, _, f = case
    args = [J(f[k]) for k in _COR]
    return {kc: jax.jit(lambda *a, kc=kc: jmy25.my25_corstep(
        cfg_j, grid_j, 3, *a, kantha_clayson=kc))(*args)
        for kc in (False, True)}


@pytest.mark.parametrize("kc", [False, True],
                         ids=["galperin", "kantha_clayson"])
def test_my25_corstep(case, reference_corstep, kc):
    _, _, cfg_t, grid_t, f = case
    got = tmy25.my25_corstep(cfg_t, grid_t, 3, *(T(f[k]) for k in _COR),
                             kantha_clayson=kc)
    names = ("tke", "gls", "Akv", "Akt", "Akk", "Lscale")
    for name, a, b in zip(names, got, reference_corstep[kc]):
        _close(a, b, name)
    assert float((got[2] - cfg_t.akv_bak).abs().max()) > 1e-6


def test_my25_constants():
    """The derived factors are mod_scalars.F:4475-4490's and roms_tpu's."""
    for name in ("my_B1p2o3", "my_B1pm1o3", "my_Sm1", "my_Sm2", "my_Sh1",
                 "my_Sh2_gal", "my_Sm3", "my_Sm4_gal", "my_Sh2_kc",
                 "my_Sm4_kc", "my_E1", "my_E2", "my_Gh0", "my_Sq",
                 "my_lmax", "my_qmin"):
        assert getattr(tmy25, name) == getattr(jmy25, name), name
    assert np.isclose(tmy25.my_B1p2o3, 16.6 ** (2.0 / 3.0))
    assert np.isclose(tmy25.my_Sh1, 0.74 * (1.0 - 6.0 * 0.92 / 16.6))
    assert np.isclose(tmy25.my_Sm2, 9.0 * 0.92 * 0.74)
    assert np.isclose(tmy25.my_Sm4_gal, 18.0 * 0.92 ** 2 + 9.0 * 0.92 * 0.74)


def _ml_case(vmix):
    """tests/test_vmix.py's make_ml_case on the port: flat 50 m, doubly
    periodic, stably stratified, a steady 0.1 N/m2 wind."""
    per = LBC.doubly_periodic()
    cfg = Config(
        name="mixed_layer", Lm=8, Mm=8, N=16, ntracers=2,
        ew_periodic=True, ns_periodic=True,
        dt=600.0, ndtfast=12, solve3d=True,
        vtransform=2, vstretching=4, theta_s=3.0, theta_b=0.0, tcline=10.0,
        uv_adv=True, uv_cor=True, uv_vis2=False, visc2=0.0,
        bottom_drag="linear", rdrg=3.0e-4,
        akv_bak=1.0e-5, akt_bak=(1.0e-6, 1.0e-6),
        eos="linear", R0=1027.0, T0=14.0, S0=35.0, Tcoef=1.7e-4, Scoef=0.0,
        vmix=vmix,
        lbc_zeta=per, lbc_ubar=per, lbc_vbar=per, lbc_u=per, lbc_v=per,
        lbc_t=per)
    grid, cfg = build_grid(cfg, 8e3, 8e3, f0=1e-4, beta=0.0,
                           depth_fn=lambda x, y, i, j, c: 50.0 + 0 * x,
                           device="cpu")
    z_r, _, _ = vgrid.set_depth(grid.h, torch.zeros_like(grid.h),
                                thc_of(cfg), grid.sc_r, grid.Cs_r, grid.sc_w,
                                grid.Cs_w, cfg.vtransform)
    temp = 14.0 + 0.2 * (z_r + 50.0)
    t0 = torch.stack([bc.fill_halo(cfg, temp),
                      bc.fill_halo(cfg, torch.full_like(temp, 35.0))])
    s0 = initial_state(cfg, device="cpu", t=t0)

    def ffn(cfg, grid, time):
        return {"sustr": torch.full_like(grid.h, 0.1 / 1025.0)}

    return cfg, grid, s0, ffn


def test_my25_mixed_layer_grows():
    cfg, grid, s0, ffn = _ml_case("my25")
    s = stepping.run(cfg, grid, s0, 30, ffn)      # 5 h of wind
    H = cfg.halo
    col = (slice(None), H + 4, H + 4)
    tke = s.tke[col].numpy()
    akv = s.Akv[col].numpy()
    assert bool(torch.isfinite(s.tke).all()) and \
        bool(torch.isfinite(s.gls).all())
    # q2 at the surface is the Dirichlet value B1^(2/3) u*^2
    assert np.isclose(tke[-1], 16.6 ** (2.0 / 3.0) * 0.1 / 1025.0,
                      rtol=1e-3)
    assert akv[-3:].max() > 1e-4          # the near surface mixes
    assert akv[1] < 1e-3                  # the deep interior stays quiet
    u = s.u.numpy()
    assert np.isfinite(u).all() and np.abs(u).max() < 1.0


def test_my25_galperin_vs_kantha_clayson():
    cfg, grid, s0, ffn = _ml_case("my25")
    s_g = stepping.run(cfg, grid, s0, 10, ffn)
    s_k = stepping.run(cfg.replace(my25_kantha_clayson=True), grid, s0, 10,
                       ffn)
    assert bool(torch.isfinite(s_g.Akv).all()) and \
        bool(torch.isfinite(s_k.Akv).all())
    assert float((s_g.Akv - s_k.Akv).abs().max()) > 0.0
