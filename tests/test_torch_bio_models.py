"""roms_tpu_torch's biology models against roms_tpu's, in float64 on the CPU,
and analogs of tests/test_bio_models.py on the port.

(a) each model's source term on the seeded inputs of
    scripts/torch_biology_fixture.py (MODELS): NPZD Powell with sinking
    phytoplankton, Franks, iron with IRON_RELAX, Fennel's core, with PO4
    and denitrification, with oxygen and carbon with and without
    denitrification (TALK_NONCONSERV on the latter), hypoxia with a
    respiration field, NEMURO, the red tide with a cyst map and a DIN
    climatology after mid-December (the year's wrap) and in April, and
    EcoSim.  roms_tpu runs jitted, or, where its jitted function compiles
    for seconds (Fennel with carbon, NEMURO, EcoSim), its eager output is
    read from tests/data/torch_biology_small.npz;
(b) tests/test_bio_models.py's checks on the port: the pCO2 check value,
    O2 saturation, conservation and blooms, gas exchange, the respiration
    sink and the saturation clamp, NEMURO's nitrogen and night, ppm_swim,
    the red tide's germination and its endogenous clock, EcoSim's growth,
    CDOC shading and bacterial loop.

Bound: each tracer within MODEL_BOUND = 1e-12 x its max|output| (measured
at most 4.2e-15, NEMURO, which is roms_tpu's own change when its inputs
move one ulp; `scripts/torch_biology_fixture.py --report`).
"""

import numpy as np
import pytest
import torch

from roms_tpu_torch.models import bio_toy
from roms_tpu_torch.ops import bio_models as bm
from roms_tpu_torch.ops.bio_models import (
    EcosimParams, FennelParams, FranksParams, HypoxiaParams, IronParams,
    NemuroParams, RedTideParams, ecosim, fennel, hypoxia_srm, nemuro,
    npzd_franks, npzd_iron, o2_saturation, pco2_water, ppm_swim, red_tide)
from chip_smoke import biology_fixture_script

torch.set_num_threads(1)

fx = biology_fixture_script()


@pytest.mark.parametrize("name", tuple(fx.MODELS))
def test_model_matches_roms_tpu(name):
    got = fx.port_model(name)
    if fx.MODELS[name][3]:
        want = np.load(fx.OUT)[f"{name}/out"]
    else:
        want = fx.reference_model(name, jit=True)
    assert got.shape == want.shape
    err = fx.model_errors(name, got, want)
    assert (err <= fx.MODEL_BOUND).all(), err


# ---------------------------------------------------------------------
# tests/test_bio_models.py's checks on the port
# ---------------------------------------------------------------------

def _column(N=12, Ny=3, Nx=4, depth=50.0):
    z_w = torch.linspace(-depth, 0.0, N + 1, dtype=torch.float64)[
        :, None, None] * torch.ones((1, Ny, Nx), dtype=torch.float64)
    Hz = z_w[1:] - z_w[:-1]
    z_r = 0.5 * (z_w[1:] + z_w[:-1])
    return Hz, z_w, z_r


class _G:
    rmask = None
    h = None


def _mkcfg(nbio, dt=3600.0):
    cfg = bio_toy.make_config(Lm=4, Mm=3, N=12)
    return cfg.replace(ntracers=2 + nbio, ibio=tuple(range(2, 2 + nbio)),
                       t_hadv=(2 + nbio) * ("U3",),
                       t_vadv=(2 + nbio) * ("C4",),
                       tnu2=(2 + nbio) * (0.0,), dt=dt)


def _stack(vals, N=12, Ny=3, Nx=4):
    return torch.stack([torch.full((N, Ny, Nx), float(v),
                                   dtype=torch.float64) for v in vals])


def _t(*groups):
    return torch.cat([_stack(g) for g in groups])


def test_pco2_check_value():
    # fennel.h:1953-1956 (DoNewton=0); the quoted value is itself a
    # bisection's, good to ~1e-5
    f = lambda v: torch.tensor([v], dtype=torch.float64)  # noqa: E731
    pco2, ph = pco2_water(f(24.0), f(36.6), f(2040.0), f(2390.0))
    np.testing.assert_allclose(float(pco2[0]), 350.74945, rtol=1e-4)
    assert 7.5 < float(ph[0]) < 8.5


def test_o2_saturation_range():
    f = lambda v: torch.tensor(v, dtype=torch.float64)  # noqa: E731
    o20 = float(o2_saturation(f(20.0), f(35.0)))
    o25 = float(o2_saturation(f(5.0), f(35.0)))
    assert 200.0 < o20 < 250.0
    assert o25 > o20


def test_franks_conservation_and_bloom():
    cfg = _mkcfg(4)
    Hz, z_w, z_r = _column()
    t = _t([20.0, 35.0], [1.67, 0.08, 0.06, 0.04])
    t_new = npzd_franks(cfg, FranksParams(wDet=0.0), t, t, Hz, z_w, z_r)
    tot0 = sum(float((t[i] * Hz).sum()) for i in cfg.ibio)
    tot1 = sum(float((t_new[i] * Hz).sum()) for i in cfg.ibio)
    np.testing.assert_allclose(tot1, tot0, rtol=1e-12)
    assert float(t_new[3][-1, 0, 0]) > 0.08
    assert float(t_new[2][-1, 0, 0]) < 1.67


def test_iron_conservation():
    cfg = _mkcfg(6)
    # FeRR = 1: every Fe release complete, so total Fe is conserved too
    p = IronParams(wPhy=0.0, wDet=0.0, FeRR=1.0, const_par=158.075)
    Hz, z_w, _ = _column()
    t = _t([20.0, 35.0], [17.0, 1.0, 1.0, 1.0, 0.06, 0.01])
    t_new = npzd_iron(cfg, p, _G(), t, t, Hz, z_w, None)
    incr = {i: t_new[i] - t[i] for i in cfg.ibio}
    totN = float(sum((incr[i] * Hz).sum() for i in cfg.ibio[:4]))
    totFe = float(sum((incr[i] * Hz).sum() for i in cfg.ibio[4:]))
    np.testing.assert_allclose(totN, 0.0, atol=1e-10)
    np.testing.assert_allclose(totFe, 0.0, atol=1e-12)
    # more phytoplankton iron (a higher Fe:C) makes a stronger bloom
    t_rich = t.clone()
    t_rich[7] = 0.5
    t_new_rich = npzd_iron(cfg, p, _G(), t_rich, t_rich, Hz, z_w, None)
    assert float((t_new_rich[3] - t_rich[3])[-1, 0, 0]) > \
        float((t_new[3] - t[3])[-1, 0, 0])


@pytest.mark.parametrize("denit", [False, True])
def test_fennel_nitrogen_budget(denit):
    # BIO_SEDIMENT returns the seabed flux to NH4: N is conserved without
    # DENITRIFICATION and lost with it
    cfg = _mkcfg(7)
    p = FennelParams(denitrification=denit, bio_sediment=True,
                     const_par=158.075, wPhy=5.0, wSDet=5.0, wLDet=20.0)
    Hz, z_w, _ = _column()
    t = _t([20.0, 35.0], [10.0, 1.0, 0.5, 1.0, 0.5, 0.5, 0.5])
    t_new = fennel(cfg, p, _G(), t, t, Hz, z_w, None)
    iN = [cfg.ibio[i] for i in (0, 1, 3, 4, 5, 6)]
    dN = float(sum(((t_new[i] - t[i]) * Hz).sum() for i in iN))
    if denit:
        assert dN < -1e-8
    else:
        np.testing.assert_allclose(dN, 0.0, atol=1e-9)
    assert bool(torch.isfinite(t_new).all())


def test_fennel_oxygen_carbon():
    cfg = _mkcfg(12)
    p = FennelParams(oxygen=True, carbon=True, const_par=158.075)
    Hz, z_w, _ = _column()
    # undersaturated in O2, supersaturated in CO2
    t = _t([20.0, 35.0], [10.0, 1.0, 0.5, 1.0, 0.5, 0.5, 0.5, 0.5, 0.5,
                          2300.0, 2300.0, 100.0])
    zero2 = torch.zeros_like(t[0, 0])
    t_new = fennel(cfg, p, _G(), t, t, Hz, z_w, None, uwind=zero2 + 5.0,
                   vwind=zero2)
    iOxy, iTIC = cfg.ibio[11], cfg.ibio[9]
    assert float((t_new[iOxy] - t[iOxy])[-1, 0, 0]) > 0.0
    pco2, _ = pco2_water(t[0, -1], t[1, -1], t[iTIC, -1],
                         t[cfg.ibio[10], -1])
    assert float(pco2[0, 0]) > 370.0
    assert float((t_new[iTIC] - t[iTIC])[-1, 0, 0]) < \
        float((t_new[iTIC] - t[iTIC])[-2, 0, 0]) + 1e-12
    assert bool(torch.isfinite(t_new).all())


def test_hypoxia_respiration_and_reaeration():
    cfg = _mkcfg(1)
    Hz, z_w, _ = _column()
    t = _t([20.0, 35.0], [100.0])
    zero2 = torch.zeros_like(t[0, 0])
    # the respiration field of the forcing in place of ResRate
    resp = torch.full_like(t[0], 10.0)
    t_new = hypoxia_srm(cfg, HypoxiaParams(), _G(), t, t, Hz, z_w, None,
                        uwind=zero2 + 10.0, vwind=zero2, respiration=resp)
    incr = t_new[2] - t[2]
    np.testing.assert_allclose(incr[0].numpy(), -10.0 * cfg.dt / 86400.0,
                               rtol=1e-12)
    assert float(incr[-1, 0, 0]) > float(incr[0, 0, 0])


def test_hypoxia_saturation_clamp():
    cfg = _mkcfg(1)
    p = HypoxiaParams(ResRate=0.0, surface_do_saturation=True)
    Hz, z_w, _ = _column()
    t = _t([20.0, 35.0], [100.0])
    t_new = hypoxia_srm(cfg, p, _G(), t, t, Hz, z_w, None)
    sat = float(o2_saturation(torch.tensor(20.0, dtype=torch.float64),
                              torch.tensor(35.0, dtype=torch.float64)))
    np.testing.assert_allclose(t_new[2][-1].numpy(), sat, rtol=1e-12)


_NEMURO_INI = [0.2, 0.2, 0.05, 0.05, 0.02, 5.0, 0.5, 0.1, 0.2, 10.0, 0.1]


def test_nemuro_nitrogen_conservation():
    cfg = _mkcfg(11)
    p = NemuroParams(setVPON=0.0, setVOpal=0.0, const_par=200.0)
    Hz, z_w, _ = _column()
    t = _t([15.0, 33.0], _NEMURO_INI)
    incr = nemuro(cfg, p, t, t, Hz, z_w, None) - t
    dN = sum(float((incr[i] * Hz).sum()) for i in cfg.ibio[:9])
    scaleN = sum(float((t[i] * Hz).sum()) for i in cfg.ibio[:9])
    assert abs(dN) < 1e-9 * scaleN


def test_nemuro_day_bloom_and_night():
    cfg = _mkcfg(11)
    off = {k: 0.0 for k in ("GRmaxSps", "GRmaxLps", "GRmaxLpl", "GRmaxLzs",
                            "GRmaxPpl", "GRmaxPzs", "GRmaxPzl")}
    Hz, z_w, _ = _column()
    t = _t([15.0, 33.0], _NEMURO_INI)
    incr = nemuro(cfg, NemuroParams(setVPON=0.0, setVOpal=0.0,
                                    const_par=200.0, **off),
                  t, t, Hz, z_w, None) - t
    assert float(incr[cfg.ibio[0]][-1, 0, 0]) > 0.0     # PS bloom
    assert float(incr[cfg.ibio[5]][-1, 0, 0]) < 0.0     # NO3 drawdown
    night = nemuro(cfg, NemuroParams(setVPON=0.0, setVOpal=0.0), t, t, Hz,
                   z_w, torch.zeros((3, 4), dtype=torch.float64)) - t
    assert float(night[cfg.ibio[5]].min()) >= 0.0       # nitrification only


def test_ppm_swim_upward_conserves_and_moves():
    N, Ny, Nx = 12, 3, 4
    Hz = torch.full((N, Ny, Nx), 4.0, dtype=torch.float64)
    qc = torch.zeros((N, Ny, Nx), dtype=torch.float64)
    qc[5] = 10.0
    z_c = torch.arange(N, dtype=torch.float64)[:, None, None] * 4.0 + 2.0

    def com(q):
        return float((q * Hz * z_c).sum() / (q * Hz).sum())
    up = ppm_swim(qc, Hz, -2.0)          # up 2 m (CFL 0.5)
    np.testing.assert_allclose(float((up * Hz).sum()),
                               float((qc * Hz).sum()), rtol=1e-12)
    assert com(up) > com(qc) + 1.0
    assert com(ppm_swim(qc, Hz, 2.0)) < com(qc) - 1.0


def test_red_tide_germination_growth_swim():
    cfg = _mkcfg(1, dt=3600.0)
    Hz, z_w, z_r = _column(depth=30.0)
    t = _t([15.0, 31.0], [100.0])
    srflx = torch.full((3, 4), 300.0 / (1025.0 * 3985.0),
                       dtype=torch.float64)
    cyst = torch.full((3, 4), 1000.0, dtype=torch.float64)
    incr = red_tide(cfg, RedTideParams(), t, t, Hz, z_w, z_r, srflx, 150.0,
                    cyst_ini=cyst)[2] - t[2]
    assert bool(torch.isfinite(incr).all())
    assert float((incr * Hz).sum()) > 0.0
    assert float(incr[-1, 0, 0]) > float(incr[5, 0, 0])


def test_red_tide_endo_scale_wraps():
    for yd in (0.0, 15.5, 100.0, 349.5, 360.0, 365.0):
        assert 0.0 < bm._endo_scale(yd) <= 1.0
    assert bm._endo_scale(135.5) == pytest.approx(1.0)


def _ecosim_setup(Lm=6, Mm=6, N=12, par=200.0):
    from roms_tpu_torch import vgrid
    from roms_tpu_torch.grid import hc_of
    from roms_tpu_torch.models import upwelling
    nbio, nt = 20, 22
    cfg = upwelling.make_config(Lm=Lm, Mm=Mm, N=N).replace(
        ntracers=nt, biology="ecosim", bio_params=EcosimParams(),
        ibio=tuple(range(2, 2 + nbio)), t_hadv=nt * ("U3",),
        t_vadv=nt * ("C4",), tnu2=nt * (0.0,))
    cfg, grid, s, _ = upwelling.build(cfg.replace(ntracers=2), device="cpu")
    cfg = cfg.replace(ntracers=nt)
    z_r, z_w, Hz = vgrid.set_depth(grid.h, s.zeta, hc_of(cfg), grid.sc_r,
                                   grid.Cs_r, grid.sc_w, grid.Cs_w,
                                   cfg.vtransform)
    t = torch.zeros((nt,) + z_r.shape, dtype=torch.float64)
    t[0], t[1] = 15.0, 35.0
    for k, v in enumerate((8.0, 0.5, 0.6, 6.0, 2100.0, 1.0, 0.12, 0.008,
                           0.3, 1.0, 0.15, 0.01, 0.16, 0.5, 0.5, 10.0, 1.0,
                           2.0, 0.5, 0.06)):
        t[2 + k] = v
    srflx = torch.full_like(grid.h, par / (1025.0 * 3985.0))
    return cfg, t, Hz, z_w, srflx


def _interior_of(cfg):
    H = cfg.halo
    return (slice(None), slice(H, H + cfg.Mm), slice(H, H + cfg.Lm))


def test_ecosim_growth_and_budgets():
    cfg, t, Hz, z_w, srflx = _ecosim_setup()
    for k in (14, 15, 16, 18, 19):        # the heterotroph pools emptied
        t[2 + k] = 1e-12
    t1 = ecosim(cfg, cfg.bio_params, t, t, Hz, z_w, srflx)
    sl = _interior_of(cfg)
    d = {k: (t1[2 + k] - t[2 + k])[sl].numpy() for k in range(20)}
    Hzi = Hz[sl].numpy()
    assert d[5][-1].mean() > 0.0
    assert (d[9] * Hzi).sum(axis=0).mean() > 0.0
    assert d[4][-1].mean() < 0.0
    assert (d[0] + d[1])[-1].mean() < 0.0
    assert d[3][-1].mean() < 0.0
    assert (d[15] + d[17])[-1].mean() > 0.0
    assert bool(torch.isfinite(t1).all())


def test_ecosim_spectral_light_cdoc_shading():
    cfg, t, Hz, z_w, srflx = _ecosim_setup(N=16)
    t_clear, t_dark = t.clone(), t.clone()
    t_clear[2 + 17] = 0.0
    t_dark[2 + 17] = 60.0
    H, k = cfg.halo, cfg.N // 2
    dC = [float((ecosim(cfg, cfg.bio_params, a, a, Hz, z_w, srflx)[2 + 5] -
                 a[2 + 5])[k, H + 2, H + 2]) for a in (t_clear, t_dark)]
    assert dC[0] > 2.0 * max(dC[1], 0.0) or dC[1] <= 0.0


def test_ecosim_dark_bacteria_remineralize():
    cfg, t, Hz, z_w, srflx = _ecosim_setup(par=0.0)
    for k in range(5, 14):                 # no phytoplankton
        t[2 + k] = 1e-12
    t1 = ecosim(cfg, cfg.bio_params, t, t, Hz, z_w, srflx)
    sl = _interior_of(cfg)
    d = {k: (t1[2 + k] - t[2 + k])[sl].numpy() for k in (0, 4, 5, 15)}
    assert np.abs(d[5]).max() <= 1e-10
    assert d[15].mean() < 0.0
    assert d[4].mean() > 0.0
    assert d[0].mean() > 0.0
