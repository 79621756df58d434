"""roms_tpu_torch's sediment stage against roms_tpu's, in float64 on the CPU,
and analogs of tests/test_sediment.py on the port.

(a) ppm_sink (ops/settling.py) against roms_tpu's biology.ppm_sink on
    profiles that reach each branch of the limiter, sinking less than a
    cell, through several cells and out through the bed;
(b) apply_sediment on random water columns, beds and stresses (some
    columns below the critical stress, some far above it): MPM bedload on
    a closed grid with land, one bed layer; Soulsby's bedload with the
    BBL's stress split on an east-west channel, two layers; SED_MORPH's
    amplified bed exchange with the BBL's combined stress, three layers and
    two classes; the current stress alone, three layers;
(c) tests/test_sediment.py's checks on the port: the water and the bed
    balance exactly and the bed never goes negative, MPM bedload conserves
    mass in a periodic channel, the borrow and the split of the bed
    layers, SED_TOY conserves its sediment while it deposits, SED_MORPH's
    erosion deepens h, Soulsby's bedload moves the bed.

Tolerance 1e-12 x max|field| over the whole padded array (RTOL; measured
at most a few 1e-16: the stage is one pass of arithmetic with one square
root and powers).
"""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from roms_tpu import vgrid as jvgrid
from roms_tpu.config import Config as JConfig, LBC as JLBC
from roms_tpu.grid import hc_of
from roms_tpu.ops import biology as jbio, sediment as jsed
from roms_tpu_torch import convert, stepping, vgrid
from roms_tpu_torch.grid import hc_of as thc_of
from roms_tpu_torch.models import sed_toy
from roms_tpu_torch.ops import bc, sediment as tsed, settling
from roms_tpu_torch.state import _initial_bed_mass
from test_torch_obc import _depth, _mask, jit, regional_pair

torch.set_num_threads(1)

RTOL = 1e-12
T = lambda a: torch.tensor(np.asarray(a))      # noqa: E731
J = jnp.asarray


def _close(got, ref, name="", floor=1e-300):
    """|got - ref| within RTOL x max|ref| (at least RTOL x floor)."""
    got, ref = got.numpy(), np.asarray(ref)
    assert got.shape == ref.shape, name
    scale = max(np.abs(ref).max(), floor)
    np.testing.assert_allclose(got, ref, rtol=0, atol=RTOL * scale,
                               err_msg=name)


@pytest.mark.parametrize("dist", [0.3, 7.0, 60.0])
def test_ppm_sink(dist):
    rng = np.random.default_rng(int(dist * 10))
    N, s2 = 8, (5, 6)
    Hz = 1.0 + 4.0 * rng.random((N,) + s2)
    z_w = np.concatenate([-Hz.sum(0)[None], -Hz.sum(0)[None] +
                          np.cumsum(Hz, 0)])
    qc = rng.random((N,) + s2) ** 3
    qc[:, 0, 0] = 0.5                        # uniform: every slope zero
    qc[::2, 1, 1] = 0.0                      # zig-zag: the limiter's zeros
    qc[:, 2, 2] = np.linspace(0.0, 1.0, N)   # monotone
    ref = jit(lambda *a: jbio.ppm_sink(*a, dist), J(qc), J(Hz), J(z_w))
    got = settling.ppm_sink(T(qc), T(Hz), T(z_w), dist)
    # against the input's scale: sinking 60 m empties the columns, and
    # leaves round-off
    _close(got[0], ref[0], "profile", floor=1.0)
    _close(got[1], ref[1], "export")


def _sed_cfg(name, ew_periodic, p):
    per = JLBC.periodic_ew() if ew_periodic else JLBC()
    nt = 2 + p.NST
    return JConfig(name=name, Lm=12, Mm=8, N=5, ntracers=nt,
                   ew_periodic=ew_periodic, ns_periodic=False, dt=300.0,
                   ndtfast=10, theta_s=3.0, theta_b=0.0, tcline=25.0,
                   t_hadv=nt * ("U3",), t_vadv=nt * ("C4",),
                   tnu2=nt * (0.0,), sediment=True, sed_params=p,
                   lbc_zeta=per, lbc_ubar=per, lbc_vbar=per, lbc_u=per,
                   lbc_v=per, lbc_t=per)


_TWO = dict(Sd50=(0.0001, 0.0006), Srho=(2650.0, 2600.0),
            Wsed=(0.0005, 0.004), Erate=(5.0e-4, 1.0e-4),
            tau_ce=(0.05 / 1025.0, 0.2 / 1025.0),
            tau_cd=(0.05 / 1025.0, 0.2 / 1025.0))
# variant -> (an east-west channel?, the parameters, the BBL's stresses?)
VARIANTS = {
    "mpm-closed": (False, dict(bedload=True, bedload_coeff=0.5), False),
    "soulsby-channel": (True, dict(Nbed=2, bedload=True,
                                   bedload_method="soulsby",
                                   bedload_coeff=1.0, Sd50=(0.0005,),
                                   Erate=(5.0e-4,)), True),
    "morph-two-classes": (True, dict(Nbed=3, sed_morph=True,
                                     morph_fac=10.0, **_TWO), True),
    "three-layers": (False, dict(Nbed=3, newlayer_thick=0.002,
                                 Erate=(5.0e-3,)), False),
}


@pytest.fixture(scope="module", params=list(VARIANTS))
def variant(request):
    """Both packages' configuration and grid of a variant, and random
    inputs as numpy."""
    channel, kw, bbl = VARIANTS[request.param]
    p = jsed.SedParams(**kw)
    cfg = _sed_cfg(request.param, channel, p)
    cfg_j, grid_j, cfg_t, grid_t = regional_pair(
        cfg, 12 * 2.0e3, 8 * 2.0e3, 1.0e-4, _depth,
        None if channel else _mask)
    rng = np.random.default_rng(len(request.param))
    N, nt = cfg_j.N, cfg_j.ntracers
    s2 = (cfg_j.ny_tot, cfg_j.nx_tot)
    _, z_w, Hz = map(np.asarray, jit(
        lambda zeta: jvgrid.set_depth(grid_j.h, zeta, hc_of(cfg_j),
                                      grid_j.sc_r, grid_j.Cs_r, grid_j.sc_w,
                                      grid_j.Cs_w, cfg_j.vtransform),
        J(0.2 * rng.standard_normal(s2))))
    bed = np.asarray(jsed.initial_bed(cfg_j, p))
    bed = bed * (0.2 + 2.0 * rng.random(bed.shape))
    bed[0, :, 3, 4] = 0.0                        # an empty top layer
    # kinematic stresses from well below to far above critical
    stress = lambda: 5e-4 * rng.standard_normal(s2) ** 3  # noqa: E731
    f = dict(t=np.concatenate([10.0 + rng.random((2, N) + s2),
                               0.2 * rng.random((nt - 2, N) + s2) ** 2]),
             bed=bed, Hz=Hz, z_w=z_w, bustr=stress(), bvstr=stress())
    kw_j = {}
    if bbl:
        f.update(tau_cw=np.abs(stress()) + 1e-6,
                 tau_c=np.abs(stress()), tau_wav=np.abs(stress()),
                 phicw=2.0 * np.pi * rng.random(s2))
        kw_j = ("tau_cw", "tau_c", "tau_wav", "phicw")
    return cfg_j, grid_j, cfg_t, grid_t, p, f, kw_j


def test_apply_sediment(variant):
    cfg_j, grid_j, cfg_t, grid_t, p, f, kw = variant
    args = ("t", "bed", "Hz", "z_w", "bustr", "bvstr")
    ref = jit(lambda *a, **k: jsed.apply_sediment(cfg_j, grid_j, p, *a,
                                                  **k),
              *(J(f[k]) for k in args), **{k: J(f[k]) for k in kw})
    p_t = cfg_t.sed_params
    got = tsed.apply_sediment(cfg_t, grid_t, p_t, *(T(f[k]) for k in args),
                              **{k: T(f[k]) for k in kw})
    for name, a, b in zip(("t", "bed_mass"), got, ref):
        _close(a, b, name)
    # the stage moved sediment between the water and the bed
    assert float((got[1] - T(f["bed"])).abs().max()) > 1e-8


def test_sed_params_convert():
    """config_from_reference carries the sediment and BBL parameters."""
    from roms_tpu.ops import bbl as jbbl
    from roms_tpu_torch.ops import bbl as tbbl
    cfg = dataclasses.replace(_sed_cfg("c", True, jsed.SedParams(**_TWO)),
                              bbl="mb", bbl_params=jbbl.MBBBLParams(
                                  d50=0.0003))
    cfg_t = convert.config_from_reference(cfg)
    assert cfg_t.sed_params == tsed.SedParams(**_TWO)
    assert cfg_t.bbl_params == tbbl.MBBBLParams(d50=0.0003)
    assert cfg_t.sed_params.NST == 2


# ---- tests/test_sediment.py's checks on the port ----

def _setup(params, conc=0.0, **kw):
    cfg, grid, s0, ffn = sed_toy.build(
        sed_toy.make_config(params=params, **kw), device="cpu", conc=conc)
    _, z_w, Hz = vgrid.set_depth(grid.h, s0.zeta, thc_of(cfg), grid.sc_r,
                                 grid.Cs_r, grid.sc_w, grid.Cs_w,
                                 cfg.vtransform)
    return cfg, grid, s0, ffn, Hz, z_w


def _inv(cfg, grid, t, bed, Hz):
    """The interior inventory (kg): suspended and bed, over the classes."""
    H = cfg.halo
    jj, ii = slice(H, H + cfg.Mm), slice(H, H + cfg.Lm)
    area = grid.omn[jj, ii]
    p = cfg.sed_params
    wat = sum(float((t[p.ised0 + c][:, jj, ii] * Hz[:, jj, ii] *
                     area).sum()) for c in range(p.NST))
    sed = float((bed[:, :, jj, ii] * area).sum())
    return wat + sed, wat, sed


def test_settle_erode_balance_and_limiting():
    p = tsed.SedParams(Wsed=(0.002,), Erate=(10.0,))
    cfg, grid, s0, _, Hz, z_w = _setup(p, conc=0.3)
    bustr = torch.full_like(s0.zeta, 5.0e-4)      # >> tau_ce
    t1, bed1 = tsed.apply_sediment(cfg, grid, p, s0.t, s0.bed_mass, Hz,
                                   z_w, bustr, torch.zeros_like(bustr))
    assert float(bed1.min()) >= 0.0
    np.testing.assert_allclose(_inv(cfg, grid, t1, bed1, Hz)[0],
                               _inv(cfg, grid, s0.t, s0.bed_mass, Hz)[0],
                               rtol=1e-12)
    H = cfg.halo
    assert float(t1[2][0, H + 3, H + 3]) > float(s0.t[2][0, H + 3, H + 3])
    # no stress, a clean column: nothing moves
    cfg0, grid0, s00, _, Hz0, z_w0 = _setup(tsed.SedParams())
    zero = torch.zeros_like(s00.zeta)
    t2, bed2 = tsed.apply_sediment(cfg0, grid0, cfg0.sed_params, s00.t,
                                   s00.bed_mass, Hz0, z_w0, zero, zero)
    np.testing.assert_allclose(t2.numpy(), s00.t.numpy(), atol=1e-15)
    np.testing.assert_allclose(bed2.numpy(), s00.bed_mass.numpy(),
                               atol=1e-15)


def test_bedload_mpm_conserves_in_periodic_channel():
    p = tsed.SedParams(Wsed=(0.0,), Erate=(0.0,), bedload=True,
                       bedload_coeff=0.5)
    cfg, grid, s0, _, Hz, z_w = _setup(p)
    H = cfg.halo
    jj = torch.arange(s0.zeta.shape[-2], dtype=torch.float64)[:, None]
    ii = torch.arange(s0.zeta.shape[-1], dtype=torch.float64)[None, :]
    bustr = bc.fill_halo(cfg, 2.0e-3 * (
        1.0 + 0.5 * torch.sin(2 * np.pi * ii / cfg.Lm)) *
        torch.exp(-((jj - H - cfg.Mm / 2) / cfg.Mm) ** 2))
    bvstr = bc.fill_halo(cfg, 5.0e-4 * torch.cos(2 * np.pi * ii / cfg.Lm) *
                         torch.ones_like(jj * ii))
    bed, t = s0.bed_mass, s0.t
    tot0 = _inv(cfg, grid, t, bed, Hz)[0]
    for _ in range(5):
        t, bed = tsed.apply_sediment(cfg, grid, p, t, bed, Hz, z_w, bustr,
                                     bvstr)
    np.testing.assert_allclose(_inv(cfg, grid, t, bed, Hz)[0], tot0,
                               rtol=1e-11)
    top = bed[0, 0, H:H + cfg.Mm, H:H + cfg.Lm].numpy()
    assert top.std() > 1e-6 and top.min() >= 0.0


def test_bed_layers_borrow_and_split():
    p = tsed.SedParams(Nbed=3, newlayer_thick=0.01)
    cfg, grid, s0, _, _, _ = _setup(p)
    shp = s0.zeta.shape
    unit = p.Srho[0] * (1.0 - p.poros)       # kg/m2 a metre

    def bed_of(*thick):
        return torch.stack([torch.full((1,) + shp, th * unit,
                                       dtype=torch.float64)
                            for th in thick])

    iactv = torch.full(shp, 0.02, dtype=torch.float64)
    bed = bed_of(0.001, 0.05, 0.05)           # a thin top: borrow
    out = tsed._bed_layers(cfg, p, bed, iactv)
    np.testing.assert_allclose(float(out[0, 0, 3, 3]) / unit, 0.02,
                               rtol=1e-9)
    np.testing.assert_allclose(float(out.sum()), float(bed.sum()),
                               rtol=1e-12)
    bed = bed_of(0.2, 0.01, 0.01)             # a thick top: split, merge
    out = tsed._bed_layers(cfg, p, bed, iactv)
    for layer, th in enumerate((0.02, 0.18, 0.02)):
        np.testing.assert_allclose(float(out[layer, 0, 3, 3]) / unit, th,
                                   rtol=1e-9)
    np.testing.assert_allclose(float(out.sum()), float(bed.sum()),
                               rtol=1e-12)


def test_sed_toy_end_to_end():
    """Suspended mud settles while the wind spins the channel up: the
    sediment (water and bed) is conserved, the bed gains.  15 steps here;
    chip_smoke.py phase 17 (d) runs roms_tpu's 30 on the card."""
    p = tsed.SedParams(Wsed=(0.001,), Erate=(0.0,))
    cfg, grid, s0, ffn, Hz, z_w = _setup(p, conc=0.1)
    tot0, wat0, sed0 = _inv(cfg, grid, s0.t, s0.bed_mass, Hz)
    s = stepping.run(cfg, grid, s0, 15, ffn)
    _, _, Hz1 = vgrid.set_depth(grid.h, s.zeta, thc_of(cfg), grid.sc_r,
                                grid.Cs_r, grid.sc_w, grid.Cs_w,
                                cfg.vtransform)
    tot1, wat1, sed1 = _inv(cfg, grid, s.t, s.bed_mass, Hz1)
    assert bool(torch.isfinite(s.t).all()) and \
        bool(torch.isfinite(s.bed_mass).all())
    assert sed1 > sed0 and wat1 < wat0
    np.testing.assert_allclose(tot1, tot0, rtol=1e-8)


def test_sed_morph_erosion_deepens_h():
    p = tsed.SedParams(Sd50=(0.0001,), Wsed=(1.0e-4,), Erate=(5.0e-3,),
                       tau_ce=(1.0e-6,), tau_cd=(1.0e-6,), sed_morph=True,
                       morph_fac=50.0)
    cfg, grid, s0, ffn = sed_toy.build(sed_toy.make_config(params=p),
                                       device="cpu")
    # a strong bottom current: the drag far above tau_ce
    s = s0.replace(u=torch.full_like(s0.u, 0.5),
                   ubar=torch.full_like(s0.zeta, 0.5))
    start = tsed.bed_thickness_total(p, s.bed_mass)
    s = stepping.run(cfg, grid, s, 5, ffn)
    H = cfg.halo
    jj, ii = slice(H, H + cfg.Mm), slice(H, H + cfg.Lm)
    end = tsed.bed_thickness_total(p, s.bed_mass)
    assert float((end - start)[jj, ii].min()) < -1.0e-5     # net erosion
    dh = end - tsed.bed_thickness_total(p, _initial_bed_mass(cfg, "cpu"))
    assert float(dh[jj, ii].min()) < -1.0e-5                # h deepened
    assert bool(torch.isfinite(s.t).all())


def test_soulsby_bedload_runs_and_transports():
    p = tsed.SedParams(Sd50=(0.0005,), Wsed=(1.0e-3,), bedload=True,
                       bedload_method="soulsby", bedload_coeff=1.0)
    cfg, grid, s0, _ = sed_toy.build(sed_toy.make_config(params=p),
                                     device="cpu")
    full = lambda x: torch.full_like(grid.h, x)  # noqa: E731
    tau_c, tau_w, phicw = full(2.0e-4), full(1.0e-3), full(0.25 * np.pi)
    bed = s0.bed_mass
    bed2 = tsed._bedload_mpm(cfg, grid, p, bed, full(1.2e-3), full(2.0e-4),
                             full(0.0), tau_c=tau_c, tau_wav=tau_w,
                             phicw=phicw)
    d = (bed2[0, 0] - bed[0, 0]).numpy()
    H = cfg.halo
    assert np.isfinite(d).all()
    assert np.abs(d[H + 2:-H - 2, H + 2:-H - 2]).max() < 1e-12
    x = torch.linspace(0.5, 1.5, grid.h.shape[1],
                       dtype=torch.float64)[None, :]
    bed3 = tsed._bedload_mpm(cfg, grid, p, bed, full(1.2e-3), full(2.0e-4),
                             full(0.0), tau_c=tau_c, tau_wav=tau_w * x,
                             phicw=phicw)
    db = (bed3[0, 0] - bed[0, 0]).numpy()
    assert db[H + 3:-H - 3, H + 3:-H - 3].min() < -1e-12
    assert np.isfinite(db).all()
