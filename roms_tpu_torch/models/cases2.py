"""The third batch of analytic cases (counterpart of the builders of
``roms_tpu/models/cases2.py``; ROMS/Include/<app>.h with the ana_grid,
ana_initial, ana_smflux, ana_fsobc/ana_m2obc and ana_psource fixtures and
the roms_<app>.in runtime values):

 * CHANNEL: a periodic channel with a jet in thermal-wind balance;
 * LMD_TEST and BL_TEST: KPP columns with double diffusion;
 * MIXED_LAYER: GLS with Craig-Banner wave breaking and Charnok roughness;
 * TEST_CHAN: a flume driven by ramped Chapman/Flather/clamped boundaries;
 * RIVERPLUME2: a river into a coastal current fed by wall sources;
 * WEDDELL: an ice-shelf cavity with a boundary M2 tide;
 * SED_TEST1: suspended sand in a steady open flume under MY2.5.

Each case has a ``<case>_config(...)``, whose defaults are the published
sizes, and a ``<case>(cfg=None, device=cuda)`` builder that returns
(cfg, grid, state0, forcing_fn) with every tensor on `device`.  The
deltas from the reference that roms_tpu documents are kept (rest-depth
boundary cross-sections and source shapes, the boundary-value limit of
WEDDELL's tidal ellipse, BL_TEST's uniform dx and direct wind stress).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from .. import constants as C
from ..config import (Config, GLSParams, LBC, BC_CHAPMAN_EXPLICIT,
                      BC_CLAMPED, BC_CLOSED, BC_FLATHER, BC_GRADIENT,
                      BC_RADIATION)
from ..grid import build_grid, hc_of, torch_dtype
from .. import vgrid
from ..state import initial_state
from ..ops import bc
from ..ops.bulk_flux import ana_srflux_albedo
from ..ops.sediment import SedParams
from ..ops.sources import PointSources
from .cases import _build_flat, _rest_z_r


def _fh(cfg, a):
    return bc.fill_halo(cfg, a)


# ---------------------------------------------------------------------------
# CHANNEL
# ---------------------------------------------------------------------------
def channel_config(Lm: int = 41, Mm: int = 25, N: int = 10,
                   dt: float = 1800.0, ndtfast: int = 18,
                   dtype: str = "float64") -> Config:
    """CHANNEL (channel.h; roms_channel.in): E-W periodic, harmonic
    viscosity and diffusion (100 m2/s), linear EOS in temperature, linear
    drag with RDRG = 0."""
    per = LBC.periodic_ew()
    return Config(
        name="channel", Lm=Lm, Mm=Mm, N=N, ntracers=1,
        ew_periodic=True, ns_periodic=False,
        dt=dt, ndtfast=ndtfast,
        uv_vis2=True, visc2=100.0, ts_dif2=True, tnu2=(100.0,),
        t_hadv=("U3",), t_vadv=("C4",),
        akv_bak=1.0e-5, akt_bak=(1.0e-5,),
        bottom_drag="linear", rdrg=0.0,
        eos="linear", R0=1025.0, T0=10.0, Tcoef=1.6e-4, Scoef=0.0,
        theta_s=0.0, theta_b=0.0, tcline=1e16, vtransform=2,
        vstretching=4,
        lbc_zeta=per, lbc_ubar=per, lbc_vbar=per, lbc_u=per, lbc_v=per,
        lbc_t=per, dtype=dtype)


def channel(cfg: Config | None = None,
            device: torch.device | str = torch.device("cuda")):
    """CHANNEL: a 600 x 360 km channel 500 m deep on an f-plane (f = 1e-4,
    ana_grid.h:255-260) with the jet u = u0 (1/2 + s + s^2/2)
    exp(-((y - y0)/40 km)^2) and the temperature in thermal-wind balance
    with it through erf (ana_initial.h:217-227, 422-436, 560-573).  No
    forcing."""
    cfg = cfg or channel_config()
    Esize = 360.0e3
    grid, cfg = _build_flat(cfg, 600.0e3, Esize, 1.0e-4, 0.0, 500.0,
                            device)
    z_r = _rest_z_r(cfg, grid)
    guscale, u0 = 40.0e3, 1.6
    y0 = 0.5 * Esize
    h3 = grid.h.expand_as(z_r)
    val1 = (grid.yr - y0) / guscale
    val2 = -0.5 * u0 * guscale * grid.f * math.sqrt(math.pi) / \
        (cfg.Tcoef * C.g * grid.h)
    temp = (val2 * torch.special.erf(val1) + cfg.T0)[None] * \
        (1.0 + z_r / h3)
    yu = 0.5 * (grid.yr + torch.roll(grid.yr, 1, -1))
    v1u = (yu - y0) / guscale
    s = z_r / h3            # at u points too (the depth is flat)
    u3 = u0 * (0.5 + s + 0.5 * s * s) * torch.exp(-v1u * v1u)[None]
    ubar = u0 * torch.exp(-v1u * v1u) / 6.0
    state0 = initial_state(cfg, device=device,
                           t=torch.stack([_fh(cfg, temp)]),
                           u=_fh(cfg, u3), ubar=_fh(cfg, ubar))
    return cfg, grid, state0, None


# ---------------------------------------------------------------------------
# LMD_TEST
# ---------------------------------------------------------------------------
def lmd_test_config(Lm: int = 10, Mm: int = 10, N: int = 50,
                    dt: float = 120.0, ndtfast: int = 10,
                    dtype: str = "float64") -> Config:
    """LMD_TEST (lmd_test.h; roms_lmd_test.in): doubly periodic, the whole
    KPP suite (interior Ri mixing, double diffusion, surface and bottom
    layers, nonlocal transport), JM95, quadratic drag."""
    per = LBC("Per", "Per", "Per", "Per")
    return Config(
        name="lmd_test", Lm=Lm, Mm=Mm, N=N, ntracers=2,
        ew_periodic=True, ns_periodic=True,
        dt=dt, ndtfast=ndtfast,
        uv_vis2=False, visc2=0.0, tnu2=(0.0, 0.0),
        t_hadv=("U3", "U3"), t_vadv=("C4", "C4"),
        splines_vdiff=True, splines_vvisc=True,
        akv_bak=1.0e-5, akt_bak=(1.0e-6, 1.0e-6),
        bottom_drag="quadratic", rdrg2=3.0e-3,
        vmix="kpp", kpp_bottom=True, lmd_ddmix=True,
        eos="jm95", T0=10.0, S0=35.0,
        theta_s=0.0, theta_b=0.0, tcline=1e16, vtransform=2,
        vstretching=4,
        lbc_zeta=per, lbc_ubar=per, lbc_vbar=per, lbc_u=per, lbc_v=per,
        lbc_t=per, dtype=dtype)


def lmd_test(cfg: Config | None = None,
             device: torch.device | str = torch.device("cuda")):
    """LMD_TEST: 100 x 100 km, 50 m deep, f = 1.09e-4; t = min(13, 7 +
    0.2 (z + 50)), s = 35 (ana_initial.h:700-711); an eastward wind burst
    over the first 16 h (ana_smflux.h:236-249)."""
    cfg = cfg or lmd_test_config()
    grid, cfg = _build_flat(cfg, 100.0e3, 100.0e3, 1.09e-4, 0.0, 50.0,
                            device)
    z_r = _rest_z_r(cfg, grid)
    temp = torch.clamp(7.0 + 0.2 * (z_r + 50.0), max=13.0)
    salt = torch.full_like(temp, 35.0)
    state0 = initial_state(cfg, device=device, t=torch.stack(
        [_fh(cfg, temp), _fh(cfg, salt)]))

    def forcing_fn(cfg_, grid_, time):
        amp = -0.6 * math.sin(math.pi * time / 57600.0) * \
            math.sin(2.0 * math.pi * time / 57600.0) / cfg_.rho0 \
            if time <= 57600.0 else 0.0
        return {"sustr": torch.full_like(grid_.h, amp)}

    return cfg, grid, state0, forcing_fn


# ---------------------------------------------------------------------------
# MIXED_LAYER
# ---------------------------------------------------------------------------
def mixed_layer_config(Lm: int = 10, Mm: int = 8, N: int = 30,
                       dt: float = 30.0, ndtfast: int = 20,
                       dtype: str = "float64") -> Config:
    """MIXED_LAYER (mixed_layer.h): GLS k-epsilon with Craig-Banner
    wave-breaking TKE flux and Charnok roughness, logarithmic drag,
    linear EOS.  Lm/Mm/N/DT are roms_tpu's (no reference .in pins them)."""
    clo = LBC()
    return Config(
        name="mixed_layer", Lm=Lm, Mm=Mm, N=N, ntracers=2,
        ew_periodic=False, ns_periodic=False,
        dt=dt, ndtfast=ndtfast,
        uv_vis2=False, visc2=0.0, tnu2=(0.0, 0.0),
        t_hadv=("U3", "U3"), t_vadv=("C4", "C4"),
        splines_vdiff=True, splines_vvisc=True,
        akv_bak=1.0e-5, akt_bak=(1.0e-6, 1.0e-6),
        bottom_drag="logarithmic", zob=0.02,
        vmix="gls",
        gls_params=GLSParams(craig_banner=True, charnok=True),
        eos="linear", R0=1027.0, T0=10.0, S0=35.0,
        Tcoef=1.7e-4, Scoef=7.6e-4,
        theta_s=0.0, theta_b=0.0, tcline=1e16, vtransform=1,
        vstretching=1,
        lbc_zeta=clo, lbc_ubar=clo, lbc_vbar=clo, lbc_u=clo, lbc_v=clo,
        lbc_t=clo, dtype=dtype)


def mixed_layer(cfg: Config | None = None,
                device: torch.device | str = torch.device("cuda")):
    """MIXED_LAYER: a closed 500 x 400 m box 50 m deep, f = 0; t = 10 +
    3 (z + h)/h (ana_initial.h:712-723); a constant sustr = 1e-4 m2/s2
    (ana_smflux.h:189-197)."""
    cfg = cfg or mixed_layer_config()
    grid, cfg = _build_flat(cfg, 500.0, 400.0, 0.0, 0.0, 50.0, device)
    z_r = _rest_z_r(cfg, grid)
    h3 = grid.h.expand_as(z_r)
    temp = 10.0 + 3.0 * (z_r + h3) / h3
    state0 = initial_state(cfg, device=device, t=torch.stack(
        [_fh(cfg, temp), _fh(cfg, torch.full_like(temp, cfg.S0))]))

    def forcing_fn(cfg_, grid_, time):
        return {"sustr": torch.full_like(grid_.h, 1.0e-4)}

    return cfg, grid, state0, forcing_fn


# ---------------------------------------------------------------------------
# TEST_CHAN
# ---------------------------------------------------------------------------
def test_chan_config(Lm: int = 100, Mm: int = 3, N: int = 20,
                     dt: float = 10.0, ndtfast: int = 20,
                     dtype: str = "float64") -> Config:
    """TEST_CHAN (test_chan.h; roms_test_chan.in): Chapman zeta, Flather
    (west) and clamped (east) ubar/vbar, gradient u/v/t at the open ends,
    no bottom drag, linear EOS."""
    open_uvt = LBC(BC_GRADIENT, BC_CLOSED, BC_GRADIENT, BC_CLOSED)
    return Config(
        name="test_chan", Lm=Lm, Mm=Mm, N=N, ntracers=1,
        ew_periodic=False, ns_periodic=False,
        dt=dt, ndtfast=ndtfast,
        uv_vis2=False, visc2=0.0, tnu2=(0.0,),
        t_hadv=("U3",), t_vadv=("C4",),
        splines_vdiff=True, splines_vvisc=True,
        akv_bak=5.0e-5, akt_bak=(5.0e-6,),
        bottom_drag=None,
        eos="linear", R0=1000.0, T0=20.0, Tcoef=-1.0e-4, Scoef=0.0,
        theta_s=3.0, theta_b=1.0, tcline=1e16, vtransform=1,
        vstretching=1,
        lbc_zeta=LBC(BC_CHAPMAN_EXPLICIT, BC_CLOSED,
                     BC_CHAPMAN_EXPLICIT, BC_CLOSED),
        lbc_ubar=LBC(BC_FLATHER, BC_CLOSED, BC_CLAMPED, BC_CLOSED),
        lbc_vbar=LBC(BC_FLATHER, BC_CLOSED, BC_CLAMPED, BC_CLOSED),
        lbc_u=open_uvt, lbc_v=open_uvt, lbc_t=open_uvt, dtype=dtype)


def test_chan(cfg: Config | None = None,
              device: torch.device | str = torch.device("cuda")):
    """TEST_CHAN: a 10 x 1 km flume, h = 10 + 0.404 i/(Lm+1)
    (ana_grid.h:1041-1046), at rest at t = 20; the west inflow ubar of a
    fixed transport and the east zeta ramp to -0.404 m over 150000 s
    (ana_fsobc.h:139-151, ana_m2obc.h:229-260), over the rest-depth
    cross-section as in roms_tpu."""
    cfg = cfg or test_chan_config()

    def depth_fn(x, y, i, j, c):
        return 10.0 + 0.4040 * i / (c.Lm + 1.0)

    grid, cfg = build_grid(cfg, 10000.0, 1000.0, f0=0.0, beta=0.0,
                           depth_fn=depth_fn, device=device)
    kw = dict(dtype=torch_dtype(cfg), device=grid.h.device)
    state0 = initial_state(cfg, device=device, t=torch.full(
        (1, cfg.N) + tuple(grid.h.shape), 20.0, **kw))
    H = cfg.halo
    ny = cfg.ny_tot
    h_np = grid.h.cpu().numpy()
    on_np = 1.0 / grid.pn.cpu().numpy()
    jj = slice(H, H + cfg.Mm)
    area_w = float((h_np[jj, H] * on_np[jj, H]).sum())
    width_w = float(on_np[jj, H].sum())

    def forcing_fn(cfg_, grid_, time):
        ramp = min(time / 150000.0, 1.0)
        ones = torch.ones((ny,), **kw)
        zeros = torch.zeros((ny,), **kw)
        return {"bry": {
            "zeta_west": zeros,
            "ubar_west": (width_w * 10.0 * 1.0 / area_w) * ramp * ones,
            "vbar_west": zeros.clone(),
            "zeta_east": -0.4040 * ramp * ones,
            "ubar_east": (width_w * 10.0 / area_w) * ramp * ones,
            "vbar_east": zeros.clone()}}

    return cfg, grid, state0, forcing_fn


# ---------------------------------------------------------------------------
# RIVERPLUME2
# ---------------------------------------------------------------------------
def riverplume2_config(Lm: int = 50, Mm: int = 70, N: int = 13,
                       dt: float = 120.0, ndtfast: int = 20,
                       dtype: str = "float64") -> Config:
    """RIVERPLUME2 (riverplume2.h; roms_riverplume2.in): KPP with its
    bottom layer, JM95, geopotential tracer mixing (tnu2 = 0), quadratic
    drag, Chapman/gradient open north and south boundaries."""
    open_ns = LBC(BC_CLOSED, BC_GRADIENT, BC_CLOSED, BC_GRADIENT)
    return Config(
        name="riverplume2", Lm=Lm, Mm=Mm, N=N, ntracers=2,
        ew_periodic=False, ns_periodic=False,
        dt=dt, ndtfast=ndtfast,
        uv_vis2=False, visc2=0.0,
        ts_dif2=True, tnu2=(0.0, 0.0), ts_mix_geo=True,
        t_hadv=("U3", "U3"), t_vadv=("C4", "C4"),
        splines_vdiff=True, splines_vvisc=True,
        akv_bak=5.0e-6, akt_bak=(5.0e-6, 5.0e-6),
        bottom_drag="quadratic", rdrg2=3.0e-3,
        vmix="kpp", kpp_bottom=True,
        eos="jm95", T0=4.0, S0=32.0,
        theta_s=3.0, theta_b=1.0, tcline=30.0, vtransform=2,
        vstretching=4,
        lbc_zeta=LBC(BC_CLOSED, BC_CHAPMAN_EXPLICIT, BC_CLOSED,
                     BC_CHAPMAN_EXPLICIT),
        lbc_ubar=open_ns, lbc_vbar=open_ns, lbc_u=open_ns, lbc_v=open_ns,
        lbc_t=open_ns, dtype=dtype)


def riverplume2(cfg: Config | None = None,
                device: torch.device | str = torch.device("cuda")):
    """RIVERPLUME2: a 100 x 210 km shelf from 190 m to 15 m with a land
    strip i <= 5 opened by a channel at j = Mm-10 (ana_mask.h:189-202); the
    ambient -0.05 m/s along-shore flow kept by 2 (Lm-5) v-face sources on
    the south and north walls (Qbar = -0.05 om_v h at rest) and the 1500
    m3/s fresh river at the u-face (6, 60) (ana_psource.h:175-191,
    358-382), each source's shape uniform by thickness at rest, as in
    roms_tpu."""
    cfg = cfg or riverplume2_config()
    Lm, Mm = cfg.Lm, cfg.Mm
    depth = 190.0

    def depth_fn(x, y, i, j, c):
        return np.where(i <= 5, 15.0,
                        depth + (c.Lm - i) * (15.0 - depth) / (c.Lm - 6.0))

    def mask_fn(x, y, i, j, c):
        land = (i <= 5) & ((j <= c.Mm - 11) | (j >= c.Mm - 9))
        return np.where(land, 0.0, 1.0)

    grid, cfg = build_grid(cfg, 100.0e3, 210.0e3, f0=1.0e-4, beta=0.0,
                           depth_fn=depth_fn, mask_fn=mask_fn,
                           device=device)
    z_r, _, Hz0 = vgrid.set_depth(grid.h, torch.zeros_like(grid.h),
                                  hc_of(cfg), grid.sc_r, grid.Cs_r,
                                  grid.sc_w, grid.Cs_w, cfg.vtransform)
    h3 = grid.h.expand_as(z_r)
    zob = cfg.zob
    v_log = -0.05 * torch.log((h3 + z_r) / zob) / \
        (torch.log(h3 / zob) - 1.0 + zob / h3)
    t0 = torch.stack([_fh(cfg, torch.full_like(z_r, cfg.T0)),
                      _fh(cfg, torch.full_like(z_r, cfg.S0))])
    state0 = initial_state(cfg, device=device, t=t0, v=_fh(cfg, v_log),
                           vbar=_fh(cfg, torch.full_like(grid.h, -0.05)))

    H = cfg.halo
    h_np = grid.h.cpu().numpy()
    om_np = 1.0 / grid.pm.cpu().numpy()
    isrc, jsrc, dsrc, qbar = [], [], [], []
    for i in range(6, Lm + 1):
        a = i + H - 1
        for jroms in (1, Mm + 1):
            b = jroms + H - 1
            hv = 0.5 * (h_np[b - 1, a] + h_np[b, a])
            isrc.append(a)
            jsrc.append(b)
            dsrc.append(1)
            qbar.append(-0.05 * om_np[b, a] * hv)
    isrc.append(6 + H - 1)      # the river at the first open-water u-face
    jsrc.append(60 + H - 1)
    dsrc.append(0)
    qbar.append(1500.0)
    nsrc = len(qbar)
    Hz_np = Hz0.cpu().numpy()
    qshape = np.zeros((cfg.N, nsrc))
    for k in range(cfg.N):
        for s_i in range(nsrc):
            a, b = isrc[s_i], jsrc[s_i]
            qshape[k, s_i] = Hz_np[k, b, a] / h_np[b, a]
    qshape /= qshape.sum(axis=0, keepdims=True)
    tsrc = np.zeros((2, cfg.N, nsrc))
    tsrc[0] = cfg.T0
    tsrc[1] = cfg.S0
    tsrc[1, :, -1] = 0.0        # the river is fresh
    kw = dict(dtype=torch_dtype(cfg), device=grid.h.device)
    idx = dict(dtype=torch.int64, device=grid.h.device)
    src = PointSources(
        isrc=torch.tensor(isrc, **idx), jsrc=torch.tensor(jsrc, **idx),
        dsrc=torch.tensor(dsrc, **idx), Qbar=torch.tensor(qbar, **kw),
        Qshape=torch.tensor(qshape, **kw), Tsrc=torch.tensor(tsrc, **kw))

    def forcing_fn(cfg_, grid_, time):
        return {"sources": src}

    return cfg, grid, state0, forcing_fn


# ---------------------------------------------------------------------------
# WEDDELL
# ---------------------------------------------------------------------------
def weddell_config(Lm: int = 300, Mm: int = 10, N: int = 30,
                   dt: float = 50.0, ndtfast: int = 20,
                   dtype: str = "float64") -> Config:
    """WEDDELL (weddell.h; roms_weddell.in): north-south periodic,
    Chapman/Flather west and east boundaries with radiation u/v/t,
    harmonic viscosity (50) and diffusion (10 m2/s), JM95, quadratic drag
    (also the ice-base drag)."""
    per = "Per"
    rad = LBC(BC_RADIATION, per, BC_RADIATION, per)
    return Config(
        name="weddell", Lm=Lm, Mm=Mm, N=N, ntracers=2,
        ew_periodic=False, ns_periodic=True,
        dt=dt, ndtfast=ndtfast,
        uv_vis2=True, visc2=50.0,
        ts_dif2=True, tnu2=(10.0, 10.0),
        t_hadv=("U3", "U3"), t_vadv=("C4", "C4"),
        splines_vdiff=True, splines_vvisc=True,
        akv_bak=1.0e-5, akt_bak=(1.0e-6, 1.0e-6),
        bottom_drag="quadratic", rdrg2=3.0e-3,
        eos="jm95", T0=-0.2775, S0=34.6489,
        theta_s=3.0, theta_b=0.0, tcline=50.0, vtransform=1,
        vstretching=1,
        lbc_zeta=LBC(BC_CHAPMAN_EXPLICIT, per, BC_CHAPMAN_EXPLICIT, per),
        lbc_ubar=LBC(BC_FLATHER, per, BC_FLATHER, per),
        lbc_vbar=LBC(BC_FLATHER, per, BC_FLATHER, per),
        lbc_u=rad, lbc_v=rad, lbc_t=rad, dtype=dtype)


def _weddell_zice(i):
    """The ice draft ramp (ana_grid.h:1157-1170): -340 m under the cavity
    (i <= 4), rising to 0 at i = 20."""
    return np.minimum(
        np.where(i > 20, 0.0,
                 np.where(i > 4, -340.0 + (i - 1) * (340.0 / 16.0),
                          -340.0)), 0.0)


def weddell(cfg: Config | None = None,
            device: torch.device | str = torch.device("cuda")):
    """WEDDELL: a section of 4 km cells across an ice-shelf cavity; the
    reference's piecewise shelf-to-deep bathymetry (ana_grid.h:1073-1100)
    with h the resting water-column thickness under the ice (bathymetry
    less |zice|, as vgrid.set_depth takes it); f from -79 degrees along i
    (ana_grid.h:874-880) and the grid turned by 90 degrees; at rest in the
    T0/S0 water mass (the reduced-pressure ice load makes zeta = 0 the rest
    state); the M2 tidal ellipse at the west and east boundaries through
    `bry`, ramped in over a day (ana_fsobc.h:155-180, ana_m2obc.h:300-345,
    at the boundary values as in roms_tpu)."""
    cfg = cfg or weddell_config()
    Lm, Mm = cfg.Lm, cfg.Mm
    val1, val2 = 98.80, 0.8270
    ks = np.arange(-1, 236)
    xwrk = np.empty(ks.shape)
    hwrk = np.empty(ks.shape)
    for idx, k in enumerate(ks):
        if k <= 26:
            xwrk[idx] = (k - 1) * 15.0e3
            hwrk[idx] = 375.0
        elif k <= 232:
            zwrk = -2.0 + (k - 1) * 0.020
            xwrk[idx] = (520.0 + val1 + zwrk * val1 +
                         val1 * val2 * np.log(np.cosh(zwrk))) * 1.0e3
            hwrk[idx] = -75.0 + 2198.0 * (1.0 + val2 * np.tanh(zwrk))
        else:
            xwrk[idx] = (850.0 + (k - 228) * 50.0) * 1.0e3
            hwrk[idx] = 4000.0

    def depth_fn(x, y, i, j, c):
        hbot = np.interp(x, xwrk, hwrk, left=375.0, right=4000.0)
        return hbot - np.abs(_weddell_zice(i))

    grid, cfg = build_grid(cfg, 4000.0 * Lm, 4000.0 * Mm, f0=0.0,
                           beta=0.0, depth_fn=depth_fn, device=device)
    H = cfg.halo
    i_idx = np.arange(cfg.nx_tot)[None, :] - H + 1
    dlat = 10.4 / Lm
    f = 2.0 * 7.2e-5 * np.sin((-79.0 + (i_idx - 1) * dlat) * np.pi / 180.0)
    shape = tuple(grid.h.shape)
    kw = dict(dtype=torch_dtype(cfg), device=grid.h.device)
    grid = dataclasses.replace(
        grid, f=torch.tensor(np.broadcast_to(f, shape), **kw),
        angler=torch.full_like(grid.h, 0.5 * np.pi),
        zice=torch.tensor(np.broadcast_to(_weddell_zice(i_idx), shape),
                          **kw))
    z_r, _, _ = vgrid.set_depth(grid.h, torch.zeros_like(grid.h),
                                hc_of(cfg), grid.sc_r, grid.Cs_r,
                                grid.sc_w, grid.Cs_w, cfg.vtransform,
                                zice=grid.zice)
    state0 = initial_state(cfg, device=device, t=torch.stack(
        [_fh(cfg, torch.full_like(z_r, cfg.T0)),
         _fh(cfg, torch.full_like(z_r, cfg.S0))]))
    ny = cfg.ny_tot
    deg2rad = np.pi / 180.0
    omega_m2 = 2.0 * np.pi / (12.42 * 3600.0)

    def forcing_fn(cfg_, grid_, time):
        fac = math.tanh(time / 86400.0)
        om_t = omega_m2 * time
        ones = torch.ones((ny,), **kw)
        # west boundary ellipse
        zw = fac * 0.53 * math.cos(om_t - 277.0 * deg2rad)
        major, minor = 0.1144, 0.0143
        ph_u = 318.0 * deg2rad
        ang = 125.0 * deg2rad - 0.5 * np.pi     # less angler
        ubw = fac * (major * math.cos(ang) * math.cos(om_t - ph_u) -
                     minor * math.sin(ang) * math.sin(om_t - ph_u))
        vbw = fac * (major * math.sin(ang) * math.cos(om_t - ph_u))
        # east boundary (the reference doubles the linear increments)
        val_e = 0.53 + (0.53 - 0.48)
        ze = fac * val_e * math.cos(om_t - (277.0 + 37.0) * deg2rad)
        maj_e = 0.1144 + (0.1144 - 0.013)
        min_e = 0.0143 + (0.0143 + 0.010)
        ph_ue = (318.0 - 37.0) * deg2rad
        ang_e = (125.0 + 100.0) * deg2rad - 0.5 * np.pi
        ube = fac * (maj_e * math.cos(ang_e) * math.cos(om_t - ph_ue) -
                     min_e * math.sin(ang_e) * math.sin(om_t - ph_ue))
        vbe = fac * (maj_e * math.sin(ang_e) * math.cos(om_t - ph_ue))
        return {"bry": {
            "zeta_west": zw * ones, "ubar_west": ubw * ones,
            "vbar_west": vbw * ones,
            "zeta_east": ze * ones, "ubar_east": ube * ones,
            "vbar_east": vbe * ones}}

    return cfg, grid, state0, forcing_fn


# ---------------------------------------------------------------------------
# BL_TEST
# ---------------------------------------------------------------------------
def bl_test_config(Lm: int = 39, Mm: int = 4, N: int = 30,
                   dt: float = 150.0, ndtfast: int = 30,
                   dtype: str = "float64") -> Config:
    """BL_TEST (bl_test.h; roms_bl_test.in): north-south periodic, a
    closed west wall and radiation east boundary, the whole KPP suite with
    double diffusion, JM95, quadratic drag."""
    per = "Per"
    rad = LBC(BC_CLOSED, per, BC_RADIATION, per)
    return Config(
        name="bl_test", Lm=Lm, Mm=Mm, N=N, ntracers=2,
        ew_periodic=False, ns_periodic=True,
        dt=dt, ndtfast=ndtfast,
        uv_vis2=True, visc2=0.0, tnu2=(0.0, 0.0),
        t_hadv=("U3", "U3"), t_vadv=("C4", "C4"),
        splines_vdiff=True, splines_vvisc=True,
        akv_bak=1.0e-5, akt_bak=(1.0e-6, 1.0e-6),
        bottom_drag="quadratic", rdrg2=3.0e-3,
        vmix="kpp", kpp_bottom=True, lmd_ddmix=True,
        eos="jm95", T0=17.25, S0=31.0,
        theta_s=5.0, theta_b=1.5, tcline=20.0, vtransform=2,
        vstretching=4,
        lbc_zeta=LBC(BC_CLOSED, per, BC_GRADIENT, per),
        lbc_ubar=rad, lbc_vbar=rad, lbc_u=rad, lbc_v=rad, lbc_t=rad,
        dtype=dtype)


def bl_test(cfg: Config | None = None,
            device: torch.device | str = torch.device("cuda")):
    """BL_TEST: a 100 x 5 km shelf, h = 14 + 25 (1 - exp(-pi x 1e-5)) -
    8 exp(-((x + 500)/15000)^2) (ana_grid.h:926-934), f = 9.25e-4; t = T0 +
    6.25 tanh(1.1 z + 11), s = S0 - 0.75 tanh(...) (ana_initial.h:546-558);
    a northward wind svstr = 0.3 N/m2 (ana_smflux.h:153-163) and the
    diurnal shortwave with albedo, also as the surface heat flux.  Uniform
    dx and the direct wind stress, as in roms_tpu."""
    cfg = cfg or bl_test_config()

    def depth_fn(x, y, i, j, c):
        val1 = (x + 500.0) / 15000.0
        return 14.0 + 25.0 * (1.0 - np.exp(-np.pi * x * 1.0e-5)) - \
            8.0 * np.exp(-val1 * val1)

    grid, cfg = build_grid(cfg, 100.0e3, 5.0e3, f0=9.25e-4, beta=0.0,
                           depth_fn=depth_fn, device=device)
    z_r = _rest_z_r(cfg, grid)
    val1 = torch.tanh(1.1 * z_r + 11.0)
    temp = cfg.T0 + 6.25 * val1
    salt = cfg.S0 - 0.75 * val1
    state0 = initial_state(cfg, device=device, t=torch.stack(
        [_fh(cfg, temp), _fh(cfg, salt)]))

    def forcing_fn(cfg_, grid_, time):
        zero = torch.zeros_like(grid_.h)
        srflx = ana_srflux_albedo(cfg_, zero - 70.0, zero + 35.0,
                                  zero + 20.0, zero + 0.8, zero + 0.3,
                                  time / 86400.0)
        return {"svstr": torch.full_like(grid_.h, 0.3 / cfg_.rho0),
                "srflx": srflx, "stflux": torch.stack([srflx, zero])}

    return cfg, grid, state0, forcing_fn


# ---------------------------------------------------------------------------
# SED_TEST1
# ---------------------------------------------------------------------------
def sed_test1_config(Lm: int = 100, Mm: int = 12, N: int = 10,
                     dt: float = 1.0, ndtfast: int = 20,
                     dtype: str = "float64") -> Config:
    """SED_TEST1 (sed_test1.h; roms_sed_test1.in: 100x12x10, DT = 1 s):
    MY2.5 mixing, logarithmic drag, radiation (west) and clamped (east)
    zeta, clamped ubar/vbar, and one sand class (sediment_sed_test1.in:
    d50 = 1 mm, ws = 1 mm/s, Erate = 5e-4, tau_ce = 0.1 N/m2; the
    reference also carries two mud classes) advected by HSIMT (the
    reference's U3 grows a negative front at the clamped inflow; roms_tpu's
    documented delta, kept)."""
    sed = SedParams(ised0=2, Sd50=(0.001,), Srho=(2650.0,),
                    Wsed=(1.0e-3,), Erate=(5.0e-4,),
                    tau_ce=(0.1 / 1025.0,), tau_cd=(0.1 / 1025.0,),
                    poros=0.5)
    open_uv = LBC(BC_GRADIENT, BC_CLOSED, BC_GRADIENT, BC_CLOSED)
    bar = LBC(BC_CLAMPED, BC_CLOSED, BC_CLAMPED, BC_CLOSED)
    return Config(
        name="sed_test1", Lm=Lm, Mm=Mm, N=N, ntracers=3,
        ew_periodic=False, ns_periodic=False,
        dt=dt, ndtfast=ndtfast,
        uv_vis2=False, visc2=0.0, tnu2=3 * (0.0,),
        t_hadv=("U3", "U3", "HSIMT"), t_vadv=("C4", "C4", "HSIMT"),
        splines_vdiff=True, splines_vvisc=True,
        akv_bak=5.0e-5, akt_bak=(5.0e-6, 5.0e-6),
        bottom_drag="logarithmic", zob=0.005,
        vmix="my25",
        eos="linear", R0=1027.0, T0=20.0, S0=0.0,
        Tcoef=1.7e-4, Scoef=7.6e-4,
        theta_s=1.0, theta_b=1.0, tcline=1.0, vtransform=1,
        vstretching=1,
        lbc_zeta=LBC(BC_RADIATION, BC_CLOSED, BC_CLAMPED, BC_CLOSED),
        lbc_ubar=bar, lbc_vbar=bar, lbc_u=open_uv, lbc_v=open_uv,
        lbc_t=LBC(BC_GRADIENT, BC_CLOSED, BC_CLAMPED, BC_CLOSED),
        sediment=True, sed_params=sed, dtype=dtype)


def sed_test1(cfg: Config | None = None,
              device: torch.device | str = torch.device("cuda")):
    """SED_TEST1: suspended sediment in a steady open channel, a 300 x 36 m
    flume 10 m deep whose -1 m/s flow the clamped ends hold (the reference
    drives it with u-face point sources of -360 m3/s at both ends,
    ana_psource.h:192-205,386-455; roms_tpu imposes the equivalent
    rest-depth boundary ubar, a documented delta kept here).  The initial
    u is the log-layer profile (ana_initial.h:455-468)."""
    cfg = cfg or sed_test1_config()
    grid, cfg = _build_flat(cfg, 300.0, 36.0, 0.0, 0.0, 10.0, device)
    z_r = _rest_z_r(cfg, grid)
    h3 = grid.h.expand(z_r.shape)
    zob = cfg.zob
    u_log = -1.0 * torch.log((h3 + z_r) / zob) / \
        (torch.log(h3 / zob) - 1.0 + zob / h3)
    t0 = torch.stack([_fh(cfg, torch.full_like(z_r, 20.0)),
                      _fh(cfg, torch.zeros_like(z_r)),
                      _fh(cfg, torch.zeros_like(z_r))])
    state0 = initial_state(cfg, device=device, t=t0, u=_fh(cfg, u_log),
                           ubar=_fh(cfg, torch.full_like(grid.h, -1.0)))
    kw = dict(dtype=torch_dtype(cfg), device=grid.h.device)
    ny = cfg.ny_tot

    def forcing_fn(cfg_, grid_, time):
        ub = torch.full((ny,), -1.0, **kw)
        zero = torch.zeros((ny,), **kw)
        t_e = torch.stack([torch.full((cfg_.N, ny), 20.0, **kw),
                           torch.zeros((cfg_.N, ny), **kw),
                           torch.zeros((cfg_.N, ny), **kw)])
        return {"bry": {"ubar_west": ub, "vbar_west": zero,
                        "ubar_east": ub.clone(), "vbar_east": zero.clone(),
                        "zeta_east": zero.clone(), "t_east": t_e}}

    return cfg, grid, state0, forcing_fn
