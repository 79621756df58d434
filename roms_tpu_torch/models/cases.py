"""Analytic cases (counterpart of the builders of ``roms_tpu/models/cases.py``;
ROMS/Include/<app>.h with the ana_grid, ana_initial, ana_smflux and
ana_*obc fixtures and the roms_<app>.in runtime values):

 * closed and periodic basins that exercise the horizontal operators:
   BASIN (biharmonic viscosity and diffusion), DOUBLE_GYRE, GRAV_ADJ,
   SEAMOUNT (the pressure-gradient-error test), CANYON3D, OVERFLOW
   (isopycnal diffusion) and WINDBASIN;
 * regional cases with open boundaries, tides, rivers and GLS: KELVIN,
   ESTUARY_TEST and RIVERPLUME1;
 * LAKE_SIGNELL: a closed lake with MPDATA tracers, the SSW bottom
   boundary layer under wind and waves, and suspended sand.

Each case has a ``<case>_config(...)``, whose defaults are the published
sizes, and a ``<case>(cfg=None, device=cuda)`` builder that returns
(cfg, grid, state0, forcing_fn) with every tensor on `device`.  The
forcing functions build their open-boundary dict ``bry`` or their
``PointSources`` with torch on the grid's device.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .. import constants as C
from ..config import (Config, LBC, BC_CHAPMAN_EXPLICIT, BC_CLAMPED,
                      BC_CLOSED, BC_GRADIENT, BC_PERIODIC, BC_RADIATION)
from ..grid import build_grid, hc_of, torch_dtype
from .. import vgrid
from ..state import initial_state
from ..ops import bc
from ..ops.bbl import BBLParams
from ..ops.sediment import SedParams
from ..ops.sources import PointSources


def _build_flat(cfg, Xsize, Esize, f0, beta, depth, device):
    return build_grid(cfg, Xsize, Esize, f0=f0, beta=beta,
                      depth_fn=lambda x, y, i, j, c: depth + 0 * x,
                      device=device)


def _rest_z_r(cfg, grid):
    """z_r at rest (zeta = 0)."""
    z_r, _, _ = vgrid.set_depth(grid.h, torch.zeros_like(grid.h), hc_of(cfg),
                                grid.sc_r, grid.Cs_r, grid.sc_w, grid.Cs_w,
                                cfg.vtransform)
    return z_r


def _rest_state(cfg, grid, temp_fn, device, salt=None):
    """A state at rest with temperature temp_fn(z_r) and salinity `salt`
    (S0 when None); returns (state0, z_r)."""
    z_r = _rest_z_r(cfg, grid)
    temp = temp_fn(z_r)
    fields = [bc.fill_halo(cfg, temp)]
    if cfg.ntracers >= 2:
        s = salt if salt is not None else torch.full_like(temp, cfg.S0)
        fields.append(bc.fill_halo(cfg, s))
    return initial_state(cfg, device=device,
                         t=torch.stack(fields, dim=0)), z_r


def _stratification_800(cfg, z_r, scale=800.0):
    """BASIN/BENCHMARK-family stratification (ana_initial.h:523-547)."""
    val1 = (44.69 / 39.382) ** 2
    val2 = val1 * (cfg.rho0 * scale / C.g) * \
        (5.0e-5 / ((42.689 / 44.69) ** 2))
    return val2 * torch.exp(z_r / scale) * \
        (0.6 - 0.4 * torch.tanh(z_r / scale))


def _linear_config(name: str, lbc: LBC, **kw) -> Config:
    """The settings the operator cases share: one linear-EOS temperature
    tracer with U3/C4 advection, Vtransform 1 with stretching 1, and the
    same boundary kind for every field; `kw` sets the rest."""
    base = dict(name=name, ntracers=1, t_hadv=("U3",), t_vadv=("C4",),
                eos="linear", Scoef=0.0, Tcoef=1.7e-4,
                theta_s=0.0, theta_b=0.0, tcline=1e16, vtransform=1,
                vstretching=1, ew_periodic=lbc.west == BC_PERIODIC,
                ns_periodic=lbc.south == BC_PERIODIC,
                lbc_zeta=lbc, lbc_ubar=lbc, lbc_vbar=lbc, lbc_u=lbc,
                lbc_v=lbc, lbc_t=lbc)
    base.update(kw)
    return Config(**base)


# ---------------------------------------------------------------------------
# BASIN
# ---------------------------------------------------------------------------
def basin_config(Lm: int = 180, Mm: int = 140, N: int = 12, dt: float = 800.0,
                 ndtfast: int = 20, dtype: str = "float64") -> Config:
    """BASIN (basin.h; roms_basin.in): biharmonic viscosity (visc4 8e10
    m4/s) and diffusion (tnu4 2e10 m4/s), quadratic drag."""
    return _linear_config(
        "basin", LBC(), Lm=Lm, Mm=Mm, N=N, dt=dt, ndtfast=ndtfast,
        uv_vis2=False, visc2=0.0, uv_vis4=True, visc4=8.0e10,
        ts_dif4=True, tnu4=(2.0e10,), tnu2=(0.0,), akt_bak=(1.0e-7,),
        akv_bak=1.0e-5, bottom_drag="quadratic", rdrg2=3.0e-3,
        R0=1028.0, T0=10.0, theta_s=3.3, dtype=dtype)


def basin(cfg: Config | None = None,
          device: torch.device | str = torch.device("cuda")):
    """BASIN: a closed 3600 x 2800 km beta-plane box 5000 m deep at rest in
    the 800 m stratification, driven by a double-gyre wind ramped up over
    days 3-9 (ana_smflux.h BASIN; the stress at the surface rather than
    as BODYFORCE layers, as in roms_tpu)."""
    cfg = cfg or basin_config()
    Esize = 2800e3
    grid, cfg = _build_flat(cfg, 3600e3, Esize, 1.0e-4, 2.0e-11, 5000.0,
                            device)
    state0, _ = _rest_state(cfg, grid,
                            lambda z: _stratification_800(cfg, z), device)

    def forcing_fn(cfg_, grid_, time):
        val1 = 5.0e-5 * (1.0 + math.tanh((time - 6.0 * 86400.0) /
                                         (3.0 * 86400.0)))
        return {"sustr": -val1 * torch.cos(2.0 * math.pi * grid_.yr / Esize)}

    return cfg, grid, state0, forcing_fn


# ---------------------------------------------------------------------------
# DOUBLE_GYRE
# ---------------------------------------------------------------------------
def double_gyre_config(Lm: int = 54, Mm: int = 108, N: int = 4,
                       dt: float = 3600.0, ndtfast: int = 20,
                       dtype: str = "float64") -> Config:
    """DOUBLE_GYRE (double_gyre.h; roms_double_gyre.in): harmonic
    viscosity and diffusion (1280 m2/s), temperature and salinity, linear
    drag."""
    return _linear_config(
        "double_gyre", LBC(), Lm=Lm, Mm=Mm, N=N, ntracers=2,
        t_hadv=("U3", "U3"), t_vadv=("C4", "C4"), dt=dt, ndtfast=ndtfast,
        uv_vis2=True, visc2=1280.0, tnu2=(1280.0, 1280.0),
        bottom_drag="linear", rdrg=3.0e-4, R0=1028.0, T0=10.0, S0=34.5,
        theta_s=1.0, theta_b=1.0, dtype=dtype)


def double_gyre(cfg: Config | None = None,
                device: torch.device | str = torch.device("cuda")):
    """DOUBLE_GYRE: wind-driven gyres in a closed 1000 x 2000 km beta-plane
    basin 500 m deep; temperature stratified and cooling northward,
    salinity freshening upward and northward, a cosine wind."""
    cfg = cfg or double_gyre_config()
    Esize = 2000e3
    grid, cfg = _build_flat(cfg, 1000e3, Esize, 7.3e-5, 2.0e-11, 500.0,
                            device)
    val1 = (44.69 / 39.382) ** 2
    val2 = val1 * (cfg.rho0 * 100.0 / C.g) * \
        (5.0e-5 / ((42.689 / 44.69) ** 2))

    def temp_fn(z_r):
        return cfg.T0 + val2 * torch.exp(z_r / 100.0) * \
            (10.0 - 0.4 * torch.tanh(z_r / 100.0)) - 3.0 * (grid.yr / Esize)

    z_r = _rest_z_r(cfg, grid)
    salt = 34.5 - 0.001 * z_r - grid.yr / Esize
    state0, _ = _rest_state(cfg, grid, temp_fn, device, salt=salt)

    def forcing_fn(cfg_, grid_, time):
        windamp = -0.05 / cfg_.rho0
        return {"sustr": windamp * torch.cos(2.0 * math.pi * grid_.yr /
                                             Esize)}

    return cfg, grid, state0, forcing_fn


# ---------------------------------------------------------------------------
# GRAV_ADJ
# ---------------------------------------------------------------------------
def grav_adj_config(Lm: int = 128, Mm: int = 4, N: int = 40,
                    dt: float = 50.0, ndtfast: int = 20,
                    dtype: str = "float64") -> Config:
    """GRAV_ADJ (grav_adj.h): north-south periodic, no Coriolis, no bottom
    drag, harmonic viscosity 5 m2/s."""
    return _linear_config(
        "grav_adj", LBC(BC_CLOSED, BC_PERIODIC, BC_CLOSED, BC_PERIODIC),
        Lm=Lm, Mm=Mm, N=N, dt=dt, ndtfast=ndtfast, uv_cor=False,
        uv_vis2=True, visc2=5.0, tnu2=(0.0,), akv_bak=1.0e-5,
        akt_bak=(1.0e-7,), bottom_drag=None, R0=1028.0, T0=10.0,
        dtype=dtype)


def grav_adj(cfg: Config | None = None,
             device: torch.device | str = torch.device("cuda")):
    """GRAV_ADJ: lock exchange in a 64 x 2 km channel 20 m deep, the west
    half 5 degC warmer than the east."""
    cfg = cfg or grav_adj_config()
    grid, cfg = _build_flat(cfg, 64e3, 2e3, 0.0, 0.0, 20.0, device)
    i = torch.arange(cfg.nx_tot, device=grid.h.device) - cfg.halo + 1
    left = i <= (cfg.Lm + 1) // 2

    def temp_fn(z_r):
        return torch.where(left, cfg.T0 + 5.0, cfg.T0) + 0.0 * z_r

    state0, _ = _rest_state(cfg, grid, temp_fn, device)
    return cfg, grid, state0, None


# ---------------------------------------------------------------------------
# SEAMOUNT
# ---------------------------------------------------------------------------
def seamount_config(Lm: int = 49, Mm: int = 48, N: int = 13, dt: float = 60.0,
                    ndtfast: int = 20, dtype: str = "float64",
                    prsgrd_scheme: str = "djs") -> Config:
    """SEAMOUNT (seamount.h): no lateral mixing, linear drag, strongly
    stretched levels; `prsgrd_scheme` picks the pressure gradient under
    test (djs, dj, pj, pjq2 or pjq4)."""
    return _linear_config(
        "seamount", LBC(), Lm=Lm, Mm=Mm, N=N, dt=dt, ndtfast=ndtfast,
        uv_vis2=False, visc2=0.0, tnu2=(0.0,), akv_bak=1.0e-5,
        akt_bak=(1.0e-7,), bottom_drag="linear", rdrg=3.0e-4, R0=1028.0,
        T0=10.0, theta_s=5.0, theta_b=0.4, tcline=50.0,
        prsgrd_scheme=prsgrd_scheme, dtype=dtype)


def seamount(cfg: Config | None = None,
             device: torch.device | str = torch.device("cuda")):
    """SEAMOUNT: the pressure-gradient-error benchmark over a Gaussian
    seamount 4500 m tall in a 5000 m ocean (Beckmann & Haidvogel 1993),
    exponentially stratified; the exact solution is rest."""
    cfg = cfg or seamount_config()
    Xsize = Esize = 320e3

    def depth_fn(x, y, i, j, c):
        v1 = (x - 0.5 * Xsize) / 40e3
        v2 = (y - 0.5 * Esize) / 40e3
        return 5000.0 - 4500.0 * np.exp(-(v1 * v1 + v2 * v2))

    grid, cfg = build_grid(cfg, Xsize, Esize, f0=1.0e-4, beta=0.0,
                           depth_fn=depth_fn, device=device)
    state0, _ = _rest_state(
        cfg, grid, lambda z: cfg.T0 + 7.5 * torch.exp(z / 1000.0), device)
    return cfg, grid, state0, None


# ---------------------------------------------------------------------------
# CANYON3D
# ---------------------------------------------------------------------------
def canyon3d_config(Lm: int = 65, Mm: int = 48, N: int = 15,
                    dt: float = 100.0, ndtfast: int = 20,
                    dtype: str = "float64") -> Config:
    """CANYON (canyon.h): east-west periodic, harmonic viscosity and
    diffusion 5 m2/s, linear drag."""
    return _linear_config(
        "canyon3d", LBC(BC_PERIODIC, BC_CLOSED, BC_PERIODIC, BC_CLOSED),
        Lm=Lm, Mm=Mm, N=N, dt=dt, ndtfast=ndtfast, uv_vis2=True, visc2=5.0,
        tnu2=(5.0,), akv_bak=1.0e-5, akt_bak=(1.0e-7,),
        bottom_drag="linear", rdrg=3.0e-4, R0=1028.0, T0=10.0,
        theta_s=3.5, dtype=dtype)


def canyon3d(cfg: Config | None = None,
             device: torch.device | str = torch.device("cuda")):
    """CANYON3D: a shelf 20 m deep falling to 4000 m, cut by a canyon whose
    head reaches 16 km into it, in the 800 m stratification."""
    cfg = cfg or canyon3d_config()
    Xsize, Esize = 128e3, 96e3

    def depth_fn(x, y, i, j, c):
        val1 = 32000.0 - 16000.0 * (np.sin(np.pi * x / Xsize)) ** 24
        return 20.0 + 0.5 * (4000.0 - 20.0) * \
            (1.0 + np.tanh((y - val1) / 10000.0))

    grid, cfg = build_grid(cfg, Xsize, Esize, f0=1.0e-4, beta=0.0,
                           depth_fn=depth_fn, device=device)
    state0, _ = _rest_state(
        cfg, grid,
        lambda z: 3.488 * torch.exp(z / 800.0) *
        (1.0 - (2.0 / 3.0) * torch.tanh(z / 800.0)), device)
    return cfg, grid, state0, None


# ---------------------------------------------------------------------------
# OVERFLOW
# ---------------------------------------------------------------------------
def overflow_config(Lm: int = 4, Mm: int = 128, N: int = 20, dt: float = 20.0,
                    ndtfast: int = 20, dtype: str = "float64") -> Config:
    """OVERFLOW (overflow.h; roms_overflow.in 4x128x20, DT 20 s): north-south
    periodic and east-west closed (roms_overflow.in:184-191), no Coriolis,
    harmonic diffusion rotated to isopycnals (MIX_ISO_TS), quadratic
    drag."""
    return _linear_config(
        "overflow", LBC(BC_CLOSED, BC_PERIODIC, BC_CLOSED, BC_PERIODIC),
        Lm=Lm, Mm=Mm, N=N, dt=dt, ndtfast=ndtfast, uv_cor=False,
        uv_vis2=True, visc2=1.0, ts_dif2=True, tnu2=(1.0,),
        ts_mix_iso=True, splines_vdiff=True, splines_vvisc=True,
        akv_bak=1.0e-5, akt_bak=(1.0e-7,), bottom_drag="quadratic",
        rdrg2=3.0e-3, R0=1028.0, T0=10.0, dtype=dtype)


def overflow(cfg: Config | None = None,
             device: torch.device | str = torch.device("cuda")):
    """OVERFLOW: a dense gravity current down a slope: tanh shelf-to-deep
    bathymetry along eta (ana_grid.h:993-1000), cold water on the shelf
    (ana_initial.h:756-763)."""
    cfg = cfg or overflow_config()

    def depth_fn(x, y, i, j, c):
        return 200.0 + 0.5 * (4000.0 - 200.0) * \
            (1.0 + np.tanh((y - 100.0e3) / 20.0e3))

    grid, cfg = build_grid(cfg, 4.0e3, 200.0e3, f0=0.0, beta=0.0,
                           depth_fn=depth_fn, device=device)

    def temp_fn(z_r):
        return cfg.T0 - 0.5 * cfg.T0 * (
            1.0 + torch.tanh((grid.yr - 60.0e3) / 2.0e3)) + 0.0 * z_r

    state0, _ = _rest_state(cfg, grid, temp_fn, device)
    return cfg, grid, state0, None


# ---------------------------------------------------------------------------
# WINDBASIN
# ---------------------------------------------------------------------------
def windbasin_config(Lm: int = 101, Mm: int = 52, N: int = 25,
                     dt: float = 120.0, ndtfast: int = 30,
                     dtype: str = "float64") -> Config:
    """WINDBASIN (windbasin.h; roms_windbasin.in 101x52x25, DT 120 s): no
    momentum advection (no UV_ADV), no lateral mixing, quadratic drag."""
    return _linear_config(
        "windbasin", LBC(), Lm=Lm, Mm=Mm, N=N, dt=dt, ndtfast=ndtfast,
        uv_adv=False, uv_cor=True, uv_vis2=False, visc2=0.0, tnu2=(0.0,),
        splines_vdiff=True, splines_vvisc=True, akv_bak=1.0e-5,
        akt_bak=(1.0e-6,), bottom_drag="quadratic", rdrg2=3.0e-3,
        R0=1027.0, T0=20.0, dtype=dtype)


def windbasin(cfg: Config | None = None,
              device: torch.device | str = torch.device("cuda")):
    """WINDBASIN: a wind-driven homogeneous closed basin of 2 x 1 km cells,
    50 m deep, f = 1e-4, under a westward wind ramped up over two days
    (ana_smflux.h:331-343)."""
    cfg = cfg or windbasin_config()
    grid, cfg = _build_flat(cfg, 2000.0 * cfg.Lm, 1000.0 * cfg.Mm, 1.0e-4,
                            0.0, 50.0, device)
    state0, _ = _rest_state(cfg, grid, lambda z: torch.full_like(z, 20.0),
                            device)

    def forcing_fn(cfg_, grid_, time):
        tdays = time / C.day2sec
        wind = -0.1 * math.sin(math.pi * tdays / 4.0) if tdays <= 2.0 \
            else -0.1
        return {"sustr": (wind / cfg_.rho0) * torch.ones_like(grid_.h)}

    return cfg, grid, state0, forcing_fn


# ---------------------------------------------------------------------------
# KELVIN
# ---------------------------------------------------------------------------
def kelvin_config(Lm: int = 50, Mm: int = 30, N: int = 10, dt: float = 900.0,
                  ndtfast: int = 60, dtype: str = "float64") -> Config:
    """KELVIN (kelvin.h; roms_kelvin.in): west boundary clamped to an M2
    Kelvin wave, east radiation, closed north and south."""
    return Config(
        name="kelvin", Lm=Lm, Mm=Mm, N=N, ntracers=2,
        ew_periodic=False, ns_periodic=False,
        dt=dt, ndtfast=ndtfast,
        uv_vis2=False, visc2=0.0, tnu2=(20.0, 0.0),
        t_hadv=("U3", "U3"), t_vadv=("C4", "C4"),
        akv_bak=1.0e-5, akt_bak=(1.0e-6, 1.0e-6),
        bottom_drag=None,
        eos="linear", R0=1027.0, T0=14.0, S0=35.0, Tcoef=1.7e-4,
        Scoef=0.0,
        theta_s=3.0, theta_b=0.0, tcline=25.0,
        lbc_zeta=LBC(BC_CLAMPED, BC_CLOSED, BC_RADIATION, BC_CLOSED),
        lbc_ubar=LBC(BC_CLAMPED, BC_CLOSED, BC_RADIATION, BC_CLOSED),
        lbc_vbar=LBC(BC_CLAMPED, BC_CLOSED, BC_RADIATION, BC_CLOSED),
        lbc_u=LBC(BC_RADIATION, BC_GRADIENT, BC_RADIATION, BC_GRADIENT),
        lbc_v=LBC(BC_RADIATION, BC_GRADIENT, BC_RADIATION, BC_GRADIENT),
        lbc_t=LBC(BC_RADIATION, BC_GRADIENT, BC_RADIATION, BC_GRADIENT),
        dtype=dtype)


def kelvin(cfg: Config | None = None,
           device: torch.device | str = torch.device("cuda")):
    """KELVIN: coastal Kelvin wave with radiation open boundaries, a flat
    100 m f-plane basin of 20 km cells (ana_grid.h), at rest with T0/S0."""
    cfg = cfg or kelvin_config()
    grid, cfg = _build_flat(cfg, 20e3 * cfg.Lm, 20e3 * cfg.Mm, 1.0e-4, 0.0,
                            100.0, device)
    state0, _ = _rest_state(cfg, grid,
                            lambda z: torch.full_like(z, cfg.T0), device)
    f0, depth, zeta0 = 1.0e-4, 100.0, 1.0
    omega_m2 = 2.0 * math.pi / (12.42 * 3600.0)
    cph = math.sqrt(C.g * depth)

    def forcing_fn(cfg, grid, time):
        # western boundary: analytic Kelvin wave (ana_fsobc/ana_m2obc)
        y_west = grid.yr[:, cfg.halo]
        zw = zeta0 * torch.exp(-f0 * y_west / cph) * \
            math.cos(omega_m2 * time)
        ubw = zw * cph / depth
        return {"bry": {"zeta_west": zw, "ubar_west": ubw}}

    return cfg, grid, state0, forcing_fn


# ---------------------------------------------------------------------------
# ESTUARY_TEST
# ---------------------------------------------------------------------------
def estuary_config(Lm: int = 200, Mm: int = 3, N: int = 20, dt: float = 30.0,
                   ndtfast: int = 20, dtype: str = "float64") -> Config:
    """ESTUARY_TEST (estuary_test.h; roms_estuary_test.in): Chapman and
    clamped tidal boundaries, GLS k-epsilon, logarithmic drag, HSIMT."""
    return Config(
        name="estuary", Lm=Lm, Mm=Mm, N=N, ntracers=2,
        ew_periodic=False, ns_periodic=False,
        dt=dt, ndtfast=ndtfast,
        uv_vis2=False, visc2=0.0, tnu2=(0.0, 0.0),
        t_hadv=("HSIMT", "HSIMT"), t_vadv=("HSIMT", "HSIMT"),
        splines_vdiff=True, splines_vvisc=True,
        akv_bak=5.0e-6, akt_bak=(5.0e-6, 5.0e-6),
        bottom_drag="logarithmic", zob=0.005,
        vmix="gls",
        eos="linear", R0=1027.0, T0=10.0, S0=30.0,
        Tcoef=1.7e-4, Scoef=7.6e-4,
        theta_s=0.0, theta_b=0.0, tcline=1e16, vtransform=1,
        vstretching=1,
        lbc_zeta=LBC(BC_CHAPMAN_EXPLICIT, BC_CLOSED, BC_GRADIENT,
                     BC_CLOSED),
        lbc_ubar=LBC(BC_CLAMPED, BC_CLOSED, BC_CLAMPED, BC_CLOSED),
        lbc_vbar=LBC(BC_CLAMPED, BC_CLOSED, BC_CLAMPED, BC_CLOSED),
        lbc_u=LBC(BC_GRADIENT, BC_CLOSED, BC_GRADIENT, BC_CLOSED),
        lbc_v=LBC(BC_GRADIENT, BC_CLOSED, BC_GRADIENT, BC_CLOSED),
        lbc_t=LBC(BC_RADIATION, BC_CLOSED, BC_CLAMPED, BC_CLOSED),
        dtype=dtype)


def estuary(cfg: Config | None = None,
            device: torch.device | str = torch.device("cuda")):
    """ESTUARY_TEST: tidal salt-wedge estuary.  Linear 10 -> 5 m depth over
    100 km (ana_grid.h:943-948), salinity 30 in the west grading to river
    water in the east (ana_initial.h:625-641); M2 tide and the river
    outflow imposed at the west (ana_fsobc.h:106-113, ana_m2obc.h:127-147,
    the flux over the rest-depth cross-section as in the JAX case), the
    river inflow at the east (ana_m2obc.h:150-167, ana_tobc.h:98-112)."""
    cfg = cfg or estuary_config()
    Xsize = 100.0e3
    Lm, Mm = cfg.Lm, cfg.Mm

    def depth_fn(x, y, i, j, c):
        return 5.0 + (Xsize - x) / Xsize * 5.0

    grid, cfg = build_grid(cfg, Xsize, 300.0, f0=0.0, beta=0.0,
                           depth_fn=depth_fn, device=device)
    z_r = _rest_z_r(cfg, grid)
    xr3 = grid.xr.expand_as(z_r)
    salt = torch.where(xr3 <= 30.0e3, torch.full_like(z_r, 30.0),
                       torch.where(xr3 <= 80.0e3,
                                   (80.0e3 - xr3) / 50.0e3 * 30.0,
                                   torch.zeros_like(z_r)))
    t0 = torch.stack([bc.fill_halo(cfg, torch.full_like(z_r, 10.0)),
                      bc.fill_halo(cfg, salt)])
    state0 = initial_state(cfg, device=device, t=t0)

    H = cfg.halo
    ny = cfg.ny_tot
    # boundary cross-sections at rest
    h_np = grid.h.cpu().numpy()
    on_np = 1.0 / grid.pn.cpu().numpy()
    area_w = float((h_np[H:H + Mm, H] * on_np[H:H + Mm, H]).sum())
    area_e = float((h_np[H:H + Mm, H + Lm - 1] *
                    on_np[H:H + Mm, H + Lm - 1]).sum())
    riv_flow = 0.08 * 300.0 * 5.0
    tid_flow = 0.40 * 300.0 * 10.0
    kw = dict(dtype=torch_dtype(cfg), device=grid.h.device)

    def forcing_fn(cfg_, grid_, time):
        pha = 2.0 * math.pi * time / (12.0 * 3600.0)
        ones = torch.ones((ny,), **kw)
        zeros = torch.zeros((ny,), **kw)
        zw = math.sin(pha) * ones
        ubw = ((-tid_flow * math.sin(pha) - riv_flow) / area_w) * ones
        ube = (-riv_flow / area_e) * ones
        t_east = torch.stack([torch.full((cfg_.N, ny), 10.0, **kw),
                              torch.zeros((cfg_.N, ny), **kw)])
        return {"bry": {"zeta_west": zw, "ubar_west": ubw,
                        "vbar_west": zeros, "ubar_east": ube,
                        "vbar_east": zeros.clone(), "t_east": t_east}}

    return cfg, grid, state0, forcing_fn


# ---------------------------------------------------------------------------
# RIVERPLUME1
# ---------------------------------------------------------------------------
def riverplume_config(Lm: int = 39, Mm: int = 67, N: int = 13,
                      dt: float = 120.0, ndtfast: int = 20,
                      dtype: str = "float64") -> Config:
    """RIVERPLUME1 (riverplume1.h; roms_riverplume1.in): JM95, KPP with its
    bottom layer, rotated harmonic tracer mixing, quadratic drag."""
    clo = LBC()
    return Config(
        name="riverplume", Lm=Lm, Mm=Mm, N=N, ntracers=2,
        ew_periodic=False, ns_periodic=False,
        dt=dt, ndtfast=ndtfast,
        uv_vis2=True, visc2=5.0,
        ts_dif2=True, tnu2=(5.0, 5.0), ts_mix_geo=True,
        t_hadv=("U3", "U3"), t_vadv=("C4", "C4"),
        splines_vdiff=True, splines_vvisc=True,
        akv_bak=1.0e-5, akt_bak=(1.0e-6, 1.0e-6),
        bottom_drag="quadratic", rdrg2=3.0e-3,
        vmix="kpp", kpp_bottom=True,
        eos="jm95", T0=14.0, S0=32.0,
        theta_s=3.0, theta_b=0.0, tcline=25.0, vtransform=1,
        vstretching=1,
        lbc_zeta=clo, lbc_ubar=clo, lbc_vbar=clo, lbc_u=clo, lbc_v=clo,
        lbc_t=clo, dtype=dtype)


def riverplume(cfg: Config | None = None,
               device: torch.device | str = torch.device("cuda")):
    """RIVERPLUME1: river discharge into a rotating coastal basin with land
    masking.  Shelf sloping from 15 m at the coast to 150 m
    (ana_grid.h:1001-1010); land strip i <= 5 with a one-cell channel at
    j = Mm-17 (ana_mask.h:175-188); a river source Qbar = 1500 m3/s at the
    u-face (i=2, j=50) with T=10, S=0 (ana_psource.h:156-162,340-348,
    488-503; the reference's 10 vertical-influx rain cells are not
    modelled, as in the JAX case)."""
    cfg = cfg or riverplume_config()

    def depth_fn(x, y, i, j, c):
        return np.where(i <= 5, 15.0,
                        150.0 + (c.Lm - i) * (15.0 - 150.0) /
                        (c.Lm - 6.0))

    def mask_fn(x, y, i, j, c):
        land = (i <= 5) & ((j <= c.Mm - 18) | (j >= c.Mm - 16))
        return np.where(land, 0.0, 1.0)

    grid, cfg = build_grid(cfg, 58.5e3, 201.0e3, f0=1.0e-4, beta=0.0,
                           depth_fn=depth_fn, mask_fn=mask_fn,
                           device=device)
    z_r = _rest_z_r(cfg, grid)
    k3 = torch.arange(1, cfg.N + 1, dtype=z_r.dtype,
                      device=z_r.device)[:, None, None]
    temp = cfg.T0 + 0.01 * k3 + 0.0 * z_r
    salt = torch.full_like(temp, cfg.S0)
    state0 = initial_state(cfg, device=device, t=torch.stack(
        [bc.fill_halo(cfg, temp), bc.fill_halo(cfg, salt)]))

    H = cfg.halo
    kw = dict(dtype=torch_dtype(cfg), device=grid.h.device)
    idx = dict(dtype=torch.int64, device=grid.h.device)
    src = PointSources(
        isrc=torch.tensor([2 + H - 1], **idx),
        jsrc=torch.tensor([50 + H - 1], **idx),
        dsrc=torch.tensor([0], **idx),
        Qbar=torch.tensor([1500.0], **kw),
        Qshape=torch.full((cfg.N, 1), 1.0 / cfg.N, **kw),
        Tsrc=torch.stack([torch.full((cfg.N, 1), 10.0, **kw),
                          torch.zeros((cfg.N, 1), **kw)]))

    def forcing_fn(cfg_, grid_, time):
        return {"sources": src}

    return cfg, grid, state0, forcing_fn


# ---------------------------------------------------------------------------
# LAKE_SIGNELL
# ---------------------------------------------------------------------------
def lake_signell_config(Lm: int = 100, Mm: int = 20, N: int = 8,
                        dt: float = 60.0, ndtfast: int = 20,
                        dtype: str = "float64",
                        sediment: bool = True) -> Config:
    """LAKE_SIGNELL (lake_signell.h; roms_lake_signell.in: 100x20x8, DT =
    60 s): a closed lake, GLS k-epsilon, MPDATA tracers, the SSW bottom
    boundary layer and one sand class (sediment_lake_signell.in:207-232;
    the reference's bedload is Soulsby's, roms_tpu's case has none, as
    here)."""
    clo = LBC()
    nt = 2 + (1 if sediment else 0)
    sed = SedParams(ised0=2, Sd50=(0.001,), Srho=(2650.0,),
                    Wsed=(1.0e-3,), Erate=(1.0e-5,),
                    tau_ce=(0.07 / 1025.0,), tau_cd=(0.07 / 1025.0,),
                    poros=0.5) if sediment else None
    return Config(
        name="lake_signell", Lm=Lm, Mm=Mm, N=N, ntracers=nt,
        ew_periodic=False, ns_periodic=False,
        dt=dt, ndtfast=ndtfast,
        uv_vis2=False, visc2=0.0, tnu2=nt * (0.0,),
        t_hadv=nt * ("MPDATA",), t_vadv=nt * ("MPDATA",),
        splines_vdiff=True, splines_vvisc=True,
        akv_bak=5.0e-6, akt_bak=(5.0e-6,) * min(nt, 2),
        bottom_drag="logarithmic", zob=0.005,
        vmix="gls",
        eos="linear", R0=1027.0, T0=10.0, S0=30.0,
        Tcoef=1.7e-4, Scoef=7.6e-4,
        theta_s=0.0, theta_b=0.0, tcline=1e16, vtransform=1,
        vstretching=1,
        lbc_zeta=clo, lbc_ubar=clo, lbc_vbar=clo, lbc_u=clo, lbc_v=clo,
        lbc_t=clo,
        sediment=sediment, sed_params=sed,
        bbl="ssw",
        bbl_params=BBLParams(d50=0.001, tau_ce=0.07 / 1025.0),
        dtype=dtype)


def lake_signell(cfg: Config | None = None,
                 device: torch.device | str = torch.device("cuda")):
    """LAKE_SIGNELL: a 50 x 10 km lake whose depth grows linearly from 2 to
    18 m in eta (ana_grid.h:981-986), at rest at 10 degC and 30 psu; the
    wind stress and the wave field ramp up about hour 15 and down about
    hour 50 (ana_smflux.h:219-236, ana_wwave.h:191-202)."""
    cfg = cfg or lake_signell_config()

    def depth_fn(x, y, i, j, c):
        return 18.0 - 16.0 * (c.Mm - j) / (c.Mm - 1.0)

    grid, cfg = build_grid(cfg, 50.0e3, 10.0e3, f0=0.0, beta=0.0,
                           depth_fn=depth_fn, device=device)
    z_r = _rest_z_r(cfg, grid)
    fields = [bc.fill_halo(cfg, torch.full_like(z_r, 10.0)),
              bc.fill_halo(cfg, torch.full_like(z_r, 30.0))]
    if cfg.sediment:
        fields.append(torch.zeros_like(z_r))
    state0 = initial_state(cfg, device=device, t=torch.stack(fields))

    def forcing_fn(cfg_, grid_, time):
        th = time / 3600.0
        ramp = min(0.5 * (math.tanh((th - 15.0) / 2.0) + 1.0),
                   1.0 - 0.5 * (math.tanh((th - 50.0) / 2.0) + 1.0))
        one = torch.ones_like(grid_.h)
        return {"sustr": 0.25 / cfg_.rho0 * ramp * one,
                "Hwave": max(2.0 * 0.25 * ramp, 0.01) * one,
                "Pwave": 5.0 * one,
                "Dwave": 270.0 * C.deg2rad * one}

    return cfg, grid, state0, forcing_fn
