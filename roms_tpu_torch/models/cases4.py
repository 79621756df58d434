"""Curvilinear and file-driven coastal cases (counterpart of the
LAB_CANYON, INLET_TEST and TEST_HEAD builders of
``roms_tpu/models/cases4.py``).

 * lab_canyon - LAB_CANYON (lab_canyon.h; ana_grid.h:480-511,687-700,
   811-821 polar annulus; ana_initial.h:678-685 linear stratification):
   the reference application whose analytic grid is curvilinear (polar
   metrics, nonuniform azimuthal spacing, angler = theta), periodic
   north-south.  As in roms_tpu, the oscillating-table rotation of
   ana_spinning.h is not applied: f is the constant 4 pi / 25.
 * channel_neck - CHANNEL_NECK (channel_neck.h; ana_initial.h:586-594): a
   masked channel with a neck constriction and viscosity rotated to
   geopotentials (MIX_GEO_UV).  The reference grid is a file that is not
   shipped; the neck here is roms_tpu's analytic stand-in.
 * inlet_test - INLET_TEST (inlet_test.h; grid from
   Data/ROMS/Grid/inlet_test_grid.nc; ana_fsobc.h:77-85 semidiurnal
   north-boundary tide): wetting-drying tidal inlet, GLS k-epsilon, no
   SWAN or sediment.
 * test_head - TEST_HEAD (test_head.h; grid from
   Data/ROMS/Grid/test_head_curv_grd.nc): curvilinear headland with
   wetting-drying and an analytic M2 elevation at the open west boundary
   in place of the SSH/UV tide files, no SWAN or sediment.

Each case has ``<case>_config(...)`` (the published sizes and settings as
defaults) and ``<case>(cfg=None, device=cuda)``, which returns (cfg, grid,
state0, forcing_fn).  INLET_TEST and TEST_HEAD read their grid from
`grid_path` (by default the reference's file under REF_GRID_DIR, the
repository's Data/ROMS/Grid) and take Lm and Mm from it; without the file
they raise FileNotFoundError naming it.
"""

from __future__ import annotations

import dataclasses
import math
import os

import numpy as np
import torch

from ..config import (Config, LBC, BC_CHAPMAN_IMPLICIT, BC_CLOSED,
                      BC_FLATHER, BC_GRADIENT, BC_PERIODIC)
from ..grid import build_curvilinear_grid, build_grid, hc_of, torch_dtype
from .. import vgrid
from ..state import initial_state
from ..ops import bc

# where the reference's grid files go when they are added to the
# repository (ROMS's Data/ROMS/Grid layout); none is there yet
REF_GRID_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), "Data", "ROMS", "Grid")


# ---------------------------------------------------------------------------
# LAB_CANYON
# ---------------------------------------------------------------------------
def lab_canyon_config(Lm: int = 110, Mm: int = 250, N: int = 25,
                      dt: float = 0.01, ndtfast: int = 20,
                      dtype: str = "float64") -> Config:
    """LAB_CANYON (lab_canyon.h; roms_lab_canyon.in 110x250x25, DT 0.01 s):
    closed east-west, periodic north-south, constant mixing (vmix
    "none"), linear EOS, linear drag."""
    per = LBC(BC_CLOSED, BC_PERIODIC, BC_CLOSED, BC_PERIODIC)
    return Config(
        name="lab_canyon", Lm=Lm, Mm=Mm, N=N, ntracers=1,
        ew_periodic=False, ns_periodic=True,
        dt=dt, ndtfast=ndtfast,
        uv_adv=True, uv_cor=True, curvgrid=True,
        uv_vis2=True, visc2=1.0e-5,
        ts_dif2=True, tnu2=(0.0,), ts_mix_geo=True,
        splines_vdiff=True, splines_vvisc=True,
        bottom_drag="linear", rdrg=3.0e-4,
        akv_bak=1.0e-6, akt_bak=(1.0e-6,),
        vmix="none", prsgrd_scheme="djs",
        eos="linear", R0=1027.0, T0=4.0, Tcoef=1.7e-4, Scoef=0.0,
        vtransform=1, vstretching=1, theta_s=0.01, theta_b=0.0,
        tcline=0.0,
        t_hadv=("U3",), t_vadv=("C4",),
        lbc_zeta=per, lbc_ubar=per, lbc_vbar=per,
        lbc_u=per, lbc_v=per, lbc_t=per,
        dtype=dtype)


def lab_canyon(cfg: Config | None = None,
               device: torch.device | str = torch.device("cuda")):
    """LAB_CANYON: a 0.55 m wide polar annulus of a lab tank with a canyon
    cut into its shelf, at rest with t = -659.34183 z."""
    cfg = cfg or lab_canyon_config()
    H = cfg.halo
    Lm, Mm = cfg.Lm, cfg.Mm
    Xsize = 0.55                         # annulus width (m)
    dx = Xsize / Lm
    dth = 0.01                           # azimuthal spacing parameter
    twopi = 2.0 * np.pi
    cff = (4.0 * np.pi / (dth * Mm)) - 1.0
    f0 = 4.0 * np.pi / 25.0

    # padded fractional indices: i = 1 at padded column H (ROMS interior)
    ii = np.arange(cfg.nx_tot) - H + 1.0
    jj = np.arange(cfg.ny_tot) - H + 1.0
    I, J = np.meshgrid(ii, jj)
    r = 0.35 + dx * (I - 1.0 + 0.5)
    theta = -np.pi + 0.5 * dth * (
        (cff + 1.0) * (J - 1.0 + 0.5) +
        (cff - 1.0) * (Mm / twopi) * np.sin(twopi * (J - 1.0 + 0.5) / Mm))
    xr = r * np.cos(theta)
    yr = r * np.sin(theta)
    # metrics (ana_grid.h:687-700): pm = 1/dx; pn = 1/(r * dtheta_loc)
    theta_sp = 0.5 * dth * ((cff + 1.0) +
                            (cff - 1.0) * np.cos(twopi * (J - 1.0) / Mm))
    pm = np.full_like(xr, 1.0 / dx)
    pn = 1.0 / (r * theta_sp)

    # canyon bathymetry (ana_grid.h:949-978), h in metres (lab tank)
    val1 = 0.55 - 0.15 * np.cos(np.pi * theta * 0.55 / 0.2) ** 2
    val2 = 0.15 + 0.15 * np.cos(np.pi * theta * 0.55 / 0.2) ** 2
    h_out = np.where(
        r <= 0.55, 0.025,
        np.where(r >= 0.7, 0.125,
                 0.125 - 0.1 * np.cos(0.5 * np.pi * (r - 0.55) / 0.15) ** 2))
    h_in = np.where(
        r <= val1, 0.025,
        np.where(r >= 0.7, 0.125,
                 0.125 - 0.1 * np.cos(0.5 * np.pi * (r - val1) /
                                      np.maximum(val2, 1e-12)) ** 2))
    h = np.where(np.abs(theta) >= 0.181818181818, h_out, h_in)

    grid, cfg = build_curvilinear_grid(cfg, xr, yr, pm, pn,
                                       np.full_like(xr, f0), h,
                                       angler=theta, device=device)
    # initial state (ana_initial.h:678-685): t = -659.34183 z
    z_r, _, _ = vgrid.set_depth(grid.h, torch.zeros_like(grid.h),
                                hc_of(cfg), grid.sc_r, grid.Cs_r, grid.sc_w,
                                grid.Cs_w, cfg.vtransform)
    t0 = bc.fill_halo(cfg, -659.34183 * z_r)[None]
    return cfg, grid, initial_state(cfg, device=device, t=t0), None


# ---------------------------------------------------------------------------
# CHANNEL_NECK
# ---------------------------------------------------------------------------
def channel_neck_config(Lm: int = 48, Mm: int = 16, N: int = 8,
                        dt: float = 30.0, ndtfast: int = 10,
                        dtype: str = "float64") -> Config:
    """CHANNEL_NECK (channel_neck.h): closed, momentum advection and
    Coriolis, linear drag, harmonic viscosity 50 m2/s rotated to
    geopotentials, constant mixing (vmix "none")."""
    clo = LBC(BC_CLOSED, BC_CLOSED, BC_CLOSED, BC_CLOSED)
    return Config(
        name="channel_neck", Lm=Lm, Mm=Mm, N=N, ntracers=1,
        ew_periodic=False, ns_periodic=False,
        dt=dt, ndtfast=ndtfast,
        uv_adv=True, uv_cor=True,
        uv_vis2=True, visc2=50.0, uv_mix_geo=True,
        splines_vdiff=True, splines_vvisc=True,
        bottom_drag="linear", rdrg=3.0e-4,
        akv_bak=1.0e-5, akt_bak=(1.0e-6,),
        vmix="none", prsgrd_scheme="djs",
        eos="linear", R0=1027.0, T0=20.0, Tcoef=1.7e-4, Scoef=0.0,
        theta_s=0.0, theta_b=0.0, tcline=1.0e16,
        t_hadv=("U3",), t_vadv=("C4",),
        lbc_zeta=clo, lbc_ubar=clo, lbc_vbar=clo,
        lbc_u=clo, lbc_v=clo, lbc_t=clo,
        dtype=dtype)


def channel_neck(cfg: Config | None = None,
                 device: torch.device | str = torch.device("cuda")):
    """CHANNEL_NECK: a 96 x 32 km channel 50 m deep that narrows to its
    middle third over the middle fifth of its length, t = 20 everywhere,
    and a sloshing surface 0.2 cos(pi x / Xsize) that drives water east
    through the neck."""
    cfg = cfg or channel_neck_config()
    Xsize, Esize = 96.0e3, 32.0e3

    def mask_fn(x, y, i, j, c):
        in_neck = np.abs(x - 0.5 * Xsize) < 0.1 * Xsize
        wide = np.abs(y - 0.5 * Esize) < 0.5 * Esize
        narrow = np.abs(y - 0.5 * Esize) < Esize / 6.0
        return np.where(in_neck, narrow, wide).astype(np.float64)

    grid, cfg = build_grid(cfg, Xsize, Esize, f0=1.0e-4, beta=0.0,
                           depth_fn=lambda x, y, i, j, c:
                           np.full_like(x, 50.0), mask_fn=mask_fn,
                           device=device)
    zeta0 = 0.2 * torch.cos(math.pi * grid.xr / Xsize) * grid.rmask
    t0 = torch.full((1, cfg.N, cfg.ny_tot, cfg.nx_tot), 20.0,
                    dtype=grid.h.dtype, device=grid.h.device)
    state0 = initial_state(cfg, device=device, zeta=bc.fill_halo(cfg, zeta0),
                           t=t0)
    return cfg, grid, state0, None


# ---------------------------------------------------------------------------
# the file-grid cases
# ---------------------------------------------------------------------------
def _coastal_config(name: str, lbc_zeta: LBC, lbc_uv: LBC, lbc_3d: LBC,
                    N: int, dt: float, ndtfast: int, zob: float,
                    curvgrid: bool, dtype: str) -> Config:
    """The settings INLET_TEST and TEST_HEAD share; Lm and Mm are place
    holders until the grid file gives them."""
    return Config(
        name=name, Lm=1, Mm=1, N=N, ntracers=1, dt=dt, ndtfast=ndtfast,
        ew_periodic=False, ns_periodic=False,
        uv_adv=True, uv_cor=False, curvgrid=curvgrid,
        uv_vis2=True, visc2=2.0,
        splines_vdiff=True, splines_vvisc=True,
        bottom_drag="logarithmic", zob=zob,
        akv_bak=5.0e-5, akt_bak=(5.0e-6,),
        vmix="gls", prsgrd_scheme="djs",
        eos="linear", R0=1027.0, T0=14.0, Tcoef=1.7e-4, Scoef=0.0,
        theta_s=3.0, theta_b=0.0, tcline=1.0e16,
        t_hadv=("HSIMT",), t_vadv=("HSIMT",),
        lbc_zeta=lbc_zeta, lbc_ubar=lbc_uv, lbc_vbar=lbc_uv,
        lbc_u=lbc_3d, lbc_v=lbc_3d, lbc_t=lbc_3d,
        wetdry=True, dcrit=0.1, dtype=dtype)


def _file_case(cfg: Config, grid_path: str, device):
    """(cfg, grid, state0) of a case on the grid file `grid_path`, at
    rest with t = T0; raises FileNotFoundError without the file."""
    from ..io.gridfile import load_grid
    if not os.path.isfile(grid_path):
        raise FileNotFoundError(
            f"{cfg.name}: grid file {grid_path} not found (the reference's "
            "grid, or one written with io.gridfile.save_grid)")
    kw = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)
          if f.name not in ("Lm", "Mm", "hmin", "nfast")}
    grid, cfg = load_grid(grid_path, device=device, **kw)
    t0 = torch.full((1, cfg.N, cfg.ny_tot, cfg.nx_tot), cfg.T0,
                    dtype=torch_dtype(cfg), device=grid.h.device)
    return cfg, grid, initial_state(cfg, device=device, t=t0)


def inlet_test_config(N: int = 8, dt: float = 4.0, ndtfast: int = 20,
                      dtype: str = "float64") -> Config:
    """INLET_TEST (inlet_test.h): open north boundary (Chapman implicit
    zeta, Flather ubar/vbar, gradient 3-D fields), closed elsewhere."""
    return _coastal_config(
        "inlet_test",
        LBC(BC_CLOSED, BC_CLOSED, BC_CLOSED, BC_CHAPMAN_IMPLICIT),
        LBC(BC_CLOSED, BC_CLOSED, BC_CLOSED, BC_FLATHER),
        LBC(BC_CLOSED, BC_CLOSED, BC_CLOSED, BC_GRADIENT),
        N, dt, ndtfast, 0.05, False, dtype)


def inlet_test(cfg: Config | None = None,
               device: torch.device | str = torch.device("cuda"),
               grid_path: str = REF_GRID_DIR + "/inlet_test_grid.nc"):
    """INLET_TEST: wetting-drying tidal inlet on the grid file; the
    semidiurnal elevation zeta_north = -sin(2 pi t / 12 h) at the open
    north boundary (ana_fsobc.h:77-85)."""
    cfg, grid, state0 = _file_case(cfg or inlet_test_config(), grid_path,
                                   device)
    kw = dict(dtype=torch_dtype(cfg), device=grid.h.device)

    def forcing_fn(cfg_, grid_, time):
        zn = -math.sin(2.0 * math.pi * time / (12.0 * 3600.0))
        return {"bry": {"zeta_north": torch.full((cfg_.nx_tot,), zn,
                                                 **kw)}}

    return cfg, grid, state0, forcing_fn


def test_head_config(N: int = 8, dt: float = 6.0, ndtfast: int = 20,
                     dtype: str = "float64") -> Config:
    """TEST_HEAD (test_head.h): curvilinear, open west boundary (Chapman
    implicit zeta, Flather ubar/vbar, gradient 3-D fields)."""
    return _coastal_config(
        "test_head",
        LBC(BC_CHAPMAN_IMPLICIT, BC_CLOSED, BC_CLOSED, BC_CLOSED),
        LBC(BC_FLATHER, BC_CLOSED, BC_CLOSED, BC_CLOSED),
        LBC(BC_GRADIENT, BC_CLOSED, BC_CLOSED, BC_CLOSED),
        N, dt, ndtfast, 0.02, True, dtype)


def test_head(cfg: Config | None = None,
              device: torch.device | str = torch.device("cuda"),
              grid_path: str = REF_GRID_DIR + "/test_head_curv_grd.nc"):
    """TEST_HEAD: tidal flow past a curvilinear headland with
    wetting-drying on the grid file; an analytic M2 elevation
    0.5 sin(2 pi t / 12.42 h) at the open west boundary."""
    cfg, grid, state0 = _file_case(cfg or test_head_config(), grid_path,
                                   device)
    kw = dict(dtype=torch_dtype(cfg), device=grid.h.device)

    def forcing_fn(cfg_, grid_, time):
        zw = 0.5 * math.sin(2.0 * math.pi * time / (12.42 * 3600.0))
        return {"bry": {"zeta_west": torch.full((cfg_.ny_tot,), zw, **kw)}}

    return cfg, grid, state0, forcing_fn
