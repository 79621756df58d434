"""BENCHMARK: the idealized Southern Ocean, the reference's scaling workload
(counterpart of ``roms_tpu/models/benchmark.py``).

ROMS/Include/benchmark.h, roms_benchmark1/2/3.in, ana_grid.h:243-248,
460-479,867-872,920-925, ana_initial.h:523-537, ana_winds.h:118-126: a
spherical 360x20 degree strip at 70S-50S, periodic in longitude, tanh
shelf bathymetry, JM95 EOS, KPP mixing with COARE bulk fluxes from an
analytic atmosphere, quadratic bottom drag, curvilinear metrics, rotated
(geopotential) harmonic tracer mixing.  Sizes: BENCHMARK1 512x64x30,
BENCHMARK2 1024x128x30, BENCHMARK3 2048x256x30; DT=150 s, NDTFAST=20.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import constants as C
from ..config import Config, LBC
from ..grid import build_spherical_grid, hc_of
from .. import vgrid
from ..state import initial_state
from ..ops import bc
from ..ops.bulk_flux import ana_srflux_albedo


def make_config(Lm: int = 512, Mm: int = 64, N: int = 30,
                dt: float = 150.0, ndtfast: int = 20,
                dtype: str = "float64") -> Config:
    per = LBC.periodic_ew()
    return Config(
        name="benchmark",
        Lm=Lm, Mm=Mm, N=N, ntracers=2,
        ew_periodic=True, ns_periodic=False, spherical=True,
        dt=dt, ndtfast=ndtfast, solve3d=True,
        vtransform=2, vstretching=4, theta_s=0.0, theta_b=0.0,
        tcline=400.0,
        uv_adv=True, uv_cor=True, curvgrid=True,
        uv_vis2=True, visc2=5000.0,
        ts_dif2=True, tnu2=(500.0, 500.0), ts_mix_geo=True,
        splines_vdiff=True, splines_vvisc=True,
        bottom_drag="quadratic", rdrg2=3.0e-3,
        akv_bak=1.0e-4, akt_bak=(1.0e-5, 1.0e-5),
        vmix="kpp", bulk_fluxes=True,
        prsgrd_scheme="djs",
        eos="jm95", rho0=1025.0,
        t_hadv=("U3", "U3"), t_vadv=("C4", "C4"),
        lbc_zeta=per, lbc_ubar=per, lbc_vbar=per,
        lbc_u=per, lbc_v=per, lbc_t=per,
        gamma2=1.0, dtype=dtype,
    )


def _depth_fn(lonr, latr, i, j, cfg):
    """h = 500 + 1750*(1 + tanh((68 + lat)/dy)) (ana_grid.h:920-925)."""
    dy = 20.0 / cfg.Mm
    return 500.0 + 1750.0 * (1.0 + np.tanh((68.0 + latr) / dy))


def forcing_fn(cfg: Config, grid, time: float) -> dict:
    """The analytic atmosphere (ana_winds/tair/pair/humid/cloud BENCHMARK)
    and the shortwave, computed from the grid argument: a zonal wind jet
    at 60S, 4 C air at 1025 mb, 80% humidity, 0.6 cloud cover, no rain."""
    lonr, latr = grid.xr, grid.yr
    Uwind = 15.0 * torch.exp(-(0.2 * (60.0 + latr)) ** 2)
    Vwind = torch.zeros_like(Uwind)
    Tair = torch.full_like(Uwind, 4.0)
    Pair = torch.full_like(Uwind, 1025.0)
    Hair = torch.full_like(Uwind, 0.8)
    cloud = torch.full_like(Uwind, 0.6)
    rain = torch.zeros_like(Uwind)
    tdays = time / C.day2sec
    srflx = ana_srflux_albedo(cfg, lonr, latr, Tair, Hair, cloud, tdays)
    return {"Uwind": Uwind, "Vwind": Vwind, "Tair": Tair, "Pair": Pair,
            "Hair": Hair, "cloud": cloud, "rain": rain, "srflx": srflx}


def build(cfg: Config | None = None,
          device: torch.device | str = torch.device("cuda")):
    """Returns (cfg, grid, state0, forcing_fn) with tensors on `device`."""
    cfg = cfg or make_config()
    grid, cfg = build_spherical_grid(cfg, lon_size=360.0, lat_min=-70.0,
                                     lat_size=20.0, depth_fn=_depth_fn,
                                     device=device)

    # initial stratification (ana_initial.h BENCHMARK)
    z_r, _, _ = vgrid.set_depth(grid.h, torch.zeros_like(grid.h),
                                hc_of(cfg), grid.sc_r, grid.Cs_r,
                                grid.sc_w, grid.Cs_w, cfg.vtransform)
    val1 = (44.69 / 39.382) ** 2
    val2 = val1 * (cfg.rho0 * 800.0 / C.g) * \
        (5.0e-5 / ((42.689 / 44.69) ** 2))
    temp = val2 * torch.exp(z_r / 800.0) * \
        (0.6 - 0.4 * torch.tanh(z_r / 800.0))
    salt = torch.full_like(temp, 35.0)
    t0 = torch.stack([bc.fill_halo(cfg, temp), bc.fill_halo(cfg, salt)],
                     dim=0)
    state0 = initial_state(cfg, device=device, t=t0)
    return cfg, grid, state0, forcing_fn
