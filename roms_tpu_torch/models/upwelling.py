"""UPWELLING: the reference's default validation case (counterpart of
``roms_tpu/models/upwelling.py``).

41x80x16 EW-periodic channel with shelf bathymetry on both channel walls,
f-plane (southern hemisphere), linear EOS, along-channel wind-stress ramp
over 2 days, DT=300 s, NDTFAST=30, NTIMES=1440 (5 days); ROMS/Include/
upwelling.h, roms_upwelling.in, ana_grid.h:384-389,1047-1078,
ana_initial.h:806-825, ana_smflux.h:306-330.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .. import constants as C
from ..config import Config, LBC
from ..grid import build_grid, hc_of
from .. import vgrid
from ..state import initial_state
from ..ops import bc


def make_config(Lm: int = 41, Mm: int = 80, N: int = 16,
                dt: float = 300.0, ndtfast: int = 30,
                dtype: str = "float64") -> Config:
    per = LBC.periodic_ew()
    return Config(
        name="upwelling",
        Lm=Lm, Mm=Mm, N=N, ntracers=2,
        ew_periodic=True, ns_periodic=False,
        dt=dt, ndtfast=ndtfast,
        solve3d=True,
        vtransform=2, vstretching=4, theta_s=3.0, theta_b=0.0, tcline=25.0,
        uv_adv=True, uv_cor=True, uv_vis2=True, visc2=5.0,
        ts_dif2=True, tnu2=(0.0, 0.0),
        splines_vdiff=True, splines_vvisc=True,
        bottom_drag="linear", rdrg=3.0e-4,
        akv_bak=1.0e-5, akt_bak=(1.0e-6, 1.0e-6),
        prsgrd_scheme="djs",
        eos="linear", rho0=1025.0, R0=1027.0, T0=14.0, S0=35.0,
        Tcoef=1.7e-4, Scoef=0.0,
        t_hadv=("U3", "U3"), t_vadv=("C4", "C4"),
        lbc_zeta=per, lbc_ubar=per, lbc_vbar=per,
        lbc_u=per, lbc_v=per, lbc_t=per,
        gamma2=1.0, dtype=dtype,
    )


def _depth_fn(xr, yr, i, j, cfg):
    """EW-periodic branch of the UPWELLING bathymetry (ana_grid.h:
    1060-1073): shelf profile as a function of the cross-channel index j."""
    depth = 150.0
    val1 = np.where(j <= cfg.Mm / 2, j, cfg.Mm + 1 - j)
    return np.minimum(depth, 84.5 + 66.526 * np.tanh((val1 - 10.0) / 7.0))


def wind_stress(cfg: Config, time: float, dstart: float = 0.0) -> float:
    """Along-channel kinematic wind stress (m2/s2) at `time` seconds: a
    sine ramp over the first 2 days (ana_smflux.h:306-330)."""
    tdays = time / C.day2sec - dstart
    if tdays <= 2.0:
        return -0.1 * math.sin(math.pi * tdays / 4.0) / cfg.rho0
    return -0.1 / cfg.rho0


def build(cfg: Config | None = None,
          device: torch.device | str = torch.device("cuda")):
    """Returns (cfg, grid, state0, forcing_fn) with tensors on `device`."""
    cfg = cfg or make_config()
    Xsize = 1000.0 * cfg.Lm
    Esize = 1000.0 * cfg.Mm
    grid, cfg = build_grid(cfg, Xsize, Esize, f0=-8.26e-5, beta=0.0,
                           depth_fn=_depth_fn, device=device)

    # initial stratification T = T0 + 8*exp(z/50), S = S0 at rest
    z_r, _, _ = vgrid.set_depth(grid.h, torch.zeros_like(grid.h), hc_of(cfg),
                                grid.sc_r, grid.Cs_r, grid.sc_w, grid.Cs_w,
                                cfg.vtransform)
    temp = cfg.T0 + 8.0 * torch.exp(z_r / 50.0)
    salt = torch.full_like(temp, cfg.S0)
    t0 = torch.stack([bc.fill_halo(cfg, temp), bc.fill_halo(cfg, salt)],
                     dim=0)
    state0 = initial_state(cfg, device=device, t=t0)

    def forcing_fn(cfg, grid, time):
        return {"sustr": torch.full_like(grid.h, wind_stress(cfg, time))}

    return cfg, grid, state0, forcing_fn
