"""Surface/bottom kinematic fluxes (counterpart of ``roms_tpu/ops/vbc.py``;
set_vbc.F): tracer flux loading and linear or quadratic bottom drag."""

from __future__ import annotations

import torch

from ..config import Config
from ..grid import Grid
from . import bc
from .stencil import im1, jm1, ip1, jp1


def set_vbc(cfg: Config, grid: Grid, u, v, t, stflux, btflux):
    """Returns (bustr, bvstr, stflx, btflx).

    u/v: 3-D velocity at nrhs; t: tracers (NT,N,Ny,Nx) at nrhs;
    stflux/btflux: raw surface/bottom tracer fluxes (NT,Ny,Nx); the
    freshwater flux E-P is multiplied by surface salinity (set_vbc.F:
    139-147).
    """
    stflx = [stflux[0]]
    btflx = [btflux[0]]
    if cfg.ntracers >= 2:
        stflx.append(stflux[1] * t[1, -1])      # EmP * surface salinity
        btflx.append(btflux[1] * t[1, 0])
        for i in range(2, cfg.ntracers):
            stflx.append(stflux[i])
            btflx.append(btflux[i])
    stflx = torch.stack(stflx, dim=0)
    btflx = torch.stack(btflx, dim=0)

    # bottom momentum stress (m2/s2) from the bottom-layer velocity
    if cfg.bottom_drag == "linear":
        bustr = cfg.rdrg * u[0]
        bvstr = cfg.rdrg * v[0]
    elif cfg.bottom_drag == "quadratic":
        # UV_QDRAG: |u_b| * rdrg2 with the 4-point averaged cross component
        ub, vb = u[0], v[0]
        v_at_u = 0.25 * (vb + jp1(vb) + im1(vb) + im1(jp1(vb)))
        u_at_v = 0.25 * (ub + ip1(ub) + jm1(ub) + jm1(ip1(ub)))
        bustr = cfg.rdrg2 * torch.sqrt(ub * ub + v_at_u * v_at_u) * ub
        bvstr = cfg.rdrg2 * torch.sqrt(u_at_v * u_at_v + vb * vb) * vb
    elif cfg.bottom_drag is None:
        bustr = torch.zeros_like(u[0])
        bvstr = torch.zeros_like(v[0])
    else:
        raise NotImplementedError(f"bottom drag {cfg.bottom_drag!r}")
    return (bc.fill_halo(cfg, bustr), bc.fill_halo(cfg, bvstr),
            stflx, btflx)
