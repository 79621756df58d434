"""Mass fluxes and diagnostic vertical velocity.

Counterpart of ``roms_tpu/ops/omega.py``: set_massflux (set_massflux.F:
121-180) and omega (omega.F:120-225).
"""

from __future__ import annotations

import torch

from ..config import Config, LBC, BC_GRADIENT
from ..grid import Grid
from . import bc
from .stencil import ip1, im1, jp1, jm1

_GRAD_ALL = LBC(BC_GRADIENT, BC_GRADIENT, BC_GRADIENT, BC_GRADIENT)


def set_massflux(cfg: Config, grid: Grid, u, v, Hz):
    """Huon = 0.5*(Hz_i + Hz_{i-1})*u*on_u, Hvom analog; halos filled."""
    Huon = 0.5 * (Hz + im1(Hz)) * u * grid.on_u
    Hvom = 0.5 * (Hz + jm1(Hz)) * v * grid.om_v
    return bc.fill_halo(cfg, Huon), bc.fill_halo(cfg, Hvom)


def omega(cfg: Config, grid: Grid, Huon, Hvom, z_w):
    """S-coordinate vertical mass flux W (N+1,Ny,Nx) from continuity: the
    bottom-up integral of the horizontal flux divergence with the
    moving-grid correction that makes W vanish at the free surface; halo
    filled with zero-gradient BCs (bc_w3d + exchange)."""
    N = Huon.shape[0]
    div = (ip1(Huon) - Huon) + (jp1(Hvom) - Hvom)     # (N,...) at rho
    Wk = -torch.cumsum(div, dim=0)                     # k=1..N
    wrk = Wk[N - 1] / (z_w[N] - z_w[0])
    Wcorr = Wk - wrk * (z_w[1:] - z_w[0])
    zero = torch.zeros_like(Wk[:1])
    W = torch.cat([zero, Wcorr[:-1], zero], dim=0)
    return bc.apply_bc_rho(cfg, _GRAD_ALL, W)
