"""Mass fluxes and diagnostic vertical velocity.

Counterpart of ``roms_tpu/ops/omega.py``: set_massflux (set_massflux.F:
121-180), omega (omega.F:120-225) and the true vertical velocity for
output, wvelocity (wvelocity.F), which no step calls.
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


def wvelocity(cfg: Config, grid: Grid, u, v, W, z_r, z_w, DU_avg1, DV_avg1):
    """True vertical velocity w (m/s) at W points for output
    (wvelocity.F): omega plus the quasi-horizontal contribution along the
    S-surfaces and the free-surface tendency spread linearly over the
    column; halo filled."""
    pm, pn = grid.pm, grid.pn
    pmn = pm * pn
    N = cfg.N
    # (Ui + Vj) * grad_s(z) at rho points and levels
    wrku = u * (z_r - im1(z_r)) * (pm + im1(pm))
    wrkv = v * (z_r - jm1(z_r)) * (pn + jm1(pn))
    vert = 0.25 * (wrku + ip1(wrku)) + 0.25 * (wrkv + jp1(wrkv))

    dz_col = z_w[-1] - z_w[0]
    tend = ((DU_avg1 - ip1(DU_avg1)) + (DV_avg1 - jp1(DV_avg1))) / dz_col

    c1, c2, c3 = 3.0 / 8.0, 3.0 / 4.0, 1.0 / 8.0
    c4, c5 = 9.0 / 16.0, 1.0 / 16.0
    # bottom (cubic extrapolation of vert)
    slope = (z_r[0] - z_w[0]) / (z_r[1] - z_r[0])
    w0 = c1 * (vert[0] - slope * (vert[1] - vert[0])) + \
        c2 * vert[0] - c3 * vert[1]
    w1 = pmn * (W[1] + tend * (z_w[1] - z_w[0])) + \
        c1 * vert[0] + c2 * vert[1] - c3 * vert[2]
    mid = pmn[None] * (W[2:N - 1] + tend[None] *
                       (z_w[2:N - 1] - z_w[0][None])) + \
        c4 * (vert[1:N - 2] + vert[2:N - 1]) - \
        c5 * (vert[0:N - 3] + vert[3:N])
    wNm1 = pmn * (W[N - 1] + tend * (z_w[N - 1] - z_w[0])) + \
        c1 * vert[N - 1] + c2 * vert[N - 2] - c3 * vert[N - 3]
    slope = (z_w[N] - z_r[N - 1]) / (z_r[N - 1] - z_r[N - 2])
    wN = pmn * tend * (z_w[N] - z_w[0]) + \
        c1 * (vert[N - 1] + slope * (vert[N - 1] - vert[N - 2])) + \
        c2 * vert[N - 1] - c3 * vert[N - 2]
    wvel = torch.cat([w0[None], w1[None], mid, wNm1[None], wN[None]], dim=0)
    return bc.fill_halo(cfg, wvel)
