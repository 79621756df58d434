"""Pieces of the fast barotropic engine (counterpart of
``roms_tpu/ops/step2d.py``; step2d_LF_AM3.h).

Fast2DState carries the rotating storage of the reference's fast loop as
named fields.  depth_fluxes, _rhs_momentum and _step_momentum are the
building blocks of the fast loop; the loop itself, on the configuration
subset its kernel covers, lives beside that kernel in ops/step2d_cuda.py.
The general loop (wetting-drying, open boundaries, sources, climatology)
is not ported.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch

from .. import constants as C
from ..config import Config
from ..grid import Grid
from . import bc
from .stencil import ip1, im1, jp1, jm1, at_u, at_v, at_p

FS_FIELDS = ("zeta_n", "zeta_nm1", "ubar_n", "ubar_nm1", "vbar_n",
             "vbar_nm1", "rzeta_n", "rzeta_nm1", "rubar_n", "rubar_nm1",
             "rvbar_n", "rvbar_nm1", "Zt_avg1", "DU_avg1", "DV_avg1",
             "DU_avg2", "DV_avg2")


@dataclass
class Fast2DState:
    """Carried state of the fast loop (all (Ny,Nx) padded tensors):
    accepted fast levels n and n-1, the predictor RHS history, and the
    power-law filter accumulators (mod_coupling.F:12-49)."""
    zeta_n: torch.Tensor
    zeta_nm1: torch.Tensor
    ubar_n: torch.Tensor
    ubar_nm1: torch.Tensor
    vbar_n: torch.Tensor
    vbar_nm1: torch.Tensor
    rzeta_n: torch.Tensor
    rzeta_nm1: torch.Tensor
    rubar_n: torch.Tensor
    rubar_nm1: torch.Tensor
    rvbar_n: torch.Tensor
    rvbar_nm1: torch.Tensor
    Zt_avg1: torch.Tensor
    DU_avg1: torch.Tensor
    DV_avg1: torch.Tensor
    DU_avg2: torch.Tensor
    DV_avg2: torch.Tensor

    def replace(self, **kw) -> "Fast2DState":
        return dataclasses.replace(self, **kw)


def depth_fluxes(grid: Grid, zeta, ubar, vbar):
    """Total depth and vertically integrated mass fluxes
    (step2d_LF_AM3.h:499-516)."""
    Drhs = zeta + grid.h
    DUon = ubar * at_u(Drhs) * grid.on_u
    DVom = vbar * at_v(Drhs) * grid.om_v
    return Drhs, DUon, DVom


def _g(cfg: Config) -> float:
    return cfg.g_override if cfg.g_override is not None else C.g


def _rhs_momentum(cfg: Config, grid: Grid, ubar, vbar, Drhs, DUon, DVom,
                  gzeta, gzeta2):
    """RHS of the 2-D momentum equations (step2d_LF_AM3.h:929-1790 under
    SOLVE3D): surface-slope pressure gradient, 4th-order advection,
    Coriolis, curvilinear terms and harmonic viscosity."""
    if not cfg.solve3d:
        raise NotImplementedError("2-D-only mode (main2d) fast step")
    H = cfg.halo
    h = grid.h
    g = _g(cfg)
    sixth = 1.0 / 6.0

    # --- surface-slope pressure gradient (:936-1027) ---
    rhs_ubar = 0.5 * g * grid.on_u * (
        (im1(h) + h) * (im1(gzeta) - gzeta) + (im1(gzeta2) - gzeta2))
    rhs_vbar = 0.5 * g * grid.om_v * (
        (jm1(h) + h) * (jm1(gzeta) - gzeta) + (jm1(gzeta2) - gzeta2))

    # --- 4th-order centered advection (:1079-1287) ---
    if cfg.uv_adv:
        gr = im1(ubar) - 2.0 * ubar + ip1(ubar)
        Dg = im1(DUon) - 2.0 * DUon + ip1(DUon)
        gr = bc.extrap_west(cfg, gr, H)
        Dg = bc.extrap_west(cfg, Dg, H)
        gr = bc.extrap_east(cfg, gr, H + cfg.Lm)
        Dg = bc.extrap_east(cfg, Dg, H + cfg.Lm)
        UFx = 0.25 * (ubar + ip1(ubar) - sixth * (gr + ip1(gr))) * \
            (DUon + ip1(DUon) - sixth * (Dg + ip1(Dg)))

        gr = jm1(ubar) - 2.0 * ubar + jp1(ubar)
        gr = bc.extrap_south(cfg, gr, H - 1)
        gr = bc.extrap_north(cfg, gr, H + cfg.Mm)
        Dg = im1(DVom) - 2.0 * DVom + ip1(DVom)
        UFe = 0.25 * (ubar + jm1(ubar) - sixth * (gr + jm1(gr))) * \
            (DVom + im1(DVom) - sixth * (Dg + im1(Dg)))

        gr = im1(vbar) - 2.0 * vbar + ip1(vbar)
        gr = bc.extrap_west(cfg, gr, H - 1)
        gr = bc.extrap_east(cfg, gr, H + cfg.Lm)
        Dg = jm1(DUon) - 2.0 * DUon + jp1(DUon)
        VFx = 0.25 * (vbar + im1(vbar) - sixth * (gr + im1(gr))) * \
            (DUon + jm1(DUon) - sixth * (Dg + jm1(Dg)))

        gr = jm1(vbar) - 2.0 * vbar + jp1(vbar)
        Dg = jm1(DVom) - 2.0 * DVom + jp1(DVom)
        gr = bc.extrap_south(cfg, gr, H)
        Dg = bc.extrap_south(cfg, Dg, H)
        gr = bc.extrap_north(cfg, gr, H + cfg.Mm)
        Dg = bc.extrap_north(cfg, Dg, H + cfg.Mm)
        VFe = 0.25 * (vbar + jp1(vbar) - sixth * (gr + jp1(gr))) * \
            (DVom + jp1(DVom) - sixth * (Dg + jp1(Dg)))

        rhs_ubar = rhs_ubar - (UFx - im1(UFx)) - (jp1(UFe) - UFe)
        rhs_vbar = rhs_vbar - (ip1(VFx) - VFx) - (VFe - jm1(VFe))

    # --- Coriolis (:1288-1326) ---
    if cfg.uv_cor:
        cor = 0.5 * Drhs * grid.fomn
        UFxc = cor * (vbar + jp1(vbar))
        VFec = cor * (ubar + ip1(ubar))
        rhs_ubar = rhs_ubar + 0.5 * (UFxc + im1(UFxc))
        rhs_vbar = rhs_vbar - 0.5 * (VFec + jm1(VFec))

    # --- curvilinear metric advection terms (:1330-1403) ---
    if cfg.curvgrid and cfg.uv_adv:
        cff = 0.5 * (vbar + jp1(vbar)) * grid.dndx - \
            0.5 * (ubar + ip1(ubar)) * grid.dmde
        cffu = 0.5 * Drhs * cff * (ubar + ip1(ubar))
        cffv = 0.5 * Drhs * cff * (vbar + jp1(vbar))
        rhs_ubar = rhs_ubar + 0.5 * (cffv + im1(cffv))
        rhs_vbar = rhs_vbar - 0.5 * (cffu + jm1(cffu))

    # --- harmonic viscosity (:1405-1474) ---
    if cfg.uv_vis2 and cfg.visc2 != 0.0:
        pm, pn = grid.pm, grid.pn
        Drhs_p = at_p(Drhs)
        cff_r = cfg.visc2 * Drhs * 0.5 * (
            (pm / pn) * ((pn + ip1(pn)) * ip1(ubar) - (im1(pn) + pn) * ubar) -
            (pn / pm) * ((pm + jp1(pm)) * jp1(vbar) - (jm1(pm) + pm) * vbar))
        UFxv = grid.on_r * grid.on_r * cff_r
        VFev = grid.om_r * grid.om_r * cff_r

        sum_pm = im1(jm1(pm)) + im1(pm) + jm1(pm) + pm
        sum_pn = im1(jm1(pn)) + im1(pn) + jm1(pn) + pn
        cff_p = cfg.visc2 * Drhs_p * 0.5 * (
            (sum_pm / sum_pn) *
            ((jm1(pn) + pn) * vbar - (im1(jm1(pn)) + im1(pn)) * im1(vbar)) +
            (sum_pn / sum_pm) *
            ((im1(pm) + pm) * ubar - (im1(jm1(pm)) + jm1(pm)) * jm1(ubar)))
        cff_p = cff_p * grid.pmask
        om_p = 4.0 / sum_pm
        on_p = 4.0 / sum_pn
        UFev = om_p * om_p * cff_p
        VFxv = on_p * on_p * cff_p

        rhs_ubar = rhs_ubar + \
            0.5 * (im1(pn) + pn) * (UFxv - im1(UFxv)) + \
            0.5 * (im1(pm) + pm) * (jp1(UFev) - UFev)
        rhs_vbar = rhs_vbar + \
            0.5 * (jm1(pn) + pn) * (ip1(VFxv) - VFxv) - \
            0.5 * (jm1(pm) + pm) * (VFev - jm1(VFev))
    return rhs_ubar, rhs_vbar


def _step_momentum(cfg: Config, grid: Grid, u_kstp, v_kstp, Dstp, Dnew,
                   dtau_u, dtau_v):
    """ubar(knew) = (ubar(kstp)*(Dstp_i+Dstp_{i-1}) + cff*dtau) /
    (Dnew_i+Dnew_{i-1}) with cff = (pm_i+pm_{i-1})*(pn_i+pn_{i-1})
    (step2d_LF_AM3.h:2093-2258); dtau_* are the time-combined RHS."""
    pm, pn = grid.pm, grid.pn
    ubar_new = (u_kstp * (Dstp + im1(Dstp)) +
                (pm + im1(pm)) * (pn + im1(pn)) * dtau_u) / \
        (Dnew + im1(Dnew))
    ubar_new = ubar_new * grid.umask
    vbar_new = (v_kstp * (Dstp + jm1(Dstp)) +
                (pm + jm1(pm)) * (pn + jm1(pn)) * dtau_v) / \
        (Dnew + jm1(Dnew))
    vbar_new = vbar_new * grid.vmask
    return ubar_new, vbar_new
