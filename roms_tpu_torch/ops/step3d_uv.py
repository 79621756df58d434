"""Momentum corrector (counterpart of ``roms_tpu/ops/step3d_uv.py``;
step3d_uv.F).

1. add the 23/12 AB3 term of the new RHS and divide by the new thicknesses,
2. implicit vertical viscosity by parabolic splines (SPLINES_VVISC),
3. replace the vertical mean with the fast-time-averaged transport DU_avg1
   (and, under WET_DRY, multiply by the averaged face masks `wet`),
4. lateral BCs (open sides through obc.u3dbc/v3dbc from the previous
   level), point sources, boundary-ring-only replacement at non-periodic
   edges,
5. ubar/vbar from DU_avg1 / (D * on_u),
6. time-centered mass fluxes corrected to integrate to DU_avg2.
"""

from __future__ import annotations

import torch

from ..config import Config
from ..grid import Grid
from . import bc, obc
from .stencil import im1, jm1
from .tridiag import spline_vdiff_flux


def corrector_cff(dt: float, iic: int) -> float:
    """0.25 dt times the AB3 weight of the new right-hand side over the
    start-up ladder: 1, 3/2, then 23/12 (step3d_uv.F)."""
    return 0.25 * dt * (1.0 if iic == 0 else (1.5 if iic == 1
                                             else 23.0 / 12.0))


def step3d_uv(cfg: Config, grid: Grid, iic: int, u_nnew, v_nnew, ru, rv,
              Hz_new, Akv, DU_avg1, DV_avg1, DU_avg2, DV_avg2,
              Huon_old, Hvom_old, u_old=None, v_old=None, bry=None,
              sources=None, z_w_new=None, wet=None):
    """Returns (u, v, ubar, vbar, Huon, Hvom), all halo-filled.  u_old and
    v_old (the previous level) feed the open-boundary BCs; `sources`
    imposes the river profile, which needs the new depths z_w_new; `wet`
    (the fast loop's averaged masks) limits u and v after the mean
    replacement (step3d_uv.F:562)."""
    dt = cfg.dt
    pm, pn = grid.pm, grid.pn
    H = cfg.halo
    L, M = cfg.Lm, cfg.Mm
    cff = corrector_cff(dt, iic)

    # ---------------- XI direction ----------------
    Hzk_u = 0.5 * (Hz_new + im1(Hz_new))
    oHz_u = 1.0 / Hzk_u
    AKu = 0.5 * (Akv + im1(Akv))
    DC0 = cff * (pm + im1(pm)) * (pn + im1(pn))
    u = (u_nnew + DC0 * ru) * oHz_u
    if cfg.splines_vvisc:
        flux = spline_vdiff_flux(dt, Hzk_u, oHz_u, AKu, u)
        u = u + dt * oHz_u * (flux[1:] - flux[:-1])
    CF0 = torch.sum(Hzk_u, dim=0)
    DCm = torch.sum(u * Hzk_u, dim=0)
    err_u = (DCm * grid.on_u - DU_avg1) / (CF0 * grid.on_u)
    u = (u - err_u) * grid.umask
    if wet is not None:
        u = u * wet["umask_wet"]

    # ---------------- ETA direction ----------------
    Hzk_v = 0.5 * (Hz_new + jm1(Hz_new))
    oHz_v = 1.0 / Hzk_v
    AKv_ = 0.5 * (Akv + jm1(Akv))
    DC0v = cff * (pm + jm1(pm)) * (pn + jm1(pn))
    v = (v_nnew + DC0v * rv) * oHz_v
    if cfg.splines_vvisc:
        flux = spline_vdiff_flux(dt, Hzk_v, oHz_v, AKv_, v)
        v = v + dt * oHz_v * (flux[1:] - flux[:-1])
    CF0v = torch.sum(Hzk_v, dim=0)
    DCmv = torch.sum(v * Hzk_v, dim=0)
    err_v = (DCmv * grid.om_v - DV_avg1) / (CF0v * grid.om_v)
    v = (v - err_v) * grid.vmask
    if wet is not None:
        v = v * wet["vmask_wet"]

    # ---------------- lateral BCs ----------------
    u = bc.apply_bc_u(cfg, cfg.lbc_u, u, gamma2=cfg.gamma2, mask=grid.umask)
    if u_old is not None and bc.has_advanced(cfg.lbc_u):
        u = bc.fill_halo(cfg, obc.u3dbc(cfg, grid, cfg.lbc_u, u_old, u, bry))
    v = bc.apply_bc_v(cfg, cfg.lbc_v, v, gamma2=cfg.gamma2, mask=grid.vmask)
    if v_old is not None and bc.has_advanced(cfg.lbc_v):
        v = bc.fill_halo(cfg, obc.v3dbc(cfg, grid, cfg.lbc_v, v_old, v, bry))
    if sources is not None and z_w_new is not None:
        from .sources import apply_uv_sources
        u, v = apply_uv_sources(sources, u, v, z_w_new, grid.on_u,
                                grid.om_v)

    # ---------------- 2D/3D coupling (step3d_uv.F:997-1213) ----------------
    DCk_u = 0.5 * grid.on_u * (Hz_new + im1(Hz_new))
    oD_u = 1.0 / torch.sum(DCk_u, dim=0)
    CFb_u = oD_u * (torch.sum(DCk_u * u, dim=0) - DU_avg1)
    ubar = oD_u * DU_avg1
    # boundary-ring-only replacement at non-periodic edges
    if not cfg.ew_periodic:
        u = bc.add_col(u, H, -CFb_u[:, H], "west")
        u = bc.add_col(u, H + L, -CFb_u[:, H + L], "east")
    if not cfg.ns_periodic:
        u = bc.add_row(u, H - 1, -CFb_u[H - 1, :], "south")
        u = bc.add_row(u, H + M, -CFb_u[H + M, :], "north")
    # time-centered mass flux corrected to integrate to DU_avg2
    Huon = 0.5 * (Huon_old + u * DCk_u)
    FCc = oD_u * (torch.sum(Huon, dim=0) - DU_avg2)
    Huon = Huon - DCk_u * FCc

    DCk_v = 0.5 * grid.om_v * (Hz_new + jm1(Hz_new))
    oD_v = 1.0 / torch.sum(DCk_v, dim=0)
    CFb_v = oD_v * (torch.sum(DCk_v * v, dim=0) - DV_avg1)
    vbar = oD_v * DV_avg1
    if not cfg.ew_periodic:
        v = bc.add_col(v, H - 1, -CFb_v[:, H - 1], "west")
        v = bc.add_col(v, H + L, -CFb_v[:, H + L], "east")
    if not cfg.ns_periodic:
        v = bc.add_row(v, H, -CFb_v[H, :], "south")
        v = bc.add_row(v, H + M, -CFb_v[H + M, :], "north")
    Hvom = 0.5 * (Hvom_old + v * DCk_v)
    FCcv = oD_v * (torch.sum(Hvom, dim=0) - DV_avg2)
    Hvom = Hvom - DCk_v * FCcv

    return (bc.fill_halo(cfg, u), bc.fill_halo(cfg, v),
            bc.fill_halo(cfg, ubar), bc.fill_halo(cfg, vbar),
            bc.fill_halo(cfg, Huon), bc.fill_halo(cfg, Hvom))
