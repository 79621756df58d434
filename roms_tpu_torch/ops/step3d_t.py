"""Tracer corrector (counterpart of ``roms_tpu/ops/step3d_t.py``;
step3d_t.F): horizontal and vertical advection of the intermediate tracer
t3, implicit vertical diffusion (parabolic splines under SPLINES_VDIFF,
else the standard tridiagonal solve) and lateral BCs.  MPDATA, climatology
nudging and open boundaries are not ported."""

from __future__ import annotations

import torch

from ..config import Config
from ..grid import Grid
from . import bc
from .advection import hadv_fluxes, vadv_flux
from .stencil import ip1, jp1
from .tridiag import spline_vdiff_flux, thomas_implicit


def step3d_t(cfg: Config, grid: Grid, t_nnew, t3, Huon, Hvom, W,
             Hz_new, z_r_new, Akt):
    """Returns the new tracers (NT,N,Ny,Nx), halo-filled."""
    if bc.has_advanced(cfg.lbc_t):
        raise NotImplementedError("open-boundary tracer BCs")
    pmn = grid.pm * grid.pn
    oHz = 1.0 / Hz_new
    out = []
    for itrc in range(cfg.ntracers):
        ltrc = min(1, itrc) if cfg.ntracers >= 2 else 0
        out.append(tracer_corrector(
            cfg, pmn, itrc, t_nnew[itrc], t3[itrc], Huon, Hvom, W, Hz_new,
            z_r_new, oHz, Akt[ltrc]))
    return torch.stack(out, dim=0)


def tracer_corrector(cfg: Config, pmn, itrc: int, tn_i, t3_i, Huon, Hvom,
                     W, Hz_new, z_r_new, oHz, Akt_l):
    """One tracer's corrector (the step3d_t.F:227-1142 loop body)."""
    dt = cfg.dt
    hscheme = cfg.t_hadv[itrc]
    vscheme = cfg.t_vadv[itrc]
    if "MPDATA" in (hscheme, vscheme):
        raise NotImplementedError("MPDATA tracer advection")
    FX, FE = hadv_fluxes(cfg, hscheme, t3_i, Huon, Hvom)
    tn = tn_i - dt * pmn * ((ip1(FX) - FX) + (jp1(FE) - FE))

    FC = vadv_flux(vscheme, t3_i, W, Hz_new, "corrector")
    tn = (tn - dt * pmn * (FC[1:] - FC[:-1])) * oHz

    if cfg.splines_vdiff:
        flux = spline_vdiff_flux(dt, Hz_new, oHz, Akt_l, tn)
        tn = tn + dt * oHz * (flux[1:] - flux[:-1])
    else:
        tn = thomas_implicit(dt, 1.0, Hz_new, z_r_new, Akt_l, tn * Hz_new)
    return bc.apply_bc_rho(cfg, cfg.lbc_t, tn)
