"""Tracer corrector (counterpart of ``roms_tpu/ops/step3d_t.py``;
step3d_t.F): horizontal and vertical advection of the intermediate tracer
t3, implicit vertical diffusion (parabolic splines under SPLINES_VDIFF,
else the standard tridiagonal solve), point-source fluxes, nudging toward
the tracer climatology (`clm`: tclm and tnudg) and lateral BCs, open
boundaries included (obc.t3dbc with the previous level and `bry`).  MPDATA
tracers take the two-pass route: first-order upstream of t3
(step3d_t.F:408-428, 1167-1180), then the anti-diffusive corrected pass
with monotonically limited velocities (ops/mpdata.py; step3d_t.F:
1213-1318)."""

from __future__ import annotations

import torch

from ..config import Config
from ..grid import Grid
from . import bc, obc
from .advection import hadv_fluxes, vadv_flux
from .mpdata import mpdata_adiff, mpdata_corrected_fluxes
from .stencil import ip1, jp1
from .tridiag import spline_vdiff_flux, thomas_implicit


DIAG_TERMS = ("xadv", "yadv", "vadv", "vdiff")


def step3d_t(cfg: Config, grid: Grid, t_nnew, t3, Huon, Hvom, W,
             Hz_new, z_r_new, Akt, t_old=None, bry=None, sources=None,
             clm=None, want_diags: bool = False):
    """Returns the new tracers (NT,N,Ny,Nx), halo-filled.  t_old: the
    tracers at the previous level, which the open-boundary BCs read;
    clm: {"tclm": (NT,N,Ny,Nx), "tnudg": 1/s, one for all tracers or one
    a tracer}.  want_diags (DIAGNOSTICS_TS; mod_diags.F DiaTrc): also
    return {xadv, yadv, vadv, vdiff}, each (NT,N,Ny,Nx), the per-step
    concentration increments of xi, eta and vertical advection and of the
    vertical diffusion: in the interior, the new tracer is t_nnew/Hz_new
    plus their sum."""
    pmn = grid.pm * grid.pn
    oHz = 1.0 / Hz_new
    out = []
    dia = {k: [] for k in DIAG_TERMS}
    for itrc in range(cfg.ntracers):
        ltrc = min(1, itrc) if cfg.ntracers >= 2 else 0
        t_old_i = t_old[itrc] if t_old is not None else None
        if "MPDATA" in (cfg.t_hadv[itrc], cfg.t_vadv[itrc]):
            res = mpdata_corrector(
                cfg, grid, pmn, itrc, t_nnew[itrc], t3[itrc], Huon, Hvom, W,
                Hz_new, z_r_new, oHz, Akt[ltrc], t_old_i, bry, clm,
                want_diags=want_diags)
        else:
            res = tracer_corrector(
                cfg, pmn, itrc, t_nnew[itrc], t3[itrc], Huon, Hvom, W,
                Hz_new, z_r_new, oHz, Akt[ltrc], grid=grid, t_old_i=t_old_i,
                bry=bry, sources=sources, clm=clm, want_diags=want_diags)
        if want_diags:
            res, parts = res
            for k in DIAG_TERMS:
                dia[k].append(parts[k])
        out.append(res)
    t_new = torch.stack(out, dim=0)
    if want_diags:
        return t_new, {k: torch.stack(v, dim=0) for k, v in dia.items()}
    return t_new


def tracer_corrector(cfg: Config, pmn, itrc: int, tn_i, t3_i, Huon, Hvom,
                     W, Hz_new, z_r_new, oHz, Akt_l, grid=None,
                     t_old_i=None, bry=None, sources=None, clm=None,
                     want_diags: bool = False):
    """One tracer's corrector (the step3d_t.F:227-1142 loop body); HSIMT
    and the open boundaries need `grid`.  want_diags: also return the
    tracer's DIAG_TERMS increments."""
    dt = cfg.dt
    hscheme = cfg.t_hadv[itrc]
    vscheme = cfg.t_vadv[itrc]
    FX, FE = hadv_fluxes(cfg, hscheme, t3_i, Huon, Hvom, grid=grid,
                         Hz=Hz_new, dt=dt)
    if sources is not None:
        from .sources import apply_tracer_flux_sources
        FX, FE = apply_tracer_flux_sources(sources, itrc, FX, FE, Huon,
                                           Hvom)
    tn = tn_i - dt * pmn * ((ip1(FX) - FX) + (jp1(FE) - FE))

    FC = vadv_flux(vscheme, t3_i, W, Hz_new, "corrector", z_r=z_r_new,
                   pmn=pmn, dt=dt)
    tn = (tn - dt * pmn * (FC[1:] - FC[:-1])) * oHz

    pre_vd = tn
    if cfg.splines_vdiff:
        flux = spline_vdiff_flux(dt, Hz_new, oHz, Akt_l, tn)
        tn = tn + dt * oHz * (flux[1:] - flux[:-1])
    else:
        tn = thomas_implicit(dt, 1.0, Hz_new, z_r_new, Akt_l, tn * Hz_new)
    tn_new = _finalize_tracer(cfg, grid, itrc, tn, t_old_i, bry, clm, dt)
    if not want_diags:
        return tn_new
    return tn_new, {"xadv": -dt * pmn * oHz * (ip1(FX) - FX),
                    "yadv": -dt * pmn * oHz * (jp1(FE) - FE),
                    "vadv": -dt * pmn * oHz * (FC[1:] - FC[:-1]),
                    "vdiff": tn - pre_vd}


def mpdata_corrector(cfg: Config, grid: Grid, pmn, itrc: int, tn_i, t3_i,
                     Huon, Hvom, W, Hz_new, z_r_new, oHz, Akt_l,
                     t_old_i=None, bry=None, clm=None,
                     want_diags: bool = False):
    """One MPDATA tracer's corrector (step3d_t.F:408-428, 1167-1180,
    1213-1318): a first-order upstream pass of t3 in every direction, the
    anti-diffusive velocities, the corrected fluxes, then the standard
    implicit vertical diffusion on the Tunits x m field (the spline form
    needs Tunits input) and the lateral BCs.  want_diags: also return the
    DIAG_TERMS increments, the two passes' fluxes together."""
    hscheme = cfg.t_hadv[itrc]
    vscheme = cfg.t_vadv[itrc]
    if not (hscheme == "MPDATA" and vscheme == "MPDATA"):
        raise ValueError("MPDATA must be used in both directions")
    dt = cfg.dt
    FX, FE = hadv_fluxes(cfg, "U1", t3_i, Huon, Hvom)
    Ta = tn_i - dt * pmn * ((ip1(FX) - FX) + (jp1(FE) - FE))
    FC = vadv_flux("U1", t3_i, W, Hz_new, "corrector")
    Ta = bc.fill_halo(cfg, (Ta - dt * pmn * (FC[1:] - FC[:-1])) * oHz)
    Ua, Va, Wa = mpdata_adiff(cfg, grid, t3_i, Ta, Huon, Hvom, W, oHz,
                              z_r_new)
    FX2, FE2, FC2 = mpdata_corrected_fluxes(grid, Ta, Ua, Va, Wa, Hz_new)
    tn = Ta * Hz_new - dt * pmn * (
        (ip1(FX2) - FX2) + (jp1(FE2) - FE2) + (FC2[1:] - FC2[:-1]))
    pre_vd = tn * oHz
    tn = thomas_implicit(dt, 1.0, Hz_new, z_r_new, Akt_l, tn)
    tn_new = _finalize_tracer(cfg, grid, itrc, tn, t_old_i, bry, clm, dt)
    if not want_diags:
        return tn_new
    return tn_new, {
        "xadv": -dt * pmn * oHz * ((ip1(FX) - FX) + (ip1(FX2) - FX2)),
        "yadv": -dt * pmn * oHz * ((jp1(FE) - FE) + (jp1(FE2) - FE2)),
        "vadv": -dt * pmn * oHz * ((FC[1:] - FC[:-1]) +
                                   (FC2[1:] - FC2[:-1])),
        "vdiff": tn - pre_vd}


def _finalize_tracer(cfg: Config, grid, itrc: int, tn, t_old_i, bry,
                     clm=None, dt: float = 0.0):
    """Nudging toward the tracer climatology, then the lateral BCs
    (step3d_t.F:1172-1185): the simple kinds, then the open sides from the
    previous level t_old_i."""
    if clm is not None and "tclm" in clm:
        nudg = clm.get("tnudg", 0.0)
        coef = nudg[itrc] if hasattr(nudg, "__len__") else nudg
        tn = tn + dt * coef * (clm["tclm"][itrc] - tn)
    tn = bc.apply_bc_rho(cfg, cfg.lbc_t, tn)
    if t_old_i is not None and bc.has_advanced(cfg.lbc_t):
        tname = "temp" if itrc == 0 else ("salt" if itrc == 1
                                          else f"trc{itrc}")
        tn = bc.fill_halo(cfg, obc.t3dbc(cfg, grid, cfg.lbc_t, t_old_i, tn,
                                         bry, name=tname))
    return tn
