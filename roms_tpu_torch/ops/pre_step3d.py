"""LF-AM3 predictor stage (counterpart of ``roms_tpu/ops/pre_step3d.py``;
pre_step3d.F).

Computes t3 (tracers at n+1/2), t_nnew (mass-weighted tracers started
with the surface/bottom fluxes) and u_nnew/v_nnew (mass-weighted momentum
started with the AB3 history and the stresses).  The implicit weight
lambda = 1 makes the explicit vertical-diffusion part vanish.  The step
counter iic is a host int, so every iic-dependent weight is a host float.
"""

from __future__ import annotations

import torch

from ..config import Config
from ..grid import Grid
from . import bc
from .advection import hadv_fluxes, vadv_flux
from .stencil import ip1, im1, jp1, jm1

# the schemes whose predictor takes first-order upstream fluxes and
# gamma = 1/2 (pre_step3d.F:76-100)
_UPSTREAM_PREDICTOR = ("MPDATA", "HSIMT")


def pre_step3d(cfg: Config, grid: Grid, iic: int, t, t_prev, u, v,
               Hz, z_r, Huon, Hvom, W, Akt,
               sustr, svstr, bustr, bvstr, stflx, btflx,
               ru_prev, ru_prev2, rv_prev, rv_prev2,
               srflx=None, ghats=None, swdk_w=None, sources=None):
    """Returns (t3, t_nnew, u_nnew, v_nnew)."""
    t3, t_nnew = tracer_phase(cfg, grid, iic, t, t_prev, Hz, Huon, Hvom, W,
                              Akt, stflx, btflx, srflx=srflx, ghats=ghats,
                              swdk_w=swdk_w, sources=sources)
    a1, a2 = ab3_start_coefs(iic)
    u_nnew, v_nnew = momentum_init(
        cfg, grid.pm, grid.pn, a1, a2, u, v, Hz, ru_prev, ru_prev2, rv_prev,
        rv_prev2, sustr, svstr, bustr, bvstr)
    return t3, t_nnew, u_nnew, v_nnew


def tracer_phase(cfg: Config, grid: Grid, iic: int, t, t_prev, Hz, Huon,
                 Hvom, W, Akt, stflx, btflx, srflx=None, ghats=None,
                 swdk_w=None, sources=None):
    """The tracer loop of pre_step3d (pre_step3d.F:336-598): returns the
    stacks (t3, t_nnew).  `sources` (ops/sources.PointSources) sets the
    advective fluxes at river faces."""
    pmn = grid.pm * grid.pn
    t3_list = []
    tn_list = []
    for itrc in range(cfg.ntracers):
        ltrc = min(1, itrc) if cfg.ntracers >= 2 else 0
        t3_i, tn_i = tracer_predictor(
            cfg, pmn, itrc, predictor_coefs(cfg, iic, itrc), t[itrc],
            t_prev[itrc], Hz, Huon, Hvom, W, Akt[ltrc],
            ghats[itrc] if (ghats is not None
                            and itrc < ghats.shape[0]) else None,
            srflx if itrc == 0 else None, swdk_w,
            stflx[itrc], btflx[itrc], sources=sources)
        t3_list.append(t3_i)
        tn_list.append(tn_i)
    t3 = torch.stack(t3_list, dim=0) if t3_list else t
    t_nnew = torch.stack(tn_list, dim=0) if tn_list else t
    return t3, t_nnew


def predictor_coefs(cfg: Config, iic: int, itrc: int):
    """The iic-dependent LF/AM3 predictor weights (cff, cff1, cff2, cffv);
    gamma is 1/2 for an MPDATA or HSIMT scheme, 1/6 otherwise."""
    dt = cfg.dt
    hscheme = cfg.t_hadv[itrc]
    vscheme = cfg.t_vadv[itrc]
    gam_h = 0.5 if hscheme in _UPSTREAM_PREDICTOR else 1.0 / 6.0
    gam_v = 0.5 if vscheme in _UPSTREAM_PREDICTOR else 1.0 / 6.0
    if iic == 0:
        return 0.5 * dt, 1.0, 0.0, 0.5 * dt
    return (1.0 - gam_h) * dt, 0.5 + gam_h, 0.5 - gam_h, (1.0 - gam_v) * dt


def tracer_predictor(cfg: Config, pmn, itrc: int, coefs, q, q_prev,
                     Hz, Huon, Hvom, W, Akt_l, ghats_i, srflx, swdk_w,
                     stflx_i, btflx_i, sources=None):
    """One tracer's LF-AM3 predictor (pre_step3d.F:336-598 loop body):
    returns (t3_i, t_nnew_i).  MPDATA and HSIMT take first-order upstream
    fluxes here (pre_step3d.F:76-77, 98-100)."""
    dt = cfg.dt
    cff, cff1, cff2, cffv = coefs
    hscheme = cfg.t_hadv[itrc]
    vscheme = cfg.t_vadv[itrc]

    FX, FE = hadv_fluxes(
        cfg, "U1" if hscheme in _UPSTREAM_PREDICTOR else hscheme, q, Huon,
        Hvom)
    if sources is not None:
        # river faces carry Huon*Tsrc, not the advective stencil
        # (pre_step3d.F:530-548 LuvSrc)
        from .sources import apply_tracer_flux_sources
        FX, FE = apply_tracer_flux_sources(sources, itrc, FX, FE, Huon,
                                           Hvom)
    t3 = Hz * (cff1 * q + cff2 * q_prev) - \
        cff * pmn * ((ip1(FX) - FX) + (jp1(FE) - FE))

    # vertical advection + artificial continuity (pre_step3d.F:556-598)
    FC = vadv_flux("U1" if vscheme in _UPSTREAM_PREDICTOR else vscheme, q,
                   W, Hz, "predictor")
    DC = 1.0 / (Hz - cffv * pmn *
                ((ip1(Huon) - Huon) + (jp1(Hvom) - Hvom) +
                 (W[1:] - W[:-1])))
    t3 = DC * (t3 - cffv * pmn * (FC[1:] - FC[:-1]))
    t3 = bc.apply_bc_rho(cfg, cfg.lbc_t, t3)

    # start t(nnew): flux BCs (lambda = 1: no explicit diffusion part)
    FCd = torch.zeros_like(W[1:-1])
    if ghats_i is not None:           # KPP nonlocal transport flux
        FCd = FCd - dt * Akt_l[1:-1] * ghats_i[1:-1]
    if srflx is not None and swdk_w is not None:   # penetrating shortwave
        FCd = FCd + dt * srflx[None] * swdk_w[1:-1]
    FCd = torch.cat([dt * btflx_i[None], FCd, dt * stflx_i[None]], dim=0)
    tn = Hz * q + (FCd[1:] - FCd[:-1])
    return t3, tn


def ab3_start_coefs(iic: int):
    """AB3 start-up ladder (pre_step3d.F:659-700): coefficients applied to
    (r_{n-2}, r_{n-1}); the 23/12 r_n term is added in step3d_uv."""
    a1 = 0.0 if iic <= 1 else 5.0 / 12.0
    a2 = 0.0 if iic == 0 else (-0.5 if iic == 1 else -16.0 / 12.0)
    return a1, a2


def momentum_init(cfg: Config, pm, pn, a1, a2, u, v, Hz,
                  ru_prev, ru_prev2, rv_prev, rv_prev2,
                  sustr, svstr, bustr, bvstr):
    """Mass-weighted momentum start (pre_step3d.F:659-700): AB3 history
    terms plus surface/bottom stress boundary fluxes.  Under BODYFORCE
    the stresses enter through ru/rv in rhs3d instead, and the fluxes are
    zero (pre_step3d.F:931-1106)."""
    if cfg.bodyforce:
        sustr = bustr = torch.zeros_like(sustr)
        svstr = bvstr = torch.zeros_like(svstr)
    dt = cfg.dt
    DC0u = dt * 0.25 * (pm + im1(pm)) * (pn + im1(pn))
    FCu = torch.cat(
        [dt * bustr[None], torch.zeros_like(u[1:]), dt * sustr[None]], dim=0)
    u_nnew = u * 0.5 * (Hz + im1(Hz)) + \
        DC0u * (a1 * ru_prev2 + a2 * ru_prev) + (FCu[1:] - FCu[:-1])

    DC0v = dt * 0.25 * (pm + jm1(pm)) * (pn + jm1(pn))
    FCv = torch.cat(
        [dt * bvstr[None], torch.zeros_like(v[1:]), dt * svstr[None]], dim=0)
    v_nnew = v * 0.5 * (Hz + jm1(Hz)) + \
        DC0v * (a1 * rv_prev2 + a2 * rv_prev) + (FCv[1:] - FCv[:-1])
    return u_nnew, v_nnew
