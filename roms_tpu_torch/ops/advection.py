"""Tracer advection flux builders shared by the predictor (pre_step3d.F) and
the corrector (step3d_t.F); counterpart of ``roms_tpu/ops/advection.py``.

Horizontal schemes: C2, U1, U3, C4, A4 and HSIMT; vertical: SPLINES, A4,
C2, C4, U1 and HSIMT.  Fluxes carry the reference's units (Tunits m3/s):
FX/FE include Huon/Hvom, the vertical flux includes W.
"""

from __future__ import annotations

import torch

from ..config import Config
from . import bc
from .stencil import ip1, im1, jp1, jm1, maximum, minimum
from .tridiag import spline_interp_flux

_EPS = 1.0e-16

# HSIMT TVD limiter coefficients (Wu & Zhu 2010; mod_scalars.F:375-377)
_CC1, _CC2, _CC3 = 0.25, 0.5, 1.0 / 12.0
_EPS1 = 1.0e-12


def _hsimt_sw(q_up, q_dn, grad_c, grad_up, Ka_c, Ka_up):
    """HSIMT upwinded face value for one flow direction: q_up is the
    upstream cell, grad_c the face gradient, grad_up the next-upstream
    face gradient, Ka the antidiffusion factors (step3d_t.F:300-430)."""
    oKa_c = torch.where(Ka_c <= _EPS1, 0.0,
                        1.0 / torch.clamp(Ka_c, min=_EPS1))
    small = torch.abs(grad_c) <= _EPS1
    safe = torch.where(small, 1.0, grad_c)
    r = torch.where(small, 0.0, grad_up / safe)
    rka = torch.where(small, 0.0, Ka_up * oKa_c)
    a1 = _CC1 * Ka_c + _CC2 - _CC3 * oKa_c
    b1 = -_CC1 * Ka_c + _CC2 + _CC3 * oKa_c
    beta = a1 + b1 * r
    lim = torch.clamp(torch.minimum(torch.clamp(2.0 * r * rka, max=2.0),
                                    beta), min=0.0)
    return q_up + 0.5 * lim * grad_c * Ka_c


def _hsimt_inflow(f, a, inflow, along_x: bool, side: str):
    """f with its column (along_x) or row `a` zeroed where `inflow` (a
    write on the physical edge `side`)."""
    if along_x:
        return bc.set_col(f, a, torch.where(inflow, 0.0, f[..., :, a]), side)
    return bc.set_row(f, a, torch.where(inflow, 0.0, f[..., a, :]), side)


def _hsimt_fluxes(cfg: Config, q, Huon, Hvom, grid, Hz, dt):
    """HSIMT-TVD horizontal fluxes (step3d_t.F HSIMT), with the west/east
    and south/north inflow special cases: zero gradient and Ka beyond a
    boundary the flow enters through."""
    H = cfg.halo
    L, M = cfg.Lm, cfg.Mm
    pm, pn = grid.pm, grid.pn
    oHz = 1.0 / Hz
    cffx = 0.125 * (pn + im1(pn)) * (pm + im1(pm)) * dt
    KaX = 1.0 - torch.abs(Huon * cffx * (oHz + im1(oHz)))
    gradX = q - im1(q)
    if not cfg.ew_periodic:
        inflow_w = Huon[..., :, H] >= 0.0
        gradX = _hsimt_inflow(gradX, H - 1, inflow_w, True, "west")
        KaX = _hsimt_inflow(KaX, H - 1, inflow_w, True, "west")
        inflow_e = Huon[..., :, H + L] < 0.0
        gradX = _hsimt_inflow(gradX, H + L + 1, inflow_e, True, "east")
        KaX = _hsimt_inflow(KaX, H + L + 1, inflow_e, True, "east")
    sw_pos = _hsimt_sw(im1(q), q, gradX, im1(gradX), KaX, im1(KaX))
    sw_neg = _hsimt_sw(q, im1(q), -gradX, -ip1(gradX), KaX, ip1(KaX))
    FX = torch.where(Huon >= 0.0, sw_pos, sw_neg) * Huon

    cffe = 0.125 * (pn + jm1(pn)) * (pm + jm1(pm)) * dt
    KaE = 1.0 - torch.abs(Hvom * cffe * (oHz + jm1(oHz)))
    gradE = q - jm1(q)
    if not cfg.ns_periodic:
        inflow_s = Hvom[..., H, :] >= 0.0
        gradE = _hsimt_inflow(gradE, H - 1, inflow_s, False, "south")
        KaE = _hsimt_inflow(KaE, H - 1, inflow_s, False, "south")
        inflow_n = Hvom[..., H + M, :] < 0.0
        gradE = _hsimt_inflow(gradE, H + M + 1, inflow_n, False,
                             "north")
        KaE = _hsimt_inflow(KaE, H + M + 1, inflow_n, False, "north")
    sw_pos = _hsimt_sw(jm1(q), q, gradE, jm1(gradE), KaE, jm1(KaE))
    sw_neg = _hsimt_sw(q, jm1(q), -gradE, -jp1(gradE), KaE, jp1(KaE))
    FE = torch.where(Hvom >= 0.0, sw_pos, sw_neg) * Hvom
    return FX, FE


def _akima(d_hi, d_lo):
    """Akima's harmonic-mean gradient of two first differences: zero unless
    they have one sign (tadv.F Akima4)."""
    cff = 2.0 * d_hi * d_lo
    pos = cff > _EPS
    return torch.where(pos, cff / torch.where(pos, d_hi + d_lo, 1.0), 0.0)


def hadv_fluxes(cfg: Config, scheme: str, q, Huon, Hvom, grid=None,
                Hz=None, dt=None):
    """Horizontal advective fluxes (FX at u-points, FE at v-points) of a
    tracer stack q (N,Ny,Nx) at one time level (pre_step3d.F:336-523,
    step3d_t.F:227-564).  HSIMT needs grid, Hz and dt for the
    Courant-number antidiffusion factors."""
    H = cfg.halo
    L, M = cfg.Lm, cfg.Mm
    if scheme == "HSIMT":
        return _hsimt_fluxes(cfg, q, Huon, Hvom, grid, Hz, dt)
    if scheme == "C2":
        FX = Huon * 0.5 * (im1(q) + q)
        FE = Hvom * 0.5 * (jm1(q) + q)
        return FX, FE
    if scheme == "U1":
        FX = maximum(Huon, 0.0) * im1(q) + \
            minimum(Huon, 0.0) * q
        FE = maximum(Hvom, 0.0) * jm1(q) + \
            minimum(Hvom, 0.0) * q
        return FX, FE
    if scheme not in ("U3", "C4", "A4"):
        raise ValueError(f"unknown horizontal advection scheme {scheme}")
    # xi-direction: first differences at u-points with one-sided edge
    # extrapolation (FX(Istr-1)=FX(Istr) etc.)
    dq = q - im1(q)
    dq = bc.extrap_west(cfg, dq, H - 1)
    dq = bc.extrap_east(cfg, dq, H + L + 1)
    if scheme == "U3":
        curv = ip1(dq) - dq
        FX = Huon * 0.5 * (im1(q) + q) - (1.0 / 6.0) * (
            im1(curv) * maximum(Huon, 0.0) +
            curv * minimum(Huon, 0.0))
    else:
        grad = _akima(ip1(dq), dq) if scheme == "A4" else \
            0.5 * (ip1(dq) + dq)
        FX = Huon * 0.5 * (im1(q) + q - (1.0 / 3.0) * (grad - im1(grad)))

    # eta-direction
    dq = q - jm1(q)
    dq = bc.extrap_south(cfg, dq, H - 1)
    dq = bc.extrap_north(cfg, dq, H + M + 1)
    if scheme == "U3":
        curv = jp1(dq) - dq
        FE = Hvom * 0.5 * (jm1(q) + q) - (1.0 / 6.0) * (
            jm1(curv) * maximum(Hvom, 0.0) +
            curv * minimum(Hvom, 0.0))
    else:
        grad = _akima(jp1(dq), dq) if scheme == "A4" else \
            0.5 * (jp1(dq) + dq)
        FE = Hvom * 0.5 * (jm1(q) + q - (1.0 / 3.0) * (grad - jm1(grad)))
    return FX, FE


def vadv_flux(scheme: str, q, W, Hz, spline_variant: str, z_r=None,
              pmn=None, dt=None):
    """Vertical advective flux at interfaces (N+1,Ny,Nx); flux[0] =
    flux[N] = 0.  spline_variant: "predictor" (pre_step3d.F:436-470) or
    "corrector" (step3d_t.F:633-666); HSIMT needs z_r, pmn and dt."""
    N = q.shape[0]
    zero = torch.zeros_like(q[:1])
    if scheme == "HSIMT":
        # vertical HSIMT-TVD (step3d_t.F:739-800)
        KaZ = 1.0 - torch.abs(pmn * dt * W[1:-1] / (z_r[1:] - z_r[:-1]))
        gradZ = q[1:] - q[:-1]                     # interfaces k=1..N-1
        pad0 = torch.zeros_like(gradZ[:1])
        Ka_dn = torch.cat([pad0, KaZ[:-1]], dim=0)           # KaZ(k-1)
        Ka_up = torch.cat([KaZ[1:], pad0], dim=0)            # KaZ(k+1)
        g_dn = torch.cat([pad0, gradZ[:-1]], dim=0)
        g_up = torch.cat([gradZ[1:], pad0], dim=0)
        sw_pos = _hsimt_sw(q[:-1], q[1:], gradZ, g_dn, KaZ, Ka_dn)
        sw_neg = _hsimt_sw(q[1:], q[:-1], -gradZ, -g_up, KaZ, Ka_up)
        sw = torch.where(W[1:-1] >= 0.0, sw_pos, sw_neg)
        # first/last interface pure upwind when flow leaves the column
        sw = torch.cat([torch.where(W[1] >= 0.0, q[0], sw[0])[None],
                        sw[1:]], dim=0)
        sw = torch.cat([sw[:-1], torch.where(W[N - 1] < 0.0, q[N - 1],
                                             sw[-1])[None]], dim=0)
        return torch.cat([zero, W[1:-1] * sw, zero], dim=0)
    if scheme == "C2":
        flux = W[1:-1] * 0.5 * (q[:-1] + q[1:])
        return torch.cat([zero, flux, zero], dim=0)
    if scheme == "A4":
        # Akima monotonized 4th order (pre_step3d.F:486-516)
        d = q[1:] - q[:-1]                       # k=1..N-1
        d = torch.cat([d[:1], d, d[-1:]], dim=0)  # pad -> k=0..N
        CFk = _akima(d[1:], d[:-1])              # k=1..N
        flux = W[1:-1] * 0.5 * (q[:-1] + q[1:] -
                                (1.0 / 3.0) * (CFk[1:] - CFk[:-1]))
        return torch.cat([zero, flux, zero], dim=0)
    if scheme == "U1":
        flux = maximum(W[1:-1], 0.0) * q[:-1] + \
            minimum(W[1:-1], 0.0) * q[1:]
        return torch.cat([zero, flux, zero], dim=0)
    if scheme == "SPLINES":
        if spline_variant == "predictor":
            return spline_interp_flux(Hz, q, W, 1.5, 0.5, 3.0, 2.0)
        return spline_interp_flux(Hz, q, W, 2.0, 1.0, 2.0, 1.0)
    if scheme == "C4":
        # 4th-order centered with reduced-order end interfaces
        # (pre_step3d.F:527-556 / step3d_t.F:804-833)
        c1, c2, c3 = 0.5, 7.0 / 12.0, 1.0 / 12.0
        flux_int = W[2:-2] * (c2 * (q[1:-2] + q[2:-1]) -
                              c3 * (q[:-3] + q[3:]))
        f1 = (W[1] * (c1 * q[0] + c2 * q[1] - c3 * q[2]))[None]
        fNm1 = (W[N - 1] * (c1 * q[N - 1] + c2 * q[N - 2] -
                            c3 * q[N - 3]))[None]
        return torch.cat([zero, f1, flux_int, fNm1, zero], dim=0)
    raise ValueError(f"unknown vertical advection scheme {scheme}")
