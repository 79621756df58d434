"""Tracer advection flux builders shared by the predictor (pre_step3d.F) and
the corrector (step3d_t.F); counterpart of ``roms_tpu/ops/advection.py``.

Ported: horizontal U3 and C4, vertical C4 and SPLINES (the schemes of
UPWELLING and BENCHMARK1); the others raise NotImplementedError.  Fluxes
carry the reference's units (Tunits m3/s): FX/FE include Huon/Hvom, the
vertical flux includes W.
"""

from __future__ import annotations

import torch

from ..config import Config
from . import bc
from .stencil import ip1, im1, jp1, jm1
from .tridiag import spline_interp_flux


def hadv_fluxes(cfg: Config, scheme: str, q, Huon, Hvom):
    """Horizontal advective fluxes (FX at u-points, FE at v-points) of a
    tracer stack q (N,Ny,Nx) at one time level (pre_step3d.F:336-523,
    step3d_t.F:227-564)."""
    H = cfg.halo
    L, M = cfg.Lm, cfg.Mm
    if scheme not in ("U3", "C4"):
        raise NotImplementedError(f"horizontal tracer advection {scheme!r}")
    # xi-direction: first differences at u-points with one-sided edge
    # extrapolation (FX(Istr-1)=FX(Istr) etc.)
    dq = q - im1(q)
    dq = bc.extrap_west(cfg, dq, H - 1)
    dq = bc.extrap_east(cfg, dq, H + L + 1)
    if scheme == "U3":
        curv = ip1(dq) - dq
        FX = Huon * 0.5 * (im1(q) + q) - (1.0 / 6.0) * (
            im1(curv) * torch.clamp(Huon, min=0.0) +
            curv * torch.clamp(Huon, max=0.0))
    else:
        grad = 0.5 * (ip1(dq) + dq)
        FX = Huon * 0.5 * (im1(q) + q - (1.0 / 3.0) * (grad - im1(grad)))

    # eta-direction
    dq = q - jm1(q)
    dq = bc.extrap_south(cfg, dq, H - 1)
    dq = bc.extrap_north(cfg, dq, H + M + 1)
    if scheme == "U3":
        curv = jp1(dq) - dq
        FE = Hvom * 0.5 * (jm1(q) + q) - (1.0 / 6.0) * (
            jm1(curv) * torch.clamp(Hvom, min=0.0) +
            curv * torch.clamp(Hvom, max=0.0))
    else:
        grad = 0.5 * (jp1(dq) + dq)
        FE = Hvom * 0.5 * (jm1(q) + q - (1.0 / 3.0) * (grad - jm1(grad)))
    return FX, FE


def vadv_flux(scheme: str, q, W, Hz, spline_variant: str):
    """Vertical advective flux at interfaces (N+1,Ny,Nx); flux[0] =
    flux[N] = 0.  spline_variant: "predictor" (pre_step3d.F:436-470) or
    "corrector" (step3d_t.F:633-666)."""
    N = q.shape[0]
    zero = torch.zeros_like(q[:1])
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
    raise NotImplementedError(f"vertical tracer advection {scheme!r}")
