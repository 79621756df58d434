"""Vertical tridiagonal solves over all water columns at once.

Counterpart of ``roms_tpu/ops/tridiag.py``; each ``lax.scan`` over k is a
Python loop over k here, with whole (Ny, Nx) planes as the carried state.

 * spline_vdiff_flux   - parabolic-spline vertical derivative flux of the
                         implicit viscosity/diffusion (step3d_uv.F:346-464,
                         step3d_t.F:1036-1090).
 * spline_interp_flux  - parabolic-spline interface interpolation of the
                         SPLINES vertical advection (pre_step3d.F:436-470,
                         step3d_t.F:633-666).
 * thomas_implicit     - standard implicit vertical diffusion
                         (step3d_t.F:1092-1142).
"""

from __future__ import annotations

import torch


def spline_vdiff_flux(dt: float, Hz, oHz, AK, q):
    """Solve the spline system for the interface derivatives of q and
    return the interface flux AK * dq/dz: (N+1, ...) with flux[0] =
    flux[N] = 0.  Hz/oHz: (N, ...); AK: (N+1, ...); q: (N, ...)."""
    sixth = 1.0 / 6.0
    third = 1.0 / 3.0
    FC = sixth * Hz[:-1] - dt * AK[:-2] * oHz[:-1]
    CF = sixth * Hz[1:] - dt * AK[2:] * oHz[1:]
    BC = third * (Hz[:-1] + Hz[1:]) + dt * AK[1:-1] * (oHz[:-1] + oHz[1:])
    rhs = q[1:] - q[:-1]

    zero = torch.zeros_like(q[0])
    CFp, DCp = zero, zero
    CFs, DCs = [], []
    for k in range(q.shape[0] - 1):
        cff = 1.0 / (BC[k] - FC[k] * CFp)
        CFp = cff * CF[k]
        DCp = cff * (rhs[k] - FC[k] * DCp)
        CFs.append(CFp)
        DCs.append(DCp)
    Ds = [None] * len(CFs)
    Dnext = zero
    for k in range(len(CFs) - 1, -1, -1):
        Dnext = DCs[k] - CFs[k] * Dnext
        Ds[k] = Dnext
    flux = AK[1:-1] * torch.stack(Ds, dim=0)
    return torch.cat([zero[None], flux, zero[None]], dim=0)


def spline_interp_flux(Hz, q, W, c_bot: float, cf1: float,
                       c_top: float, d_top: float):
    """Parabolic-spline interface interpolation of q, times W: (N+1, ...)
    with flux[0] = flux[N] = 0.  End conditions (c_bot, cf1, c_top, d_top)
    are (1.5, 0.5, 3, 2) in the predictor and (2, 1, 2, 1) in the
    corrector."""
    N = q.shape[0]
    FCm1 = c_bot * q[0]
    CFk = torch.full_like(q[0], cf1)
    CFs, FCs = [], []
    for k in range(N - 1):
        Hzk, Hzk1 = Hz[k], Hz[k + 1]
        cff = 1.0 / (2.0 * Hzk + Hzk1 * (2.0 - CFk))
        CFk = cff * Hzk
        FCm1 = cff * (3.0 * (Hzk * q[k + 1] + Hzk1 * q[k]) - Hzk1 * FCm1)
        CFs.append(CFk)
        FCs.append(FCm1)
    FCnext = (c_top * q[-1] - FCm1) / (d_top - CFk)
    FCint = [None] * (N - 1)
    for k in range(N - 2, -1, -1):
        FCnext = FCs[k] - CFs[k] * FCnext
        FCint[k] = FCnext
    zero = torch.zeros_like(q[0])
    flux = W[1:-1] * torch.stack(FCint, dim=0)
    return torch.cat([zero[None], flux, zero[None]], dim=0)


def thomas_implicit(dt: float, lam: float, Hz, z_r, AK, rhs_mass):
    """Standard implicit vertical diffusion solve:
      FC(k) = -dt*lambda*AK[k]/(z_r[k+1]-z_r[k]), k=1..N-1; FC(0)=FC(N)=0
      BC(k) = Hz[k] - FC(k) - FC(k-1);  tridiag(FC,BC,FC) q = rhs_mass.
    Returns q (N, ...)."""
    zero = torch.zeros_like(rhs_mass[0])
    FCi = -dt * lam * AK[1:-1] / (z_r[1:] - z_r[:-1])
    FC = torch.cat([zero[None], FCi, zero[None]], dim=0)
    BC = Hz - FC[1:] - FC[:-1]
    CFp, DCp = zero, zero
    CFs, DCs = [], []
    for k in range(rhs_mass.shape[0]):
        cff = 1.0 / (BC[k] - FC[k] * CFp)
        CFp = cff * FC[k + 1]
        DCp = cff * (rhs_mass[k] - FC[k] * DCp)
        CFs.append(CFp)
        DCs.append(DCp)
    qs = [None] * len(CFs)
    qnext = zero
    for k in range(len(CFs) - 1, -1, -1):
        qnext = DCs[k] - CFs[k] * qnext
        qs[k] = qnext
    return torch.stack(qs, dim=0)
