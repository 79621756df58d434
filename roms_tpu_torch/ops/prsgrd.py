"""Baroclinic pressure gradient (counterpart of ``roms_tpu/ops/prsgrd.py``),
all five reference variants:

 * "djs"  - splines density Jacobian (Shchepetkin & McWilliams 2003),
            prsgrd32.h (the default)
 * "dj"   - standard/weighted density Jacobian, prsgrd31.h
 * "pj"   - finite-volume pressure Jacobian (Lin 1997), prsgrd40.h
 * "pjq2" - quartic-2 pressure Jacobian with parabolic WENO density
            reconstruction (Shchepetkin 2000), prsgrd42.h
 * "pjq4" - quartic-4 pressure Jacobian with power-law reconciliation,
            prsgrd44.h

Returns the contribution to ru/rv (m4/s2; multiplied by Hz and the cell
width as in the reference).  Arrays are [k, j, i], k=0 bottom.
"""

from __future__ import annotations

import torch

from .. import constants as C
from ..config import Config
from .stencil import im1, ip1, jm1

_EPS = 1.0e-10


def _harm_clamped(a, b):
    """Monotonized harmonic mean: 2ab/(a+b) where 2ab > eps, else 0."""
    cff = 2.0 * a * b
    safe = torch.where(cff > _EPS, a + b, torch.ones_like(a))
    return torch.where(cff > _EPS, cff / safe, torch.zeros_like(a))


def _rcumsum(inc, top):
    """Integrate increments downward from the top: out[k] = top +
    sum_{m>=k} inc[m]; out has one more level than inc (out[-1]=top)."""
    rc = torch.flip(torch.cumsum(torch.flip(inc, (0,)), dim=0), (0,))
    return torch.cat([top[None] + rc, top[None]], dim=0)


def prsgrd32(cfg: Config, grid, rho, z_r, z_w, Hz, eq_tide=None):
    """Splines density-Jacobian pressure gradient (prsgrd32.h:119-285).
    eq_tide: equilibrium tidal elevation subtracted from the surface
    pressure (prsgrd32.h:271)."""
    g = C.g
    GRho = g / cfg.rho0
    HalfGRho = 0.5 * GRho
    OneFifth = 0.2
    OneTwelfth = 1.0 / 12.0

    # ---- vertical monotonized differences (prsgrd32.h:134-160) ----
    dR = rho[1:] - rho[:-1]
    dZ = z_r[1:] - z_r[:-1]
    dR = torch.cat([dR[:1], dR, dR[-1:]], dim=0)
    dZ = torch.cat([dZ[:1], dZ, dZ[-1:]], dim=0)
    dRm = _harm_clamped(dR[1:], dR[:-1])
    dZm = 2.0 * dZ[1:] * dZ[:-1] / (dZ[1:] + dZ[:-1])

    # ---- kinematic pressure P/rho0 (prsgrd32.h:162-186) ----
    N = rho.shape[0]
    zwN = z_w[-1]
    cff2 = 0.5 * (rho[N - 1] - rho[N - 2]) * (zwN - z_r[N - 1]) / \
        (z_r[N - 1] - z_r[N - 2])
    P_top = g * zwN + GRho * (rho[N - 1] + cff2) * (zwN - z_r[N - 1])
    if eq_tide is not None:
        P_top = P_top - g * eq_tide
    inc = HalfGRho * (
        (rho[1:] + rho[:-1]) * (z_r[1:] - z_r[:-1]) -
        OneFifth * ((dRm[1:] - dRm[:-1]) *
                    (z_r[1:] - z_r[:-1] - OneTwelfth * (dZm[1:] + dZm[:-1])) -
                    (dZm[1:] - dZm[:-1]) *
                    (rho[1:] - rho[:-1] - OneTwelfth * (dRm[1:] + dRm[:-1]))))
    P = _rcumsum(inc, P_top)

    # ---- XI-component (prsgrd32.h:188-238) ----
    dzu = z_r - im1(z_r)
    dru = rho - im1(rho)
    dZx = _harm_clamped(dzu, torch.roll(dzu, -1, -1))
    dRx = _harm_clamped(dru, torch.roll(dru, -1, -1))
    ru_pg = grid.on_u * 0.5 * (Hz + im1(Hz)) * (
        im1(P) - P - HalfGRho * (
            (rho + im1(rho)) * dzu -
            OneFifth * ((dRx - im1(dRx)) *
                        (dzu - OneTwelfth * (dZx + im1(dZx))) -
                        (dZx - im1(dZx)) *
                        (dru - OneTwelfth * (dRx + im1(dRx))))))

    # ---- ETA-component (prsgrd32.h:240-285) ----
    dzv = z_r - jm1(z_r)
    drv = rho - jm1(rho)
    dZe = _harm_clamped(dzv, torch.roll(dzv, -1, -2))
    dRe = _harm_clamped(drv, torch.roll(drv, -1, -2))
    rv_pg = grid.om_v * 0.5 * (Hz + jm1(Hz)) * (
        jm1(P) - P - HalfGRho * (
            (rho + jm1(rho)) * dzv -
            OneFifth * ((dRe - jm1(dRe)) *
                        (dzv - OneTwelfth * (dZe + jm1(dZe))) -
                        (dZe - jm1(dZe)) *
                        (drv - OneTwelfth * (dRe + jm1(dRe))))))
    return ru_pg, rv_pg


def _dj_component(cfg: Config, rho, z_r, z_w, Hz, dm1, width):
    """One direction of the standard density Jacobian (prsgrd31.h); dm1 is
    the lateral shift (im1 for XI at u-points, jm1 for ETA), width on_u or
    om_v."""
    g = C.g
    fac1 = 0.5 * g / cfg.rho0
    fac2 = 1000.0 * g / cfg.rho0
    fac3 = 0.25 * g / cfg.rho0

    # surface contribution (prsgrd31.h surface block)
    cff1 = (z_w[-1] - z_r[-1]) + (dm1(z_w[-1]) - dm1(z_r[-1]))
    phi_top = fac1 * (rho[-1] - dm1(rho[-1])) * cff1 + \
        (fac2 + fac1 * (rho[-1] + dm1(rho[-1]))) * (z_w[-1] - dm1(z_w[-1]))

    # interior increments k = N-1..1: weighted density Jacobian with the
    # gamma curvature weight (prsgrd31.h interior block)
    dz_hi = z_r[1:] - z_r[:-1]
    dz_lo = dm1(z_r[1:]) - dm1(z_r[:-1])
    cg1 = 1.0 / (dz_hi * dz_lo)
    cg2 = (z_r[:-1] - dm1(z_r[:-1])) + (z_r[1:] - dm1(z_r[1:]))
    cg3 = dz_hi - dz_lo
    gamma = 0.125 * cg1 * cg2 * cg3

    c1 = (1.0 + gamma) * (rho[1:] - dm1(rho[1:])) + \
        (1.0 - gamma) * (rho[:-1] - dm1(rho[:-1]))
    c2 = (rho[1:] + dm1(rho[1:])) - (rho[:-1] + dm1(rho[:-1]))
    c3 = (z_r[1:] + dm1(z_r[1:])) - (z_r[:-1] + dm1(z_r[:-1]))
    c4 = (1.0 + gamma) * (z_r[1:] - dm1(z_r[1:])) + \
        (1.0 - gamma) * (z_r[:-1] - dm1(z_r[:-1]))
    inc = fac3 * (c1 * c3 - c2 * c4)
    phi = _rcumsum(inc, phi_top)           # phi[k] = phi_top + sum_{m>k}
    return -0.5 * (Hz + dm1(Hz)) * phi * width


def prsgrd31(cfg: Config, grid, rho, z_r, z_w, Hz):
    """Standard density-Jacobian pressure gradient (prsgrd31.h)."""
    return (_dj_component(cfg, rho, z_r, z_w, Hz, im1, grid.on_u),
            _dj_component(cfg, rho, z_r, z_w, Hz, jm1, grid.om_v))


def prsgrd40(cfg: Config, grid, rho, z_r, z_w, Hz):
    """Finite-volume pressure Jacobian of Lin (1997); prsgrd40.h:183-267.
    P is the hydrostatic pressure at interfaces (zero at the surface), FX
    its vertical integral over each box; the lateral force is the
    surface-slope barotropic part plus the FX/FC contour integral."""
    g = C.g
    P = _rcumsum(Hz * rho, torch.zeros_like(z_w[-1]))
    FX = 0.5 * Hz * (P[1:] + P[:-1])

    def component(dm1, width):
        dh = z_w[:-1] - dm1(z_w[:-1])            # bottom interface of box k
        FCi = 0.5 * dh * (P[:-1] + dm1(P[:-1]))
        FC = torch.cat([FCi, torch.zeros_like(FCi[:1])], dim=0)
        return (0.5 * g * (dm1(Hz) + Hz) * (dm1(z_w[-1]) - z_w[-1]) +
                (g / cfg.rho0) * (dm1(FX) - FX + FC[1:] - FC[:-1])) * width

    return component(im1, grid.on_u), component(jm1, grid.om_v)


_WENO_EPS = 1.0e-8


def _weno_reconstruct(rho, Hz, F):
    """Parabolic WENO side limits and interface values (prsgrd42.h:231-292,
    prsgrd44.h:225-283).  F is the per-interface scaled difference stack
    ((N-1,...); FC in 42, d in 44).  Returns r1 at the N-1 interior
    interfaces."""
    # interior boxes k=1..N-2
    dRt = Hz[1:-1] * F[1:]
    dLt = Hz[1:-1] * F[:-1]
    opp = dRt * dLt < 0.0
    dRt = torch.where(opp, 0.0, dRt)
    dLt = torch.where(opp, 0.0, dLt)
    cff = Hz[:-2] + 2.0 * Hz[1:-1] + Hz[2:]
    cffR = cff * F[1:]
    cffL = cff * F[:-1]
    dRt = torch.where(torch.abs(dRt) > torch.abs(cffL), cffL, dRt)
    dLt = torch.where(torch.abs(dLt) > torch.abs(cffR), cffR, dLt)
    cff = (dRt - dLt) / (Hz[:-2] + Hz[1:-1] + Hz[2:])
    dRt = dRt - cff * Hz[2:]
    dLt = dLt + cff * Hz[:-2]
    aR_i = rho[1:-1] + dRt
    aL_i = rho[1:-1] - dLt
    dR_i = (2.0 * dRt - dLt) ** 2
    dL_i = (2.0 * dLt - dRt) ** 2
    # boundary boxes (prsgrd42.h:265-276)
    aL_N = aR_i[-1]
    aR_N = 2.0 * rho[-1] - aL_N
    dR_N = (2.0 * aR_N + aL_N - 3.0 * rho[-1]) ** 2
    dL_N = (3.0 * rho[-1] - 2.0 * aL_N - aR_N) ** 2
    aR_1 = aL_i[0]
    aL_1 = 2.0 * rho[0] - aR_1
    dR_1 = (2.0 * aR_1 + aL_1 - 3.0 * rho[0]) ** 2
    dL_1 = (3.0 * rho[0] - 2.0 * aL_1 - aR_1) ** 2
    aR = torch.cat([aR_1[None], aR_i, aR_N[None]], dim=0)
    aL = torch.cat([aL_1[None], aL_i, aL_N[None]], dim=0)
    dR = torch.cat([dR_1[None], dR_i, dR_N[None]], dim=0)
    dL = torch.cat([dL_1[None], dL_i, dL_N[None]], dim=0)
    # WENO-reconciled interface values, interfaces 1..N-1
    wL = torch.clamp(dL[:-1], min=_WENO_EPS)
    wR = torch.clamp(dR[1:], min=_WENO_EPS)
    return (wR * aR[:-1] + wL * aL[1:]) / (wR + wL)


def _minmod3(deltaR, deltaL):
    """The reference's 3-way parabolic limiter (prsgrd42.h:311-321)."""
    return torch.where(
        deltaR * deltaL < 0.0, 0.0,
        torch.where(torch.abs(deltaR) > 2.0 * torch.abs(deltaL),
                    3.0 * deltaL,
                    torch.where(torch.abs(deltaL) > 2.0 * torch.abs(deltaR),
                                3.0 * deltaR, deltaR + deltaL)))


def prsgrd42(cfg: Config, grid, rho, z_r, z_w, Hz):
    """Quartic-2 finite-volume pressure Jacobian (prsgrd42.h)."""
    g = C.g
    sixth = 1.0 / 6.0
    F = (rho[1:] - rho[:-1]) / (Hz[1:] + Hz[:-1])
    r1 = _weno_reconstruct(rho, Hz, F)
    # interface density r at 0..N (non-NEUMANN ends, prsgrd42.h:285-292)
    r_top = 2.0 * rho[-1] - r1[-1]
    r_bot = 2.0 * rho[0] - r1[0]
    r = torch.cat([r_bot[None], r1, r_top[None]], dim=0)

    P = _rcumsum(Hz * rho, torch.zeros_like(z_w[-1]))
    rr_box = _minmod3(r[1:] - rho, rho - r[:-1])
    FX = 0.5 * Hz * (P[1:] + P[:-1] + sixth * rr_box * Hz)

    def phase1(dm1, mask):
        delP = dm1(P[:-1]) - P[:-1]
        dh = z_w[:-1] - dm1(z_w[:-1])
        rr = _minmod3(dh * r[:-1] - delP, delP - dh * dm1(r[:-1]))
        FCi = 0.5 * dh * (P[:-1] + dm1(P[:-1]) + sixth * rr)
        FC = torch.cat([FCi, torch.zeros_like(FCi[:1])], dim=0)
        return 2.0 * (dm1(FX) - FX + FC[1:] - FC[:-1]) / (dm1(Hz) + Hz) \
            * mask

    ru1 = phase1(im1, grid.umask)
    rv1 = phase1(jm1, grid.vmask)

    # curvature cross-term sweep + barotropic part (prsgrd42.h:394-466)
    fac = g / (24.0 * cfg.rho0)

    def phase2(r_tmp, dm1, dp1, width, zwslope_dm1):
        # FC at interfaces 1..N-1
        dh = fac * (z_w[1:-1] - zwslope_dm1(z_w[1:-1]))
        FCi = (torch.clamp(dh, min=0.0) *
               (r_tmp[1:] + dp1(r_tmp)[:-1] - r_tmp[:-1] -
                dm1(r_tmp)[1:]) +
               torch.clamp(dh, max=0.0) *
               (r_tmp[:-1] + dp1(r_tmp)[1:] - r_tmp[1:] -
                dm1(r_tmp)[:-1]))
        dh0 = fac * (z_w[0] - zwslope_dm1(z_w[0]))
        FC0 = (torch.clamp(dh0, min=0.0) * (r_tmp[0] - dm1(r_tmp[0])) +
               torch.clamp(dh0, max=0.0) * (dp1(r_tmp[0]) - r_tmp[0]))
        FC = torch.cat([FC0[None], FCi, torch.zeros_like(FC0)[None]], dim=0)
        hz2 = zwslope_dm1(Hz) + Hz
        return ((0.5 * g * (zwslope_dm1(z_w[-1]) - z_w[-1]) +
                 0.5 * g / cfg.rho0 * r_tmp) * hz2 +
                FC[1:] - FC[:-1]) * width

    ru = phase2(ru1, im1, ip1, grid.on_u, im1)
    # the reference's ETA sweep reads rv(i+1,...) (prsgrd42.h:437-456),
    # kept as roms_tpu keeps it
    rv = phase2(rv1, jm1, ip1, grid.om_v, jm1)
    return ru, rv


def prsgrd44(cfg: Config, grid, rho, z_r, z_w, Hz):
    """Quartic-4 pressure Jacobian with power-law side-limit
    reconciliation and a Pade-fit interface correction (prsgrd44.h)."""
    g = C.g
    eps = _WENO_EPS
    sixth = 1.0 / 6.0
    twelfth = 1.0 / 12.0
    F0 = 1.0 / (Hz[1:] + Hz[:-1])                   # interfaces 1..N-1
    d0 = F0 * (rho[1:] - rho[:-1])
    r1i = _weno_reconstruct(rho, Hz, d0)
    r1_top = 2.0 * rho[-1] - r1i[-1]
    r1_bot = 2.0 * rho[0] - r1i[0]
    r1 = torch.cat([r1_bot[None], r1i, r1_top[None]], dim=0)

    # power-law per-box derivative side limits (prsgrd44.h:297-330)
    deltaR = r1[1:] - rho
    deltaL = rho - r1[:-1]
    prod = deltaR * deltaL
    big = prod > eps
    cffp = torch.where(big, (deltaR + deltaL) / torch.where(big, prod, 1.0),
                       0.0)
    cffL = cffp * deltaL
    cffR = cffp * deltaR
    big_l = cffL > 3.0
    big_r = cffR > 3.0
    outL = torch.where(big_l, cffL * deltaL,
                       torch.where(big_r, 0.0, 4.0 * deltaL - 2.0 * deltaR))
    outR = torch.where(big_l, 0.0,
                       torch.where(big_r, cffR * deltaR,
                                   4.0 * deltaR - 2.0 * deltaL))
    dLbox = outL / Hz
    dRbox = outR / Hz

    # interface derivative + Pade amplitude correction (prsgrd44.h:331-372)
    dmid = F0 * (Hz[1:] * dLbox[1:] + Hz[:-1] * dRbox[:-1])
    cR = 8.0 * (dRbox[:-1] + 2.0 * dLbox[:-1])
    cL = 8.0 * (dLbox[1:] + 2.0 * dRbox[1:])
    dmid = torch.where(torch.abs(dmid) > torch.abs(cR), cR, dmid)
    dmid = torch.where(torch.abs(dmid) > torch.abs(cL), cL, dmid)
    upside = (dLbox[1:] - dRbox[:-1]) * (rho[1:] - rho[:-1]) > 0.0
    Hdd = torch.where(upside, Hz[:-1] * (dmid - dRbox[:-1]),
                      Hz[1:] * (dLbox[1:] - dmid))
    rr = torch.abs(torch.where(upside, rho[:-1] - r1[:-2], r1[2:] - rho[1:]))
    Ampl = 0.2 * Hdd * rr
    aHdd = torch.abs(Hdd)
    cff = rr * rr + 0.0763636363636363636 * aHdd * \
        (rr + 0.004329004329004329 * aHdd)
    big = cff > eps
    Ampl = torch.where(big, Ampl * (rr + 0.0363636363636363636 * aHdd) /
                       torch.where(big, cff, 1.0), 0.0)
    r_mid = r1[1:-1] + Ampl

    r_bot = 2.0 * rho[0] - r_mid[0]
    r_top = 2.0 * rho[-1] - r_mid[-1]
    r = torch.cat([r_bot[None], r_mid, r_top[None]], dim=0)
    d = torch.cat([dmid[:1], dmid, dmid[-1:]], dim=0)

    P = _rcumsum(Hz * rho, torch.zeros_like(z_w[-1]))
    FX = 0.5 * Hz * (P[1:] + P[:-1] +
                     0.2 * Hz * (r[1:] - r[:-1] -
                                 twelfth * Hz * (d[1:] + d[:-1])))

    def component(dm1, width, wmask):
        dh = z_w[:-1] - dm1(z_w[:-1])
        delP = dm1(P[:-1]) - P[:-1]
        rr_ = 0.5 * dh * (r[:-1] + dm1(r[:-1]) -
                          sixth * dh * (d[:-1] - dm1(d[:-1])))
        limtr = 2.0 * delP * rr_
        den = rr_ * rr_ + delP * delP
        limtr = torch.where(limtr > eps * den,
                            limtr / torch.where(den > 0.0, den, 1.0), 0.0)
        FCi = 0.5 * dh * (P[:-1] + dm1(P[:-1]) +
                          limtr * 0.2 * dh *
                          (r[:-1] - dm1(r[:-1]) -
                           twelfth * dh * (d[:-1] + dm1(d[:-1]))))
        FC = torch.cat([FCi, torch.zeros_like(FCi[:1])], dim=0)
        return (0.5 * g * (dm1(Hz) + Hz) * (dm1(z_w[-1]) - z_w[-1]) +
                (g / cfg.rho0) * (dm1(FX) - FX + FC[1:] - FC[:-1])) \
            * width * wmask

    return (component(im1, grid.on_u, grid.umask),
            component(jm1, grid.om_v, grid.vmask))


_SCHEMES = {"djs": prsgrd32, "dj": prsgrd31, "pj": prsgrd40,
            "pjq2": prsgrd42, "pjq4": prsgrd44}


def prsgrd(cfg: Config, grid, rho, z_r, z_w, Hz, eq_tide=None):
    """Dispatch on cfg.prsgrd_scheme.  The tide-generating force (eq_tide)
    enters djs only, as in roms_tpu."""
    try:
        fn = _SCHEMES[cfg.prsgrd_scheme]
    except KeyError:
        raise ValueError(f"unknown prsgrd scheme {cfg.prsgrd_scheme}")
    if eq_tide is not None:
        if cfg.prsgrd_scheme != "djs":
            raise ValueError("TIDE_GENERATING_FORCES is wired into the "
                             "default djs (prsgrd32) scheme only")
        return fn(cfg, grid, rho, z_r, z_w, Hz, eq_tide=eq_tide)
    return fn(cfg, grid, rho, z_r, z_w, Hz)
