"""Generic Length Scale two-equation turbulence closure (counterpart of
``roms_tpu/ops/gls.py``).

Reference: ROMS/Nonlinear/gls_prestep.F and gls_corstep.F (Umlauf &
Burchard 2003; Warner et al. 2005) with Canuto-A stability functions
(mod_scalars.F:4450-4470) and N2S2_HORAVG smoothing.  The k-epsilon,
k-omega, k-kl and generic instances are selected by the (p, m, n)
exponents of GLSParams.

tke and gls live at W-points (N+1 levels); the reference's three time
slots are explicit (prev, now, intermediate) tensors.  The implicit solve
is a loop over levels, down then up, in the reference's order.
"""

from __future__ import annotations

import math

import torch

from .. import constants as C
from ..config import Config, GLSParams, LBC
from ..grid import Grid
from . import bc
from .stencil import ip1, im1, jp1, jm1

vonKar = 0.41
eps = 1.0e-10
GADV = -0.25      # same upstream-bias hyperdiffusion weight as rhs3d


# Canuto-A stability constants (mod_scalars.F CANUTO_A)
_L1, _L2, _L3, _L4 = 0.107, 0.0032, 0.0864, 0.12
_L5, _L6, _L7, _L8 = 11.9, 0.4, 0.0, 0.48
gls_Gh0, gls_Ghcri, gls_Ghmin = 0.0329, 0.03, -0.28
gls_E2 = 1.33

_s0 = 1.5 * _L1 * _L5 ** 2
_s1 = -_L4 * (_L6 + _L7) + 2.0 * _L4 * _L5 * (_L1 - _L2 / 3.0 - _L3) + \
    1.5 * _L1 * _L5 * _L8
_s2 = -0.375 * _L1 * (_L6 ** 2 - _L7 ** 2)
_s4 = 2.0 * _L5
_s5 = 2.0 * _L4
_s6 = (2.0 / 3.0) * _L5 * (3.0 * _L3 ** 2 - _L2 ** 2) - \
    0.5 * _L5 * _L1 * (3.0 * _L3 - _L2) + 0.75 * _L1 * (_L6 - _L7)
_b0 = 3.0 * _L5 ** 2
_b1 = _L5 * (7.0 * _L4 + 3.0 * _L8)
_b2 = _L5 ** 2 * (3.0 * _L3 ** 2 - _L2 ** 2) - 0.75 * (_L6 ** 2 - _L7 ** 2)
_b3 = _L4 * (4.0 * _L4 + 3.0 * _L8)
_b5 = 0.25 * (_L2 ** 2 - 3.0 * _L3 ** 2) * (_L6 ** 2 - _L7 ** 2)
_b4 = _L4 * (_L2 * _L6 - 3.0 * _L3 * _L7 - _L5 * (_L2 ** 2 - _L3 ** 2)) + \
    _L5 * _L8 * (3.0 * _L3 ** 2 - _L2 ** 2)


def _upwind3_fluxes(cfg, q3, Hu_w, Hv_w):
    """3rd-order upstream-biased fluxes (gls_corstep.F advective step)."""
    H = cfg.halo
    gx = q3 - im1(q3)
    gx = bc.extrap_west(cfg, gx, H - 1)
    gx = bc.extrap_east(cfg, gx, H + cfg.Lm + 1)
    cvx = ip1(gx) - gx
    cup = torch.where(Hu_w > 0.0, im1(cvx), cvx)
    FX = Hu_w * 0.5 * (im1(q3) + q3 - GADV * cup)

    ge = q3 - jm1(q3)
    ge = bc.extrap_south(cfg, ge, H - 1)
    ge = bc.extrap_north(cfg, ge, H + cfg.Mm + 1)
    cve = jp1(ge) - ge
    cup = torch.where(Hv_w > 0.0, jm1(cve), cve)
    FE = Hv_w * 0.5 * (jm1(q3) + q3 - GADV * cup)
    return FX, FE


def _c4_fluxes(cfg, q, Hu_w, Hv_w):
    """4th-order centered fluxes (gls_prestep.F)."""
    H = cfg.halo
    gx = q - im1(q)
    gx = bc.extrap_west(cfg, gx, H - 1)
    gx = bc.extrap_east(cfg, gx, H + cfg.Lm + 1)
    FX = Hu_w * 0.5 * (im1(q) + q - (1.0 / 6.0) * (ip1(gx) - im1(gx)))
    ge = q - jm1(q)
    ge = bc.extrap_south(cfg, ge, H - 1)
    ge = bc.extrap_north(cfg, ge, H + cfg.Mm + 1)
    FE = Hv_w * 0.5 * (jm1(q) + q - (1.0 / 6.0) * (jp1(ge) - jm1(ge)))
    return FX, FE


def _vadv_w(q, W):
    """Vertical advective flux of a W-point stack at RHO levels k=1..N
    (cell-centered flux with the 7/12 -1/12 interior and 1/3, 5/6, -1/6
    end stencils of gls_prestep/corstep).  Returns (N, ...) fluxes."""
    N = q.shape[0] - 1
    c1, c2 = 7.0 / 12.0, 1.0 / 12.0
    Wc = 0.5 * (W[1:] + W[:-1])            # at rho levels k=1..N
    flux_int = Wc[1:-1] * (c1 * (q[1:N - 1] + q[2:N]) -
                           c2 * (q[0:N - 2] + q[3:N + 1]))
    a1, a2, a3 = 1.0 / 3.0, 5.0 / 6.0, 1.0 / 6.0
    f1 = (Wc[0] * (a1 * q[0] + a2 * q[1] - a3 * q[2]))[None]
    fN = (Wc[-1] * (a1 * q[N] + a2 * q[N - 1] - a3 * q[N - 2]))[None]
    return torch.cat([f1, flux_int, fN], dim=0)


def _pad_w(q, top, bot):
    """Interior W levels q (k=1..N-1) with the bottom and top levels."""
    return torch.cat([bot[None], q, top[None]], dim=0)


def gls_prestep(cfg: Config, grid: Grid, gp: GLSParams, iic: int,
                tke, gls, tke_prev, gls_prev, Hz, Huon, Hvom, W):
    """Predictor: intermediate (n+1/2) tke/gls (slot 3) and mass-weighted
    tke/gls at nnew; returns (tke3, gls3, tke_nnew, gls_nnew).  All
    tke/gls arguments are (N+1,Ny,Nx) W-point stacks; iic is the host
    step count."""
    dt = cfg.dt
    pmn = grid.pm * grid.pn
    Gamma = 1.0 / 6.0
    N = cfg.N

    Hz_w = 0.5 * (Hz[:-1] + Hz[1:])        # box heights at interior W levels
    Hu_w = 0.5 * (Huon[:-1] + Huon[1:])
    Hv_w = 0.5 * (Hvom[:-1] + Hvom[1:])

    cff1 = 1.0 if iic == 0 else 0.5 + Gamma
    cff2 = 0.0 if iic == 0 else 0.5 - Gamma
    cff3 = 0.5 * dt if iic == 0 else (1.0 - Gamma) * dt

    qk = tke[1:N]                          # interior W levels k=1..N-1
    qp = gls[1:N]
    FXk, FEk = _c4_fluxes(cfg, qk, Hu_w, Hv_w)
    FXp, FEp = _c4_fluxes(cfg, qp, Hu_w, Hv_w)
    cff4 = cff3 * pmn
    Hz_half = Hz_w - cff4 * ((ip1(Hu_w) - Hu_w) + (jp1(Hv_w) - Hv_w))
    tke3_i = Hz_w * (cff1 * qk + cff2 * tke_prev[1:N]) - \
        cff4 * ((ip1(FXk) - FXk) + (jp1(FEk) - FEk))
    gls3_i = Hz_w * (cff1 * qp + cff2 * gls_prev[1:N]) - \
        cff4 * ((ip1(FXp) - FXp) + (jp1(FEp) - FEp))
    tke_nnew_i = Hz_w * qk
    gls_nnew_i = Hz_w * qp

    # vertical advection (flux at rho levels k=1..N)
    FCk = _vadv_w(tke, W)
    FCp = _vadv_w(gls, W)
    Wc = 0.5 * (W[1:] + W[:-1])
    Hz_half = Hz_half - cff4 * (Wc[1:] - Wc[:-1])
    oHh = 1.0 / Hz_half
    tke3_i = oHh * (tke3_i - cff4 * (FCk[1:] - FCk[:-1]))
    gls3_i = oHh * (gls3_i - cff4 * (FCp[1:] - FCp[:-1]))

    tke3 = _pad_w(tke3_i, tke[N], tke[0])
    gls3 = _pad_w(gls3_i, gls[N], gls[0])
    tke_nnew = _pad_w(tke_nnew_i, tke[N], tke[0])
    gls_nnew = _pad_w(gls_nnew_i, gls[N], gls[0])

    grad_all = LBC("Gra", "Gra", "Gra", "Gra")
    tke3 = bc.apply_bc_rho(cfg, grad_all, tke3)
    gls3 = bc.apply_bc_rho(cfg, grad_all, gls3)
    return tke3, gls3, tke_nnew, gls_nnew


def _smooth_w(cfg, q):
    """N2S2_HORAVG: rho->psi->rho 1-2-1 horizontal smoothing with edge
    replication (gls_corstep.F:230-300)."""
    H = cfg.halo
    if not cfg.ew_periodic:
        q = bc.set_col(q, H - 1, q[..., :, H], "west")
        q = bc.set_col(q, H + cfg.Lm, q[..., :, H + cfg.Lm - 1], "east")
    if not cfg.ns_periodic:
        q = bc.set_row(q, H - 1, q[..., H, :], "south")
        q = bc.set_row(q, H + cfg.Mm, q[..., H + cfg.Mm - 1, :], "north")
    q = bc.fill_halo(cfg, q)
    qp = 0.25 * (q + ip1(q) + jp1(q) + ip1(jp1(q)))   # at psi+1/2 offset
    return 0.25 * (qp + im1(qp) + jm1(qp) + im1(jm1(qp)))


def _gls_tridiag(BCd, FC, rhs, flux_t, flux_b):
    """gls_corstep implicit solve: unknowns at interior W levels k=1..N-1
    (tensors (N-1, ...)); FC(k) couples level k to k-1 and FC(k+1) to
    k+1; elimination from the top down, then back substitution upward.
    flux_t comes off the k=N-1 right-hand side, flux_b off k=1 (scaled by
    the last elimination factor), as in the reference."""
    Nm1 = rhs.shape[0]
    zero = torch.zeros_like(rhs[0])
    CFs, xs = [None] * Nm1, [None] * Nm1
    CFp, xp = zero, zero                   # CF(k+1), x(k+1)
    cffd = None
    for k in reversed(range(Nm1)):
        fcup = FC[k + 1] if k + 1 < Nm1 else zero
        r = rhs[k] - flux_t if k == Nm1 - 1 else rhs[k]
        cffd = 1.0 / (BCd[k] - CFp * fcup)
        CFp = cffd * FC[k]
        xp = cffd * (r - fcup * xp)
        CFs[k], xs[k] = CFp, xp
    x = xs[0] - cffd * flux_b              # cffd of k = 1 (index 0)
    out = [x]
    for k in range(1, Nm1):
        x = xs[k] - CFs[k] * x
        out.append(x)
    return torch.stack(out, dim=0)


def gls_corstep(cfg: Config, grid: Grid, gp: GLSParams, iic: int,
                tke, gls, tke3, gls3, tke_nnew, gls_nnew,
                u, v, bvf, Hz, z_r, z_w, Huon, Hvom, W,
                Akv, Akt, Akk, Akp, Lscale,
                sustr, svstr, bustr, bvstr, Hwave=None):
    """Corrector: advect, produce and dissipate, solve implicitly, then
    the stability functions and the new mixing coefficients.

    Wave-forced surface BCs (gls_corstep.F:278-302,810-918): with
    gp.craig_banner the surface tke is flux-forced by wave breaking and
    the gls Schmidt number is replaced by the Craig-Banner-consistent
    value; gp.charnok / gp.zos_hsig set the surface roughness from the
    wind stress / wave height (Hwave).

    Returns (tke_new, gls_new, Akv, Akt, Akk, Akp, Lscale)."""
    dt = cfg.dt
    N = cfg.N
    pmn = grid.pm * grid.pn

    # derived factors (gls_corstep.F:186-210)
    L_sft = vonKar
    sqrt2 = math.sqrt(2.0)
    cmu0 = gp.cmu0
    cmu_fac1 = cmu0 ** (-gp.p / gp.n)
    cmu_fac2 = cmu0 ** (3.0 + gp.p / gp.n)
    cmu_fac3 = 1.0 / cmu0 ** 2
    gls_fac2 = cmu0 ** gp.p * gp.n * vonKar ** gp.n
    gls_fac3 = cmu0 ** gp.p * gp.n
    gls_fac4 = cmu0 ** gp.p
    gls_fac5 = 0.56 ** (0.5 * gp.n) * cmu0 ** gp.p
    gls_fac6 = 8.0 / cmu0 ** 6
    gls_exp1 = 1.0 / gp.n
    tke_exp1 = gp.m / gp.n
    tke_exp2 = 0.5 + gp.m / gp.n
    tke_exp4 = gp.m + 0.5 * gp.n
    Zos_min = 0.0001
    Zob_min = max(cfg.zob, 0.0001)
    cmu_fac4 = (1.5 * gp.sigk) ** (1.0 / 3.0) / cmu0 ** (4.0 / 3.0)
    if gp.craig_banner:
        # Craig-Banner-consistent gls Schmidt number (gls_corstep.F:
        # 278-295); the wall function raises it for k-kl (MY2.5)
        lmy25 = (gp.p == 0.0) and (gp.n == 1.0) and (gp.m == 1.0)
        cb_wallE = 1.25 if lmy25 else 1.0
        cff1_cb = (1.5 * gp.sigk) ** 0.5 * cmu0 / L_sft
        sigp_cb = L_sft ** 2 / (cmu0 ** 2 * gp.c2 * cb_wallE) * (
            gp.n ** 2 - cff1_cb * gp.n / 3.0 * (4.0 * gp.m + 1.0) +
            cff1_cb ** 2 * gp.m / 9.0 * (2.0 + 4.0 * gp.m))
    else:
        sigp_cb = gp.sigp
    ogls_sigp = 1.0 / sigp_cb

    # ---- shear^2 and buoyancy at W points, horizontally smoothed ----
    dz = z_r[1:] - z_r[:-1]
    cffs = 0.5 / dz
    du = u[1:] - u[:-1]
    dv = v[1:] - v[:-1]
    shear2_i = (cffs * (du + ip1(du))) ** 2 + (cffs * (dv + jp1(dv))) ** 2
    zpad = torch.zeros_like(shear2_i[:1])
    shear2 = _smooth_w(cfg, torch.cat([zpad, shear2_i, zpad], dim=0))
    buoy2 = _smooth_w(cfg, bvf)

    # ---- horizontal advection (3rd upstream) into nnew ----
    Hu_w = 0.5 * (Huon[:-1] + Huon[1:])
    Hv_w = 0.5 * (Hvom[:-1] + Hvom[1:])
    FXk, FEk = _upwind3_fluxes(cfg, tke3[1:N], Hu_w, Hv_w)
    FXp, FEp = _upwind3_fluxes(cfg, gls3[1:N], Hu_w, Hv_w)
    cdt = dt * pmn
    tke_n = torch.clamp(
        tke_nnew[1:N] - cdt * ((ip1(FXk) - FXk) + (jp1(FEk) - FEk)),
        min=gp.Kmin)
    gls_n = torch.clamp(
        gls_nnew[1:N] - cdt * ((ip1(FXp) - FXp) + (jp1(FEp) - FEp)),
        min=gp.Pmin)

    # ---- vertical advection ----
    FCk = _vadv_w(tke3, W)
    FCp = _vadv_w(gls3, W)
    tke_n = torch.clamp(tke_n - cdt * (FCk[1:] - FCk[:-1]), min=gp.Kmin)
    gls_n = torch.clamp(gls_n - cdt * (FCp[1:] - FCp[:-1]), min=gp.Pmin)

    # ---- production / dissipation ----
    b2 = buoy2[1:N]
    s2 = shear2[1:N]
    gls_c3 = torch.where(b2 > 0.0, torch.full_like(b2, gp.c3m),
                         torch.full_like(b2, gp.c3p))
    dAkv = Akv[1:N] - cfg.akv_bak
    dAkt = Akt[0][1:N] - cfg.akt_bak[0]
    Kprod = s2 * dAkv - b2 * dAkt
    Pprod = gp.c1 * s2 * dAkv - gls_c3 * b2 * dAkt
    on1 = (~(Kprod < 0.0)).to(Kprod.dtype)
    Kprod = torch.where(Kprod < 0.0, Kprod + b2 * dAkt, Kprod)
    on2 = (~(Pprod < 0.0)).to(Pprod.dtype)
    Pprod = torch.where(Pprod < 0.0, Pprod + gls_c3 * b2 * dAkt, Pprod)

    Hz_w = 0.5 * (Hz[:-1] + Hz[1:])
    tke_n = tke_n + dt * Hz_w * Kprod
    gls_n = gls_n + dt * Hz_w * Pprod * gls[1:N] / \
        torch.clamp(tke[1:N], min=gp.Kmin)

    # ---- implicit dissipation + vertical diffusion ----
    # off-diagonal: FC(k) couples levels k and k-1, k=2..N-1; FC(1)=0
    FCk_im = -0.5 * dt * (Akk[2:N] + Akk[1:N - 1]) / Hz[1:N - 1]
    FCp_im = -0.5 * dt * (Akp[2:N] + Akp[1:N - 1]) / Hz[1:N - 1]
    zero2d = torch.zeros_like(tke_n[0])
    FCk_full = torch.cat([zero2d[None], FCk_im], dim=0)   # k=1..N-1
    FCp_full = torch.cat([zero2d[None], FCp_im], dim=0)
    FCk_up = torch.cat([FCk_full[1:], zero2d[None]], dim=0)
    FCp_up = torch.cat([FCp_full[1:], zero2d[None]], dim=0)

    diss_k = gls[1:N] ** (-gls_exp1) * cmu_fac2 * tke[1:N] ** tke_exp2
    wall_fac = 1.0
    BCk = Hz_w * (1.0 + dt * diss_k +
                  dt * (1.0 - on1) * b2 * dAkt / tke[1:N]) - \
        FCk_full - FCk_up
    BCp = Hz_w * (1.0 + dt * gp.c2 * wall_fac * diss_k +
                  dt * (1.0 - on2) * gls_c3 * b2 * dAkt / tke[1:N]) - \
        FCp_full - FCp_up

    # Dirichlet surface/bottom values; Craig-Banner replaces the surface
    # Dirichlet scale and adds a wave-breaking TKE flux
    ust2 = 0.5 * torch.sqrt((sustr + ip1(sustr)) ** 2 +
                            (svstr + jp1(svstr)) ** 2)
    ubt2 = 0.5 * torch.sqrt((bustr + ip1(bustr)) ** 2 +
                            (bvstr + jp1(bvstr)) ** 2)
    if gp.craig_banner:
        tke_sfc = torch.clamp(
            cmu_fac4 * ust2 * gp.crgban_cw ** (2.0 / 3.0), min=gp.Kmin)
    else:
        tke_sfc = torch.clamp(cmu_fac3 * ust2, min=gp.Kmin)
    tke_bot = torch.clamp(cmu_fac3 * ubt2, min=gp.Kmin)
    # effective surface roughness (gls_corstep.F:834-842)
    if gp.charnok:
        Zos_eff = torch.clamp(gp.charnok_alpha / C.g * ust2, min=Zos_min)
    elif gp.zos_hsig and Hwave is not None:
        Zos_eff = torch.clamp(gp.zos_hsig_alpha * Hwave, min=Zos_min)
    else:
        Zos_eff = torch.full_like(ust2, Zos_min)
    gls_sfc = torch.clamp(
        cmu0 ** gp.p * tke_sfc ** gp.m * (L_sft * Zos_eff) ** gp.n,
        min=gp.Pmin)
    gls_bot = torch.clamp(
        gls_fac4 * (vonKar * Zob_min) ** gp.n * tke_bot ** gp.m,
        min=gp.Pmin)

    if gp.craig_banner:
        # surface TKE flux dt*crgban_cw*ustar^3 (added to the k=N-1 rhs;
        # _gls_tridiag subtracts flux_t, hence the sign)
        tke_flux_t = -dt * gp.crgban_cw * ust2 ** 1.5
    else:
        tke_flux_t = zero2d
    tke_i = _gls_tridiag(BCk, FCk_full, tke_n, tke_flux_t, zero2d)

    # gls surface/bottom diffusive fluxes (gls_corstep.F:640-655), tke
    # clamped at Kmin before the fractional power
    tke_i = torch.clamp(tke_i, min=gp.Kmin)
    cff_t = 0.5 * (tke_sfc + tke_i[-1])
    gls_fluxt = dt * gls_fac3 * cff_t ** gp.m * L_sft ** gp.n * \
        (Zos_eff + 0.5 * Hz[-1]) ** (gp.n - 1.0) * \
        0.5 * (Akp[N] + Akp[N - 1])
    if gp.craig_banner:
        # wave-breaking contribution to the gls surface flux
        # (gls_corstep.F:896-903)
        gls_fluxt = gls_fluxt - dt * gp.m * cmu0 ** gp.p * \
            cff_t ** (gp.m - 1.0) * \
            ((Zos_eff + 0.5 * Hz[-1]) * L_sft) ** gp.n * \
            gp.sigk * ogls_sigp * gp.crgban_cw * ust2 ** 1.5
    cff_b = 0.5 * (tke_bot + tke_i[0])
    gls_fluxb = dt * gls_fac2 * cff_b ** gp.m * \
        (0.5 * Hz[0] + Zob_min) ** (gp.n - 1.0) * 0.5 * (Akp[0] + Akp[1])
    gls_i = _gls_tridiag(BCp, FCp_full, gls_n, gls_fluxt, gls_fluxb)

    tke_i = torch.clamp(tke_i, min=gp.Kmin)
    gls_i = torch.clamp(gls_i, min=gp.Pmin)

    # ---- length scale limitation and stability functions ----
    sqrt_b = torch.sqrt(torch.clamp(b2, min=0.0)) + eps
    lim = gls_fac5 * tke_i ** tke_exp4 * sqrt_b ** (-gp.n)
    if gp.n >= 0.0:
        gls_i = torch.minimum(gls_i, lim)
    else:
        gls_i = torch.maximum(gls_i, lim)
    Ls_unlmt = torch.clamp(
        gls_i ** gls_exp1 * cmu_fac1 * tke_i ** (-tke_exp1), min=eps)
    Ls_lmt = torch.where(
        b2 > 0.0,
        torch.minimum(Ls_unlmt, torch.sqrt(
            0.56 * tke_i / (torch.clamp(b2, min=0.0) + eps))),
        Ls_unlmt)
    gls_i = torch.clamp(cmu0 ** gp.p * tke_i ** gp.m * Ls_lmt ** gp.n,
                        min=gp.Pmin)

    Gh = torch.clamp(-b2 * Ls_lmt * Ls_lmt / (2.0 * tke_i), max=gls_Gh0)
    Gh = torch.minimum(Gh, Gh - (Gh - gls_Ghcri) ** 2 /
                       (Gh + gls_Gh0 - 2.0 * gls_Ghcri))
    Gh = torch.clamp(Gh, min=gls_Ghmin)
    Gm = (_b0 / gls_fac6 - _b1 * Gh + _b3 * gls_fac6 * Gh ** 2) / \
        (_b2 - _b4 * gls_fac6 * Gh)
    Gm = torch.minimum(Gm, s2 * Ls_lmt * Ls_lmt / (2.0 * tke_i))
    cffd = _b0 - _b1 * gls_fac6 * Gh + _b2 * gls_fac6 * Gm + \
        _b3 * gls_fac6 ** 2 * Gh ** 2 - _b4 * gls_fac6 ** 2 * Gh * Gm + \
        _b5 * gls_fac6 ** 2 * Gm * Gm
    Sm = torch.clamp((_s0 - _s1 * gls_fac6 * Gh + _s2 * gls_fac6 * Gm) /
                     cffd, min=0.0)
    Sh = torch.clamp((_s4 - _s5 * gls_fac6 * Gh + _s6 * gls_fac6 * Gm) /
                     cffd, min=0.0)
    Sm = Sm * sqrt2 / cmu0 ** 3
    Sh = Sh * sqrt2 / cmu0 ** 3

    ql = sqrt2 * 0.5 * (Ls_lmt * torch.sqrt(tke_i) +
                        Lscale[1:N] * torch.sqrt(tke[1:N]))
    Akv_i = cfg.akv_bak + Sm * ql
    Akk_i = gp.akk_bak + Sm * ql / gp.sigk
    Akp_i = gp.akp_bak + Sm * ql * ogls_sigp

    # surface/bottom coefficients (gls_corstep.F:1065-1073)
    Akv_sfc = cfg.akv_bak + L_sft * Zos_eff * cmu0 * torch.sqrt(tke_sfc)
    Akv_bot = cfg.akv_bak + vonKar * Zob_min * cmu0 * torch.sqrt(tke_bot)

    def cat(bot, mid, top):
        return bc.fill_halo(cfg, torch.cat([bot[None], mid, top[None]],
                                           dim=0))

    Akv_new = cat(Akv_bot, Akv_i, Akv_sfc)
    Akt_new = torch.stack(
        [cat(torch.full_like(Akv_bot, cfg.akt_bak[i]),
             cfg.akt_bak[i] + Sh * ql,
             torch.full_like(Akv_bot, cfg.akt_bak[i]))
         for i in range(Akt.shape[0])], dim=0)
    Akk_new = cat(gp.akk_bak + Akv_bot / gp.sigk, Akk_i,
                  gp.akk_bak + Akv_sfc / gp.sigk)
    # bottom Akp uses sigp, surface the CB-consistent ogls_sigp
    # (gls_corstep.F:1072-1073)
    Akp_new = cat(gp.akp_bak + Akv_bot / gp.sigp, Akp_i,
                  gp.akp_bak + Akv_sfc * ogls_sigp)
    Lscale_new = cat(torch.zeros_like(Akv_bot), Ls_lmt,
                     torch.zeros_like(Akv_sfc))
    tke_new = cat(tke_bot, tke_i, tke_sfc)
    gls_new = cat(gls_bot, gls_i, gls_sfc)
    return tke_new, gls_new, Akv_new, Akt_new, Akk_new, Akp_new, Lscale_new
