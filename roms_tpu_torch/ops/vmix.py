"""K-profile vertical mixing (counterpart of ``roms_tpu/ops/vmix.py``):
interior shear and internal-wave mixing (lmd_vmix.F, RI_SPLINES), the
surface boundary layer (lmd_skpp.F with LMD_RIMIX, CONVEC and NONLOCAL)
and the bottom boundary layer (lmd_bkpp.F, ``cfg.kpp_bottom``), with the
Paulson & Simpson solar absorption (lmd_swfrac.F); and the
Brunt-Vaisala mixing ``bvf_mix`` (bvf_mix.F, ``cfg.vmix = "bvf"``), and
the double-diffusive interior mixing (lmd_vmix.F LMD_DDMIX,
``cfg.lmd_ddmix``).  The thermal expansion and saline contraction
coefficients come from autograd of the EOS, as the JAX function takes
them from jax.grad.

All constants from mod_scalars.F:1502-1630 and 4330-4331.
"""

from __future__ import annotations

import math

import torch

from .. import constants as C
from ..config import Config
from ..grid import Grid
from . import bc, eos
from .stencil import ip1, jp1, take_k

# --- constants (mod_scalars.F) ---
vonKar = 0.41
eps = 1.0e-20
small = 1.0e-20

lmd_Ri0 = 0.7
lmd_nu0m = 10.0e-4
lmd_nu0s = 10.0e-4
lmd_Ric = 0.3
lmd_am = 1.257
lmd_as = -28.86
lmd_betaT = -0.2
lmd_cekman = 0.7
lmd_cmonob = 1.0
lmd_cm = 8.36
lmd_cs = 98.96
lmd_Cv = 1.25
lmd_Cstar = 10.0
lmd_epsilon = 0.1
lmd_zetam = -0.2
lmd_zetas = -1.0
lmd_Cg = lmd_Cstar * vonKar * (lmd_cs * vonKar * lmd_epsilon) ** (1.0 / 3.0)

# Paulson & Simpson (1977) Jerlov water types (mod_scalars.F:1502-1514)
lmd_mu1 = (0.35, 0.6, 1.0, 1.5, 1.4, 0.42, 0.37, 0.33, 0.00468592)
lmd_mu2 = (23.0, 20.0, 17.0, 14.0, 7.9, 5.13, 3.54, 2.34, 1.51)
lmd_r1 = (0.58, 0.62, 0.67, 0.77, 0.78, 0.57, 0.57, 0.57, 0.55)


def swfrac(Z, zscale: float = -1.0, jwtype: int = 1):
    """Shortwave penetration fraction at depth Z (positive distance below
    the surface times zscale; lmd_swfrac.F).  jwtype: Jerlov type 1..9."""
    j = jwtype - 1
    fac1 = zscale / lmd_mu1[j]
    fac2 = zscale / lmd_mu2[j]
    r1 = lmd_r1[j]
    return torch.exp(Z * fac1) * r1 + torch.exp(Z * fac2) * (1.0 - r1)


def cbrt(x):
    """Cube root of a non-negative tensor (PyTorch has no cbrt): x**(1/3)
    and one Newton step, which brings it to jnp.cbrt's value to round-off
    (held against jnp.cbrt in float64 by the tests); 0 at x = 0."""
    y = x ** (1.0 / 3.0)
    pos = x > 0.0
    y_safe = torch.where(pos, y, torch.ones_like(y))
    y_nt = y_safe - (y_safe * y_safe * y_safe - x) / (3.0 * y_safe * y_safe)
    return torch.where(pos, y_nt, y)


def _set_ends(a, bottom, top):
    """a with its first and last planes along k set to the scalars."""
    a = a.clone()
    a[0] = bottom
    a[-1] = top
    return a


def _spline_deriv(Hz, rhs):
    """Parabolic-spline vertical derivative at W-points (lmd_vmix.F
    RI_SPLINES recurrence): returns d (N+1,...) with d[0]=d[N]=0.

    rhs[k] is the source term at interface k (k=1..N-1): 6*(rho(k+1)-rho(k))
    for density, 3*(sum of velocity differences) for u/v.  A forward sweep
    over k, then a backward one, as the JAX function's two scans."""
    zero = torch.zeros_like(Hz[0])
    FCm1, dm1 = zero, zero
    FCs, ds = [], []
    for k in range(Hz.shape[0] - 1):
        cff = 1.0 / (2.0 * Hz[k + 1] + Hz[k] * (2.0 - FCm1))
        FCm1 = cff * Hz[k + 1]
        dm1 = cff * (rhs[k] - Hz[k] * dm1)
        FCs.append(FCm1)
        ds.append(dm1)
    dnext = zero
    dint = [None] * len(ds)
    for k in reversed(range(len(ds))):
        dnext = ds[k] - FCs[k] * dnext
        dint[k] = dnext
    return torch.stack([zero] + dint + [zero], dim=0)


def _wscale(Ustar, zeta_hat):
    """Turbulent velocity scales (wm, ws) from the similarity functions
    (lmd_skpp.F): zeta_hat = vonKar*sigma*Bflux."""
    Ustar3 = Ustar * Ustar * Ustar
    zetapar = zeta_hat / (Ustar3 + small)
    wm_st = vonKar * Ustar / (1.0 + 5.0 * zetapar)
    s16 = torch.sqrt(torch.clamp(1.0 - 16.0 * zetapar, min=0.0))
    wm_un = torch.where(
        zetapar > lmd_zetam,
        vonKar * Ustar * torch.sqrt(s16),
        vonKar * cbrt(torch.clamp(lmd_am * Ustar3 - lmd_cm * zeta_hat,
                                  min=0.0)))
    ws_un = torch.where(
        zetapar > lmd_zetas,
        vonKar * Ustar * s16,
        vonKar * cbrt(torch.clamp(lmd_as * Ustar3 - lmd_cs * zeta_hat,
                                  min=0.0)))
    stable = zeta_hat >= 0.0
    wm = torch.where(stable, wm_st, wm_un)
    ws = torch.where(stable, wm_st, ws_un)
    return wm, ws


def _alpha_beta(cfg: Config, temp_s, salt_s):
    """Surface thermal expansion / saline contraction coefficients.

    Linear EOS: |Tcoef|, |Scoef| (rho_eos.F:774-780); JM95: -drho/dT / rho
    and drho/dS / rho at the surface, by autograd of the EOS."""
    if cfg.eos == "linear":
        alpha = torch.full_like(temp_s, abs(cfg.Tcoef))
        beta = torch.full_like(temp_s, abs(cfg.Scoef))
        return alpha, beta
    with torch.enable_grad():
        T = temp_s.detach().requires_grad_()
        S = salt_s.detach().requires_grad_()
        den = eos.rho_jm95(T, S, torch.zeros_like(T)) + 1000.0
        dT, dS = torch.autograd.grad(den.sum(), (T, S))
    den = den.detach()
    return -dT / den, dS / den


def _ddmix(cfg: Config, t):
    """Double-diffusive diffusivities of heat and salt (nu_ddt, nu_dds)
    at the N-1 interior W interfaces (lmd_vmix.F:360-428, Large et al.
    1994 section 4c): salt fingering for a density ratio Rrho = alpha dT /
    (beta dS) in (1, Rrho0] with dS/dz > 0, diffusive convection
    (Marmorino & Caldwell 1976) for 0 < Rrho < 1 with dS/dz < 0."""
    lmd_Rrho0, lmd_nuf, lmd_fdd = 1.9, 0.001, 0.7
    lmd_nu = 1.5e-6
    lmd_tdd1, lmd_tdd2, lmd_tdd3 = 0.909, 4.6, 0.54
    lmd_sdd1, lmd_sdd2, lmd_sdd3 = 0.15, 1.85, 0.85
    ddDT = t[0, 1:] - t[0, :-1]
    dS_raw = t[1, 1:] - t[1, :-1]
    tiny = torch.full_like(dS_raw, 1.0e-14)
    ddDS = torch.sign(dS_raw) * torch.maximum(torch.abs(dS_raw), tiny)
    ddDS = torch.where(dS_raw == 0.0, tiny, ddDS)
    # alpha/beta at the interface from the cell-mean T and S (the
    # reference's rho_eos alfaobeta at W points)
    Tw = 0.5 * (t[0, 1:] + t[0, :-1])
    Sw = 0.5 * (t[1, 1:] + t[1, :-1])
    a_w, b_w = _alpha_beta(cfg, Tw, Sw)
    Rrho = a_w / b_w * ddDT / ddDS
    # salt fingering
    Rr_f = torch.clamp(Rrho, 1.0, lmd_Rrho0)
    nu_f = 1.0 - ((Rr_f - 1.0) / (lmd_Rrho0 - 1.0)) ** 2
    nu_dds_f = lmd_nuf * nu_f * nu_f * nu_f
    nu_ddt_f = lmd_fdd * nu_dds_f
    # diffusive convection
    Rr_c = torch.clamp(Rrho, 1.0e-10, 1.0)
    nu_ddt_c = lmd_nu * lmd_tdd1 * torch.exp(
        lmd_tdd2 * torch.exp(-lmd_tdd3 * (1.0 / Rr_c - 1.0)))
    nu_dds_c = torch.where(Rr_c < 0.5, nu_ddt_c * lmd_sdd1 * Rr_c,
                           nu_ddt_c * (lmd_sdd2 * Rr_c - lmd_sdd3))
    finger = (Rrho > 1.0) & (ddDS > 0.0)
    dconv = (Rrho > 0.0) & (Rrho < 1.0) & (ddDS < 0.0)
    zero = torch.zeros_like(Rrho)
    nu_ddt = torch.where(finger, nu_ddt_f,
                         torch.where(dconv, nu_ddt_c, zero))
    nu_dds = torch.where(finger, nu_dds_f,
                         torch.where(dconv, nu_dds_c, zero))
    return nu_ddt, nu_dds


def lmd_vmix(cfg: Config, grid: Grid, u, v, t, rho, pden, bvf,
             Hz, z_r, z_w, sustr, svstr, bustr, bvstr,
             stflx, srflx, hsbl_prev, btflx=None, hbbl_prev=None):
    """K-profile parameterization: interior (with the double-diffusive
    terms under cfg.lmd_ddmix and two tracers) and surface boundary layer.

    Returns (Akv, Akt stack (NAT,N+1,Ny,Nx), hsbl, hbbl, ghats stack).
    srflx: surface shortwave (degC m/s); stflx: (NT,Ny,Nx) surface fluxes.
    With cfg.kpp_bottom the bottom layer (_lmd_bkpp) sets hbbl and blends
    its mixing in; otherwise hbbl is hbbl_prev (z_w[0] when None).
    """
    N = cfg.N
    g = C.g
    gorho0 = g / cfg.rho0
    zsurf = z_w[-1]

    # ============ interior: gradient Richardson mixing ============
    # spline derivatives of u and v at W-points
    rhs_u = 3.0 * ((u[1:] - u[:-1]) + ip1(u[1:] - u[:-1]))
    rhs_v = 3.0 * ((v[1:] - v[:-1]) + jp1(v[1:] - v[:-1]))
    dU = _spline_deriv(Hz, rhs_u)
    dV = _spline_deriv(Hz, rhs_v)
    shear2 = dU * dU + dV * dV
    Rig = bvf / (shear2 + eps)

    cff = torch.clamp(Rig / lmd_Ri0, 0.0, 1.0)
    nu_sx = (1.0 - cff * cff) ** 3
    sh2 = bvf / (Rig + eps)
    nu_sx = nu_sx * sh2 * sh2 / (sh2 * sh2 + 16.0e-10)
    # internal wave breaking (Gargett & Holloway)
    cffw = 1.0 / torch.sqrt(torch.clamp(bvf, min=1.0e-7))
    Akv = 1.0e-6 * cffw + lmd_nu0m * nu_sx
    Akt_t = 1.0e-7 * cffw + lmd_nu0s * nu_sx
    Akv = _set_ends(Akv, cfg.akv_bak, cfg.akv_bak)
    Akt_t = _set_ends(Akt_t, cfg.akt_bak[0], cfg.akt_bak[0])
    Akt_s = Akt_t
    if cfg.lmd_ddmix and cfg.ntracers >= 2:
        # new tensors: Akt_s starts as Akt_t, and an in-place add would
        # give each the other's term too
        nu_ddt, nu_dds = _ddmix(cfg, t)
        Akt_t = torch.cat([Akt_t[:1], Akt_t[1:-1] + nu_ddt, Akt_t[-1:]])
        Akt_s = torch.cat([Akt_s[:1], Akt_s[1:-1] + nu_dds, Akt_s[-1:]])

    # ============ surface boundary layer (lmd_skpp) ============
    Ustar = torch.sqrt(torch.sqrt(
        (0.5 * (sustr + ip1(sustr))) ** 2 +
        (0.5 * (svstr + jp1(svstr))) ** 2))
    temp_s = t[0, -1]
    salt_s = t[1, -1] if cfg.ntracers >= 2 else torch.zeros_like(temp_s)
    alpha, beta = _alpha_beta(cfg, temp_s, salt_s)
    stflx_T = stflx[0]
    stflx_S = stflx[1] if cfg.ntracers >= 2 else torch.zeros_like(stflx[0])
    Bo = g * (alpha * (stflx_T - srflx) - beta * stflx_S)
    Bosol = g * alpha * srflx

    # buoyancy flux profile and raw nonlocal flux (lmd_skpp.F Bflux loop)
    zgrid = zsurf[None] - z_w                 # (N+1,...) depth below surface
    swdk = swfrac(zgrid)
    Bflux = Bo[None] + Bosol[None] * (1.0 - swdk)
    unstable = Bflux < 0.0
    zeros_w = torch.zeros_like(Bflux)
    ghat_T = torch.where(unstable,
                         -(stflx_T - srflx + srflx * (1.0 - swdk)), zeros_w)
    ghat_S = torch.where(unstable, stflx_S.expand_as(Bflux), zeros_w)

    # spline derivative of potential density for the bulk Ri
    rhs_p = 6.0 * (pden[1:] - pden[:-1])
    dR = _spline_deriv(Hz, rhs_p)
    # boundary-layer-independent pieces
    sl_dpth = lmd_epsilon * (zsurf - hsbl_prev)
    third = 1.0 / 3.0
    sixth = 1.0 / 6.0
    u_r = 0.5 * (u + ip1(u))
    v_r = 0.5 * (v + jp1(v))
    Rref = pden[-1] + Hz[-1] * (third * dR[-1] + sixth * dR[-2])
    Uref = u_r[-1] + Hz[-1] * (third * dU[-1] + sixth * dU[-2])
    Vref = v_r[-1] + Hz[-1] * (third * dV[-1] + sixth * dV[-2])

    Vtc = lmd_Cv * math.sqrt(-lmd_betaT) / (
        math.sqrt(lmd_cs * lmd_epsilon) * lmd_Ric * vonKar * vonKar)

    # critical function FC at interfaces k-1 = 0..N-1 (lmd_skpp.F)
    depth_b = zsurf[None] - z_w[:-1]          # depth of interface k-1, k=1..N
    sigma_b = torch.where(Bflux[:-1] < 0.0,
                          torch.minimum(sl_dpth[None], depth_b), depth_b)
    wm_b, ws_b = _wscale(Ustar[None], vonKar * sigma_b * Bflux[:-1])
    Rk = pden - Hz * (third * dR[:-1] + sixth * dR[1:])
    Uk = u_r - Hz * (third * dU[:-1] + sixth * dU[1:])
    Vk = v_r - Hz * (third * dV[:-1] + sixth * dV[1:])
    Ritop = -gorho0 * (Rref[None] - Rk) * depth_b
    Ribot = (Uref[None] - Uk) ** 2 + (Vref[None] - Vk) ** 2 + \
        Vtc * depth_b * ws_b * torch.sqrt(torch.abs(bvf[:-1]))
    FCcrit = Ritop - lmd_Ric * Ribot          # (N,...) at interfaces 0..N-1

    # hsbl: interpolate where FC changes sign, scanning from the surface
    # (ksbl = largest k in [2..N] with FC(k-1) > 0)
    kidx = torch.arange(2, N + 1, device=z_w.device)[:, None, None]
    one = torch.ones_like(kidx)
    pos = FCcrit[1:] > 0.0                              # FC(k-1), k=2..N
    ks = torch.where(pos, kidx, one).amax(dim=0)        # (Ny,Nx)
    ks = torch.clamp(ks, min=1)
    # gather FC(k-1), FC(k), z_w(k), z_w(k-1) at k=ks
    FC_km1 = take_k(FCcrit, ks - 1)
    FC_pad = torch.cat([FCcrit, torch.zeros_like(FCcrit[:1])], dim=0)
    FC_k = take_k(FC_pad, ks)
    zw_k = take_k(z_w, ks)
    zw_km1 = take_k(z_w, ks - 1)
    denom = FC_km1 - FC_k
    denom = torch.where(torch.abs(denom) > 1e-30, denom,
                        torch.full_like(denom, 1e-30))
    hsbl = torch.where(ks > 1, (zw_k * FC_km1 - zw_km1 * FC_k) / denom,
                       z_w[1])

    # Bfsfc at hsbl; Ekman/Monin-Obukhov limits
    swdk_h = swfrac(zsurf - hsbl)
    Bfsfc = Bo + Bosol * (1.0 - swdk_h)
    hekman = lmd_cekman * Ustar / torch.clamp(torch.abs(grid.f), min=eps)
    hmonob = lmd_cmonob * Ustar ** 3 / torch.clamp(vonKar * Bfsfc, min=eps)
    limit = (Ustar > 0.0) & (Bfsfc > 0.0)
    hsbl = torch.where(
        limit, zsurf - torch.minimum(torch.minimum(hekman, hmonob),
                                     zsurf - hsbl), hsbl)
    hsbl = torch.clamp(hsbl, min=z_w[0], max=zsurf)
    hsbl = bc.fill_halo(cfg, hsbl)

    # final ksbl: largest k in [2..N] with z_w(k-1) < hsbl, else 1
    below = z_w[1:N] < hsbl[None]                        # k-1 = 1..N-1
    ks = torch.where(below, kidx, one).amax(dim=0)
    swdk_h = swfrac(zsurf - hsbl)
    Bfsfc = Bo + Bosol * (1.0 - swdk_h)

    # velocity scales at hsbl
    sl_dpth = lmd_epsilon * (zsurf - hsbl)
    sigma_h = torch.where(Bfsfc > 0.0, torch.ones_like(Bfsfc),
                          torch.full_like(Bfsfc, lmd_epsilon)) * \
        (zsurf - hsbl)
    wm1, ws1 = _wscale(Ustar, vonKar * sigma_h * Bfsfc)

    # shape-function matching at hsbl (lmd_skpp.F Gm1/Gt1/Gs1)
    f1 = 5.0 * torch.clamp(Bfsfc, min=0.0) * vonKar / (Ustar ** 4 + eps)
    zbl = zsurf - hsbl
    interior_bl = hsbl > z_w[1]
    zw_k = take_k(z_w, ks)
    zw_km1 = take_k(z_w, ks - 1)

    def match(Ak):
        Ak_k = take_k(Ak, ks)
        Ak_km1 = take_k(Ak, ks - 1)
        cffk = 1.0 / (zw_k - zw_km1)
        cff_dn = cffk * (hsbl - zw_km1)
        cff_up = cffk * (zw_k - hsbl)
        K_bl = cff_dn * Ak_k + cff_up * Ak_km1
        dK_bl = cffk * (Ak_k - Ak_km1)
        return K_bl, dK_bl

    Ustarb = torch.sqrt(torch.sqrt(
        (0.5 * (bustr + ip1(bustr))) ** 2 +
        (0.5 * (bvstr + jp1(bvstr))) ** 2))
    dK_bot = vonKar * Ustarb
    K_bot = dK_bot * (hsbl - z_w[0])

    def g1(Ak, wscale):
        K_bl, dK_bl = match(Ak)
        K_bl = torch.where(interior_bl, K_bl, K_bot)
        dK_bl = torch.where(interior_bl, dK_bl, dK_bot)
        G1 = K_bl / (zbl * wscale + eps)
        dG1 = torch.clamp(-dK_bl / (wscale + eps) - K_bl * f1, max=0.0)
        return G1, dG1

    Gm1, dGm1 = g1(Akv, wm1)
    Gt1, dGt1 = g1(Akt_t, ws1)
    Gs1, dGs1 = g1(Akt_s, ws1)
    ks_eff = torch.where(interior_bl, ks, torch.zeros_like(ks))

    # boundary-layer profile at interior interfaces k=1..N-1
    kk = torch.arange(1, N, device=z_w.device)[:, None, None]
    in_bl = kk > ks_eff[None]
    depth_k = zsurf[None] - z_w[1:N]
    sigma_k = torch.where(Bflux[1:N] < 0.0,
                          torch.minimum(sl_dpth[None], depth_k), depth_k)
    wm_k, ws_k = _wscale(Ustar[None], vonKar * sigma_k * Bflux[1:N])
    sig = depth_k / (zbl[None] + eps)
    a1 = sig - 2.0
    a2 = 3.0 - 2.0 * sig
    a3 = sig - 1.0
    Gm = a1 + a2 * Gm1[None] + a3 * dGm1[None]
    Gt = a1 + a2 * Gt1[None] + a3 * dGt1[None]
    Gs = a1 + a2 * Gs1[None] + a3 * dGs1[None]
    Akv_bl = depth_k * wm_k * (1.0 + sig * Gm)
    Akt_bl = depth_k * ws_k * (1.0 + sig * Gt)
    Aks_bl = depth_k * ws_k * (1.0 + sig * Gs)

    def set_interior(a, inner):
        return torch.cat([a[:1], inner, a[N:]], dim=0)

    Akv = set_interior(Akv, torch.where(in_bl, Akv_bl, Akv[1:N]))
    Akt_t = set_interior(Akt_t, torch.where(in_bl, Akt_bl, Akt_t[1:N]))
    Akt_s = set_interior(Akt_s, torch.where(in_bl, Aks_bl, Akt_s[1:N]))

    # nonlocal transport (LMD_NONLOCAL)
    cff_nl = lmd_Cg * (Bflux[1:N] < 0.0).to(Bflux.dtype) / \
        (zbl[None] * ws_k + eps)
    zeros_k = torch.zeros_like(cff_nl)
    ghat_T = set_interior(ghat_T, torch.where(in_bl, cff_nl * ghat_T[1:N],
                                              zeros_k))
    ghat_S = set_interior(ghat_S, torch.where(in_bl, cff_nl * ghat_S[1:N],
                                              zeros_k))
    ghat_T = _set_ends(ghat_T, 0.0, 0.0)
    ghat_S = _set_ends(ghat_S, 0.0, 0.0)

    # ============ bottom boundary layer (lmd_bkpp.F) ============
    hbbl = hbbl_prev if hbbl_prev is not None else z_w[0]
    if cfg.kpp_bottom:
        Akv, Akt_t, Akt_s, hbbl = _lmd_bkpp(
            cfg, grid, Akv, Akt_t, Akt_s, pden, bvf, Hz, z_w,
            u_r, v_r, dR, dU, dV, Ustarb, alpha, beta,
            btflx if btflx is not None else torch.zeros_like(stflx),
            srflx, hbbl, ks_eff, kk)

    fh = lambda a: bc.fill_halo(cfg, a)     # noqa: E731
    nat = min(cfg.ntracers, 2)
    Akt = torch.stack([fh(Akt_t), fh(Akt_s)][:nat], dim=0)
    ghats = torch.stack([fh(ghat_T), fh(ghat_S)][:nat], dim=0)
    return fh(Akv), Akt, hsbl, hbbl, ghats


def _lmd_bkpp(cfg: Config, grid: Grid, Akv, Akt_t, Akt_s, pden, bvf,
              Hz, z_w, u_r, v_r, dR, dU, dV, Ustar, alpha, beta,
              btflx, srflx, hbbl_prev, ksbl, kidx):
    """KPP bottom boundary layer (lmd_bkpp.F:240-806): the bulk Richardson
    number measured upward from the bottom, hbbl where Rib/Ric crosses 1,
    cubic shape-function mixing below hbbl, the larger value where it
    overlaps the surface layer.  Returns (Akv, Akt_t, Akt_s, hbbl)."""
    N = cfg.N
    g = C.g
    gorho0 = g / cfg.rho0
    zbot = z_w[0]
    zsurf = z_w[-1]
    third, sixth = 1.0 / 3.0, 1.0 / 6.0

    bl_dpth = lmd_epsilon * (hbbl_prev - zbot)
    # bottom buoyancy forcing (lmd_bkpp.F:268-279); the radiative part can
    # reach the bottom in shallow water
    btflx_T = btflx[0]
    btflx_S = btflx[1] if cfg.ntracers >= 2 else torch.zeros_like(btflx[0])
    Bo = g * (alpha * btflx_T - beta * btflx_S)
    srf = srflx if srflx is not None else torch.zeros_like(Bo)
    Bosol = g * alpha * srf
    swdk = swfrac(zsurf[None] - z_w)
    Bflux = Bo[None] + Bosol[None] * (1.0 - swdk)        # (N+1,...)

    # bottom reference values (lmd_bkpp.F:404-412)
    Rref = pden[0] - Hz[0] * (third * dR[0] + sixth * dR[1])
    Uref = u_r[0] - Hz[0] * (third * dU[0] + sixth * dU[1])
    Vref = v_r[0] - Hz[0] * (third * dV[0] + sixth * dV[1])

    Vtc = lmd_Cv * math.sqrt(-lmd_betaT) / (
        math.sqrt(lmd_cs * lmd_epsilon) * lmd_Ric * vonKar * vonKar)

    # critical function FC at interfaces k=1..N (lmd_bkpp.F:414-463)
    depth = z_w[1:] - zbot[None]                        # (N,...)
    sigma = torch.where(Bflux[1:] < 0.0,
                        torch.minimum(bl_dpth[None], depth), depth)
    wm_b, ws_b = _wscale(Ustar[None], vonKar * sigma * Bflux[1:])
    Rk = pden + Hz * (third * dR[1:] + sixth * dR[:-1])
    Uk = u_r + Hz * (third * dU[1:] + sixth * dU[:-1])
    Vk = v_r + Hz * (third * dV[1:] + sixth * dV[:-1])
    Ritop = -gorho0 * (Rk - Rref[None]) * depth
    Ribot = (Uk - Uref[None]) ** 2 + (Vk - Vref[None]) ** 2 + \
        Vtc * depth * ws_b * torch.sqrt(torch.abs(bvf[1:]))
    FC = Ritop / (Ribot + eps)
    FC = torch.cat([torch.zeros_like(FC[:1]), FC], dim=0)  # k=0..N

    # first k in 1..N with FC(k-1) < Ric <= FC(k) (lmd_bkpp.F:484-494)
    cross = (FC[:-1] < lmd_Ric) & (FC[1:] >= lmd_Ric)   # k=1..N
    karr = torch.arange(1, N + 1, device=z_w.device)[:, None, None]
    big = torch.full_like(karr, N)
    kb = torch.where(cross, karr, big).amin(dim=0)
    FC_k = take_k(FC, kb)
    FC_km1 = take_k(FC, kb - 1)
    zw_k = take_k(z_w, kb)
    zw_km1 = take_k(z_w, kb - 1)
    den = FC_k - FC_km1
    den = torch.where(torch.abs(den) > 1e-30, den,
                      torch.full_like(den, 1e-30))
    any_cross = cross.any(dim=0)
    hbbl = torch.where(any_cross,
                       ((lmd_Ric - FC_km1) * zw_k +
                        (FC_k - lmd_Ric) * zw_km1) / den,
                       zsurf)

    # Ekman limit (lmd_bkpp.F:526-535; height above bottom as z level)
    hekman = lmd_cekman * Ustar / torch.clamp(torch.abs(grid.f), min=eps) \
        - grid.h
    hbbl = torch.minimum(hekman, hbbl)
    hbbl = torch.minimum(torch.maximum(hbbl, zbot), zsurf)
    hbbl = bc.fill_halo(cfg, hbbl)

    # final kbbl: first k in 1..N with z_w(k) > hbbl (lmd_bkpp.F:589-600)
    above = z_w[1:] > hbbl[None]
    kbbl = torch.where(above, karr, big).amin(dim=0)

    # buoyancy flux and velocity scales at hbbl (lmd_bkpp.F:603-663)
    swdk_h = swfrac(zsurf - hbbl)
    Bfbot = Bo + Bosol * (1.0 - swdk_h)
    bl_dpth = lmd_epsilon * (hbbl - zbot)
    sigma_h = torch.where(Bfbot > 0.0, torch.ones_like(Bfbot),
                          torch.full_like(Bfbot, lmd_epsilon)) * \
        (hbbl - zbot)
    wm1, ws1 = _wscale(Ustar, vonKar * sigma_h * Bfbot)

    # shape-function matching at hbbl (lmd_bkpp.F:665-721); the sign of
    # dK_bl is opposite the surface case (increasing k moves away from
    # the bottom boundary)
    f1 = 5.0 * torch.clamp(Bfbot, min=0.0) * vonKar / (Ustar ** 4 + eps)
    zbl = hbbl - zbot
    zw_k = take_k(z_w, kbbl)
    zw_km1 = take_k(z_w, kbbl - 1)

    def g1(Ak, wscale):
        Ak_k = take_k(Ak, kbbl)
        Ak_km1 = take_k(Ak, kbbl - 1)
        cffk = 1.0 / (zw_k - zw_km1)
        K_bl = cffk * (hbbl - zw_km1) * Ak_k + cffk * (zw_k - hbbl) * Ak_km1
        dK_bl = -cffk * (Ak_k - Ak_km1)
        G1 = K_bl / (zbl * wscale + eps)
        dG1 = torch.clamp(K_bl * f1 - dK_bl / (wscale + eps), max=0.0)
        return G1, dG1

    Gm1, dGm1 = g1(Akv, wm1)
    Gt1, dGt1 = g1(Akt_t, ws1)
    Gs1, dGs1 = g1(Akt_s, ws1)

    # profile at interior interfaces k=1..N-1 (lmd_bkpp.F:723-806)
    depth_k = z_w[1:N] - zbot[None]
    in_bbl = z_w[1:N] < hbbl[None]
    sigma_k = torch.where(Bflux[1:N] < 0.0,
                          torch.minimum(bl_dpth[None], depth_k), depth_k)
    wm_k, ws_k = _wscale(Ustar[None], vonKar * sigma_k * Bflux[1:N])
    sig = depth_k / (zbl[None] + eps)
    a1 = sig - 2.0
    a2 = 3.0 - 2.0 * sig
    a3 = sig - 1.0

    overlap = kidx > ksbl[None]        # the surface layer owns these points

    def blend(Ak, G1v, dG1v, wsc):
        G = a1 + a2 * G1v[None] + a3 * dG1v[None]
        K_new = depth_k * wsc * (1.0 + sig * G)
        K_new = torch.where(overlap, torch.maximum(Ak[1:N], K_new), K_new)
        return torch.cat([Ak[:1], torch.where(in_bbl, K_new, Ak[1:N]),
                          Ak[N:]], dim=0)

    Akv = blend(Akv, Gm1, dGm1, wm_k)
    Akt_t = blend(Akt_t, Gt1, dGt1, ws_k)
    Akt_s = blend(Akt_s, Gs1, dGs1, ws_k)
    return Akv, Akt_t, Akt_s, hbbl


# BVF_MIXING parameters (mod_mixing.F / bvf_mix.F)
bvf_numax = 4.0e-4
bvf_numin = 3.0e-5
bvf_nu0 = 1.0e-7
bvf_nu0c = 1.0


def bvf_mix(cfg: Config, bvf):
    """Brunt-Vaisala-frequency diffusivities (bvf_mix.F): nu0/sqrt(N2)
    clipped to [numin, numax] where stable, nu0c where unstable, the
    background (akv_bak, akt_bak[0]) where N2 is exactly 0; the bottom and
    surface interfaces keep each coefficient's background.  Returns (Akv,
    Akt stack of min(NT, 2))."""
    cff = bvf_nu0 / torch.sqrt(torch.clamp(bvf, min=1e-30))
    akt_stable = torch.clamp(cff, bvf_numin, bvf_numax)
    conv = torch.full_like(bvf, bvf_nu0c)

    def interior(bak):
        return torch.where(bvf < 0.0, conv,
                           torch.where(bvf == 0.0, torch.full_like(bvf, bak),
                                       akt_stable))

    def ends(a, bak):
        a = a.clone()
        a[0] = bak
        a[-1] = bak
        return a

    akt = interior(cfg.akt_bak[0])
    akv = ends(interior(cfg.akv_bak), cfg.akv_bak)
    akts = [ends(akt, cfg.akt_bak[it]) for it in range(min(cfg.ntracers, 2))]
    return akv, torch.stack(akts, dim=0)
