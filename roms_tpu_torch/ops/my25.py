"""Mellor-Yamada level-2.5 turbulence closure (counterpart of
``roms_tpu/ops/my25.py``; my25_corstep.F, Mellor & Yamada 1982, Galperin
et al. 1988).

The predictor (my25_prestep.F) is textually gls_prestep.F, so the step
calls ``gls.gls_prestep`` for it.  tke = q^2 and gls = q^2 l, both at
W points.  The corrector advects the intermediate fields, adds shear and
buoyancy production, solves the implicit dissipation and vertical
diffusion with the Dirichlet surface and bottom values B1^(2/3) u*^2,
limits the length scale (Galperin) and evaluates the Sm/Sh stability
functions: Galperin's by default, Kantha & Clayson's on request
(mod_scalars.F:4475-4490).
"""

from __future__ import annotations

import torch

from ..config import Config
from ..grid import Grid
from . import bc
from .gls import _upwind3_fluxes, _vadv_w, _smooth_w, _gls_tridiag
from .stencil import ip1, jp1
from .vmix import _spline_deriv

vonKar = 0.41
eps = 1.0e-10

# closure constants (mod_scalars.F:1756-1770)
my_A1 = 0.92
my_A2 = 0.74
my_B1 = 16.6
my_B2 = 10.1
my_C1 = 0.08
my_C2 = 0.7
my_C3 = 0.2
my_E1 = 1.8
my_E2 = 1.33
my_Gh0 = 0.0233
my_Sq = 0.2
my_lmax = 0.53
my_qmin = 1.0e-8

# derived stability-function factors (mod_scalars.F:4475-4490)
my_B1p2o3 = my_B1 ** (2.0 / 3.0)
my_B1pm1o3 = my_B1 ** (-1.0 / 3.0)
my_Sm1 = my_A1 * my_A2 * ((my_B2 - 3.0 * my_A2) *
                          (1.0 - 6.0 * my_A1 / my_B1) -
                          3.0 * my_C1 * (my_B2 + 6.0 * my_A1))
my_Sm2 = 9.0 * my_A1 * my_A2
my_Sh1 = my_A2 * (1.0 - 6.0 * my_A1 / my_B1)
# Galperin et al. (1988), the default
my_Sh2_gal = 3.0 * my_A2 * (6.0 * my_A1 + my_B2)
my_Sm3 = my_A1 * (1.0 - 3.0 * my_C1 - 6.0 * my_A1 / my_B1)
my_Sm4_gal = 18.0 * my_A1 * my_A1 + 9.0 * my_A1 * my_A2
# Kantha & Clayson (1994)
my_Sh2_kc = 3.0 * my_A2 * (6.0 * my_A1 + my_B2 * (1.0 - my_C3))
my_Sm4_kc = 18.0 * my_A1 * my_A1 + 9.0 * my_A1 * my_A2 * (1.0 - my_C2)
akk_bak = 5.0e-6


def _spline_shear2(u, v, Hz):
    """The parabolic-spline du/dz and dv/dz at W points, squared and
    summed (my25_corstep.F RI_SPLINES branch)."""
    rhs_u = 3.0 * ((u[1:] - u[:-1]) + ip1(u[1:] - u[:-1]))
    rhs_v = 3.0 * ((v[1:] - v[:-1]) + jp1(v[1:] - v[:-1]))
    dU = _spline_deriv(Hz, rhs_u)
    dV = _spline_deriv(Hz, rhs_v)
    return dU * dU + dV * dV


def my25_corstep(cfg: Config, grid: Grid, iic: int,
                 tke, gls, tke3, gls3, tke_nnew, gls_nnew,
                 u, v, bvf, Hz, z_r, z_w, Huon, Hvom, W,
                 Akv, Akt, Akk, Lscale,
                 sustr, svstr, bustr, bvstr,
                 kantha_clayson: bool = False):
    """The MY2.5 corrector step (my25_corstep.F:160-894); the arguments of
    gls.gls_corstep.  Returns (tke_new, gls_new, Akv, Akt, Akk, Lscale)."""
    dt = cfg.dt
    N = cfg.N
    pmn = grid.pm * grid.pn

    # shear^2 (spline) and buoyancy at W points, smoothed as in GLS
    # (N2S2_HORAVG; my25_corstep.F:276-340)
    shear2 = _smooth_w(cfg, _spline_shear2(u, v, Hz))
    buoy2 = _smooth_w(cfg, bvf)

    # horizontal advection, third-order upstream (:350-538)
    Hu_w = 0.5 * (Huon[:-1] + Huon[1:])
    Hv_w = 0.5 * (Hvom[:-1] + Hvom[1:])
    FXk, FEk = _upwind3_fluxes(cfg, tke3[1:N], Hu_w, Hv_w)
    FXp, FEp = _upwind3_fluxes(cfg, gls3[1:N], Hu_w, Hv_w)
    cdt = dt * pmn
    tke_n = tke_nnew[1:N] - cdt * ((ip1(FXk) - FXk) + (jp1(FEk) - FEk))
    gls_n = gls_nnew[1:N] - cdt * ((ip1(FXp) - FXp) + (jp1(FEp) - FEp))

    # vertical advection (:540-578)
    FCk = _vadv_w(tke3, W)
    FCp = _vadv_w(gls3, W)
    tke_n = tke_n - cdt * (FCk[1:] - FCk[:-1])
    gls_n = gls_n - cdt * (FCp[1:] - FCp[:-1])

    # production (:595-636); small negative buoyancy is ignored (:603-608)
    b2 = buoy2[1:N]
    s2 = shear2[1:N]
    strat2 = torch.where((b2 > -5.0e-5) & (b2 < 0.0), torch.zeros_like(b2),
                         b2)
    Qprod = s2 * (Akv[1:N] - cfg.akv_bak) - \
        strat2 * (Akt[0][1:N] - cfg.akt_bak[0])
    Ls_unlmt0 = torch.clamp(gls[1:N] / torch.clamp(tke[1:N], min=eps),
                            min=eps)
    Hz_w = 0.5 * (Hz[:-1] + Hz[1:])
    tke_n = tke_n + dt * Hz_w * Qprod * 2.0
    gls_n = gls_n + dt * Hz_w * Qprod * my_E1 * Ls_unlmt0

    # dissipation and wall proximity (:625-636)
    cff3 = my_E2 / (vonKar * vonKar)
    Qdiss = dt * torch.sqrt(tke[1:N]) / (my_B1 * Ls_unlmt0)
    wall = Ls_unlmt0 * (1.0 / (z_w[-1][None] - z_w[1:N]) +
                        1.0 / (z_w[1:N] - z_w[0][None]))
    Wscale = 1.0 + cff3 * wall * wall

    # vertical-diffusion couplings FC(k) = -0.5 dt (Akk(k) + Akk(k-1)) /
    # Hz(k), k = 1..N (:586-592); tke and gls share Akk
    FC_all = -0.5 * dt * (Akk[1:] + Akk[:-1]) / Hz
    FC = FC_all[:-1]
    FC_up = FC_all[1:]
    BCK = Hz_w * (1.0 + 2.0 * Qdiss) - FC - FC_up
    BCP = Hz_w * (1.0 + Wscale * Qdiss) - FC - FC_up

    # the Dirichlet surface and bottom values (:643-655)
    tke_sfc = my_B1p2o3 * 0.5 * torch.sqrt(
        (sustr + ip1(sustr)) ** 2 + (svstr + jp1(svstr)) ** 2)
    tke_bot = my_B1p2o3 * 0.5 * torch.sqrt(
        (bustr + ip1(bustr)) ** 2 + (bvstr + jp1(bvstr)) ** 2)
    gls_sfc = torch.zeros_like(tke_sfc)
    gls_bot = torch.zeros_like(tke_bot)

    tke_i = _gls_tridiag(BCK, FC, tke_n, FC_up[-1] * tke_sfc, tke_bot)
    gls_i = _gls_tridiag(BCP, FC, gls_n, FC_up[-1] * gls_sfc, gls_bot)
    tke_i = torch.clamp(tke_i, min=my_qmin)
    gls_i = torch.clamp(gls_i, min=my_qmin)

    # length-scale limit and stability functions (:700-760)
    Ls_unlmt = gls_i / tke_i
    Ls_lmt = torch.minimum(
        Ls_unlmt,
        my_lmax * torch.sqrt(tke_i / (torch.clamp(b2, min=0.0) + eps)))
    Gh = torch.clamp(-b2 * Ls_lmt * Ls_lmt / tke_i, max=my_Gh0)
    if kantha_clayson:
        Sh = my_Sh1 / (1.0 - my_Sh2_kc * Gh)
        Sm = (my_B1pm1o3 + Sh * Gh * my_Sm4_kc) / (1.0 - my_Sm2 * Gh)
    else:
        Sh = my_Sh1 / (1.0 - my_Sh2_gal * Gh)
        Sm = (my_Sm3 + Sh * Gh * my_Sm4_gal) / (1.0 - my_Sm2 * Gh)

    # q l averaged over the two time levels (:762-776)
    ql = 0.5 * (Ls_lmt * torch.sqrt(tke_i) +
                Lscale[1:N] * torch.sqrt(tke[1:N]))
    Akv_i = cfg.akv_bak + ql * Sm
    Akk_i = akk_bak + ql * my_Sq

    def cat(b, mid, t):
        return bc.fill_halo(cfg, torch.cat([b[None], mid, t[None]], dim=0))

    Akt_new = torch.stack([cat(Akt[i][0], cfg.akt_bak[i] + ql * Sh,
                               Akt[i][-1]) for i in range(Akt.shape[0])],
                          dim=0)
    return (cat(tke_bot, tke_i, tke_sfc), cat(gls_bot, gls_i, gls_sfc),
            cat(Akv[0], Akv_i, Akv[-1]), Akt_new,
            cat(Akk[0], Akk_i, Akk[-1]),
            cat(torch.zeros_like(tke_bot), Ls_lmt,
                torch.zeros_like(tke_sfc)))
