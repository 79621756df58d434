"""Wave-current bottom boundary layers (counterpart of ``roms_tpu/ops/bbl.py``;
bbl.F with ssw_bbl.h, mb_bbl.h and sg_bbl.h).

Three closures, each returning the same surface: the kinematic current
stress (bustr, bvstr) at u/v points for the momentum solve, the current
and wave stresses tau_c, tau_w and the maximum combined stress tau_cwmax
at rho points (what sediment resuspension reads), and the ripple height
and length, which persist across steps.

 * SSW (Sherwood, Signell & Warner; M94WC + SSW_CALC_UB + SSW_CALC_ZNOT +
   N92_RIPRUF): the Madsen (1994) wave boundary layer with moveable-bed
   roughness (Nikuradse, Wiberg-Rubin saltation, Wiberg-Harris /
   Malarkey-Davies ripples);
 * MB (Meinte Blaas / Soulsby 1995, the full moveable-bed variant);
 * SG (Styles & Glenn 1999/2000): the Kelvin-function similarity solution
   and a bisection for ub/u*cw.

Everything is elementwise.  The reference's while loops and bisections are
fixed-count Python loops of the counts roms_tpu uses (madsen94's 20
iterations; SG's 27 Kelvin powers, its 4 + 1 clamp passes and p.n_iter),
and no branch reads a tensor on the host.  SG computes in complex tensors
of the field's precision.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from .. import constants as C
from ..config import Config
from .stencil import im1, ip1, jm1, jp1, at_u, at_v

_EPS = 1.0e-10
_VONKAR = 0.41


@dataclass(frozen=True)
class BBLParams:
    """ssw_bbl.h parameters (sediment.in / mod_bbl defaults)."""
    d50: float = 0.00015          # median grain size (m)
    srho: float = 2650.0          # sediment density (kg/m3)
    tau_ce: float = 0.05 / 1025.0  # critical stress (m2/s2)
    zob: float = 0.0001           # default hydraulic roughness (m)
    ar: float = 0.267             # ripple roughness coef (Nielsen 92)
    cdb_min: float = 1.0e-6
    cdb_max: float = 0.5
    calc_znot: bool = True        # SSW_CALC_ZNOT moveable-bed roughness


def _where(cond, a, b):
    """torch.where with python floats allowed on either side."""
    if not torch.is_tensor(a):
        a = torch.full_like(b, a)
    elif not torch.is_tensor(b):
        b = torch.full_like(a, b)
    return torch.where(cond, a, b)


def _limit_bstress(cfg, z_w, Ur, Vr, bustr, bvstr):
    """Cap |b*str| at 0.75 Hz_bottom |u_bottom| / dt: the bottom stress may
    slow the bottom flow to rest within a step but not reverse it
    (ssw_bbl.h:674-706, in all three closures).  cfg None (the closure
    unit tests) leaves the stresses as they are."""
    if cfg is None:
        return bustr, bvstr
    cff = 0.75 / cfg.dt
    Hzb = z_w[1] - z_w[0]
    cap_u = cff * 0.5 * (Hzb + im1(Hzb)) * torch.abs(Ur)
    bustr = torch.sign(bustr) * torch.minimum(torch.abs(bustr), cap_u)
    cap_v = cff * 0.5 * (Hzb + jm1(Hzb)) * torch.abs(Vr)
    bvstr = torch.sign(bvstr) * torch.minimum(torch.abs(bvstr), cap_v)
    return bustr, bvstr


def wave_number_kh(h, Fwave):
    """Explicit kh from the Dean & Dalrymple (1991) sixth-degree Pade
    approximation (ssw_bbl.h:264-269, SSW_CALC_UB)."""
    K1, K2, K3 = 0.6666666666, 0.3555555555, 0.1608465608
    K4, K5, K6 = 0.0632098765, 0.0217540484, 0.0065407983
    Kdh = h * Fwave ** 2 / C.g
    Kbh2 = Kdh * Kdh + Kdh / (1.0 + Kdh * (K1 + Kdh * (
        K2 + Kdh * (K3 + Kdh * (K4 + Kdh * (K5 + K6 * Kdh))))))
    return torch.sqrt(Kbh2)


def _fwc(cukw):
    """The Madsen (1994) wave friction factor, eqns 32-33
    (ssw_bbl.h:1389-1398)."""
    return _where(
        (cukw > 0.2) & (cukw <= 100.0),
        torch.exp(7.02 * torch.clamp(cukw, min=0.2) ** (-0.078) - 8.82),
        _where(cukw > 10000.0,
               math.exp(5.61 * 10000.0 ** (-0.109) - 7.30),
               _where(cukw > 100.0,
                      torch.exp(5.61 * torch.clamp(cukw, min=1.0) **
                                (-0.109) - 7.30),
                      0.43)))


def madsen94(ubr, wr, ucr, zr, phiwc, kN, n_iter: int = 20):
    """The Grant-Madsen wave-current model (ssw_bbl.h madsen94,
    :1301-1456), the reference's while loop as n_iter fixed iterations.
    Returns (ustrc, ustrwm, ustrr, zoa)."""
    zo = kN / 30.0
    cosphiwc = torch.abs(torch.cos(phiwc))
    rmu = torch.zeros_like(ubr)
    Cmu = torch.ones_like(ubr)
    ustrc = torch.zeros_like(ubr)
    ustrwm2 = torch.zeros_like(ubr)
    ustrr = torch.zeros_like(ubr)
    dwc = kN * torch.ones_like(ubr)
    for _ in range(n_iter):
        cukw = Cmu * ubr / (kN * wr)
        fwci = Cmu * _fwc(cukw)
        ustrwm2 = 0.5 * fwci * ubr * ubr                   # Eq 29
        ustrr2 = Cmu * ustrwm2                             # Eq 26
        ustrr = torch.sqrt(ustrr2)
        dwc = _where(cukw >= 8.0,
                     2.0 * _VONKAR * ustrr / torch.clamp(wr, min=_EPS), kN)
        dwc = torch.minimum(torch.maximum(dwc, kN), 0.9 * zr)   # Eq 36
        # floors: in near-dry WET_DRY columns zr ~ mm and the roughness
        # clamp can give dwc == zo; the reference evaluates wet cells only
        lnzr = torch.clamp(torch.log(zr / dwc), min=1.0e-3)
        lndw = torch.clamp(torch.log(dwc / zo), min=1.0e-3)
        lnln = lnzr / lndw
        bigsqr = -1.0 + torch.sqrt(
            1.0 + (4.0 * _VONKAR * lndw / (lnzr * lnzr)) *
            ucr / torch.clamp(ustrr, min=_EPS))
        ustrc = 0.5 * ustrr * lnln * bigsqr                # Eq 38
        rmu = ustrc * ustrc / torch.clamp(ustrwm2, min=_EPS)
        Cmu = torch.sqrt(1.0 + 2.0 * rmu * cosphiwc + rmu * rmu)  # Eq 27
    zoa = dwc * (dwc / zo) ** (-torch.sqrt(rmu / (1.0 + rmu)))   # Eq 11
    return ustrc, torch.sqrt(ustrwm2), ustrr, zoa


def ripple_geometry(p: BBLParams, Ab, tstar, rheight, rlength):
    """The Wiberg-Harris ripple predictor in Malarkey & Davies' (2003)
    explicit form (ssw_bbl.h:450-480); the relict geometry stays where the
    bed is not in motion (tstar < 1)."""
    a1, a2, a3 = 0.095, 0.442, 2.280
    b1 = 1.0 / a1
    b2 = 0.5 * (1.0 + a2) * b1
    b3 = b2 ** 2 - a3 * b1
    d50 = p.d50
    d0 = 2.0 * Ab
    dolam1 = d0 / (535.0 * d50)
    doeta1 = torch.exp(b2 - torch.sqrt(torch.clamp(
        b3 - b1 * torch.log(torch.clamp(dolam1, min=_EPS)), min=0.0)))
    lam_ratio = -torch.log(0.62 * d0 / (535.0 * d50)) * \
        torch.log(0.01 * doeta1) / math.log(5.0)
    dolam = _where(doeta1 < 20.0, 1.0 / 0.62,
                   _where(doeta1 > 100.0, dolam1,
                          dolam1 * torch.exp(-lam_ratio)))
    doeta2 = torch.exp(b2 - torch.sqrt(torch.clamp(
        b3 - b1 * torch.log(torch.clamp(dolam, min=_EPS)), min=0.0)))
    sheet = d0 / d50 > 13000.0
    rh_new = _where(sheet, 0.0, d0 / doeta2)
    rl_new = _where(sheet, 535.0 * d50, d0 / dolam)
    moving = tstar >= 1.0
    return (torch.where(moving, rh_new, rheight),
            torch.where(moving, rl_new, rlength))


def _waves_and_current(grid, u, v, z_r, z_w, Hwave, Pwave, Dwave,
                       ub_eps: float, umag_inside: bool):
    """The near-bed flow shared by the closures: (Zr, Ur, Vr, Fwave, Ab,
    Ub, Umag, phicw).  ub_eps is added to Ub; umag_inside puts the 1e-10
    under Umag's square root (SSW) instead of after it (MB, SG)."""
    Zr = torch.clamp(z_r[0] - z_w[0], min=1.0e-3)
    Ur, Vr = u[0], v[0]
    Fwave = 2.0 * math.pi / torch.clamp(Pwave, min=0.05)
    # WET_DRY grids carry h <= 0 on the dry beach, where the Pade kh
    # expansion is undefined (the stresses there are masked anyway)
    Kbh = wave_number_kh(torch.clamp(grid.h, min=0.01), Fwave)
    Ab = 0.5 * Hwave / torch.clamp(torch.sinh(Kbh), min=_EPS) + _EPS
    Ub = Fwave * Ab + ub_eps
    Ucur = 0.5 * (Ur + ip1(Ur))
    Vcur = 0.5 * (Vr + jp1(Vr))
    if umag_inside:
        Umag = torch.sqrt(Ucur * Ucur + Vcur * Vcur + _EPS)
    else:
        Umag = torch.sqrt(Ucur * Ucur + Vcur * Vcur) + _EPS
    phic = torch.atan2(Vcur, Ucur)
    angler = getattr(grid, "angler", None)
    angler = torch.zeros_like(Umag) if angler is None else angler
    phicw = 1.5 * math.pi - Dwave - phic - angler
    return Zr, Ur, Vr, Fwave, Ab, Ub, Umag, phicw


def _uv_stress(cfg, grid, z_w, Ur, Vr, Umag, tau):
    """The current stress tau (rho points) along the near-bed current at
    u/v points, capped by _limit_bstress (ssw_bbl.h:668-720)."""
    bustr = at_u(tau) * (Ur / torch.clamp(at_u(Umag), min=_EPS)) * \
        grid.umask
    bvstr = at_v(tau) * (Vr / torch.clamp(at_v(Umag), min=_EPS)) * \
        grid.vmask
    return _limit_bstress(cfg, z_w, Ur, Vr, bustr, bvstr)


def bblm(cfg: Config, grid, p: BBLParams, u, v, z_r, z_w,
         Hwave, Pwave, Dwave, rheight, rlength, tau_cw_prev):
    """One SSW bottom-boundary-layer evaluation.  u, v: the 3-D velocities;
    Hwave, Pwave, Dwave: significant wave height (m), bottom wave period
    (s) and wave direction (rad) at rho points; rheight, rlength: the
    ripples of the previous step; tau_cw_prev: the previous maximum
    combined stress (the Shields motion criterion reads it).  Returns
    (bustr, bvstr, tau_c, tau_w, tau_cwmax, rheight, rlength)."""
    Zr, Ur, Vr, Fwave, Ab, Ub, Umag, phicw = _waves_and_current(
        grid, u, v, z_r, z_w, Hwave, Pwave, Dwave, _EPS, True)

    # moveable-bed roughness (ssw_bbl.h:420-495)
    zoMAX = 0.9 * Zr
    zoMIN = max(5.0e-5, 2.5 * p.d50 / 30.0)
    zoN = torch.minimum(torch.clamp(
        2.5 * p.d50 / 30.0 * torch.ones_like(Umag), min=zoMIN), zoMAX)
    if p.calc_znot:
        tstar = tau_cw_prev / (p.tau_ce + _EPS)
        # Wiberg-Rubin (1989) saltation roughness (d50 in cm inside)
        logd = math.log(100.0 * p.d50)
        coef_st = 0.0204 * logd ** 2 + 0.0220 * logd + 0.0709
        zoST = _where(tstar >= 1.0,
                      0.056 * p.d50 * 0.68 * tstar / (1.0 + coef_st * tstar),
                      0.0)
        rheight, rlength = ripple_geometry(p, Ab, tstar, rheight, rlength)
        zoBF = p.ar * rheight ** 2 / torch.clamp(rlength, min=_EPS)
        zo = zoN + zoST + zoBF
    else:
        zo = max(p.zob, 5.0e-5) * torch.ones_like(Umag)
    zo = torch.minimum(torch.clamp(zo, min=zoMIN), zoMAX)

    # stresses (ssw_bbl.h:500-560 and madsen94)
    cff1 = _VONKAR / torch.log(Zr / zo)
    Cd = torch.clamp(cff1 * cff1, min=p.cdb_min, max=p.cdb_max)
    tau_c_cur = Cd * Umag * Umag                     # currents alone
    abokb = Ab / (30.0 * zo)
    fwm = _where(
        (abokb > 0.2) & (abokb <= 100.0),
        torch.exp(-8.82 + 7.02 * torch.clamp(abokb, min=0.2) ** (-0.078)),
        _where(abokb > 100.0,
               torch.exp(-7.30 + 5.61 * torch.clamp(abokb, min=1.0) **
                         (-0.109)), 0.3))
    tau_w_pure = 0.5 * fwm * Ub * Ub                 # waves alone
    m_ustrc, m_ustrwm, m_ustrr, _ = madsen94(Ub, Fwave, Umag, Zr, phicw,
                                             30.0 * zo)
    waves = Ub > 10.0 * 1.0e-10
    currents = Umag > 1.0e-6
    both = waves & currents & (Zr > zo)
    tau_c = torch.where(both, m_ustrc ** 2, _where(currents, tau_c_cur, 0.0))
    tau_w = torch.where(both, m_ustrwm ** 2, _where(waves, tau_w_pure, 0.0))
    tau_cwmax = torch.where(both, m_ustrr ** 2,
                            torch.where(currents, tau_c_cur, tau_w_pure))
    bustr, bvstr = _uv_stress(cfg, grid, z_w, Ur, Vr, Umag, tau_c)
    return bustr, bvstr, tau_c, tau_w, tau_cwmax, rheight, rlength


# ---------------------------------------------------------------------------
# MB_BBL: Meinte Blaas / Soulsby (1995) (mb_bbl.h)
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class MBBBLParams:
    """mb_bbl.h parameters (MB_CALC_UB + MB_Z0BL + MB_Z0RIP + MB_Z0BIO +
    MB_CALC_ZNOT, the full moveable-bed configuration)."""
    d50: float = 0.00015          # median grain size (m)
    srho: float = 2650.0          # sediment density (kg/m3)
    tau_ce: float = 0.05 / 1025.0  # critical stress (m2/s2)
    zob: float = 0.0001           # background roughness (m)
    cdb_min: float = 1.0e-6
    cdb_max: float = 0.5
    z0bl: bool = True             # MB_Z0BL bedload roughness
    z0rip: bool = True            # MB_Z0RIP ripple roughness
    z0bio: bool = False           # MB_Z0BIO biogenic roughness
    calc_znot: bool = True        # MB_CALC_ZNOT


def _soulsby_tauw(znot, Fwave, Ub):
    """Soulsby's (1995) wave stress scf1 (z0 w)^scf2 Ub^(2 - scf2)
    (mb_bbl.h:150-157)."""
    scf1 = 0.5 * 1.39
    scf2 = 0.52
    return scf1 * (znot * Fwave) ** scf2 * Ub ** (2.0 - scf2)


def _soulsby_taucw(tau_c, tau_w):
    """Soulsby's (1995) mean combined stress tau_c (1 + 1.2 (tw / (tw +
    tc))^3.2) (mb_bbl.h:245-247)."""
    return tau_c * (1.0 + 1.2 * (tau_w / (tau_w + tau_c + _EPS)) ** 3.2)


def _combined_max(tau_cw, tau_w, phiCW):
    return torch.sqrt((tau_cw + tau_w * torch.cos(phiCW)) ** 2 +
                      (tau_w * torch.sin(phiCW)) ** 2)


def bblm_mb(cfg: Config, grid, p: MBBBLParams, u, v, z_r, z_w, rho,
            Hwave, Pwave, Dwave, rheight, rlength):
    """One MB (Blaas / Soulsby) bottom-boundary-layer evaluation
    (mb_bbl.h:183-420): the reference's IF/ELSE regime ladder as nested
    selects.  rho: the density anomaly of the bottom cell.  Returns
    (bustr, bvstr, tau_c (= tau_cw), tau_w, tau_cwmax, rheight, rlength),
    as bblm."""
    vonKar = _VONKAR
    pi = math.pi
    Zr, Ur, Vr, Fwave, Ab, Ub, Umag, phiCW = _waves_and_current(
        grid, u, v, z_r, z_w, Hwave, Pwave, Dwave, 0.0, False)
    rho_w = rho + 1000.0
    viscosity = 0.0013 / rho_w            # kinematic (mb_bbl.h:205)
    rhoSed = p.srho / rho_w               # nondimensional

    d50 = p.d50
    tau_cb = p.tau_ce
    # the bedload / suspension regime thresholds (mb_bbl.h:214-218)
    tau_up = 0.172 * (rhoSed - 1.0) * C.g * d50 ** 0.624
    tau_bf = 0.79 * viscosity ** (-0.6) * \
        ((rhoSed - 1.0) * C.g) ** 0.3 * d50 ** 0.9 * tau_cb

    ZnotC0 = d50 / 12.0                   # Nikuradse skin roughness
    Znot = max(p.zob, ZnotC0)

    # current stresses with the total and the skin roughness
    cff1 = vonKar / torch.log(Zr / Znot)
    tauC = torch.clamp(cff1 * cff1, min=p.cdb_min, max=p.cdb_max) * \
        Umag * Umag
    cff1s = vonKar / torch.log(Zr / ZnotC0)
    tau_cs = cff1s * cff1s * Umag * Umag

    # the wave-dominated branch (Ub > 1 cm/s; mb_bbl.h:240-330)
    tau_w_skin = _soulsby_tauw(ZnotC0, Fwave, Ub)
    tau_cws = _combined_max(_soulsby_taucw(tau_cs, tau_w_skin), tau_w_skin,
                            phiCW)
    tauCWmax = tau_cws
    tauW = tau_w_skin

    ZnotC = ZnotC0 * torch.ones_like(Umag)
    if p.z0bl and p.calc_znot:
        # bedload saltation roughness (mb_bbl.h:260-266)
        tau_ex = torch.clamp(tau_cws - tau_cb, min=0.0)
        cffz = 1.0 / ((rhoSed - 1.0) * C.g * d50)
        ZnotC = ZnotC + 17.4 * d50 * (cffz * tau_ex) ** 0.75
    if p.z0bl:
        cff1b = vonKar / torch.log(Zr / ZnotC)
        tau_c_bl = cff1b * cff1b * Umag * Umag
        tau_wb = _soulsby_tauw(ZnotC, Fwave, Ub)
        tau_cwb = _combined_max(_soulsby_taucw(tau_c_bl, tau_wb), tau_wb,
                                phiCW)
        tauCWmax = tau_cwb
        tauW = tau_wb
    else:
        tau_cwb = tau_cws

    rhgt, rlen = rheight, rlength
    if p.z0rip:
        # the ripple regime ladder (mb_bbl.h:268-300), sandy beds only
        RHmin = 0.001
        RHmax = 0.8 * rlen / pi
        rhgt_c = torch.minimum(torch.clamp(rhgt, min=RHmin),
                               torch.clamp(RHmax, min=RHmin))
        tau_en = torch.maximum(
            tau_cws, tau_cws * (rlen / torch.clamp(rlen - pi * rhgt_c,
                                                   min=_EPS)) ** 2)
        # the regimes, in the reference's order
        local_tr = (tau_cws < tau_cb) & (tau_en >= tau_cb)
        rh1 = (19.6 * torch.sqrt(tau_cws / tau_cb) + 20.9) * d50
        bedload = (tau_cws >= tau_cb) & (tau_cwb < tau_bf)
        rh2 = (22.15 * torch.sqrt(tau_cwb / tau_cb) + 6.38) * d50
        breakoff = (tau_cwb >= tau_bf) & (tau_cwb < tau_up)
        rl3 = 535.0 * d50
        rh3 = 0.15 * rl3 * (torch.sqrt(tau_up) - torch.sqrt(tau_cwb)) / \
            torch.clamp(torch.sqrt(tau_up) - torch.sqrt(tau_bf), min=_EPS)
        sheet = tau_cwb >= tau_up
        rhgt_new = torch.where(
            local_tr, rh1, torch.where(
                bedload, rh2, torch.where(
                    breakoff, rh3, _where(sheet, 0.0, rhgt))))
        rlen_new = torch.where(
            local_tr, rh1 / 0.12, torch.where(
                bedload, rh2 / 0.12, _where(
                    breakoff, rl3, _where(sheet, 0.0, rlen))))
        if d50 >= 0.000063:             # sandy
            rhgt, rlen = rhgt_new, rlen_new
    if p.z0bio and d50 < 0.000063:
        # biogenic roughness of a muddy bed (mb_bbl.h:302-311)
        RLbio = 0.1
        thetw = tau_cws / ((rhoSed - 1.0) * C.g * d50)
        RHbio = thetw ** (-1.67) * RLbio / math.exp(4.11)
        rhgt = torch.clamp(RHbio, max=0.006)
        rlen = RLbio * torch.ones_like(rhgt)

    if (p.z0rip or p.z0bio) and p.calc_znot:
        ZnotC = ZnotC + 0.92 * rhgt * rhgt / torch.clamp(rlen, min=0.01)
    if p.z0rip or p.z0bio:
        cff1r = vonKar / torch.log(Zr / ZnotC)
        tau_cr = cff1r * cff1r * Umag * Umag
        tau_wr = _soulsby_tauw(ZnotC, Fwave, Ub)
        tauCW_wave = _soulsby_taucw(tau_cr, tau_wr)
        tauW_wave = tau_wr
    else:
        tauCW_wave = _soulsby_taucw(tauC, _soulsby_tauw(Znot, Fwave, Ub))
        tauW_wave = tauW

    # the current-only branch (Ub <= 1 cm/s; mb_bbl.h:332-356)
    ZnotC_c = ZnotC0 * torch.ones_like(Umag)
    rh_c, rl_c = rhgt, rlen
    if p.z0rip:
        sheet_c = tau_cs > tau_up
        relict = tau_cs < tau_cb
        rl_y = 1000.0 * d50                       # Yalin (1964)
        rh_y = 0.0308 * rl_y ** 1.19
        rh_c = _where(sheet_c, 0.0, _where(relict, rheight, rh_y))
        rl_c = _where(sheet_c, 0.0, _where(relict, rlength, rl_y))
        if p.calc_znot:
            ZnotC_c = ZnotC_c + 0.92 * rh_c * rh_c / \
                torch.clamp(rl_c, min=0.01)
    cff1c = vonKar / torch.log(Zr / ZnotC_c)
    tauCW_cur = torch.clamp(cff1c * cff1c, min=p.cdb_min, max=p.cdb_max) * \
        Umag * Umag

    wave = Ub > 0.01
    tauCW = torch.where(wave, tauCW_wave, tauCW_cur)
    tauW_o = _where(wave, tauW_wave, 0.0)
    tauCWmax = torch.where(wave, tauCWmax, tauC)
    rheight = torch.where(wave, rhgt, rh_c)
    rlength = torch.where(wave, rlen, rl_c)

    # the stress components at u/v points (mb_bbl.h:360-380)
    bustr, bvstr = _uv_stress(cfg, grid, z_w, Ur, Vr, Umag, tauCW)
    return bustr, bvstr, tauCW, tauW_o, tauCWmax, rheight, rlength


# ---------------------------------------------------------------------------
# SG_BBL: Styles & Glenn (1999/2000) (sg_bbl.h)
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class SGBBLParams:
    """sg_bbl.h parameters (SG_CALC_UB + SG_CALC_ZNOT) and the closure
    constants of mod_scalars.F:1450-1468."""
    d50: float = 0.00015
    srho: float = 2650.0
    zob: float = 0.0001
    cdb_min: float = 1.0e-6
    cdb_max: float = 0.5
    calc_znot: bool = True        # SG_CALC_ZNOT moveable-bed roughness
    alpha: float = 1.0            # sg_alpha (constant-stress layer)
    nu: float = 1.19e-6           # sg_nu kinematic viscosity
    n_iter: int = 20              # sg_n


_SG_Z1P = 1.0                     # sg_z1p = sg_alpha
_SG_MP = complex((0.5 / _SG_Z1P) ** 0.5, (0.5 / _SG_Z1P) ** 0.5)


def _kelvin8m(x):
    """The Kelvin functions ber, bei, ker, kei and their derivatives for
    x <= 8 (sg_bbl.h sg_kelvin8m; Abramowitz & Stegun 9.11)."""
    c = 0.125 * x
    xp = [c]
    for _ in range(27):
        xp.append(xp[-1] * c)

    def p(k):
        return xp[k - 1]

    lx = torch.log(torch.clamp(0.5 * x, min=1e-30))
    ber = (1.0 - 64.0 * p(4) + 113.77777774 * p(8) -
           32.36345652 * p(12) + 2.64191397 * p(16) -
           0.08349609 * p(20) + 0.00122552 * p(24) -
           0.00000901 * p(28))
    bei = (16.0 * p(2) - 113.77777774 * p(6) + 72.81777742 * p(10) -
           10.56765779 * p(14) + 0.52185615 * p(18) -
           0.01103667 * p(22) + 0.00011346 * p(26))
    ker = (-ber * lx + 0.25 * math.pi * bei - 0.57721566 -
           59.05819744 * p(4) + 171.36272133 * p(8) -
           60.60977451 * p(12) + 5.65539121 * p(16) -
           0.19636347 * p(20) + 0.00309699 * p(24) -
           0.00002458 * p(28))
    kei = (-bei * lx - 0.25 * math.pi * ber + 6.76454936 * p(2) -
           142.91827687 * p(6) + 124.23569650 * p(10) -
           21.30060904 * p(14) + 1.17509064 * p(18) -
           0.02695875 * p(22) + 0.00029532 * p(26))
    berp = x * (-4.0 * p(2) + 14.22222222 * p(6) - 6.06814810 * p(10) +
                0.66047849 * p(14) - 0.02609253 * p(18) +
                0.00045957 * p(22) - 0.00000394 * p(26))
    beip = x * (0.5 - 10.66666666 * p(4) + 11.37777772 * p(8) -
                2.31167514 * p(12) + 0.14677204 * p(16) -
                0.00379386 * p(20) + 0.00004609 * p(24))
    ox = 1.0 / torch.clamp(x, min=1e-30)
    kerp = (-berp * lx - ber * ox + 0.25 * math.pi * beip +
            x * (-3.69113734 * p(2) + 21.42034017 * p(6) -
                 11.36433272 * p(10) + 1.41384780 * p(14) -
                 0.06136358 * p(18) + 0.00116137 * p(22) -
                 0.00001075 * p(26)))
    keip = (-beip * lx - bei * ox - 0.25 * math.pi * berp +
            x * (0.21139217 - 13.39858846 * p(4) + 19.41182758 * p(8) -
                 4.65950823 * p(12) + 0.33049424 * p(16) -
                 0.00926707 * p(20) + 0.00011997 * p(24)))
    return ber, bei, ker, kei, berp, beip, kerp, keip


_KELVIN_TH = (complex(0.0, -0.3926991), complex(0.0110486, -0.0110485),
              complex(0.0, -0.0009765), complex(-0.0000906, -0.0000901),
              complex(-0.0000252, 0.0), complex(-0.0000034, 0.0000051),
              complex(0.0000006, 0.0000019))
_KELVIN_PH = (complex(0.7071068, 0.7071068), complex(-0.0625001, -1e-7),
              complex(-0.0013813, 0.0013811), complex(0.0000005, 0.0002452),
              complex(0.0000346, 0.0000338), complex(0.0000117, -0.0000024),
              complex(0.0000016, -0.0000032))


def _complex_of(x):
    return torch.complex128 if x.dtype == torch.float64 else torch.complex64


def _kelvin8p(x):
    """The Kelvin functions for x > 8 (sg_bbl.h sg_kelvin8p asymptotics)."""
    c = 8.0 / torch.clamp(x, min=1e-30)
    xps = [c]
    xms = [-c]
    for _ in range(5):
        xps.append(xps[-1] * c)
        xms.append(-xms[-1] * c)
    one = torch.ones_like(x).to(_complex_of(x))

    def series(coefs, xs):
        out = coefs[0] * one
        for k in range(6):
            out = out + coefs[k + 1] * xs[k]
        return out

    thetap = series(_KELVIN_TH, xps)
    thetam = series(_KELVIN_TH, xms)
    phip = series(_KELVIN_PH, xps)
    phim = series(_KELVIN_PH, xms)
    cf = x / math.sqrt(2.0)
    one_i = complex(1.0, 1.0)
    fofx = torch.sqrt(math.pi / (2.0 * x)) * torch.exp(-cf * one_i + thetam)
    gofx = 1.0 / torch.sqrt(2.0 * math.pi * x) * torch.exp(cf * one_i +
                                                           thetap)
    ker, kei = fofx.real, fofx.imag
    ber = gofx.real - kei / math.pi
    bei = gofx.imag + ker / math.pi
    fp = -fofx * phim
    gp = gofx * phip
    kerp, keip = fp.real, fp.imag
    berp = gp.real - keip / math.pi
    beip = gp.imag + kerp / math.pi
    return ber, bei, ker, kei, berp, beip, kerp, keip


def _sg_phi(ubo, row):
    """|gamma| of the Styles-Glenn similarity solution at ub/u*cw = ubo
    (the Kelvin-function block of sg_bstress and sg_purewave)."""
    ro = row / torch.clamp(ubo, min=_EPS)
    znotp = 1.0 / (_VONKAR * torch.clamp(ro, min=_EPS))

    def argi_at(zp):
        x = 2.0 * torch.sqrt(zp)
        km = _kelvin8m(torch.clamp(x, max=8.0))
        kp = _kelvin8p(torch.clamp(x, min=8.0))
        small = x <= 8.0
        ber, bei, ker, kei, berp, beip, kerp, keip = (
            torch.where(small, a, b) for a, b in zip(km, kp))
        cff = 1.0 / torch.sqrt(zp)
        return (torch.complex(ber, bei), torch.complex(ker, kei),
                torch.complex(berp, beip) * cff,
                torch.complex(kerp, keip) * cff)

    bnot, knot, bnotp, knotp = argi_at(znotp)
    b1, k1, b1p, k1p = argi_at(torch.full_like(znotp, _SG_Z1P))
    ll = _SG_MP * b1 + b1p
    nn = _SG_MP * k1 + k1p
    den1 = bnot * nn - knot * ll
    nonzero = torch.abs(den1) > 0
    one = torch.ones_like(den1)
    argi = bnotp * nn / torch.where(nonzero, den1, one) + \
        knotp * ll / torch.where(nonzero, -den1, one)
    gam_kelvin = torch.abs(-_VONKAR * znotp * argi)
    gam_thin = abs(-_VONKAR * _SG_Z1P * _SG_MP) * torch.ones_like(znotp)
    return torch.where(_SG_Z1P / znotp > 1.0, gam_kelvin, gam_thin)


def _sg_mu_eps_fofx(ubouc, row, zrozn, phicw, ubokur):
    """mu, epsilon, the bisection residual f(ubouc) and the clamped ubouc
    (sg_bstress)."""
    phi = _sg_phi(ubouc, row)
    ubouc = torch.minimum(ubouc, 1.0 / phi)     # the monotone clamp loop
    for _ in range(4):
        phi = _sg_phi(ubouc, row)
        ubouc = torch.minimum(ubouc, 1.0 / phi)
    mu = torch.sqrt(ubouc * phi)
    mu2 = mu * mu
    cosphi = torch.abs(torch.cos(phicw))
    eps2 = -mu2 * cosphi + torch.sqrt(torch.clamp(
        1.0 + mu2 * mu2 * (cosphi * cosphi - 1.0), min=0.0))
    epsilon = _where(mu >= 1.0, 0.0, torch.sqrt(torch.clamp(eps2, min=0.0)))
    ro = row / torch.clamp(ubouc, min=_EPS)
    ror = ro / zrozn
    z1ozn = _VONKAR * ro                       # sg_alpha = 1
    zroz1 = 1.0 / torch.clamp(_VONKAR * ror, min=_EPS)
    zroz2 = epsilon * zroz1
    z2ozn = z1ozn / torch.clamp(epsilon, min=_EPS)

    def lz(a):
        return torch.log(torch.clamp(a, min=_EPS))

    # the seven-branch matching ladder (sg_bbl.h sg_bstress:fofx)
    f1 = ubokur * epsilon * (lz(zroz2) + 1.0 - epsilon +
                             epsilon * lz(z1ozn))
    f2 = ubokur * epsilon * epsilon * (zroz1 - 1.0 + lz(z1ozn))
    f3 = ubokur * epsilon * epsilon * lz(zrozn)
    f4 = ubokur * epsilon * (lz(zroz2) + 1.0 - 1.0 / z2ozn)
    f5 = ubokur * epsilon * epsilon * (zroz1 - 1.0 / z1ozn)
    f6 = ubokur * epsilon * lz(zrozn)
    fof = torch.where(
        (zroz2 > 1.0) & (z1ozn > 1.0), f1, torch.where(
            (zroz2 <= 1.0) & (zroz1 > 1.0) & (z1ozn > 1.0), f2, torch.where(
                (zroz1 <= 1.0) & (z1ozn > 1.0), f3, torch.where(
                    (zroz2 > 1.0) & (z1ozn <= 1.0) & (z2ozn > 1.0), f4,
                    torch.where(
                        (zroz2 <= 1.0) & (zroz1 > 1.0) & (z1ozn <= 1.0) &
                        (z2ozn > 1.0), f5,
                        _where((zroz2 > 1.0) & (z2ozn <= 1.0), f6,
                               0.0))))))
    return mu, epsilon, -ubouc + fof, ubouc


def bblm_sg(cfg: Config, grid, p: SGBBLParams, u, v, z_r, z_w, rho,
            Hwave, Pwave, Dwave):
    """One SG (Styles & Glenn 1999) bottom-boundary-layer evaluation
    (sg_bbl.h:183-470): the wave friction of the Kelvin-function
    similarity solution, a bisection for ub/u*cw and the Shields-criterion
    moveable-bed roughness (Wiberg-Harris ripples, sheet-flow kbs).
    Returns (bustr, bvstr, tau_c, tau_w, tau_cwmax, rheight, rlength), as
    bblm."""
    vonKar = _VONKAR
    g = C.g
    Zr, Ur, Vr, Fwave, Ab, Ub, Umag, phicw = _waves_and_current(
        grid, u, v, z_r, z_w, Hwave, Pwave, Dwave, _EPS, False)
    rho_w = rho + 1000.0
    ss = p.srho / rho_w

    # the current stress of the log law with the default roughness
    cff1 = vonKar / torch.log(Zr / p.zob)
    TauC0 = torch.clamp(cff1 * cff1, min=p.cdb_min, max=p.cdb_max) * \
        Umag * Umag

    # moveable-bed roughness (SG_CALC_ZNOT; sg_bbl.h:268-330)
    d50 = p.d50
    chi = 4.0 * p.nu * Ub * Ub / (d50 * ((ss - 1.0) * g * d50) ** 1.5)
    if p.calc_znot:
        star = d50 / (4.0 * p.nu) * torch.sqrt((ss - 1.0) * g * d50)
        shldcr = torch.where(
            star <= 1.5, 0.0932 * star ** (-0.707), torch.where(
                star < 4.0, 0.0848 * star ** (-0.473), torch.where(
                    star < 10.0, 0.0680 * star ** (-0.314), _where(
                        star < 34.0, 0.033, _where(
                            star < 270.0, 0.0134 * star ** 0.255, 0.056)))))
        abokb_d = Ab / d50
        fwm0 = torch.where(
            abokb_d <= 100.0,
            torch.exp(7.02 * torch.clamp(abokb_d, min=0.1) ** (-0.078) -
                      8.82),
            torch.exp(5.61 * abokb_d ** (-0.109) - 7.30))
        ustarwm0 = torch.sqrt(0.5 * fwm0) * Ub
        shld = ustarwm0 ** 2 / ((ss - 1.0) * d50 * g)
        eta_m = torch.where(chi <= 2.0, Ab * 0.30 * chi ** (-0.39),
                            Ab * 0.45 * chi ** (-0.99))
        lam_m = torch.where(chi <= 2.0, Ab * 1.96 * chi ** (-0.28),
                            Ab * 2.71 * chi ** (-0.75))
        kbs = Ab * 0.0655 * (Ub * Ub / ((ss - 1.0) * g * Ab)) ** 1.4
        znot_mb = (d50 + 2.3 * eta_m + kbs) / 30.0
        moving = shld / shldcr > 1.0
        znot = _where(moving, znot_mb, p.zob)
        rheight = _where(moving, eta_m, 0.0)
        rlength = _where(moving, lam_m, 0.0)
    else:
        znot = p.zob * torch.ones_like(Umag)
        rheight = torch.where(chi <= 2.0, Ab * 0.32 * chi ** (-0.34),
                              Ab * 0.52 * chi ** (-1.01))
        rlength = torch.where(chi <= 2.0, Ab * 2.04 * chi ** (-0.23),
                              Ab * 2.7 * chi ** (-0.78))

    # the wave-current solution (sg_bstress bisection)
    row = Ab / znot
    zrozn = Zr / znot
    ubokur = Ub / (vonKar * Umag)
    # the pure-wave upper bound: sg_purewave's fixed point
    abokb = Ab / (30.0 * znot)
    fwm = torch.where(
        abokb <= 100.0,
        torch.exp(-8.82 + 7.02 * torch.clamp(abokb, min=0.1) ** (-0.078)),
        torch.exp(-7.30 + 5.61 * abokb ** (-0.109)))
    ubouwm = torch.sqrt(2.0 / fwm)
    for _ in range(p.n_iter):
        ubouwm = 1.0 / _sg_phi(ubouwm, row)

    a1 = torch.full_like(Umag, 1.0e-6)
    b1 = ubouwm
    _, _, fofa, _ = _sg_mu_eps_fofx(a1, row, zrozn, phicw, ubokur)
    fofb = -fofa
    c1 = 0.5 * (a1 + b1)
    for _ in range(p.n_iter):
        _, _, fofc, _ = _sg_mu_eps_fofx(c1, row, zrozn, phicw, ubokur)
        opposite = fofb * fofc < 0.0
        a1 = torch.where(opposite, c1, a1)
        b1 = torch.where(opposite, b1, c1)
        c1 = 0.5 * (a1 + b1)
    mu, epsilon, _, ubouc = _sg_mu_eps_fofx(c1, row, zrozn, phicw, ubokur)

    ustarcw = Ub / torch.clamp(ubouc, min=_EPS)
    ustarwm = mu * ustarcw
    ustarc = torch.maximum(torch.sqrt(TauC0), epsilon * ustarcw)
    both = (Umag > 1e-6) & (Ub > 1e-4) & (zrozn > 1.0)
    TauC = torch.where(both, ustarc * ustarc, TauC0)
    TauW = torch.where(both, ustarwm * ustarwm, 0.5 * fwm * Ub * Ub)
    TauCWmax = torch.where(both, _combined_max(TauC, TauW, phicw),
                           torch.maximum(TauC, TauW))
    bustr, bvstr = _uv_stress(cfg, grid, z_w, Ur, Vr, Umag, TauC)
    return bustr, bvstr, TauC, TauW, TauCWmax, rheight, rlength
