"""COARE 3.0 bulk air-sea fluxes (counterpart of ``roms_tpu/ops/bulk_flux.py``;
ROMS/Nonlinear/bulk_flux.F, Fairall et al. 1996; stability functions
Beljaars & Holtslag 1991 / Grachev et al. 2000), with the Zillman/Laevastu
analytic shortwave with albedo (ana_srflux.h ALBEDO) and the Berliand
longwave (LONGWAVE).

Vectorized over the horizontal; the reference's Monin-Obukhov loop runs
ITERMAX fixed iterations.
"""

from __future__ import annotations

import math

import torch

from .. import constants as C
from ..config import Config
from . import bc
from .stencil import im1, jm1

# mod_scalars.F:1415-1419, 435-437
blk_Cpa = 1004.67
blk_Cpw = 4000.0
blk_Rgas = 287.1
blk_Zabl = 600.0
blk_beta = 1.2
StefBo = 5.67e-8
emmiss = 0.97
rhow = 1000.0
Csolar = 1353.0
vonKar = 0.41
_eps = 1.0e-20
ITERMAX = 3
_S3 = math.sqrt(3.0)


def _psiu(ZoL):
    """bulk_psiu (bulk_flux.F:604-668)."""
    pi = C.pi
    x = torch.clamp(1.0 - 15.0 * ZoL, min=_eps) ** 0.25
    psik = 2.0 * torch.log(0.5 * (1.0 + x)) + \
        torch.log(0.5 * (1.0 + x * x)) - 2.0 * torch.atan(x) + 0.5 * pi
    y = torch.clamp(1.0 - 10.15 * ZoL, min=_eps) ** (1.0 / 3.0)
    psic = 1.5 * torch.log((1.0 + y + y * y) / 3.0) - \
        _S3 * torch.atan((1.0 + 2.0 * y) / _S3) + pi / _S3
    Fw = ZoL * ZoL / (1.0 + ZoL * ZoL)
    unstable = (1.0 - Fw) * psik + Fw * psic
    cff = torch.clamp(0.35 * ZoL, max=50.0)
    stable = -((1.0 + ZoL) + 0.6667 * (ZoL - 14.28) / torch.exp(cff) +
               8.525)
    return torch.where(ZoL < 0.0, unstable, stable)


def _psit(ZoL):
    """bulk_psit (bulk_flux.F:670-730)."""
    pi = C.pi
    x = torch.sqrt(torch.clamp(1.0 - 15.0 * ZoL, min=_eps))
    psik = 2.0 * torch.log(0.5 * (1.0 + x))
    y = torch.clamp(1.0 - 34.15 * ZoL, min=_eps) ** (1.0 / 3.0)
    psic = 1.5 * torch.log((1.0 + y + y * y) / 3.0) - \
        _S3 * torch.atan((1.0 + 2.0 * y) / _S3) + pi / _S3
    Fw = ZoL * ZoL / (1.0 + ZoL * ZoL)
    unstable = (1.0 - Fw) * psik + Fw * psic
    cff = torch.clamp(0.35 * ZoL, max=50.0)
    stable = -((1.0 + 2.0 * ZoL) ** 1.5 +
               0.6667 * (ZoL - 14.28) / torch.exp(cff) + 8.525)
    return torch.where(ZoL < 0.0, unstable, stable)


def ana_srflux_albedo(cfg: Config, lonr, latr, Tair, Hair, cloud,
                      tdays: float):
    """Zillman cloudless shortwave with the Laevastu cloud correction and
    ocean albedo, modulated by the diurnal cycle (ana_srflux.h ALBEDO).
    Returns srflx in degC m/s.  Calendar: day of year and hour from tdays
    (idealized runs start at time reference zero)."""
    pi = C.pi
    yday = tdays % 365.2425 + 1.0
    hour = 24.0 * (tdays % 1.0)
    Dangle = 23.44 * math.cos((172.0 - yday) * 2.0 * pi / 365.2425) * \
        C.deg2rad
    Hangle = (12.0 - hour) * pi / 12.0
    Rsolar = Csolar / (cfg.rho0 * C.Cp)
    LatRad = latr * C.deg2rad
    cff1 = torch.sin(LatRad) * math.sin(Dangle)
    cff2 = torch.cos(LatRad) * math.cos(Dangle)
    zenith = cff1 + cff2 * torch.cos(Hangle - lonr * C.deg2rad)
    cffT = (0.7859 + 0.03477 * Tair) / (1.0 + 0.00412 * Tair)
    e_sat = 10.0 ** cffT
    vap_p = e_sat * Hair
    srflx = torch.where(
        zenith > 0.0,
        Rsolar * zenith * zenith * (1.0 - 0.6 * cloud ** 3) /
        ((zenith + 2.7) * vap_p * 1.0e-3 + 1.085 * zenith + 0.1),
        torch.zeros_like(zenith))
    return (1.0 - 0.06) * srflx          # alb_w = 0.06


def bulk_flux(cfg: Config, grid, t_surf, srflx,
              Uwind, Vwind, Tair, Pair, Hair, cloud, rain,
              blk_ZW: float = 10.0, blk_ZT: float = 10.0,
              blk_ZQ: float = 10.0):
    """COARE 3.0 fluxes.

    Inputs at rho points: t_surf (sea temperature, C), srflx (degC m/s),
    Uwind/Vwind (m/s at blk_ZW), Tair (C), Pair (mb), Hair (RH fraction),
    cloud (fraction), rain (kg/m2/s).

    Returns dict(sustr, svstr (m2/s2 at u/v points), stflux_temp
    (degC m/s), lrflx, lhflx, shflx, emp (E-P, m/s)).
    """
    g = C.g
    rho0 = cfg.rho0
    Hscale = rho0 * C.Cp
    r3 = 1.0 / 3.0

    Wmag = torch.sqrt(Uwind ** 2 + Vwind ** 2)
    TairC = Tair
    TairK = TairC + 273.16
    TseaC = t_surf
    TseaK = TseaC + 273.16
    RH = Hair

    # Berliand net longwave (W/m2)
    cffT = (0.7859 + 0.03477 * TairC) / (1.0 + 0.00412 * TairC)
    e_sat = 10.0 ** cffT
    vap_p = e_sat * RH
    t3 = TairK ** 3
    LRad = -emmiss * StefBo * (
        t3 * TairK * (0.39 - 0.05 * torch.sqrt(vap_p)) *
        (1.0 - 0.6823 * cloud * cloud) +
        t3 * 4.0 * (TseaK - TairK))

    # specific humidities (Teten/Buck)
    cff = (1.0007 + 3.46e-6 * Pair) * 6.1121 * \
        torch.exp(17.502 * TairC / (240.97 + TairC))
    Qair = 0.62197 * (cff / (Pair - 0.378 * cff))
    cffq = cff * RH
    Q = torch.where(RH < 2.0,
                    0.62197 * (cffq / (Pair - 0.378 * cffq)),
                    RH / 1000.0)
    cff = (1.0007 + 3.46e-6 * Pair) * 6.1121 * \
        torch.exp(17.502 * TseaC / (240.97 + TseaC)) * 0.98
    Qsea = 0.62197 * (cff / (Pair - 0.378 * cff))

    rhoAir = Pair * 100.0 / (blk_Rgas * TairK * (1.0 + 0.61 * Q))
    VisAir = 1.326e-5 * (1.0 + TairC * (6.542e-3 + TairC *
                                        (8.301e-6 - 4.84e-9 * TairC)))
    Hlv = (2.501 - 0.00237 * TseaC) * 1.0e6

    Wgus = torch.full_like(Wmag, 0.5)
    delW = torch.sqrt(Wmag ** 2 + Wgus ** 2)
    delQ = Qsea - Q
    delT = TseaC - TairC

    # neutral first guesses (bulk_flux.F:370-420)
    ZoW = 0.0001
    u10 = delW * math.log(10.0 / ZoW) / math.log(blk_ZW / ZoW)
    Wstar = 0.035 * u10
    Zo10 = 0.011 * Wstar * Wstar / g + 0.11 * VisAir / Wstar
    Cd10 = (vonKar / torch.log(10.0 / Zo10)) ** 2
    Ct10 = 0.00115 / torch.sqrt(Cd10)
    ZoT10 = 10.0 / torch.exp(vonKar / Ct10)
    Cd = (vonKar / torch.log(blk_ZW / Zo10)) ** 2
    Ct = vonKar / torch.log(blk_ZT / ZoT10)
    CC = vonKar * Ct / Cd
    Ribcu = -blk_ZW / (blk_Zabl * 0.004 * blk_beta ** 3)
    Ri = -g * blk_ZW * (delT + 0.61 * TairK * delQ) / \
        (TairK * delW * delW)
    Zetu = torch.where(Ri < 0.0,
                       CC * Ri / (1.0 + Ri / Ribcu),
                       CC * Ri / (1.0 + 3.0 * Ri / CC))
    L10 = blk_ZW / Zetu
    Wstar = delW * vonKar / (torch.log(blk_ZW / Zo10) - _psiu(blk_ZW / L10))
    Tstar = -delT * vonKar / (torch.log(blk_ZT / ZoT10) -
                              _psit(blk_ZT / L10))
    Qstar = -delQ * vonKar / (torch.log(blk_ZQ / ZoT10) -
                              _psit(blk_ZQ / L10))
    charn = torch.where(
        delW > 18.0, torch.full_like(delW, 0.018),
        torch.where(delW > 10.0,
                    0.011 + 0.125 * (0.018 - 0.011) * (delW - 10.0),
                    torch.full_like(delW, 0.011)))

    # Monin-Obukhov iteration (ITERMAX fixed iterations)
    for _ in range(ITERMAX):
        ZoW = charn * Wstar * Wstar / g + 0.11 * VisAir / (Wstar + _eps)
        Rr = ZoW * Wstar / VisAir
        ZoQ = torch.clamp(5.5e-5 / Rr ** 0.6, max=1.15e-4)
        ZoT = ZoQ
        ZoL = vonKar * g * blk_ZW * (
            Tstar * (1.0 + 0.61 * Q) + 0.61 * TairK * Qstar) / \
            (TairK * Wstar * Wstar * (1.0 + 0.61 * Q) + _eps)
        L = blk_ZW / (ZoL + _eps)
        Wpsi = _psiu(ZoL)
        Tpsi = _psit(blk_ZT / L)
        Qpsi = _psit(blk_ZQ / L)
        Wstar = torch.clamp(delW * vonKar / (torch.log(blk_ZW / ZoW) - Wpsi),
                            min=_eps)
        Tstar = -delT * vonKar / (torch.log(blk_ZT / ZoT) - Tpsi)
        Qstar = -delQ * vonKar / (torch.log(blk_ZQ / ZoQ) - Qpsi)
        Bf = -g / TairK * Wstar * (Tstar + 0.61 * TairK * Qstar)
        Wgus = torch.where(Bf > 0.0, blk_beta * (Bf * blk_Zabl) ** r3,
                           torch.full_like(Bf, 0.2))
        delW = torch.sqrt(Wmag ** 2 + Wgus ** 2)

    # fluxes (bulk_flux.F:478-548)
    Wspeed = torch.sqrt(Wmag ** 2 + Wgus ** 2)
    Cd = Wstar * Wstar / (Wspeed * Wspeed + _eps)
    Hs = -blk_Cpa * rhoAir * Wstar * Tstar
    diffw = 2.11e-5 * (TairK / 273.16) ** 1.94
    diffh = 0.02411 * (1.0 + TairC * (3.309e-3 - 1.44e-6 * TairC)) / \
        (rhoAir * blk_Cpa)
    cffr = Qair * Hlv / (blk_Rgas * TairK * TairK)
    wet_bulb = 1.0 / (1.0 + 0.622 * (cffr * Hlv * diffw) /
                      (blk_Cpa * diffh))
    Hsr = rain * wet_bulb * blk_Cpw * (
        (TseaC - TairC) + (Qsea - Q) * Hlv / blk_Cpa)
    SHeat = Hs + Hsr
    Hl = -Hlv * rhoAir * Wstar * Qstar
    upvel = -1.61 * Wstar * Qstar - \
        (1.0 + 1.61 * Q) * Wstar * Tstar / TairK
    Hlw = rhoAir * Hlv * upvel * Q
    LHeat = Hl + Hlw
    Taur = 0.85 * rain * Wmag
    cfft = rhoAir * Cd * Wspeed
    Taux = cfft * Uwind + Taur * torch.sign(Uwind)
    Tauy = cfft * Vwind + Taur * torch.sign(Vwind)

    Hscale_inv = 1.0 / Hscale
    lrflx = LRad * Hscale_inv
    lhflx = -LHeat * Hscale_inv
    shflx = -SHeat * Hscale_inv
    stflux_temp = srflx + lrflx + lhflx + shflx
    evap = LHeat / Hlv
    emp = (evap - rain) / rhow          # E-P (m/s) for EMINUSP runs

    cffs = 0.5 / rho0
    sustr = cffs * (im1(Taux) + Taux)
    svstr = cffs * (jm1(Tauy) + Tauy)
    return {
        "sustr": bc.fill_halo(cfg, sustr),
        "svstr": bc.fill_halo(cfg, svstr),
        "stflux_temp": bc.fill_halo(cfg, stflux_temp),
        "lrflx": lrflx, "lhflx": lhflx, "shflx": shflx, "emp": emp,
    }
