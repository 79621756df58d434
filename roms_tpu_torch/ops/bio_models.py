"""The other ecosystem models of the biology slot (counterpart of
``roms_tpu/ops/bio_models.py``; ROMS/Nonlinear/Biology/):

 * npzd_Franks.h  - the Franks et al. (1986) NPZD;
 * npzd_iron.h    - Powell's NPZD with iron limitation (IRON_LIMIT,
                    IRON_RELAX);
 * fennel.h       - Fennel et al. (2006) nitrogen-cycle BGC with the PO4,
                    OXYGEN, CARBON (pCO2 air-sea flux), DENITRIFICATION and
                    BIO_SEDIMENT options;
 * hypoxia_srm.h  - the hypoxia simple respiration model;
 * nemuro.h       - NEMURO's lower trophic levels (Kishi et al. 2007);
 * red_tide.h     - the Alexandrium red-tide model (Stock et al. 2005);
 * ecosim.h       - a reduced EcoSim (Bissett et al. 1999): spectral light,
                    Droop quotas, a bacterial loop.

Each has ops/biology.py's design: every conversion treats the consumed
compartment backward-implicitly, the compartments are a list of (N,Ny,Nx)
tensors updated in roms_tpu's order, and the increment from the old time
level goes onto the new tracers.  Sinking is ops/settling.ppm_sink; the
red tide's upward swimming is ppm_swim here.  The surface CO2 system
(pco2_water) is a fixed 50-step bisection over the surface plane, the
branchless form of the reference's bracket-and-bisect default.  The
spectral and monthly tables are numpy constants, made tensors on the
state's device and in its dtype at each call.  Plain PyTorch: no kernel.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ..config import Config
from ..constants import rho0_default as rho0, Cp
from .biology import (NPZDParams, _MINVAL, _light, _positive_definite,
                      _rev_cumsum, add_increment, surface_par)
from .settling import ppm_sink


def _stack_old(t_old, idb, floor: bool):
    """The bio compartments of t_old as a list, floored at zero or made
    positive-definite."""
    if floor:
        return [torch.clamp(t_old[i], min=0.0) for i in idb]
    return list(_positive_definite(torch.stack([t_old[i] for i in idb])))


def _add_level(a, k: int, v):
    """a (N,Ny,Nx) with v added at level k."""
    out = a.clone()
    out[k] = a[k] + v
    return out


def _set_level(a, k: int, v):
    out = a.clone()
    out[k] = v
    return out


# =====================================================================
# NPZD Franks (npzd_Franks.h)
# =====================================================================

@dataclass(frozen=True)
class FranksParams:
    """npzd_Franks.in defaults (External/npzd_Franks.in:49-106)."""
    BioIter: int = 1
    K_ext: float = 0.06    # 1/m light extinction
    K_NO3: float = 0.1     # mmol/m3 half-saturation
    K_Phy: float = 0.4     # mmol/m3 grazing half-saturation
    Vm_NO3: float = 2.0    # 1/day max uptake
    PhyMR: float = 0.05    # 1/day P mortality -> D
    ZooGR: float = 0.6     # 1/day max grazing
    ZooMR: float = 0.2     # 1/day Z mortality -> N
    ZooMD: float = 0.05    # 1/day Z mortality -> D
    ZooGA: float = 0.3     # grazing inefficiency -> D
    ZooEC: float = 0.15    # grazing excreted -> N
    DetRR: float = 0.1     # 1/day remineralization
    wDet: float = 5.0      # m/day detritus sinking


def npzd_franks(cfg: Config, p: FranksParams, t_old, t_new, Hz, z_w, z_r,
                srflx=None):
    """The Franks NPZD conversions (npzd_Franks.h:316-380): Michaelis-Menten
    uptake under light exp(K_ext z_r), quadratic-saturation grazing, linear
    mortalities, remineralization and detritus sinking."""
    idb = cfg.ibio
    if len(idb) != 4:
        raise ValueError(f"npzd_franks needs 4 bio tracers, got {idb}")
    iN, iP, iZ, iD = 0, 1, 2, 3
    dtd = cfg.dt / 86400.0 / max(1, p.BioIter)

    bio = _stack_old(t_old, idb, floor=False)
    bio_old = list(bio)

    for _ in range(max(1, p.BioIter)):
        # nutrient uptake under light exp(K_ext z_r) (npzd_Franks.h:316)
        cff = bio[iP] * dtd * p.Vm_NO3 * torch.exp(p.K_ext * z_r) / \
            (p.K_NO3 + bio[iN])
        n_new = bio[iN] / (1.0 + cff)
        bio[iN] = n_new
        bio[iP] = bio[iP] + n_new * cff

        # grazing (quadratic saturation) and P mortality in one implicit
        # stage (npzd_Franks.h:330-350)
        cff = bio[iZ] * bio[iP] * dtd * p.ZooGR / \
            (p.K_Phy * p.K_Phy + bio[iP] * bio[iP])
        cff2 = dtd * p.PhyMR
        p_new = bio[iP] / (1.0 + cff + cff2)
        bio[iP] = p_new
        bio[iZ] = bio[iZ] + p_new * cff * (1.0 - p.ZooGA)
        bio[iD] = bio[iD] + p_new * (cff2 + cff * (p.ZooGA - p.ZooEC))
        bio[iN] = bio[iN] + p_new * cff * p.ZooEC

        # Z excretion -> N and mortality -> D (npzd_Franks.h:354-366)
        z_new = bio[iZ] / (1.0 + dtd * (p.ZooMR + p.ZooMD))
        bio[iZ] = z_new
        bio[iN] = bio[iN] + z_new * dtd * p.ZooMR
        bio[iD] = bio[iD] + z_new * dtd * p.ZooMD

        # remineralization (npzd_Franks.h:370-378)
        d_new = bio[iD] / (1.0 + dtd * p.DetRR)
        bio[iD] = d_new
        bio[iN] = bio[iN] + d_new * dtd * p.DetRR

        # detritus sinking (npzd_Franks.h:176-181)
        if p.wDet != 0.0:
            bio[iD] = ppm_sink(bio[iD], Hz, z_w, dtd * abs(p.wDet))[0]

    return add_increment(t_new, idb, bio, bio_old)


# =====================================================================
# NPZD iron (npzd_iron.h)
# =====================================================================

@dataclass(frozen=True)
class IronParams:
    """npzd_iron.in defaults (External/npzd_iron.in:49-120)."""
    BioIter: int = 1
    PARfrac: float = 0.43
    AttSW: float = 0.067
    AttPhy: float = 0.04
    PhyIS: float = 0.02
    Vm_NO3: float = 1.0
    PhyMRD: float = 0.1
    PhyMRN: float = 0.0
    K_NO3: float = 1.0
    Ivlev: float = 0.84
    ZooGR: float = 0.65
    ZooEED: float = 0.0
    ZooEEN: float = 0.3
    ZooMRD: float = 0.145
    ZooMRN: float = 0.0
    DetRR: float = 1.0
    wPhy: float = 0.0
    wDet: float = 8.0
    # iron (IRON_LIMIT)
    T_Fe: float = 1.0      # days, Fe uptake time scale
    A_Fe: float = 0.6      # Fe:C empirical exponent
    B_Fe: float = 64.0     # Fe:C empirical factor
    K_FeC: float = 16.9    # umol-Fe/mol-C half-saturation
    FeRR: float = 0.5      # Fe remineralization fraction
    # IRON_RELAX coastal source
    iron_relax: bool = False
    FeHmin: float = 200.0  # m, relax where h <= FeHmin
    FeNudgTime: float = 5.0   # days
    FeMax: float = 2.0     # mmol/m3 target
    const_par: Optional[float] = None


_FeN2FeC = (16.0 / 106.0) * 1.0e3     # umol-Fe/mmol-N -> umol-Fe/mol-C
_FeC2FeN = (106.0 / 16.0) * 1.0e-3


def npzd_iron(cfg: Config, p: IronParams, grid, t_old, t_new, Hz, z_w,
              srflx):
    """Powell's NPZD with iron limitation (npzd_iron.h:330-612).  Six
    compartments: NO3, Phy, Zoo, SDet, Fdis, Fphy (cfg.ibio order)."""
    idb = cfg.ibio
    if len(idb) != 6:
        raise ValueError(f"npzd_iron needs 6 bio tracers, got {idb}")
    iN, iP, iZ, iD, iFd, iFp = 0, 1, 2, 3, 4, 5
    dtd = cfg.dt / 86400.0 / max(1, p.BioIter)

    bio = _stack_old(t_old, idb, floor=False)

    # IRON_RELAX: the coastal dissolved-iron source (npzd_iron.h:306-316),
    # before the reaction chain and in the increment
    if p.iron_relax:
        coef = cfg.dt / (p.FeNudgTime * 86400.0)
        shallow = grid.h <= p.FeHmin
        src = coef * (p.FeMax - bio[iFd])
        bio[iFd] = bio[iFd] + torch.where(shallow[None], src,
                                          torch.zeros_like(src))
        bio_old = list(_positive_definite(torch.stack([t_old[i]
                                                       for i in idb])))
    else:
        bio_old = list(_positive_definite(torch.stack(bio)))

    par_sur = surface_par(p, bio[0][0], srflx)
    lp = NPZDParams(AttSW=p.AttSW, AttPhy=p.AttPhy)
    for _ in range(max(1, p.BioIter)):
        light = _light(lp, bio[iP], z_w, par_sur)

        # iron-limited uptake (npzd_iron.h:428-466)
        FNratio = bio[iFp] / torch.clamp(bio[iP], min=_MINVAL)
        FCratio = FNratio * _FeN2FeC
        FCratioE = p.B_Fe * torch.clamp(bio[iFd], min=0.0) ** p.A_Fe
        Flimit = FCratio ** 2 / (FCratio ** 2 + p.K_FeC ** 2)
        Nlimit = torch.div(1.0, p.K_NO3 + bio[iN])
        FNlim = torch.clamp(Flimit / torch.clamp(bio[iN] * Nlimit,
                                                 min=_MINVAL), max=1.0)
        cff4 = torch.div(1.0, torch.sqrt(p.Vm_NO3 ** 2 +
                                         p.PhyIS ** 2 * light ** 2))
        cff = bio[iP] * dtd * p.Vm_NO3 * p.PhyIS * cff4 * light * \
            FNlim * Nlimit
        n_new = bio[iN] / (1.0 + cff)
        bio[iN] = n_new
        bio[iP] = bio[iP] + n_new * cff

        # iron uptake in proportion to growth (npzd_iron.h:470-476)
        fac = cff * n_new * FNratio / torch.clamp(bio[iFd], min=_MINVAL)
        fd_new = bio[iFd] / (1.0 + fac)
        bio[iFd] = fd_new
        bio[iFp] = bio[iFp] + fd_new * fac

        # relax Fe:C toward the empirical ratio (npzd_iron.h:478-492)
        cff5 = dtd * (FCratioE - FCratio) / p.T_Fe
        cff6 = bio[iP] * cff5 * _FeC2FeN
        cff_up = torch.clamp(cff6, min=0.0) / torch.clamp(bio[iFd],
                                                          min=_MINVAL)
        cff_dn = torch.clamp(-cff6, min=0.0) / torch.clamp(bio[iFp],
                                                           min=_MINVAL)
        fd1 = bio[iFd] / (1.0 + cff_up)
        fp1 = bio[iFp] + fd1 * cff_up
        fp2 = fp1 / (1.0 + cff_dn)
        fd2 = fd1 + fp2 * cff_dn
        bio[iFd] = fd2
        bio[iFp] = fp2

        # Ivlev grazing with sloppy feeding and Fe release (h:505-524)
        cff = bio[iZ] * dtd * p.ZooGR * \
            (1.0 - torch.exp(-p.Ivlev * bio[iP])) / bio[iP]
        p_new = bio[iP] / (1.0 + cff)
        fp_new = bio[iFp] / (1.0 + cff)
        bio[iP] = p_new
        bio[iZ] = bio[iZ] + p_new * (1.0 - p.ZooEEN - p.ZooEED) * cff
        bio[iN] = bio[iN] + p_new * p.ZooEEN * cff
        bio[iD] = bio[iD] + p_new * p.ZooEED * cff
        bio[iFp] = fp_new
        bio[iFd] = bio[iFd] + fp_new * cff * p.FeRR

        # P mortality and Fe release (h:527-546)
        cffm = dtd * (p.PhyMRN + p.PhyMRD)
        p_new = bio[iP] / (1.0 + cffm)
        fp_new = bio[iFp] / (1.0 + cffm)
        bio[iP] = p_new
        bio[iN] = bio[iN] + p_new * dtd * p.PhyMRN
        bio[iD] = bio[iD] + p_new * dtd * p.PhyMRD
        bio[iFp] = fp_new
        bio[iFd] = bio[iFd] + fp_new * cffm * p.FeRR

        # Z mortality (h:548-562)
        z_new = bio[iZ] / (1.0 + dtd * (p.ZooMRN + p.ZooMRD))
        bio[iZ] = z_new
        bio[iN] = bio[iN] + z_new * dtd * p.ZooMRN
        bio[iD] = bio[iD] + z_new * dtd * p.ZooMRD

        # remineralization (h:564-574)
        d_new = bio[iD] / (1.0 + dtd * p.DetRR)
        bio[iD] = d_new
        bio[iN] = bio[iN] + d_new * dtd * p.DetRR

        # sinking of Phy and SDet (npzd_iron.h:221-228)
        for (comp, w) in ((iP, p.wPhy), (iD, p.wDet)):
            if w != 0.0:
                bio[comp] = ppm_sink(bio[comp], Hz, z_w, dtd * abs(w))[0]

    return add_increment(t_new, idb, bio, bio_old)


# =====================================================================
# Fennel et al. (2006) biogeochemistry (fennel.h)
# =====================================================================

@dataclass(frozen=True)
class FennelParams:
    """bio_Fennel.in defaults (External/bio_Fennel.in:49-90)."""
    BioIter: int = 1
    AttSW: float = 0.04       # 1/m
    AttChl: float = 0.02486   # m2/mg_Chl
    PARfrac: float = 0.43
    Vp0: float = 1.0          # Eppley max growth factor
    I_thNH4: float = 0.0095   # W/m2 nitrification threshold
    D_p5NH4: float = 0.1      # W/m2 nitrification half-dose
    NitriR: float = 0.05      # 1/day
    K_NO3: float = 2.0        # 1/(mmol/m3) (inverse half-saturation!)
    K_NH4: float = 2.0        # 1/(mmol/m3)
    K_PO4: float = 32.0       # 1/(mmol/m3)
    K_Phy: float = 2.0        # (mmol/m3)^2
    Chl2C_m: float = 0.0535   # mg_Chl/mg_C max ratio
    ChlMin: float = 0.001
    PhyCN: float = 6.625      # mol_C/mol_N
    R_P2N: float = 0.0625     # mol_P/mol_N
    PhyIS: float = 0.025      # 1/(W/m2/day)
    PhyMin: float = 0.001
    PhyMR: float = 0.15       # 1/day
    ZooAE_N: float = 0.75     # assimilation efficiency
    ZooBM: float = 0.1        # 1/day basal metabolism
    ZooCN: float = 6.625
    ZooER: float = 0.1        # 1/day excretion
    ZooGR: float = 0.6        # 1/day grazing
    ZooMin: float = 0.001
    ZooMR: float = 0.025      # 1/day mortality
    LDeRRN: float = 0.01      # 1/day large-detritus N remin
    LDeRRC: float = 0.01
    CoagR: float = 0.005      # 1/day coagulation
    SDeRRN: float = 0.03
    SDeRRC: float = 0.03
    wPhy: float = 0.1         # m/day
    wLDet: float = 1.0
    wSDet: float = 0.1
    pCO2air: float = 370.0    # ppmv
    # option flags (the CPP options)
    oxygen: bool = False      # OXYGEN
    carbon: bool = False      # CARBON (adds LDeC, SDeC, TIC, TAlk)
    po4: bool = False         # PO4
    denitrification: bool = False   # DENITRIFICATION
    bio_sediment: bool = True       # BIO_SEDIMENT
    talk_nonconserv: bool = False   # TALK_NONCONSERV
    const_par: Optional[float] = None


# O2 Schmidt number (Wanninkhof 1992) and saturation (Garcia & Gordon
# 1992) coefficients; fennel.h:368-384
_A_O2, _B_O2, _C_O2, _D_O2, _E_O2 = 1953.4, 128.0, 3.9918, 0.050091, 0.0
_OA = (2.00907, 3.22014, 4.05010, 4.94457, -0.256847, 3.88767)
_OB = (-0.00624523, -0.00737614, -0.0103410, -0.00817083)
_OC0 = -0.000000488682
_rOxNO3 = 8.625           # 138/16, fennel.h:385
_rOxNH4 = 6.625           # 106/16
_l2mol = 1000.0 / 22.3916
# CO2 Schmidt (Wanninkhof 1992) and solubility (Weiss 1974); h:400-413
_A_CO2, _B_CO2, _C_CO2, _D_CO2, _E_CO2 = (2073.1, 125.62, 3.6276,
                                          0.043219, 0.0)
_CO2SOL = (-60.2409, 93.4517, 23.3585, 0.023517, -0.023656, 0.0047036)
PCO2_ITERS = 50           # pco2_water's bisection steps


def o2_saturation(temp, salt):
    """O2 saturation (mmol/m3), Garcia & Gordon (1992) (fennel.h:1128)."""
    ts = torch.log((298.15 - temp) / (273.15 + temp))
    a0, a1, a2, a3, a4, a5 = _OA
    b0, b1, b2, b3 = _OB
    aa = a0 + ts * (a1 + ts * (a2 + ts * (a3 + ts * (a4 + ts * a5)))) + \
        salt * (b0 + ts * (b1 + ts * (b2 + ts * b3))) + \
        _OC0 * salt * salt
    return _l2mol * torch.exp(aa)


def pco2_water(temp, salt, tic, talk, po4=0.0, sio3=0.0,
               iters=PCO2_ITERS):
    """Surface seawater pCO2 (ppmv) and pH: the carbonate system of
    fennel.h:1938-2372 (pCO2_water), solved by a fixed count of bisection
    steps on the total-alkalinity balance (the DoNewton=0 default), each
    step a torch.where over the plane.

    Check value (fennel.h:1953-1956): T=24, S=36.6, TIC=2040, TAlk=2390,
    PO4=SiO3=0 -> pCO2 = 350.74945 ppmv."""
    Tk = temp + 273.15
    centiTk = 0.01 * Tk
    invTk = torch.div(1.0, Tk)
    logTk = torch.log(Tk)
    sqrtS = torch.sqrt(salt)
    SO4 = 19.924 * salt / (1000.0 - 1.005 * salt)
    sqrtSO4 = torch.sqrt(SO4)
    scl = salt / 1.80655
    alk = talk * 1.0e-6
    dic = tic * 1.0e-6
    phos = po4 * 1.0e-6
    sili = sio3 * 1.0e-6

    ff = torch.exp(-162.8301 + torch.div(218.2968, centiTk) +
                   torch.log(centiTk) * 90.9241 -
                   centiTk * centiTk * 1.47696 +
                   salt * (0.025695 - centiTk * (0.025225 -
                                                 centiTk * 0.0049867)))
    K1 = 10.0 ** (62.008 - invTk * 3670.7 - logTk * 9.7944 +
                  salt * (0.0118 - salt * 0.000116))
    K2 = 10.0 ** (-4.777 - invTk * 1394.7 + salt * (0.0184 -
                                                    salt * 0.000118))
    Kb = torch.exp(-invTk * (8966.90 + sqrtS * (2890.53 + sqrtS * (
        77.942 - sqrtS * (1.728 - sqrtS * 0.0996)))) -
        logTk * (24.4344 + sqrtS * (25.085 + sqrtS * 0.2474)) +
        Tk * (sqrtS * 0.053105) + 148.0248 +
        sqrtS * (137.1942 + sqrtS * 1.62142))
    K1p = torch.exp(115.525 - invTk * 4576.752 - logTk * 18.453 +
                    sqrtS * (0.69171 - invTk * 106.736) -
                    salt * (0.01844 + invTk * 0.65643))
    K2p = torch.exp(172.0883 - invTk * 8814.715 - logTk * 27.927 +
                    sqrtS * (1.3566 - invTk * 160.340) -
                    salt * (0.05778 - invTk * 0.37335))
    K3p = torch.exp(-18.141 - invTk * 3070.75 +
                    sqrtS * (2.81197 + invTk * 17.27039) -
                    salt * (0.09984 + invTk * 44.99486))
    Ksi = torch.exp(117.385 - invTk * 8904.2 - logTk * 19.334 +
                    sqrtSO4 * (3.5913 - invTk * 458.79) -
                    SO4 * (1.5998 - invTk * 188.74 -
                           SO4 * (0.07871 - invTk * 12.1652)) +
                    torch.log(1.0 - 0.001005 * salt))
    Kw = torch.exp(148.9652 - invTk * 13847.26 - logTk * 23.6521 -
                   sqrtS * (5.977 - invTk * 118.67 - logTk * 1.0495) -
                   salt * 0.01615)
    Ks = torch.exp(141.328 - invTk * 4276.1 - logTk * 23.093 +
                   sqrtSO4 * (324.57 - invTk * 13856.0 - logTk * 47.986 -
                              SO4 * invTk * 2698.0) -
                   SO4 * (771.54 - invTk * 35474.0 - logTk * 114.723 -
                          SO4 * invTk * 1776.0) +
                   torch.log(1.0 - 0.001005 * salt))
    Kf = torch.exp(-12.641 + invTk * 1590.2 + sqrtSO4 * 1.525 +
                   torch.log(1.0 - 0.001005 * salt) +
                   torch.log(1.0 + 0.1400 * scl / (96.062 * Ks)))
    borate = 0.000232 * scl / 10.811
    sulfate = 0.14 * scl / 96.062
    fluoride = 0.000067 * scl / 18.9984

    K12 = K1 * K2
    K12p = K1p * K2p
    K123p = K12p * K3p
    C = torch.div(1.0, 1.0 + sulfate / Ks)

    def f_of_x(X):
        X2 = X * X
        X3 = X2 * X
        invX = torch.div(1.0, X)
        A = X * (K12p + X * (K1p + X)) + K123p
        B = X * (K1 + X) + K12
        return (dic * (K1 * X + 2.0 * K12) / B +
                borate / (1.0 + X / Kb) + Kw * invX +
                phos * (K12p * X + 2.0 * K123p - X3) / A +
                torch.div(sili, 1.0 + X / Ksi) - X * C -
                sulfate / (1.0 + Ks * invX * C) -
                fluoride / (1.0 + Kf * invX) - alk)

    # bisection on [10^-10, 10^-5] (pH 10..5); f decreases with X
    x_lo = torch.full_like(Tk, 1.0e-10)
    x_hi = torch.full_like(Tk, 1.0e-5)
    f_hi = f_of_x(x_hi)
    for _ in range(iters):
        x_mid = 0.5 * (x_lo + x_hi)
        f_mid = f_of_x(x_mid)
        same = (f_hi * f_mid) > 0.0      # the root in [lo, mid]
        x_hi = torch.where(same, x_mid, x_hi)
        f_hi = torch.where(same, f_mid, f_hi)
        x_lo = torch.where(same, x_lo, x_mid)
    Ht = 0.5 * (x_lo + x_hi)
    CO2star = dic * Ht * Ht / (Ht * Ht + K1 * Ht + K12)
    return CO2star * 1.0e6 / ff, -torch.log10(Ht)


def _u10_squared(uwind, vwind, sustr, svstr, like):
    """The squared 10 m wind: from the winds, or Fennel's estimate from the
    surface stress (rho0 550 |tau|)."""
    if uwind is not None and vwind is not None:
        return uwind ** 2 + vwind ** 2
    su = sustr if sustr is not None else torch.zeros_like(like)
    sv = svstr if svstr is not None else torch.zeros_like(like)
    return rho0 * 550.0 * torch.sqrt(su ** 2 + sv ** 2)


def fennel(cfg: Config, p: FennelParams, grid, t_old, t_new, Hz, z_w,
           srflx, sustr=None, svstr=None, uwind=None, vwind=None):
    """Fennel et al. (2006) BGC source and sink terms (fennel.h:683-1575).

    cfg.ibio order: NO3, NH4, Chl, Phy, Zoo, LDeN, SDeN [, PO4][, LDeC,
    SDeC, TIC, TAlk][, Oxy] (fennel_mod.h:497-525); temp and salt are
    tracers 0 and 1 of the full stack."""
    idb = cfg.ibio
    nexp = 7 + p.po4 + 4 * p.carbon + p.oxygen
    if len(idb) != nexp:
        raise ValueError(f"fennel: expected {nexp} bio tracers "
                         f"(po4={p.po4} carbon={p.carbon} "
                         f"oxygen={p.oxygen}), got {len(idb)}")
    names = ["NO3", "NH4", "Chl", "Phy", "Zoo", "LDeN", "SDeN"]
    if p.po4:
        names += ["PO4"]
    if p.carbon:
        names += ["LDeC", "SDeC", "TIC", "TAlk"]
    if p.oxygen:
        names += ["Oxy"]
    ix = {n: i for i, n in enumerate(names)}
    iNO3, iNH4, iChl, iPhy, iZoo, iLDeN, iSDeN = range(7)

    dtd = cfg.dt / 86400.0 / max(1, p.BioIter)
    temp = torch.clamp(t_old[0], max=35.0)
    salt = torch.clamp(t_old[1], min=0.0) if cfg.ntracers >= 2 else \
        torch.zeros_like(temp)

    bio = _stack_old(t_old, idb, floor=True)
    if p.carbon:
        iTIC = ix["TIC"]
        bio[iTIC] = torch.clamp(bio[iTIC], 400.0, 3000.0)
    bio_old = list(bio)

    par_sur = surface_par(p, temp[0], srflx)
    day = par_sur > 0.0
    Hz_inv = torch.div(1.0, Hz)
    dz = z_w[1:] - z_w[:-1]
    eps = _MINVAL
    b = bio

    def where_day(x):
        return torch.where(day[None], x, torch.zeros_like(x))

    for _ in range(max(1, p.BioIter)):
        # ---- light, uptake, nitrification (fennel.h:685-882) ----
        att = (p.AttSW + p.AttChl * b[iChl]) * dz
        att_above = _rev_cumsum(att) - att
        itop = par_sur[None] * torch.exp(-att_above)
        PAR = itop * (1.0 - torch.exp(-att)) / torch.clamp(att, min=1e-20)

        cffc = p.PhyCN * 12.0
        Chl2C = torch.clamp(b[iChl] / (b[iPhy] * cffc + eps),
                            max=p.Chl2C_m)
        Vp = p.Vp0 * 0.59 * (1.066 ** temp)
        fac1 = PAR * p.PhyIS
        Epp = Vp / torch.sqrt(Vp * Vp + fac1 * fac1)
        t_PPmax = Epp * fac1

        cff1 = b[iNH4] * p.K_NH4
        cff2 = b[iNO3] * p.K_NO3
        inhNH4 = torch.div(1.0, 1.0 + cff1)
        L_NH4 = cff1 / (1.0 + cff1)
        L_NO3 = cff2 * inhNH4 / (1.0 + cff2)
        LTOT = L_NO3 + L_NH4
        if p.po4:
            iPO4 = ix["PO4"]
            cff3 = b[iPO4] * p.K_PO4
            L_PO4 = cff3 / (1.0 + cff3)
            LMIN = torch.minimum(LTOT, L_PO4)
            mu = dtd * t_PPmax * LMIN
            cff4 = mu * b[iPhy] * L_NO3 / torch.clamp(LTOT, min=eps) / \
                torch.clamp(b[iNO3], min=eps)
            cff5 = mu * b[iPhy] * L_NH4 / torch.clamp(LTOT, min=eps) / \
                torch.clamp(b[iNH4], min=eps)
            cff6 = p.R_P2N * mu * b[iPhy] / torch.clamp(b[iPO4], min=eps)
            chl_fac = dtd * t_PPmax * t_PPmax * LMIN * LMIN
        else:
            facu = dtd * t_PPmax
            cff4 = facu * p.K_NO3 * inhNH4 / (1.0 + cff2) * b[iPhy]
            cff5 = facu * p.K_NH4 / (1.0 + cff1) * b[iPhy]
            chl_fac = dtd * t_PPmax * t_PPmax * LTOT * LTOT
        # uptake by day only (the night loop of the reference nitrifies
        # only)
        cff4 = where_day(cff4)
        cff5 = where_day(cff5)
        no3 = b[iNO3] / (1.0 + cff4)
        nh4 = b[iNH4] / (1.0 + cff5)
        N_new = no3 * cff4
        N_reg = nh4 * cff5
        b[iNO3] = no3
        b[iNH4] = nh4
        if p.po4:
            cff6 = where_day(cff6)
            b[iPO4] = b[iPO4] / (1.0 + cff6)
        b[iPhy] = b[iPhy] + (N_new + N_reg)
        chl_inc = where_day(
            chl_fac * p.Chl2C_m * b[iChl] /
            (p.PhyIS * torch.clamp(Chl2C, min=eps) * PAR + eps))
        b[iChl] = b[iChl] + chl_inc
        if p.oxygen:
            iOxy = ix["Oxy"]
            b[iOxy] = b[iOxy] + (N_new * _rOxNO3 + N_reg * _rOxNH4)
        if p.carbon:
            b[iTIC] = b[iTIC] + -p.PhyCN * (N_new + N_reg)
            if p.talk_nonconserv:
                iTA = ix["TAlk"]
                b[iTA] = b[iTA] + (N_new - N_reg)

        # nitrification, light-inhibited by day, at its full rate at night
        # (fennel.h:812-882)
        if p.oxygen:
            fac2 = torch.clamp(b[iOxy], min=0.0)
            fac3 = fac2 / (3.0 + fac2)
            fac1n = dtd * p.NitriR * fac3
        else:
            fac1n = dtd * p.NitriR
        cffi = (PAR - p.I_thNH4) / (p.D_p5NH4 + PAR - 2.0 * p.I_thNH4)
        inhib = 1.0 - torch.clamp(cffi, min=0.0)
        cff3n = torch.where(day[None], fac1n * inhib,
                            torch.full_like(inhib, dtd * p.NitriR))
        nh4 = b[iNH4] / (1.0 + cff3n)
        N_nit = nh4 * cff3n
        b[iNH4] = nh4
        b[iNO3] = b[iNO3] + N_nit
        if p.oxygen:
            b[iOxy] = b[iOxy] + -2.0 * N_nit
        if p.carbon and p.talk_nonconserv:
            b[iTA] = b[iTA] + -2.0 * N_nit

        # ---- grazing and P mortality (fennel.h:884-928) ----
        cff1 = dtd * p.ZooGR * b[iZoo] * b[iPhy] / \
            (p.K_Phy + b[iPhy] ** 2)
        cff3 = torch.div(1.0, 1.0 + cff1)
        phy = cff3 * b[iPhy]
        chl = cff3 * b[iChl]
        N_assim = cff1 * phy * p.ZooAE_N
        N_egest = cff1 * phy * (1.0 - p.ZooAE_N)
        cff2 = dtd * p.PhyMR
        N_pmort = cff2 * torch.clamp(phy - p.PhyMin, min=0.0)
        b[iPhy] = phy - N_pmort
        b[iChl] = chl - cff2 * torch.clamp(chl - p.ChlMin, min=0.0)
        b[iZoo] = b[iZoo] + N_assim
        b[iSDeN] = b[iSDeN] + (N_egest + N_pmort)
        if p.carbon:
            iSDeC, iLDeC = ix["SDeC"], ix["LDeC"]
            b[iSDeC] = b[iSDeC] + (p.PhyCN * (N_egest + N_pmort) +
                                   (p.PhyCN - p.ZooCN) * N_assim)

        # ---- Z metabolism, mortality, excretion (fennel.h:930-981) ----
        fac1z = dtd * p.ZooER * b[iPhy] ** 2 / (p.K_Phy + b[iPhy] ** 2)
        cff2 = dtd * p.ZooMR * b[iZoo]
        cff3 = fac1z * p.ZooAE_N
        zoo = b[iZoo] / (1.0 + cff2 + cff3)
        N_zmort = cff2 * zoo
        N_zexc = cff3 * zoo
        cff1 = dtd * p.ZooBM
        N_zmet = cff1 * torch.clamp(zoo - p.ZooMin, min=0.0)
        b[iZoo] = zoo - N_zmet
        b[iNH4] = b[iNH4] + (N_zexc + N_zmet)
        b[iSDeN] = b[iSDeN] + N_zmort
        if p.po4:
            b[iPO4] = b[iPO4] + p.R_P2N * (N_zexc + N_zmet)
        if p.oxygen:
            b[iOxy] = b[iOxy] + -_rOxNH4 * (N_zmet + N_zexc)
        if p.carbon:
            b[iSDeC] = b[iSDeC] + p.ZooCN * N_zmort
            b[iTIC] = b[iTIC] + p.ZooCN * (N_zmet + N_zexc)
            if p.talk_nonconserv:
                b[iTA] = b[iTA] + (N_zmet + N_zexc)

        # ---- coagulation (fennel.h:983-1007) ----
        cff1 = dtd * p.CoagR * (b[iSDeN] + b[iPhy])
        cff2 = torch.div(1.0, 1.0 + cff1)
        phy = b[iPhy] * cff2
        chl = b[iChl] * cff2
        sde = b[iSDeN] * cff2
        N_coagP = phy * cff1
        N_coagD = sde * cff1
        b[iPhy] = phy
        b[iChl] = chl
        b[iSDeN] = sde
        b[iLDeN] = b[iLDeN] + (N_coagP + N_coagD)
        if p.carbon:
            b[iSDeC] = b[iSDeC] + -p.PhyCN * N_coagD
            b[iLDeC] = b[iLDeC] + p.PhyCN * (N_coagP + N_coagD)

        # ---- detritus remineralization (fennel.h:1009-1092) ----
        if p.oxygen:
            fac1r = torch.clamp(b[iOxy] - 6.0, min=0.0)
            fac2r = fac1r / (3.0 + fac1r)
        else:
            fac2r = 1.0
        cff1 = dtd * p.SDeRRN * fac2r
        cff3 = dtd * p.LDeRRN * fac2r
        sde = b[iSDeN] / (1.0 + cff1)
        lde = b[iLDeN] / (1.0 + cff3)
        N_rem = sde * cff1 + lde * cff3
        b[iSDeN] = sde
        b[iLDeN] = lde
        b[iNH4] = b[iNH4] + N_rem
        if p.po4:
            b[iPO4] = b[iPO4] + p.R_P2N * N_rem
        if p.oxygen:
            b[iOxy] = b[iOxy] + -N_rem * _rOxNH4
        if p.carbon and p.talk_nonconserv:
            b[iTA] = b[iTA] + N_rem

        # ---- surface gas exchange (fennel.h:1095-1283) ----
        if p.oxygen or p.carbon:
            u10sq = _u10_squared(uwind, vwind, sustr, svstr, temp[0])
            cffg = dtd * 0.31 * 24.0 / 100.0
            ts = temp[-1]
            ss = salt[-1]
        if p.oxygen:
            SchmO = _A_O2 - ts * (_B_O2 - ts * (_C_O2 - ts * (
                _D_O2 - ts * _E_O2)))
            kvO = cffg * u10sq * torch.sqrt(torch.div(660.0, SchmO))
            O2sat = o2_saturation(ts, ss)
            o2flux = kvO * (O2sat - b[iOxy][-1])
            b[iOxy] = _add_level(b[iOxy], -1, o2flux * Hz_inv[-1])
        if p.carbon:
            cff1 = dtd * p.SDeRRC
            cff3 = dtd * p.LDeRRC
            sdc = b[iSDeC] / (1.0 + cff1)
            ldc = b[iLDeC] / (1.0 + cff3)
            b[iSDeC] = sdc
            b[iLDeC] = ldc
            b[iTIC] = b[iTIC] + (sdc * cff1 + ldc * cff3)
            if not p.talk_nonconserv:
                # the diagnostic alkalinity (Brewer et al. 1986; h:1186)
                b[ix["TAlk"]] = 587.05 + 50.56 * salt
            SchmC = _A_CO2 - ts * (_B_CO2 - ts * (_C_CO2 - ts * (
                _D_CO2 - ts * _E_CO2)))
            kvC = cffg * u10sq * torch.sqrt(torch.div(660.0, SchmC))
            pco2, _ = pco2_water(ts, ss, b[iTIC][-1], b[ix["TAlk"]][-1])
            a1, a2, a3, b1, b2, b3 = _CO2SOL
            TempK = 0.01 * (ts + 273.15)
            co2sol = torch.exp(a1 + torch.div(a2, TempK) +
                               a3 * torch.log(TempK) +
                               ss * (b1 + TempK * (b2 + b3 * TempK)))
            co2flux = kvC * co2sol * (p.pCO2air - pco2)
            b[iTIC] = _add_level(b[iTIC], -1, co2flux * Hz_inv[-1])

        # ---- sinking (fennel.h:1286-1462) and BIO_SEDIMENT ----
        sinkers = [("Phy", p.wPhy), ("Chl", p.wPhy),
                   ("SDeN", p.wSDet), ("LDeN", p.wLDet)]
        if p.carbon:
            sinkers += [("SDeC", p.wSDet), ("LDeC", p.wLDet)]
        for (name, w) in sinkers:
            if w == 0.0:
                continue
            sunk, fc0 = ppm_sink(b[ix[name]], Hz, z_w, dtd * abs(w))
            b[ix[name]] = sunk
            if not p.bio_sediment:
                continue
            cffb = fc0 * Hz_inv[0]
            if name in ("Phy", "SDeN", "LDeN"):
                if p.denitrification:
                    b[iNH4] = _add_level(b[iNH4], 0, cffb * 4.0 / 16.0)
                    if p.oxygen:
                        b[iOxy] = _add_level(b[iOxy], 0,
                                             -cffb * 115.0 / 16.0)
                else:
                    b[iNH4] = _add_level(b[iNH4], 0, cffb)
                    if p.oxygen:
                        b[iOxy] = _add_level(b[iOxy], 0,
                                             -cffb * 106.0 / 16.0)
                    if p.carbon and p.talk_nonconserv:
                        b[iTA] = _add_level(b[iTA], 0, cffb)
                if p.po4:
                    b[iPO4] = _add_level(b[iPO4], 0, cffb * p.R_P2N)
            if p.carbon and name in ("SDeC", "LDeC"):
                b[iTIC] = _add_level(b[iTIC], 0, cffb)
            if p.carbon and name == "Phy":
                b[iTIC] = _add_level(b[iTIC], 0, cffb * p.PhyCN)

    if p.carbon:
        b[iTIC] = torch.clamp(b[iTIC], 400.0, 3000.0)
    rmask = getattr(grid, "rmask", None)
    t_new = t_new.clone()
    for n, i in enumerate(idb):
        incr = b[n] - bio_old[n]
        t_new[i] = t_new[i] + (incr if rmask is None else
                               incr * rmask[None])
    return t_new


# =====================================================================
# Hypoxia Simple Respiration Model (hypoxia_srm.h)
# =====================================================================

@dataclass(frozen=True)
class HypoxiaParams:
    """hypoxia_srm.in defaults (External/hypoxia_srm.in:49-60).

    One bio tracer: dissolved oxygen (mmol O2/m3).  Water-column
    respiration (a climatology field, OCEAN%respiration) is the only sink;
    the surface source is the air-sea O2 exchange with Fennel's
    Wanninkhof-92 transfer velocity and Garcia-Gordon saturation
    (hypoxia_srm.h:218-266)."""
    BioIter: int = 1
    ResRate: float = 1.1e-4       # 1/day default total respiration
    surface_do_saturation: bool = False   # SURFACE_DO_SATURATION
    ocmip_sc: bool = False        # OCMIP_OXYGEN_SC Schmidt variant


def hypoxia_srm(cfg: Config, p: HypoxiaParams, grid, t_old, t_new, Hz, z_w,
                srflx, sustr=None, svstr=None, uwind=None, vwind=None,
                respiration=None):
    """One dt of the simple respiration model.  respiration: the
    (N,Ny,Nx) rate (mmol O2/m3/day), the forcing's "respiration" field;
    p.ResRate everywhere when absent."""
    (iOxy,) = cfg.ibio
    dtd = cfg.dt / 86400.0 / max(1, p.BioIter)
    temp = torch.clamp(t_old[0], max=35.0)
    salt = torch.clamp(t_old[1], min=0.0) if cfg.ntracers >= 2 else \
        torch.zeros_like(temp)
    oxy = torch.clamp(t_old[iOxy], min=0.0)
    oxy_old = oxy

    if respiration is None:
        respiration = torch.full_like(temp, p.ResRate)

    for _ in range(max(1, p.BioIter)):
        # the respiration sink, floored at zero (hypoxia_srm.h:203-209)
        oxy = torch.clamp(oxy - dtd * respiration, min=0.0)

        temp_s, salt_s = temp[-1], salt[-1]
        o2sat = o2_saturation(temp_s, salt_s)
        if p.surface_do_saturation:
            # the surface cell held at saturation
            oxy = _set_level(oxy, -1, o2sat)
            continue
        # Wanninkhof-92 gas exchange (hypoxia_srm.h:222-262)
        if uwind is not None and vwind is not None:
            u10squ = uwind ** 2 + vwind ** 2
        else:
            zu = torch.zeros_like(temp_s)
            su = sustr if sustr is not None else zu
            sv = svstr if svstr is not None else zu
            u10squ = rho0 * 550.0 * torch.sqrt(
                (0.5 * (su + torch.roll(su, -1, -1))) ** 2 +
                (0.5 * (sv + torch.roll(sv, -1, -2))) ** 2)
        if p.ocmip_sc:
            sc = 1638.0 - temp_s * (81.83 - temp_s *
                                    (1.483 - temp_s * 0.008004))
        else:
            sc = 1953.4 - temp_s * (128.0 - temp_s *
                                    (3.9918 - temp_s * 0.050091))
        kw = dtd * (0.31 * 24.0 / 100.0) * u10squ * \
            torch.sqrt(torch.div(660.0, sc))
        flux = kw * (o2sat - oxy[-1])
        oxy = _add_level(oxy, -1, flux / Hz[-1])

    t_new = t_new.clone()
    t_new[iOxy] = t_new[iOxy] + (oxy - oxy_old)
    return t_new


# =====================================================================
# NEMURO lower-trophic ecosystem (Kishi et al. 2007; nemuro.h)
# =====================================================================

@dataclass(frozen=True)
class NemuroParams:
    """nemuro.in defaults (External/nemuro.in:70-170).  11 compartments,
    ibio order (Sphy, Lphy, Szoo, Lzoo, Pzoo, NO3, NH4, PON, DON, SiOH4,
    opal) (nemuro_mod.h:178-188)."""
    BioIter: int = 1
    AttSW: float = 0.04
    AttPS: float = 0.04
    AttPL: float = 0.04
    PARfrac: float = 0.43
    AlphaPS: float = 0.01
    AlphaPL: float = 0.01
    BetaPS: float = 4.5e-4
    BetaPL: float = 4.5e-4
    VmaxS: float = 0.4
    VmaxL: float = 0.8
    KNO3S: float = 1.0
    KNO3L: float = 3.0
    KNH4S: float = 0.1
    KNH4L: float = 0.3
    KSiL: float = 6.0
    PusaiS: float = 1.5
    PusaiL: float = 1.5
    KGppS: float = 6.93e-2
    KGppL: float = 6.93e-2
    ResPS0: float = 0.03
    ResPL0: float = 0.03
    KResPS: float = 0.0519
    KResPL: float = 0.0519
    GammaS: float = 0.135
    GammaL: float = 0.135
    MorPS0: float = 58.5e-3
    MorPL0: float = 29.0e-3
    KMorPS: float = 6.93e-2
    KMorPL: float = 6.93e-2
    GRmaxSps: float = 0.40
    GRmaxLps: float = 0.10
    GRmaxLpl: float = 0.40
    GRmaxLzs: float = 0.40
    GRmaxPpl: float = 0.20
    GRmaxPzs: float = 0.20
    GRmaxPzl: float = 0.20
    KGraS: float = 6.93e-2
    KGraL: float = 6.93e-2
    KGraP: float = 6.93e-2
    LamS: float = 1.4
    LamL: float = 1.4
    LamP: float = 1.4
    PS2ZSstar: float = 4.3e-2
    PS2ZLstar: float = 4.0e-2
    PL2ZLstar: float = 4.0e-2
    ZS2ZLstar: float = 4.0e-2
    PL2ZPstar: float = 4.0e-2
    ZS2ZPstar: float = 4.0e-2
    ZL2ZPstar: float = 4.0e-2
    PusaiPL: float = 4.605
    PusaiZS: float = 3.010
    MorZS0: float = 58.5e-3
    MorZL0: float = 58.5e-3
    MorZP0: float = 58.5e-3
    KMorZS: float = 0.0693
    KMorZL: float = 0.0693
    KMorZP: float = 0.0693
    AlphaZS: float = 0.70
    AlphaZL: float = 0.70
    AlphaZP: float = 0.70
    BetaZS: float = 0.30
    BetaZL: float = 0.30
    BetaZP: float = 0.30
    Nit0: float = 0.03
    VP2N0: float = 0.10
    VP2D0: float = 0.10
    VD2N0: float = 0.20
    VO2S0: float = 0.10
    KNit: float = 6.93e-2
    KP2D: float = 6.93e-2
    KP2N: float = 6.93e-2
    KD2N: float = 6.93e-2
    KO2S: float = 6.93e-2
    RSiN: float = 2.0
    setVPON: float = 40.0     # m/day
    setVOpal: float = 40.0    # m/day
    const_par: Optional[float] = None


def nemuro(cfg: Config, p: NemuroParams, t_old, t_new, Hz, z_w, srflx):
    """NEMURO source and sink terms (nemuro.h:239-660, the IVLEV_IMPLICIT
    grazing branch, the compile default)."""
    idb = cfg.ibio
    if len(idb) != 11:
        raise ValueError(f"nemuro needs 11 bio tracers, got {len(idb)}")
    (iPS, iPL, iZS, iZL, iZP, iNO3, iNH4,
     iPON, iDON, iSiOH, iOpal) = range(11)
    dtd = cfg.dt / 86400.0 / max(1, p.BioIter)
    mv = _MINVAL

    temp = t_old[0]
    b = _stack_old(t_old, idb, floor=True)
    bio_old = list(b)
    par_sur = surface_par(p, temp[0], srflx)

    def ivlev_graze(prey, pred, fac, lam, star, tfac, inhib=None,
                    implicit_prey=None):
        """Grazing of prey by pred: prey / (1 + cff), the grazed mass to
        the predator; returns the grazed mass."""
        if fac == 0.0:            # the rate is off
            return torch.zeros_like(b[prey])
        iv = 1.0 - torch.exp(lam * (star - b[prey]))
        # the implicit form divides by fac iv; where the Ivlev factor is
        # <= 0 there is no grazing
        safe = torch.clamp(iv, min=mv)
        ip = b[implicit_prey if implicit_prey is not None else prey]
        cff = (1.0 + ip / (fac * safe)) * tfac * b[pred]
        if inhib is not None:
            cff = cff * inhib
        cff = torch.where(iv > 0.0, cff, torch.zeros_like(cff))
        pnew = b[prey] / (1.0 + cff)
        gra = cff * pnew
        b[prey] = pnew
        b[pred] = b[pred] + gra
        return gra

    def decay(src, dst, v0, kk, ratio=1.0):
        c = dtd * v0 * torch.exp(kk * temp)
        s = b[src] / (1.0 + c)
        b[src] = s
        b[dst] = b[dst] + s * c * ratio

    for _ in range(max(1, p.BioIter)):
        # ---- dual-band light with photoinhibition (nemuro.h:160-186),
        # at the cell centres: half a cell of attenuation above, and the
        # cells above that ----
        dzh = 0.5 * (z_w[1:] - z_w[:-1])
        phy2 = b[iPS] + b[iPL]
        kapS = p.AttSW + p.AttPS * phy2
        kapL = p.AttSW + p.AttPL * phy2
        attS = kapS * dzh
        attL = kapL * dzh
        csumS = _rev_cumsum(2.0 * attS)
        csumL = _rev_cumsum(2.0 * attL)
        AttS = par_sur[None] * torch.exp(-(csumS - attS))
        AttL = par_sur[None] * torch.exp(-(csumL - attL))
        LightS = (1.0 - torch.exp(-p.AlphaPS * AttS / p.VmaxS)) * \
            torch.exp(-p.BetaPS * AttS / p.VmaxS)
        LightL = (1.0 - torch.exp(-p.AlphaPL * AttL / p.VmaxL)) * \
            torch.exp(-p.BetaPL * AttL / p.VmaxL)
        day = par_sur[None] > 0.0
        LightS = torch.where(day, LightS, torch.zeros_like(LightS))
        LightL = torch.where(day, LightL, torch.zeros_like(LightL))

        # ---- small-phyto gross production (nemuro.h:188-216) ----
        cff1 = dtd * p.VmaxS * torch.exp(p.KGppS * temp) * LightS * b[iPS]
        cff2 = cff1 * torch.exp(-p.PusaiS * b[iNH4]) / \
            (p.KNO3S + b[iNO3])
        cff3 = cff1 / (p.KNH4S + b[iNH4])
        b[iNO3] = b[iNO3] / (1.0 + cff2)
        b[iNH4] = b[iNH4] / (1.0 + cff3)
        GppNPS = b[iNO3] * cff2
        GppAPS = b[iNH4] * cff3
        GppPS = GppNPS + GppAPS
        b[iPS] = b[iPS] + GppPS
        RnewS = GppNPS / torch.clamp(GppPS, min=mv)
        cff4 = dtd * p.ResPS0 * torch.exp(p.KResPS * temp)
        b[iPS] = b[iPS] / (1.0 + cff4)
        ResPS = b[iPS] * cff4
        b[iNO3] = b[iNO3] + ResPS * RnewS
        b[iNH4] = b[iNH4] + ResPS * (1.0 - RnewS)
        ExcPS = GppPS * p.GammaS
        b[iPS] = b[iPS] + -ExcPS
        b[iDON] = b[iDON] + ExcPS

        # ---- large-phyto production with Si limitation (h:218-260) ----
        cff1 = dtd * p.VmaxL * torch.exp(p.KGppL * temp) * LightL * b[iPL]
        cff2 = torch.exp(-p.PusaiL * b[iNH4]) / (p.KNO3L + b[iNO3])
        cff3 = torch.div(1.0, p.KNH4L + b[iNH4])
        cff4n = cff2 * b[iNO3]
        cff5n = cff3 * b[iNH4]
        cff6 = b[iSiOH] / (p.KSiL + b[iSiOH])
        cff7 = cff6 / torch.clamp(cff4n + cff5n, min=mv)
        silim = torch.clamp(cff7, max=1.0)
        cff4 = cff1 * cff2 * silim
        cff5 = cff1 * cff3 * silim
        b[iNO3] = b[iNO3] / (1.0 + cff4)
        b[iNH4] = b[iNH4] / (1.0 + cff5)
        GppNPL = b[iNO3] * cff4
        GppAPL = b[iNH4] * cff5
        GppPL = GppNPL + GppAPL
        b[iPL] = b[iPL] + GppPL
        b[iSiOH] = b[iSiOH] + -GppPL * p.RSiN
        RnewL = GppNPL / torch.clamp(GppPL, min=mv)
        cff7r = dtd * p.ResPL0 * torch.exp(p.KResPL * temp)
        b[iPL] = b[iPL] / (1.0 + cff7r)
        ResPL = b[iPL] * cff7r
        b[iNO3] = b[iNO3] + ResPL * RnewL
        b[iNH4] = b[iNH4] + ResPL * (1.0 - RnewL)
        b[iSiOH] = b[iSiOH] + ResPL * p.RSiN
        ExcPL = GppPL * p.GammaL
        b[iPL] = b[iPL] + -ExcPL
        b[iDON] = b[iDON] + ExcPL
        b[iSiOH] = b[iSiOH] + ExcPL * p.RSiN

        # ---- phyto mortality (h:262-276) ----
        cff1 = dtd * p.MorPS0 * b[iPS] * torch.exp(p.KMorPS * temp)
        cff2 = dtd * p.MorPL0 * b[iPL] * torch.exp(p.KMorPL * temp)
        b[iPS] = b[iPS] / (1.0 + cff1)
        b[iPL] = b[iPL] / (1.0 + cff2)
        MorPS = b[iPS] * cff1
        MorPL = b[iPL] * cff2
        b[iPON] = b[iPON] + (MorPS + MorPL)
        b[iOpal] = b[iOpal] + MorPL * p.RSiN

        # ---- the grazing chain, IVLEV_IMPLICIT (h:278-420): cff = (1 +
        # prey/(fac ivlev)) exp(Ktemp) predator; the reference's ZS2ZL
        # stage uses Bio(iSphy) in the implicit factor, kept as is ----
        tS = torch.exp(p.KGraS * temp)
        tL = torch.exp(p.KGraL * temp)
        tP = torch.exp(p.KGraP * temp)
        GraPS2ZS = ivlev_graze(iPS, iZS, dtd * p.GRmaxSps, p.LamS,
                               p.PS2ZSstar, tS)
        GraPS2ZL = ivlev_graze(iPS, iZL, dtd * p.GRmaxLps, p.LamL,
                               p.PS2ZLstar, tL)
        GraPL2ZL = ivlev_graze(iPL, iZL, dtd * p.GRmaxLpl, p.LamL,
                               p.PL2ZLstar, tL)
        GraZS2ZL = ivlev_graze(iZS, iZL, dtd * p.GRmaxLzs, p.LamL,
                               p.ZS2ZLstar, tL, implicit_prey=iPS)
        inh1 = torch.exp(-p.PusaiPL * (b[iZL] + b[iZS]))
        GraPL2ZP = ivlev_graze(iPL, iZP, dtd * p.GRmaxPpl, p.LamP,
                               p.PL2ZPstar, tP, inhib=inh1)
        inh2 = torch.exp(-p.PusaiZS * b[iZL])
        GraZS2ZP = ivlev_graze(iZS, iZP, dtd * p.GRmaxPzs, p.LamP,
                               p.ZS2ZPstar, tP, inhib=inh2)
        GraZL2ZP = ivlev_graze(iZL, iZP, dtd * p.GRmaxPzl, p.LamP,
                               p.ZL2ZPstar, tP)

        # ---- egestion and excretion (h:420-434) ----
        EgeZS = (1.0 - p.AlphaZS) * GraPS2ZS
        EgeZL = (1.0 - p.AlphaZL) * (GraPS2ZL + GraPL2ZL + GraZS2ZL)
        EgeZP = (1.0 - p.AlphaZP) * (GraPL2ZP + GraZS2ZP + GraZL2ZP)
        ExcZS = (p.AlphaZS - p.BetaZS) * GraPS2ZS
        ExcZL = (p.AlphaZL - p.BetaZL) * (GraPS2ZL + GraPL2ZL + GraZS2ZL)
        ExcZP = (p.AlphaZP - p.BetaZP) * (GraPL2ZP + GraZS2ZP + GraZL2ZP)
        b[iZS] = b[iZS] + (-EgeZS - ExcZS)
        b[iZL] = b[iZL] + (-EgeZL - ExcZL)
        b[iZP] = b[iZP] + (-EgeZP - ExcZP)
        b[iPON] = b[iPON] + (EgeZS + EgeZL + EgeZP)
        b[iNH4] = b[iNH4] + (ExcZS + ExcZL + ExcZP)
        b[iOpal] = b[iOpal] + (GraPL2ZL + GraPL2ZP) * p.RSiN

        # ---- zooplankton mortality (h:436-451) ----
        cff1 = dtd * p.MorZS0 * b[iZS] * torch.exp(p.KMorZS * temp)
        cff2 = dtd * p.MorZL0 * b[iZL] * torch.exp(p.KMorZL * temp)
        cff3 = dtd * p.MorZP0 * b[iZP] * torch.exp(p.KMorZP * temp)
        b[iZS] = b[iZS] / (1.0 + cff1)
        b[iZL] = b[iZL] / (1.0 + cff2)
        b[iZP] = b[iZP] / (1.0 + cff3)
        b[iPON] = b[iPON] + (b[iZS] * cff1 + b[iZL] * cff2 +
                             b[iZP] * cff3)

        # ---- the remineralization chain (h:453-480) ----
        decay(iNH4, iNO3, p.Nit0, p.KNit)      # nitrification
        decay(iPON, iNH4, p.VP2N0, p.KP2N)
        decay(iPON, iDON, p.VP2D0, p.KP2D)
        decay(iDON, iNH4, p.VD2N0, p.KD2N)
        decay(iOpal, iSiOH, p.VO2S0, p.KO2S)

        # ---- sinking of PON and opal (h:482-660, the PPM scheme) ----
        for comp, w in ((iPON, p.setVPON), (iOpal, p.setVOpal)):
            if w != 0.0:
                b[comp] = ppm_sink(b[comp], Hz, z_w, dtd * abs(w))[0]

    return add_increment(t_new, idb, b, bio_old)


# =====================================================================
# Red tide (Alexandrium fundyense): Stock et al. (2005), He et al. (2008)
# (red_tide.h)
# =====================================================================

@dataclass(frozen=True)
class RedTideParams:
    """red_tide.in defaults (External/red_tide.in:49-70).  One bio tracer,
    the dinoflagellate concentration (cells/m3): germination from a
    bottom cyst map, temperature/salinity/light/DIN-limited growth, Q10
    mortality and upward swimming."""
    BioIter: int = 1
    Gmax: float = 1.05          # 1/day maximum growth
    Dg: float = 0.18            # cm, cyst germination depth
    Kn: float = 3.0             # mmol/m3, DIN half-saturation
    G_eff: float = 0.036        # (W/m2/day)^-1 growth efficiency
    G_r: float = 0.2            # 1/day maintenance respiration
    srad_Cdepth: float = 345.5  # W/m2 surface rad for compens. depth
    AttW: float = 0.2           # 1/m water attenuation
    AttS: float = 3.5           # 1/cm sediment attenuation
    E_light: float = 2.4        # W/m2 light germination threshold
    E_dark: float = 0.024       # W/m2 dark germination threshold
    Tmin_growth: float = 5.0    # degC
    DIN_Cdepth: float = 15.0    # mmol/m3 DIN below compensation depth
    wDino: float = 10.0         # m/day upward swimming
    Mor_a: float = 0.04         # 1/day mortality amplitude
    Mor_b: float = 0.03         # 1/day mortality intercept
    Mor_Q10: float = 10.0
    Mor_T0: float = 15.0        # degC
    NsedLayers: int = 10        # red_tide.h:165


# the monthly endogenous-clock germination potential (red_tide_mod.h:
# Month_MidDay and GP; GPN = GP / max(GP))
_MONTH_MIDDAY = np.array([15.5, 45.0, 74.5, 105.0, 135.5, 166.0, 196.5,
                          227.5, 258.0, 288.5, 319.0, 349.5])
_GP = np.array([21.90, 11.25, 78.0, 85.0, 96.8, 93.0, 60.0, 50.0, 10.0,
                11.5, 17.0, 34.5])
_GPN = _GP / 96.8


def _endo_scale(yday: float) -> float:
    """The monthly germination potential interpolated piecewise-linearly at
    year-day yday (red_tide.h:266-289), on the host."""
    md, gpn = _MONTH_MIDDAY, _GPN
    if md[0] <= yday < md[11]:
        i = int(np.clip(np.searchsorted(md, yday) - 1, 0, 10))
        cff = (yday - md[i]) / (md[i + 1] - md[i])
        return float(gpn[i] + cff * (gpn[i + 1] - gpn[i]))
    # before mid-January or after mid-December: December to January
    span = 365.0 - md[11] + md[0]
    if yday < md[0]:
        cff = (365.0 - md[11] + yday) / span
    else:
        cff = (yday - md[11]) / span
    return float(gpn[11] + cff * (gpn[0] - gpn[11]))


def ppm_swim(qc, Hz, w_dt: float):
    """Vertical swimming or sinking: the red_tide.h PPM scheme
    (red_tide.h:330-420, LIMIT_INTERIOR and NEUMANN off).  w_dt (m, a host
    float) > 0 moves mass down, < 0 up; Courant-limited (|w_dt| < min Hz),
    no flux through the surface or the bottom.  Returns the new profile."""
    FC = (qc[1:] - qc[:-1]) / (Hz[1:] + Hz[:-1])        # (N-1,...)

    # the PPM slopes of the interior boxes k = 1..N-2
    q, hzm, hz, hzp = qc[1:-1], Hz[:-2], Hz[1:-1], Hz[2:]
    dltR = hz * FC[1:]
    dltL = hz * FC[:-1]
    zero = dltR * dltL < 0.0
    cff = hzm + 2.0 * hz + hzp
    cffR = cff * FC[1:]
    cffL = cff * FC[:-1]
    z = torch.zeros_like(dltR)
    dltR = torch.where(zero, z, torch.where(torch.abs(dltR) >
                                            torch.abs(cffL), cffL, dltR))
    dltL = torch.where(zero, z, torch.where(torch.abs(dltL) >
                                            torch.abs(cffR), cffR, dltL))
    c = (dltR - dltL) / (hzm + hz + hzp)
    dltR = dltR - c * hzp
    dltL = dltL + c * hzm
    aR = q + dltR
    aL = q - dltL
    dR = (2.0 * dltR - dltL) ** 2
    dL = (2.0 * dltL - dltR) ** 2

    # the end boxes, extrapolated (the non-NEUMANN branch)
    aL_top = aR[-1]                     # aL(N) = aR(N-1)
    aR_top = 2.0 * qc[-1] - aL_top
    dR_top = (2.0 * aR_top + aL_top - 3.0 * qc[-1]) ** 2
    dL_top = (3.0 * qc[-1] - 2.0 * aL_top - aR_top) ** 2
    aR_bot = aL[0]                      # aR(1) = aL(2)
    aL_bot = 2.0 * qc[0] - aR_bot
    dR_bot = (2.0 * aR_bot + aL_bot - 3.0 * qc[0]) ** 2
    dL_bot = (3.0 * qc[0] - 2.0 * aL_bot - aR_bot) ** 2
    aR = torch.cat([aR_bot[None], aR, aR_top[None]])
    aL = torch.cat([aL_bot[None], aL, aL_top[None]])
    dR = torch.cat([dR_bot[None], dR, dR_top[None]])
    dL = torch.cat([dL_bot[None], dL, dL_top[None]])

    # the WENO-weighted interface values r(k), k = 1..N-1, and the ends
    epsw = 1.0e-12
    wL = torch.clamp(dL[:-1], min=epsw)
    wR = torch.clamp(dR[1:], min=epsw)
    r_int = (wR * aR[:-1] + wL * aL[1:]) / (wR + wL)    # (N-1,...)
    r_top = 2.0 * qc[-1] - r_int[-1]
    r_bot = 2.0 * qc[0] - r_int[0]
    r = torch.cat([r_bot[None], r_int, r_top[None]])   # (N+1,...)

    aRf = r[1:]
    aLf = r[:-1]
    dLf = 0.5 * (aRf - aLf)
    dRf = 0.5 * (aRf + aLf) - qc

    # the Courant-limited flux through the interior interfaces
    if w_dt > 0.0:
        alpha = torch.div(w_dt, Hz[1:])
        edge, cL, cR = aLf[1:], dLf[1:], dRf[1:]
    else:
        alpha = torch.div(-w_dt, Hz[:-1])
        edge, cL, cR = aRf[:-1], -dLf[:-1], dRf[:-1]
    FCk = w_dt * (edge + alpha * (cL - cR * (3.0 - 2.0 * alpha)))
    zf = torch.zeros_like(qc[:1])
    FCi = torch.cat([zf, FCk, zf])                    # (N+1,...)
    return qc + (FCi[1:] - FCi[:-1]) / Hz


def red_tide(cfg: Config, p: RedTideParams, t_old, t_new, Hz, z_w, z_r,
             srflx, yday: float, cyst_ini=None, din_obs=None):
    """The red-tide dinoflagellate source and sink terms and swimming
    (red_tide.h).  yday: the year-day (a host float; biology.year_day);
    cyst_ini: the (Ny,Nx) bottom cyst map (cysts/cm3, OCEAN%CystIni);
    din_obs: the (N,Ny,Nx) observed DIN climatology (mmol/m3)."""
    (iDino,) = cfg.ibio
    dtd = cfg.dt / 86400.0 / max(1, p.BioIter)
    rad_scale = rho0 * Cp
    temp = torch.clamp(t_old[0], max=36.0)
    salt = torch.clamp(t_old[1], min=0.0) if cfg.ntracers >= 2 else \
        torch.zeros_like(temp)
    dino = torch.clamp(t_old[iDino], min=0.0)
    dino_old = dino
    srf = srflx if srflx is not None else torch.zeros_like(temp[0])
    if cyst_ini is None:
        cyst_ini = torch.zeros_like(temp[0])

    # the compensation depth from the surface-radiation threshold
    c_depth = math.log(p.G_r / (p.G_eff * p.srad_Cdepth)) / p.AttW
    endo = _endo_scale(yday)

    for _ in range(max(1, p.BioIter)):
        # ---- cyst germination at the seabed (red_tide.h:292-330): light
        # and dark rates from the bottom temperature, the light in each of
        # NsedLayers sediment sub-layers ----
        tb = temp[0]
        GermL = (1.50 + (8.72 - 1.50) * 0.5 *
                 (torch.tanh(0.790 * tb - 6.27) + 1.0)) / p.NsedLayers
        GermD = (1.04 + (4.26 - 1.04) * 0.5 *
                 (torch.tanh(0.394 * tb - 3.33) + 1.0)) / p.NsedLayers
        ksed = torch.arange(1, p.NsedLayers + 1, dtype=temp.dtype,
                            device=temp.device)
        e_flux = rad_scale * srf[None] * torch.exp(
            p.AttW * z_w[0][None] -
            p.AttS * p.Dg * (ksed[:, None, None] - 0.5))
        frac = torch.clamp((e_flux - p.E_dark) / (p.E_light - p.E_dark),
                           0.0, 1.0)
        germ = torch.sum(GermD[None] + (GermL - GermD)[None] * frac, dim=0)
        germ = germ * p.Dg * endo          # (x100 then /100 in the ref)
        cell_flux = cyst_ini * germ / Hz[0]
        dino = _add_level(dino, 0, cell_flux * dtd)

        # ---- growth (red_tide.h:332-396): the temperature cubic (linear
        # below Tmin), the salinity cubic, light-limited above the
        # compensation depth, DIN-limited Monod ----
        t_fac = torch.where(
            temp >= p.Tmin_growth,
            0.379 + temp * (-0.0961 + temp * (0.0169 + temp * -0.000536)),
            0.254 - 0.0327 * (5.0 - temp))
        s_fac = -0.693 + salt * (0.186 + salt * (-0.00622 +
                                                 salt * 0.0000557))
        g_fac = t_fac * s_fac
        rad = srf[None] * rad_scale * torch.exp(p.AttW * z_r)
        above = z_r > c_depth
        cffg = p.Gmax * g_fac + p.G_r
        g_light = torch.clamp(cffg * torch.tanh(
            p.G_eff * rad / torch.clamp(cffg, min=1e-20)) - p.G_r, min=0.0)
        g_light = torch.where(above, g_light, torch.zeros_like(g_light))
        din = din_obs if din_obs is not None else \
            torch.full_like(temp, p.DIN_Cdepth)
        din = torch.where(above, din, torch.full_like(din, p.DIN_Cdepth))
        g_din = p.Gmax * g_fac * din / (max(p.Kn, 0.0) + din)
        g_rate = torch.clamp(torch.minimum(g_light, g_din), min=0.0)
        dino = dino / (1.0 - g_rate * dtd)

        # ---- Q10 mortality (red_tide.h:398-410) ----
        m_rate = p.Mor_a * p.Mor_Q10 ** ((temp - p.Mor_T0) * 0.1) + \
            p.Mor_b
        dino = dino / (1.0 + m_rate * dtd)

        # ---- upward swimming (SWIM_LOOP) ----
        if p.wDino != 0.0:
            dino = ppm_swim(dino, Hz, -p.wDino * dtd)

    t_new = t_new.clone()
    t_new[iDino] = t_new[iDino] + (dino - dino_old)
    return t_new


# =====================================================================
# EcoSim (reduced): the spectral bio-optics ecosystem (Biology/ecosim.h)
# =====================================================================

@dataclass(frozen=True)
class EcosimParams:
    """Reduced EcoSim (Bissett et al. 1999; Biology/ecosim.h, the
    ecosim_mod.h parameter blocks).  The reductions against the reference,
    as roms_tpu makes them: 2 phytoplankton groups (small flagellate and
    diatom) instead of 4, one chlorophyll pigment a group instead of 7,
    one DOM constituent and CDOC instead of 2, one fecal class instead of
    2, no iron pools, and 12 spectral bands (25 nm, 400-700 nm) instead of
    60 (5 nm).  Kept: the spectral downward irradiance with water,
    chlorophyll, CDOC and detrital absorption, carbon growth from the
    chlorophyll-specific absorbed light, Droop cell-quota limitation on
    a dynamic C:N:P (and C:Si for diatoms), exudation to (colored) DOM, a
    bacterial loop remineralizing DOM to NH4/PO4 with respiration to DIC,
    nitrification, and CDOC photolysis."""
    BioIter: int = 1
    # light
    PARfrac: float = 0.43
    avgcos: float = 0.83           # mean cosine
    aDOC440: float = 0.012         # CDOC-specific absorption @440
    sDOC: float = 0.014            # CDOC spectral slope (1/nm)
    aDET440: float = 0.005         # detrital absorption @440
    sDET: float = 0.011
    # phytoplankton (group 0: small, group 1: diatom)
    GtALG_max: tuple = (1.5, 2.5)      # 1/day max C growth
    aPHYmax: tuple = (0.025, 0.015)    # m2/mg-chl peak astar @ ~440
    # carbon fixed per absorbed radiant energy (mmolC m3 / (W day))
    EphotMax: float = 1.0
    maxC2nALG: tuple = (14.0, 12.0)    # max C:N (quota floor for N)
    minC2nALG: tuple = (6.0, 6.0)      # min C:N (replete)
    maxC2pALG: tuple = (250.0, 200.0)  # C:P quotas
    minC2pALG: tuple = (80.0, 80.0)
    maxC2SiALG: tuple = (0.0, 10.0)    # diatoms only
    minC2SiALG: tuple = (0.0, 5.0)
    maxC2Chl: tuple = (80.0, 60.0)     # g C : g chl bounds
    minC2Chl: tuple = (25.0, 20.0)
    KNO3: tuple = (0.5, 1.0)           # mmol/m3 half saturations
    KNH4: tuple = (0.25, 0.5)
    KPO4: tuple = (0.05, 0.1)
    KSiO: tuple = (0.0, 1.0)
    ExALG: tuple = (0.05, 0.05)        # exudation fraction of growth
    cdocfrac: float = 0.3              # colored fraction of exudation
    HsGRZ: tuple = (0.1, 0.1)          # grazing closure (1/day/(mmolC))
    WS: tuple = (0.0, 0.5)             # sinking (m/day; diatoms)
    # bacteria
    GtBAC_max: float = 2.0         # 1/day
    HsDOC_ba: float = 20.0         # mmolC/m3 half sat
    C2nBAC: float = 5.1            # bacteria C:N
    C2pBAC: float = 60.0
    BacGE: float = 0.3             # growth efficiency (the rest respired)
    BacMort: float = 0.3           # 1/day to DOM
    # cycling
    RtNIT: float = 0.05            # 1/day nitrification
    KI_nit: float = 10.0           # W/m2 light inhibition scale
    RtFec: float = 0.1             # 1/day fecal remineralization
    wFec: float = 5.0              # m/day fecal sinking
    photolysis: float = 0.05       # 1/day/(100 W/m2) CDOC photo-bleach


# the 12 bands, 400-700 nm at 25 nm (band centres): pure-water absorption
# (Pope & Fry 1997, sampled) and scattering, and the normalized
# chlorophyll-specific absorption shape
ES_LAM = np.array([400., 425., 450., 475., 500., 525., 550., 575., 600.,
                   625., 650., 675.])
ES_AW = np.array([0.0066, 0.0051, 0.0092, 0.0114, 0.0204, 0.0409, 0.0565,
                  0.0844, 0.2224, 0.2834, 0.34, 0.448])
ES_BW = 0.0076 * (400.0 / ES_LAM) ** 4.3
ES_ASHAPE = np.array([0.9, 1.0, 0.95, 0.75, 0.45, 0.25, 0.15, 0.12, 0.12,
                      0.18, 0.35, 0.85])


def _band(a, like):
    """A band table as a (nb,1,1,1) tensor on like's device, in its
    dtype."""
    return torch.as_tensor(a, dtype=like.dtype,
                           device=like.device)[:, None, None, None]


def ecosim(cfg: Config, p: EcosimParams, t_old, t_new, Hz, z_w, srflx):
    """Reduced EcoSim source and sink terms; the increment goes onto
    t_new.

    The 20 bio tracers (cfg.ibio order):
      0  NO3    1 NH4    2 PO4    3 SiO    4 DIC
      5  PhyC1  6 PhyN1  7 PhyP1  8 Chl1
      9  PhyC2 10 PhyN2 11 PhyP2 12 PhyS2 13 Chl2
      14 BacC  15 DOC   16 DON   17 CDOC
      18 FecC  19 FecN
    """
    idb = cfg.ibio
    if len(idb) != 20:
        raise ValueError(f"ecosim needs 20 bio tracers, got {len(idb)}")
    dtd = cfg.dt / 86400.0 / max(1, p.BioIter)

    b = _stack_old(t_old, idb, floor=False)
    bio_old = list(b)
    (iNO3, iNH4, iPO4, iSiO, iDIC, iC1, iN1, iP1, iL1,
     iC2, iN2, iP2, iS2, iL2, iBAC, iDOC, iDON, iCDC,
     iFC, iFN) = range(20)

    par0 = p.PARfrac * torch.clamp(srflx, min=0.0) * rho0 * Cp  # W/m2
    nb = ES_LAM.shape[0]
    lam = _band(ES_LAM, Hz)
    a_w = _band(ES_AW, Hz) + 0.5 * _band(ES_BW, Hz)
    ashape = _band(ES_ASHAPE, Hz)

    for _ in range(max(1, p.BioIter)):
        chl = (b[iL1], b[iL2])
        # ---- the spectral downward irradiance Ed(band, k) (ecosim.h
        # "daylight": dATT = (aw + achl + acdoc + adet + 0.5 bw) / avgcos,
        # integrated down from the surface) ----
        a_chl = ashape * (p.aPHYmax[0] * chl[0][None] +
                          p.aPHYmax[1] * chl[1][None])
        a_cdc = p.aDOC440 * b[iCDC][None] * \
            torch.exp(-p.sDOC * (lam - 440.0))
        a_det = p.aDET440 * 0.01 * b[iFC][None] * \
            torch.exp(-p.sDET * (lam - 440.0))
        dATT = (a_w + a_chl + a_cdc + a_det) / p.avgcos   # (nb,N,Ny,Nx)
        dAH = dATT * Hz[None]
        tau = torch.flip(torch.cumsum(torch.flip(dAH, [1]), dim=1), [1])
        tau_up = tau - dAH                                # top of cell
        # the band-mean Ed inside the cell; PAR split equally at z = 0
        att = torch.clamp(dAH, min=1.0e-12)
        Ed = (par0[None, None] / nb) * torch.exp(-tau_up) * \
            (1.0 - torch.exp(-att)) / att
        par_tot = torch.sum(Ed, dim=0)                    # W/m2 at cells

        # ---- the phytoplankton groups ----
        for g, (iC, iN, iP, iL) in enumerate(
                ((iC1, iN1, iP1, iL1), (iC2, iN2, iP2, iL2))):
            phyC = torch.clamp(b[iC], min=_MINVAL)
            # absorbed energy -> light-limited growth (photon flux times
            # the chlorophyll-specific absorption)
            Eabs = torch.sum(Ed * ashape, dim=0) * p.aPHYmax[g] * b[iL]
            mu_E = p.EphotMax * Eabs / phyC               # 1/day
            # Droop quota limitation on the dynamic C:N and C:P (C:Si)
            QN = b[iN] / phyC                             # N:C
            QP = b[iP] / phyC
            limN = torch.clamp((QN - 1.0 / p.maxC2nALG[g]) /
                               (1.0 / p.minC2nALG[g] -
                                1.0 / p.maxC2nALG[g]), 0.0, 1.0)
            limP = torch.clamp((QP - 1.0 / p.maxC2pALG[g]) /
                               (1.0 / p.minC2pALG[g] -
                                1.0 / p.maxC2pALG[g]), 0.0, 1.0)
            lim = torch.minimum(limN, limP)
            if p.maxC2SiALG[g] > 0.0:
                QS = b[iS2] / phyC
                limS = torch.clamp(
                    (QS - 1.0 / p.maxC2SiALG[g]) /
                    (1.0 / p.minC2SiALG[g] - 1.0 / p.maxC2SiALG[g]),
                    0.0, 1.0)
                lim = torch.minimum(lim, limS)
            mu = torch.clamp(mu_E, max=p.GtALG_max[g]) * lim   # 1/day
            growth = mu * phyC * dtd                      # mmolC
            exud = p.ExALG[g] * growth
            netC = growth - exud

            # nutrient uptake toward the replete quota (Droop V)
            room_n = torch.clamp(phyC / p.minC2nALG[g] - b[iN], min=0.0)
            upNH4 = torch.minimum(
                dtd * p.GtALG_max[g] * phyC / p.minC2nALG[g] *
                b[iNH4] / (p.KNH4[g] + b[iNH4]), room_n)
            room_n = room_n - upNH4
            upNO3 = torch.minimum(
                dtd * p.GtALG_max[g] * phyC / p.minC2nALG[g] *
                b[iNO3] / (p.KNO3[g] + b[iNO3]), room_n)
            upNO3 = torch.minimum(upNO3, 0.9 * b[iNO3])
            upNH4 = torch.minimum(upNH4, 0.9 * b[iNH4])
            room_p = torch.clamp(phyC / p.minC2pALG[g] - b[iP], min=0.0)
            upPO4 = torch.minimum(
                dtd * p.GtALG_max[g] * phyC / p.minC2pALG[g] *
                b[iPO4] / (p.KPO4[g] + b[iPO4]), room_p)
            upPO4 = torch.minimum(upPO4, 0.9 * b[iPO4])

            # the grazing closure (quadratic, unresolved zooplankton; the
            # losses go to fecal matter and DOM)
            graze = dtd * p.HsGRZ[g] * phyC * phyC / \
                torch.clamp(phyC + 1.0, min=1.0)
            fgrz = torch.clamp(graze / torch.clamp(phyC, min=_MINVAL),
                               0.0, 0.5)
            # chlorophyll photoacclimates toward a C:chl between its
            # bounds (low light, more chl per C)
            c2chl_t = p.minC2Chl[g] + (p.maxC2Chl[g] - p.minC2Chl[g]) \
                * par_tot / (par_tot + 30.0)
            chl_target = 12.0 * phyC / c2chl_t     # mg chl (12 gC/molC)
            dchl = 0.5 * dtd * (chl_target - b[iL])

            old = list(b)
            b[iC] = old[iC] + (netC - fgrz * phyC)
            b[iN] = old[iN] + (upNO3 + upNH4 - fgrz * old[iN])
            b[iP] = old[iP] + (upPO4 - fgrz * old[iP])
            b[iL] = old[iL] + (dchl - fgrz * old[iL])
            b[iNO3] = old[iNO3] + -upNO3
            b[iNH4] = old[iNH4] + -upNH4
            b[iPO4] = old[iPO4] + -upPO4
            b[iDIC] = old[iDIC] + -netC
            b[iDOC] = old[iDOC] + exud * (1.0 - p.cdocfrac)
            b[iCDC] = old[iCDC] + exud * p.cdocfrac
            b[iFC] = old[iFC] + fgrz * phyC
            b[iFN] = old[iFN] + fgrz * old[iN]
            if p.maxC2SiALG[g] > 0.0:
                room_s = torch.clamp(phyC / p.minC2SiALG[g] - b[iS2],
                                     min=0.0)
                upSiO = torch.minimum(
                    dtd * p.GtALG_max[g] * phyC / p.minC2SiALG[g] *
                    b[iSiO] / (p.KSiO[g] + b[iSiO]), room_s)
                upSiO = torch.minimum(upSiO, 0.9 * b[iSiO])
                s2 = b[iS2]
                b[iS2] = s2 + (upSiO - fgrz * s2)
                b[iSiO] = b[iSiO] + (-upSiO + fgrz * s2)

        # ---- the bacterial loop (DOM -> NH4/PO4/DIC) ----
        upDOC = dtd * p.GtBAC_max * b[iBAC] * b[iDOC] / \
            (p.HsDOC_ba + b[iDOC])
        upDOC = torch.minimum(upDOC, 0.9 * b[iDOC])
        bacC = upDOC * p.BacGE                    # new bacterial C
        respC = upDOC - bacC                      # respired to DIC
        upDON = torch.minimum(
            upDOC * (b[iDON] / torch.clamp(b[iDOC], min=_MINVAL)),
            0.9 * b[iDON])
        exN = torch.clamp(upDON - bacC / p.C2nBAC, min=0.0)  # -> NH4
        mortB = dtd * p.BacMort * b[iBAC]
        b[iBAC] = b[iBAC] + (bacC - mortB)
        b[iDOC] = b[iDOC] + (-upDOC + mortB)
        b[iDON] = b[iDON] + (-upDON + mortB / p.C2nBAC)
        b[iDIC] = b[iDIC] + respC
        b[iNH4] = b[iNH4] + exN
        b[iPO4] = b[iPO4] + respC / p.C2pBAC

        # ---- nitrification (light inhibited) ----
        nitr = dtd * p.RtNIT * b[iNH4] * p.KI_nit / (p.KI_nit + par_tot)
        b[iNH4] = b[iNH4] + -nitr
        b[iNO3] = b[iNO3] + nitr

        # ---- fecal remineralization ----
        remC = dtd * p.RtFec * b[iFC]
        remN = dtd * p.RtFec * b[iFN]
        b[iFC] = b[iFC] + -remC
        b[iFN] = b[iFN] + -remN
        b[iDOC] = b[iDOC] + remC
        b[iDON] = b[iDON] + remN

        # ---- CDOC photolysis (surface-light bleaching to DOC) ----
        photo = dtd * p.photolysis * (par_tot / 100.0) * b[iCDC]
        b[iCDC] = b[iCDC] + -photo
        b[iDOC] = b[iDOC] + photo

        # ---- sinking: the diatom pools and fecal matter ----
        sink_sets = [(iFC, p.wFec), (iFN, p.wFec)]
        if p.WS[1] != 0.0:
            sink_sets += [(i, p.WS[1]) for i in (iC2, iN2, iP2, iS2, iL2)]
        for comp, w in sink_sets:
            b[comp] = ppm_sink(b[comp], Hz, z_w, dtd * abs(w))[0]
        b = list(_positive_definite(torch.stack(b)))

    return add_increment(t_new, idb, b, bio_old)
