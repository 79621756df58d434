"""Biological source and sink terms: the NPZD model of Powell et al. (2006)
and the dispatch of the biology slot (counterpart of
``roms_tpu/ops/biology.py``; ROMS/Nonlinear/Biology/npzd_Powell.h).

Four nitrogen compartments (nitrate N, phytoplankton P, zooplankton Z,
small detritus D) ride as passive tracers through the tracer step; this
module applies the food-web conversions once a slow step as a chain of
backward-implicit stages: each divides the consumed compartment by
1 + cff and adds cff times the result to the consumer, so every stage
conserves total nitrogen and keeps the pools positive at any dt.  The
increment is taken from the old time level and added to the new tracers
(npzd_Powell.h:640).  Light is a top-down cumulative sum of attenuation;
the sinking is ops/settling.ppm_sink.

The compartments are a list of (N,Ny,Nx) tensors, each stage a handful of
elementwise operations in roms_tpu's order; a Python ``c / x`` of a
number by a tensor is written ``torch.div(c, x)``, which divides (torch's
``c / x`` multiplies by the reciprocal).  Plain PyTorch: no kernel.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from ..config import Config
from ..constants import rho0_default as rho0, Cp
from .settling import ppm_sink

_MINVAL = 1.0e-6


@dataclass(frozen=True)
class NPZDParams:
    """npzd_Powell.in defaults (External/npzd_Powell.in:49-131)."""
    BioIter: int = 1
    PARfrac: float = 0.43
    AttSW: float = 0.067      # 1/m, seawater attenuation
    AttPhy: float = 0.0095    # m2/mmol, self-shading
    PhyIS: float = 0.025      # m2/W, initial P-I slope
    Vm_NO3: float = 1.5       # 1/day, nitrate uptake
    PhyMRD: float = 0.1       # 1/day, P mortality -> D
    PhyMRN: float = 0.0       # 1/day, P mortality -> N
    K_NO3: float = 1.0        # mmol/m3 half-saturation
    Ivlev: float = 0.84
    ZooGR: float = 0.52       # 1/day grazing
    ZooEED: float = 0.0       # sloppy feeding -> D
    ZooEEN: float = 0.3       # sloppy feeding -> N
    ZooMRD: float = 0.145     # 1/day, Z mortality -> D
    ZooMRN: float = 0.0       # 1/day, Z mortality -> N
    DetRR: float = 1.03       # 1/day remineralization
    wPhy: float = 0.0         # m/day sinking
    wDet: float = 8.0         # m/day sinking
    const_par: Optional[float] = None   # CONST_PAR: 158.075 W/m2


def _positive_definite(bio):
    """Draw from the most abundant pool to top negative pools up to MinVal
    (npzd_Powell.h:226-250).  bio: (nb,N,Ny,Nx); the first of equal maxima
    gives, as jnp.argmax picks it."""
    deficit = torch.sum(torch.clamp(_MINVAL - bio, min=0.0), dim=0)
    imax = torch.argmax(bio, dim=0)
    clamped = torch.clamp(bio, min=_MINVAL)
    take = torch.amax(bio, dim=0) > deficit
    onehot = torch.arange(bio.shape[0], device=bio.device)[
        :, None, None, None] == imax[None]
    return clamped - torch.where(take, deficit,
                                 torch.zeros_like(deficit))[None] * onehot


def _rev_cumsum(a):
    """The sum over levels k..N-1 at each k (roms_tpu's flip/cumsum/flip)."""
    return torch.flip(torch.cumsum(torch.flip(a, [0]), dim=0), [0])


def _light(p, phy, z_w, par_sur):
    """Cell-averaged PAR, attenuated top-down through seawater and
    phytoplankton self-shading (npzd_Powell.h:336-363)."""
    dz = z_w[1:] - z_w[:-1]
    att = (p.AttSW + p.AttPhy * phy) * dz                  # (N,Ny,Nx)
    # the attenuation from the surface down to the top of cell k
    att_above = _rev_cumsum(att) - att
    itop = par_sur[None] * torch.exp(-att_above)
    light = itop * (1.0 - torch.exp(-att)) / torch.clamp(att, min=1.0e-20)
    return torch.where(par_sur[None] > 0.0, light, torch.zeros_like(light))


def surface_par(p, like, srflx):
    """The surface PAR (W/m2) of a model with PARfrac and const_par: the
    constant, or the shortwave flux (kinematic, zero when absent) times
    PARfrac rho0 Cp.  like: a (Ny,Nx) tensor of the right dtype."""
    if p.const_par is not None:
        return torch.full_like(like, p.const_par)
    srf = srflx if srflx is not None else torch.zeros_like(like)
    return p.PARfrac * srf * rho0 * Cp    # kinematic -> W/m2


def add_increment(t_new, idb, bio, bio_old):
    """t_new with bio - bio_old (lists of (N,Ny,Nx)) added at the tracer
    indices idb."""
    t_new = t_new.clone()
    for n, i in enumerate(idb):
        t_new[i] = t_new[i] + (bio[n] - bio_old[n])
    return t_new


def npzd_powell(cfg: Config, p: NPZDParams, t_old, t_new, Hz, z_w, srflx):
    """One model dt of NPZD conversions.  t_old/t_new are the full tracer
    stacks (NT,N,Ny,Nx) at the old and new time levels; the increment from
    t_old is added to t_new (npzd_Powell.h:640-655)."""
    idb = cfg.ibio
    if len(idb) != 4 or max(idb) >= cfg.ntracers:
        raise ValueError(
            f"npzd_powell needs 4 bio tracer indices < ntracers="
            f"{cfg.ntracers}; got ibio={idb}")
    iN, iP, iZ, iD = 0, 1, 2, 3
    dtd = cfg.dt / 86400.0 / max(1, p.BioIter)

    bio = list(_positive_definite(torch.stack([t_old[i] for i in idb])))
    bio_old = list(bio)
    par_sur = surface_par(p, bio[0][0], srflx)

    for _ in range(max(1, p.BioIter)):
        light = _light(p, bio[iP], z_w, par_sur)

        # nitrate uptake, smooth P-I curve (npzd_Powell.h:371-385)
        cff1 = dtd * p.Vm_NO3 * p.PhyIS
        cff4 = torch.div(1.0, torch.sqrt(p.Vm_NO3 ** 2 +
                                         p.PhyIS ** 2 * light ** 2))
        cff = bio[iP] * cff1 * cff4 * light / (p.K_NO3 + bio[iN])
        n_new = bio[iN] / (1.0 + cff)
        bio[iN] = n_new
        bio[iP] = bio[iP] + n_new * cff

        # Ivlev grazing with sloppy feeding (npzd_Powell.h:391-408)
        cff = bio[iZ] * dtd * p.ZooGR * \
            (1.0 - torch.exp(-p.Ivlev * bio[iP])) / bio[iP]
        p_new = bio[iP] / (1.0 + cff)
        bio[iP] = p_new
        bio[iZ] = bio[iZ] + p_new * (1.0 - p.ZooEEN - p.ZooEED) * cff
        bio[iN] = bio[iN] + p_new * p.ZooEEN * cff
        bio[iD] = bio[iD] + p_new * p.ZooEED * cff

        # P and Z mortality (npzd_Powell.h:413-440)
        for (src, mrn, mrd) in ((iP, p.PhyMRN, p.PhyMRD),
                                (iZ, p.ZooMRN, p.ZooMRD)):
            s_new = bio[src] / (1.0 + dtd * (mrn + mrd))
            bio[src] = s_new
            bio[iN] = bio[iN] + s_new * dtd * mrn
            bio[iD] = bio[iD] + s_new * dtd * mrd

        # remineralization (npzd_Powell.h:444-452)
        d_new = bio[iD] / (1.0 + dtd * p.DetRR)
        bio[iD] = d_new
        bio[iN] = bio[iN] + d_new * dtd * p.DetRR

        # sinking of P and D
        for (comp, w) in ((iP, p.wPhy), (iD, p.wDet)):
            if w != 0.0:
                bio[comp] = ppm_sink(bio[comp], Hz, z_w, dtd * abs(w))[0]

    return add_increment(t_new, idb, bio, bio_old)


def year_day(time: float, dtype) -> float:
    """The year-day of model time `time` (s), mod(time / 86400, 365.25),
    computed on the host in the state's dtype, as roms_tpu computes it on
    its float state time."""
    import numpy as np
    f = np.float64 if dtype == torch.float64 else np.float32
    return float(np.mod(f(time) / f(86400.0), f(365.25)))


def apply_biology(cfg: Config, grid, t_old, t_new, Hz, z_w, srflx,
                  z_r=None, sustr=None, svstr=None, uwind=None, vwind=None,
                  frc=None, time=None):
    """Dispatch on cfg.biology (the biology.F plugin slot).

    frc: the step's forcing dict; a model with file-driven inputs reads
    its extra fields from it (hypoxia_srm "respiration"; red_tide
    "CystIni", "DIN_obs").  time: the model time (s, a host float) of a
    model with an annual clock (red_tide)."""
    frc = frc or {}
    if cfg.biology == "npzd_powell":
        p = cfg.bio_params or NPZDParams()
        return npzd_powell(cfg, p, t_old, t_new, Hz, z_w, srflx)
    from . import bio_models as bm
    if cfg.biology == "npzd_franks":
        p = cfg.bio_params or bm.FranksParams()
        return bm.npzd_franks(cfg, p, t_old, t_new, Hz, z_w, z_r, srflx)
    if cfg.biology == "npzd_iron":
        p = cfg.bio_params or bm.IronParams()
        return bm.npzd_iron(cfg, p, grid, t_old, t_new, Hz, z_w, srflx)
    if cfg.biology == "fennel":
        p = cfg.bio_params or bm.FennelParams()
        return bm.fennel(cfg, p, grid, t_old, t_new, Hz, z_w, srflx,
                         sustr=sustr, svstr=svstr, uwind=uwind, vwind=vwind)
    if cfg.biology == "hypoxia_srm":
        p = cfg.bio_params or bm.HypoxiaParams()
        return bm.hypoxia_srm(cfg, p, grid, t_old, t_new, Hz, z_w, srflx,
                              sustr=sustr, svstr=svstr, uwind=uwind,
                              vwind=vwind,
                              respiration=frc.get("respiration"))
    if cfg.biology == "nemuro":
        p = cfg.bio_params or bm.NemuroParams()
        return bm.nemuro(cfg, p, t_old, t_new, Hz, z_w, srflx)
    if cfg.biology == "ecosim":
        p = cfg.bio_params or bm.EcosimParams()
        return bm.ecosim(cfg, p, t_old, t_new, Hz, z_w, srflx)
    if cfg.biology == "red_tide":
        p = cfg.bio_params or bm.RedTideParams()
        yday = year_day(time if time is not None else 0.0, t_old.dtype)
        return bm.red_tide(cfg, p, t_old, t_new, Hz, z_w, z_r, srflx, yday,
                           cyst_ini=frc.get("CystIni"),
                           din_obs=frc.get("DIN_obs"))
    raise ValueError(f"unknown biology model {cfg.biology!r}")
