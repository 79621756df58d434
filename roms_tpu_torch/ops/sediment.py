"""Sediment transport: suspended load, bed exchange, bed layers and bedload
(counterpart of ``roms_tpu/ops/sediment.py``; Sediment/sediment.F,
sed_settling.F, sed_fluxes.F, sed_bed.F and sed_bedload.F).

The sediment classes ride as passive tracers (kg/m3) through the tracer
step; after it, apply_sediment takes one dt in the reference's order:

 1. settling by the CFL-free PPM + WENO semi-Lagrangian scheme
    (sed_settling.F:300-580, ops/settling.py); the seabed export is the
    deposition (kg/m2);
 2. erosion from the top bed layer (Ariathurai & Arulanandan,
    sed_fluxes.F:246-280), limited by the active layer's content, so the
    bed mass never goes negative;
 3. bedload, Meyer-Peter & Mueller or Soulsby & Damgaard, shifted upwind
    to the faces and zero through closed boundaries (sed_bedload.F:
    405-780);
 4. the bed layers: the Harris & Wiberg active-layer thickness, a borrow
    from the layers below when erosion thins the top one, a new layer on
    heavy deposition (sed_bed.F:246-460).

Deltas from the reference that roms_tpu documents, kept here and marked
where they act (DELTA): its module docstring describes the borrow as a
single borrow from layer 2 a step, while its code (and so this port) takes
the whole cascade through the layers below; SED_MORPH's bed-thickness
change reaches h through the step (stepping.py offsets grid.h before
set_depth), not inside this module.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Tuple

import torch

from .. import constants as C
from ..config import Config
from .bc import fill_halo, set_col, set_row
from .settling import ppm_sink
from .stencil import im1, ip1, jm1, jp1

_EPS = 1.0e-14


@dataclass(frozen=True)
class SedParams:
    """Per-class sediment parameters (sediment.in keywords; mod_sediment).

    tau_ce/tau_cd are kinematic critical stresses (m2/s2, N/m2 over rho0
    as read_sedpar makes them); Wsed in m/s positive down; Erate in
    kg/m2/s; Sd50 in m; Srho in kg/m3.
    """
    ised0: int = 2                    # first sediment tracer index
    Sd50: Tuple[float, ...] = (0.00015,)
    Srho: Tuple[float, ...] = (2650.0,)
    Wsed: Tuple[float, ...] = (0.001,)
    Erate: Tuple[float, ...] = (5.0e-5,)
    tau_ce: Tuple[float, ...] = (0.05 / 1025.0,)
    tau_cd: Tuple[float, ...] = (0.05 / 1025.0,)
    poros: float = 0.5
    Nbed: int = 1
    bedload: bool = False
    bedload_method: str = "mpm"       # BEDLOAD_MPM | BEDLOAD_SOULSBY
    bedload_coeff: float = 0.1
    newlayer_thick: float = 0.01      # m; threshold for a new stratum
    # SED_MORPH: the bed-thickness change feeds back into the bathymetry
    # (set_depth.F:166,214), the bed fluxes times the morphological
    # acceleration factor (sed_bed.F:263-270)
    sed_morph: bool = False
    morph_fac: float = 1.0

    @property
    def NST(self) -> int:
        return len(self.Sd50)


def _per_class(values, like):
    """A (NST, 1, 1) tensor of per-class values in like's dtype."""
    return torch.tensor(values, dtype=like.dtype,
                        device=like.device)[:, None, None]


def bottom_stress_mag(bustr, bvstr):
    """The kinematic bottom stress magnitude at rho points
    (sed_fluxes.F:219-224)."""
    return 0.5 * torch.sqrt((bustr + ip1(bustr)) ** 2 +
                            (bvstr + jp1(bvstr)) ** 2)


def _sanitize_ring(cfg: Config, f):
    """Overwrite the boundary ring outside closed edges with the adjacent
    interior value, then fill the halo.  The u/v ring outside a wall is
    scratch that the stencils never read, but the sediment stages evaluate
    the stress at every padded point, and stale ring values there would
    drive unbounded erosion (the reference computes sediment on
    Istr:Iend,Jstr:Jend only and exchanges afterwards)."""
    H = cfg.halo
    if not cfg.ns_periodic:
        f = set_row(f, H - 1, f[..., H, :], "south")
        f = set_row(f, H + cfg.Mm, f[..., H + cfg.Mm - 1, :], "north")
    if not cfg.ew_periodic:
        f = set_col(f, H - 1, f[..., :, H], "west")
        f = set_col(f, H + cfg.Lm, f[..., :, H + cfg.Lm - 1], "east")
    return fill_halo(cfg, f)


def _class_thickness(p: SedParams, bed_mass):
    """Each layer's and class's thickness mass / (Srho (1 - poros))."""
    srho = torch.tensor(p.Srho, dtype=bed_mass.dtype,
                        device=bed_mass.device)[None, :, None, None]
    return bed_mass / (srho * (1.0 - p.poros))


def _bed_thickness(p: SedParams, bed_mass):
    """Each layer's thickness (the bed(:,:,:,ithck) analog)."""
    return torch.sum(_class_thickness(p, bed_mass), dim=1)


def bed_thickness_total(p: SedParams, bed_mass):
    """The total bed thickness (m) over strata and classes
    (sed_bed.F:484-493 bed_thick)."""
    return torch.sum(_class_thickness(p, bed_mass), dim=(0, 1))


def apply_sediment(cfg: Config, grid, p: SedParams, t_new, bed_mass,
                   Hz, z_w, bustr, bvstr, tau_cw=None,
                   tau_c=None, tau_wav=None, phicw=None):
    """One dt of sediment dynamics.  t_new: the (NT,N,Ny,Nx) tracers after
    advection and diffusion (kg/m3); bed_mass: (Nbed,NST,Ny,Nx) kg/m2.
    tau_cw: the BBL's maximum combined wave-current stress, which erosion
    reads where there is one (sed_fluxes.F bustrcwmax); else the current
    stress.  tau_c, tau_wav and phicw feed Soulsby's bedload.  Returns
    (t_new, bed_mass)."""
    dt = cfg.dt
    bustr = _sanitize_ring(cfg, bustr)
    bvstr = _sanitize_ring(cfg, bvstr)
    if tau_cw is not None:
        tau_w = _sanitize_ring(cfg, tau_cw)
    else:
        tau_w = bottom_stress_mag(bustr, bvstr)
    rmask = grid.rmask

    top = bed_mass[0]                              # (NST,Ny,Nx)
    total_top = torch.sum(top, dim=0)
    frac = top / torch.clamp(total_top[None], min=_EPS)

    # the top layer's mean grain size and critical stress
    d50_bed = torch.sum(frac * _per_class(p.Sd50, tau_w), dim=0)
    tauc_bed = torch.sum(frac * _per_class(p.tau_ce, tau_w), dim=0)

    # the active layer thickness (sed_bed.F:377-383, Harris & Wiberg)
    iactv = torch.clamp(0.007 * (tau_w - tauc_bed) * cfg.rho0, min=0.0) + \
        6.0 * d50_bed

    t_new = t_new.clone()
    dep, ero = [], []
    for c in range(p.NST):
        it = p.ised0 + c
        # settling (sed_settling.F)
        conc, flux_bot = ppm_sink(t_new[it], Hz, z_w, dt * abs(p.Wsed[c]))
        dep_c = flux_bot * rmask                     # kg/m2 deposited
        # erosion (sed_fluxes.F:255-280)
        cff1 = (1.0 - p.poros) * frac[c]
        ero_c = dt * p.Erate[c] * cff1 * \
            torch.clamp(tau_w / p.tau_ce[c] - 1.0, min=0.0)
        avail = torch.minimum(p.Srho[c] * cff1 * iactv, top[c]) + dep_c
        ero_c = torch.minimum(ero_c, avail) * rmask
        conc = conc.clone()
        conc[0] = conc[0] + ero_c / Hz[0]
        t_new[it] = conc
        dep.append(dep_c)
        ero.append(ero_c)
    # SED_MORPH: the bed takes the exchange times the morphological
    # acceleration factor (sed_bed.F:263-270); the water column keeps the
    # physical fluxes
    mfac = p.morph_fac if p.sed_morph else 1.0
    bed_mass = bed_mass.clone()
    bed_mass[0] = bed_mass[0] + mfac * (torch.stack(dep) - torch.stack(ero))

    # bedload (sed_bedload.F, BEDLOAD_MPM / BEDLOAD_SOULSBY)
    if p.bedload:
        bed_mass = _bedload_mpm(cfg, grid, p, bed_mass, tau_w, bustr, bvstr,
                                tau_c=tau_c, tau_wav=tau_wav, phicw=phicw)

    # the bed layers (sed_bed.F)
    bed_mass = _bed_layers(cfg, p, bed_mass, iactv)
    # refresh the halos (the reference exchanges t and the bed at the end
    # of the sediment step, mp_exchange4d); without it the halo columns
    # erode with stale neighbours and diverge
    return fill_halo(cfg, t_new), \
        fill_halo(cfg, torch.clamp(bed_mass, min=0.0))


def _soulsby_transport(cfg: Config, p: SedParams, c: int, tau_mean,
                       tau_wav, phicw):
    """Soulsby & Damgaard's (2005) wave-averaged bedload along and across
    the mean current (sed_bedload.F:415-478, BEDLOAD_SOULSBY with the
    reference's w_asym = 0).  Returns (bedld_x, bedld_y), kg/m/s, in the
    current's frame."""
    smgd = (p.Srho[c] / cfg.rho0 - 1.0) * C.g * p.Sd50[c]
    osmgd = 1.0 / smgd
    smgdr = math.sqrt(smgd) * p.Sd50[c] * p.Srho[c]
    theta_wav = tau_wav * osmgd + _EPS
    theta_mean = tau_mean * osmgd
    # the largest Shields stress over the wave cycle (w_asym = 0)
    theta_max = torch.sqrt(
        (theta_mean + theta_wav * torch.cos(phicw)) ** 2 +
        (theta_wav * torch.sin(phicw)) ** 2)
    # motion initiation (the reference compares the nondimensional
    # theta_max with the kinematic tau_ce; kept as it is)
    cff3 = (theta_max / p.tau_ce[c] > 1.0).to(theta_max.dtype)
    phi_x1 = 12.0 * torch.sqrt(theta_mean) * \
        torch.clamp(theta_mean - p.tau_ce[c], min=0.0)
    phi_x2 = 12.0 * (0.9534 + 0.1907 * torch.cos(2.0 * phicw)) * \
        torch.sqrt(theta_wav) * theta_mean
    phi_x = torch.where(torch.abs(phi_x2) > phi_x1, phi_x2, phi_x1)
    bedld_x = phi_x * smgdr * cff3
    cff5 = theta_wav ** 1.5 + 1.5 * theta_mean ** 1.5
    phi_y = 12.0 * 0.1907 * theta_wav * theta_wav * \
        (theta_mean * torch.sin(2.0 * phicw)) / \
        torch.clamp(cff5, min=_EPS) * cff3
    return bedld_x, phi_y * smgdr


def _face(Fr, dm1, mask):
    """The rho-point bedload Fr shifted upwind to the faces
    (sed_bedload.F:671-698)."""
    s_here = torch.sign(Fr)
    Fm = dm1(Fr)
    s_up = torch.sign(Fm)
    pos1 = 0.5 * (1.0 + s_here)
    neg1 = 0.5 * (1.0 - s_here)
    posU = 0.5 * (1.0 + s_up)
    negU = 0.5 * (1.0 - s_up)
    mid = 0.5 * (Fm + Fr)
    return (posU * (pos1 * Fm + neg1 * mid) +
            negU * (neg1 * Fr + pos1 * mid)) * mask


def _bedload_mpm(cfg: Config, grid, p: SedParams, bed_mass, tau_w,
                 bustr, bvstr, tau_c=None, tau_wav=None, phicw=None):
    """Meyer-Peter & Mueller bedload (the default) or Soulsby & Damgaard's
    (p.bedload_method "soulsby", which needs the BBL's stress split),
    shifted upwind to the faces."""
    soulsby = (p.bedload_method == "soulsby" and tau_c is not None
               and tau_wav is not None and phicw is not None)
    if soulsby:
        # the mean stress the waves enhance (sed_bedload.F:400-403)
        tau_mean = tau_c * (1.0 + 1.2 * (tau_wav /
                                         (tau_c + tau_wav + _EPS)) ** 3.2)
    dt = cfg.dt
    # the stress direction at rho points (sed_bedload.F angleu/anglev)
    bu_r = 0.5 * (bustr + ip1(bustr))
    bv_r = 0.5 * (bvstr + jp1(bvstr))
    omag = 1.0 / torch.clamp(tau_w, min=_EPS)
    angleu = bu_r * omag
    anglev = bv_r * omag
    on_r = 1.0 / grid.pn
    om_r = 1.0 / grid.pm
    area = om_r * on_r

    frac = bed_mass[0] / torch.clamp(torch.sum(bed_mass[0], dim=0)[None],
                                     min=_EPS)
    tops = []
    H = cfg.halo
    for c in range(p.NST):
        if soulsby:
            bx, by = _soulsby_transport(cfg, p, c, tau_mean, tau_wav, phicw)
            # from the current's frame to the grid's axes
            bed_x = bx * angleu - by * anglev
            bed_y = bx * anglev + by * angleu
            FX_r = bed_x * on_r * dt * p.bedload_coeff * frac[c]
            FE_r = bed_y * om_r * dt * p.bedload_coeff * frac[c]
        else:
            smgd = (p.Srho[c] / cfg.rho0 - 1.0) * C.g * p.Sd50[c]
            osmgd = 1.0 / smgd
            smgdr = math.sqrt(smgd) * p.Sd50[c] * p.Srho[c]
            # kg/m/s (sed_bedload.F:505-513)
            bedld = 8.0 * torch.clamp(tau_w * osmgd - 0.047, min=0.0) ** 1.5 \
                * smgdr
            FX_r = angleu * bedld * on_r * dt * p.bedload_coeff * frac[c]
            FE_r = anglev * bedld * om_r * dt * p.bedload_coeff * frac[c]
        # limited to the top layer's mass (sed_bedload.F:576-588)
        denom = torch.abs(FX_r) + torch.abs(FE_r) + _EPS
        cap = bed_mass[0, c] * area
        FX_r = torch.sign(FX_r) * torch.minimum(
            torch.abs(FX_r), cap * torch.abs(FX_r) / denom)
        FE_r = torch.sign(FE_r) * torch.minimum(
            torch.abs(FE_r), cap * torch.abs(FE_r) / denom)

        FX = _face(FX_r, im1, grid.umask)
        FE = _face(FE_r, jm1, grid.vmask)
        # no bedload through closed boundaries (sed_bedload.F:722-760)
        if not cfg.ew_periodic:
            if cfg.lbc_t.west == "Clo":
                FX = set_col(FX, H, 0.0, "west")
            if cfg.lbc_t.east == "Clo":
                FX = set_col(FX, H + cfg.Lm, 0.0, "east")
        if not cfg.ns_periodic:
            if cfg.lbc_t.south == "Clo":
                FE = set_row(FE, H, 0.0, "south")
            if cfg.lbc_t.north == "Clo":
                FE = set_row(FE, H + cfg.Mm, 0.0, "north")
        div = (ip1(FX) - FX + jp1(FE) - FE) * grid.pm * grid.pn
        tops.append(torch.clamp(bed_mass[0, c] - div, min=0.0))
    bed_mass = bed_mass.clone()
    bed_mass[0] = torch.stack(tops)
    return bed_mass


def _bed_layers(cfg: Config, p: SedParams, bed_mass, iactv):
    """The stratigraphy (sed_bed.F:377-460).  A top layer thinner than the
    active layer borrows from the layers below; a top layer that deposition
    made thicker than newlayer_thick + iactv splits, its excess becoming a
    new second layer and the two bottom strata merging."""
    if p.Nbed == 1:
        return bed_mass
    thick = _bed_thickness(p, bed_mass)

    # DELTA (roms_tpu's docstring: "a single borrow-from-layer-2"; its code
    # and this port take the whole cascade): the thickness owed to the
    # active layer comes from layers 1..Nbed-1 in order, layer l giving
    # clip(deficit - sum(thick[1:l]), 0, thick[l]) (sed_bed.F:392-446)
    deficit = torch.clamp(iactv - thick[0], min=0.0)
    below = thick[1:]                               # (Nbed-1, Ny, Nx)
    cum_above = torch.cumsum(below, dim=0) - below
    take = torch.minimum(torch.clamp(deficit[None] - cum_above, min=0.0),
                         below)
    take_frac = take / torch.clamp(below, min=_EPS)
    moved = take_frac[:, None] * bed_mass[1:]       # (Nbed-1, NST, ...)
    bed_mass = torch.cat([(bed_mass[0] + torch.sum(moved, dim=0))[None],
                          bed_mass[1:] - moved], dim=0)

    # a new layer on heavy deposition (sed_bed.F:246-330)
    thick = _bed_thickness(p, bed_mass)
    split = thick[0] > (p.newlayer_thick + iactv)
    keep_frac = torch.where(split, iactv / torch.clamp(thick[0], min=_EPS),
                            torch.ones_like(iactv))
    top_keep = keep_frac[None] * bed_mass[0]
    excess = bed_mass[0] - top_keep
    if p.Nbed == 2:
        shifted = (excess + bed_mass[1])[None]
    else:
        merged = (bed_mass[-2] + bed_mass[-1])[None]
        shifted = torch.cat([excess[None], bed_mass[1:-2], merged], dim=0)
    stacked = torch.cat([top_keep[None], shifted], dim=0)
    return torch.where(split[None, None], stacked, bed_mass)


def initial_bed(cfg: Config, p: SedParams, device, thickness=0.10,
                frac=None):
    """A uniform initial bed: the total thickness (m) split equally among
    the layers, the class fractions `frac` (equal by default)."""
    from ..grid import torch_dtype
    shp = (cfg.ny_tot, cfg.nx_tot)
    if frac is None:
        frac = [1.0 / p.NST] * p.NST
    per_layer = thickness / p.Nbed
    kw = dict(dtype=torch_dtype(cfg), device=device)
    return torch.stack([
        torch.stack([torch.full(shp, per_layer * frac[c] * p.Srho[c] *
                                (1.0 - p.poros), **kw)
                     for c in range(p.NST)])
        for _ in range(p.Nbed)])
