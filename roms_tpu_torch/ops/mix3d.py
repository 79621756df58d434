"""Horizontal harmonic mixing (counterpart of ``roms_tpu/ops/mix3d.py``):
uv3dmix2 (uv3dmix2_s.h) and t3dmix2 (t3dmix2_s.h) along s-surfaces, and
t3dmix2_geo (t3dmix2_geo.h) rotated to geopotential surfaces.  Smagorinsky,
biharmonic, isopycnal and rotated-viscosity variants are not ported."""

from __future__ import annotations

import torch

from ..config import Config
from ..grid import Grid
from .stencil import ip1, im1, jp1, jm1


def uv3dmix2(cfg: Config, grid: Grid, u, v, Hz, u_nnew, v_nnew,
             rufrc, rvfrc, dt: float):
    """Harmonic s-surface viscosity (uv3dmix2_s.h K_LOOP): u/v and Hz at
    nrhs; returns the updated (u_nnew, v_nnew, rufrc, rvfrc)."""
    if cfg.uv_smagorinsky:
        raise NotImplementedError("UV_SMAGORINSKY viscosity")
    pm, pn = grid.pm, grid.pn
    visc2 = cfg.visc2 * grid.visc_factor if cfg.use_sponge else cfg.visc2
    cff_r = Hz * 0.5 * (
        (pm / pn) * ((pn + ip1(pn)) * ip1(u) - (im1(pn) + pn) * u) -
        (pn / pm) * ((pm + jp1(pm)) * jp1(v) - (jm1(pm) + pm) * v))
    UFx = grid.on_r * grid.on_r * visc2 * cff_r
    VFe = grid.om_r * grid.om_r * visc2 * cff_r

    sum_pm = im1(jm1(pm)) + im1(pm) + jm1(pm) + pm
    sum_pn = im1(jm1(pn)) + im1(pn) + jm1(pn) + pn
    Hz_p = 0.125 * (im1(Hz) + Hz + im1(jm1(Hz)) + jm1(Hz))
    cff_p = Hz_p * (
        (sum_pm / sum_pn) *
        ((jm1(pn) + pn) * v - (im1(jm1(pn)) + im1(pn)) * im1(v)) +
        (sum_pn / sum_pm) *
        ((im1(pm) + pm) * u - (im1(jm1(pm)) + jm1(pm)) * jm1(u)))
    om_p = 4.0 / sum_pm
    on_p = 4.0 / sum_pn
    if cfg.use_sponge:
        visc2_p = 0.25 * (visc2 + im1(visc2) + jm1(visc2) +
                          im1(jm1(visc2)))
    else:
        visc2_p = visc2
    cff_p = cff_p * grid.pmask * visc2_p
    UFe = om_p * om_p * cff_p
    VFx = on_p * on_p * cff_p

    cffu = dt * 0.25 * (im1(pm) + pm) * (im1(pn) + pn)
    du1 = 0.5 * (im1(pn) + pn) * (UFx - im1(UFx))
    du2 = 0.5 * (im1(pm) + pm) * (jp1(UFe) - UFe)
    rufrc = rufrc + torch.sum(du1 + du2, dim=0)
    u_nnew = u_nnew + cffu * (du1 + du2)

    cffv = dt * 0.25 * (jm1(pm) + pm) * (jm1(pn) + pn)
    dv1 = 0.5 * (jm1(pn) + pn) * (ip1(VFx) - VFx)
    dv2 = 0.5 * (jm1(pm) + pm) * (VFe - jm1(VFe))
    rvfrc = rvfrc + torch.sum(dv1 - dv2, dim=0)
    v_nnew = v_nnew + cffv * (dv1 - dv2)
    return u_nnew, v_nnew, rufrc, rvfrc


def t3dmix2(cfg: Config, grid: Grid, t, Hz, t_nnew, dt: float):
    """Harmonic s-surface tracer diffusion (t3dmix2_s.h); t at nrhs,
    updates the mass-weighted t_nnew (NT,N,Ny,Nx)."""
    pm, pn = grid.pm, grid.pn
    pmon_u = (im1(pm) + pm) / (im1(pn) + pn)
    pnom_v = (jm1(pn) + pn) / (jm1(pm) + pm)
    out = []
    for itrc in range(cfg.ntracers):
        diff2 = cfg.tnu2[itrc] if itrc < len(cfg.tnu2) else 0.0
        if diff2 == 0.0:
            out.append(t_nnew[itrc])
            continue
        q = t[itrc]
        if cfg.use_sponge:
            d2 = diff2 * grid.diff_factor
            fx_c = 0.25 * (d2 + im1(d2))
            fe_c = 0.25 * (d2 + jm1(d2))
        else:
            fx_c = 0.5 * diff2
            fe_c = 0.5 * diff2
        FX = fx_c * pmon_u * (Hz + im1(Hz)) * (q - im1(q))
        FE = fe_c * pnom_v * (Hz + jm1(Hz)) * (q - jm1(q))
        out.append(t_nnew[itrc] + dt * pm * pn *
                   ((ip1(FX) - FX) + (jp1(FE) - FE)))
    return torch.stack(out, dim=0)


def _triad_fluxes_geo(cfg: Config, grid: Grid, q, Hz, z_r, diff2):
    """Rotated-to-geopotential triad fluxes for one tracer
    (t3dmix2_geo.h mixed-derivative scheme with slope upwinding).
    Returns (FX, FE, FSfull) with FSfull at the N+1 interfaces."""
    pm, pn = grid.pm, grid.pn
    # level slopes at u/v points (all levels k=0..N-1)
    cffu = 0.5 * (pm + im1(pm))
    dZdx = cffu * (z_r - im1(z_r))
    dTdx = cffu * (q - im1(q))
    cffv = 0.5 * (pn + jm1(pn))
    dZde = cffv * (z_r - jm1(z_r))
    dTde = cffv * (q - jm1(q))
    # vertical derivative at interfaces (N+1; 0 at ends)
    zpad = torch.zeros_like(q[:1])
    dTdz = torch.cat(
        [zpad, (q[1:] - q[:-1]) / (z_r[1:] - z_r[:-1]), zpad], dim=0)

    dZdx_m = torch.clamp(dZdx, max=0.0)
    dZdx_p = torch.clamp(dZdx, min=0.0)
    dZde_m = torch.clamp(dZde, max=0.0)
    dZde_p = torch.clamp(dZde, min=0.0)

    # horizontal fluxes at levels (FX at u, FE at v)
    cfx = 0.25 * (2.0 * diff2) * grid.on_u * (Hz + im1(Hz))
    FX = cfx * (dTdx - 0.5 * (
        dZdx_m * (im1(dTdz)[:-1] + dTdz[1:]) +
        dZdx_p * (im1(dTdz)[1:] + dTdz[:-1])))
    cfe = 0.25 * (2.0 * diff2) * grid.om_v * (Hz + jm1(Hz))
    FE = cfe * (dTde - 0.5 * (
        dZde_m * (jm1(dTdz)[:-1] + dTdz[1:]) +
        dZde_p * (jm1(dTdz)[1:] + dTdz[:-1])))

    # vertical cross flux FS at interior interfaces kw=1..N-1
    c1 = dZdx_m[:-1]                       # level k   at u(i)
    c2 = ip1(dZdx_m)[1:]                   # level k+1 at u(i+1)
    c3 = dZdx_p[1:]                        # level k+1 at u(i)
    c4 = ip1(dZdx_p)[:-1]                  # level k   at u(i+1)
    dtz = dTdz[1:-1]
    FS = 0.5 * diff2 * (
        c1 * (c1 * dtz - dTdx[:-1]) +
        c2 * (c2 * dtz - ip1(dTdx)[1:]) +
        c3 * (c3 * dtz - dTdx[1:]) +
        c4 * (c4 * dtz - ip1(dTdx)[:-1]))
    e1 = dZde_m[:-1]
    e2 = jp1(dZde_m)[1:]
    e3 = dZde_p[1:]
    e4 = jp1(dZde_p)[:-1]
    FS = FS + 0.5 * diff2 * (
        e1 * (e1 * dtz - dTde[:-1]) +
        e2 * (e2 * dtz - jp1(dTde)[1:]) +
        e3 * (e3 * dtz - dTde[1:]) +
        e4 * (e4 * dtz - jp1(dTde)[:-1]))
    return FX, FE, torch.cat([zpad, FS, zpad], dim=0)


def _rotated_div(cfg: Config, grid: Grid, FX, FE, FSfull):
    """dt-free Hz-weighted tendency from rotated triad fluxes."""
    pmn = grid.pm * grid.pn
    return (pmn * ((ip1(FX) - FX) + (jp1(FE) - FE)) +
            (FSfull[1:] - FSfull[:-1]))


def t3dmix2_geo(cfg: Config, grid: Grid, t, Hz, z_r, t_nnew, dt: float):
    """Harmonic tracer diffusion rotated to geopotential surfaces
    (t3dmix2_geo.h: mixed-derivative triad scheme with slope upwinding);
    t at nrhs, updates the mass-weighted t_nnew (NT,N,Ny,Nx).  A tracer
    with tnu2 = 0 passes through unchanged."""
    out = []
    for itrc in range(cfg.ntracers):
        dcoef = cfg.tnu2[itrc] if itrc < len(cfg.tnu2) else 0.0
        if dcoef == 0.0:
            out.append(t_nnew[itrc])
            continue
        FX, FE, FS = _triad_fluxes_geo(cfg, grid, t[itrc], Hz, z_r, dcoef)
        out.append(t_nnew[itrc] + dt * _rotated_div(cfg, grid, FX, FE, FS))
    return torch.stack(out, dim=0)
