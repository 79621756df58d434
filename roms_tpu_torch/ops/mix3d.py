"""Horizontal harmonic mixing along s-surfaces (counterpart of
``roms_tpu/ops/mix3d.py``): uv3dmix2 (uv3dmix2_s.h) and t3dmix2
(t3dmix2_s.h).  Smagorinsky, biharmonic and rotated variants are not
ported."""

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
