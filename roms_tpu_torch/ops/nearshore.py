"""Wave radiation-stress forcing (counterpart of
``roms_tpu/ops/nearshore.py``; radiation_stress.F with
nearshore_mellor05.h and nearshore_mellor08.h, no Svendsen roller).

From monochromatic surface-wave fields (height Hwave, direction Dwave and
length Lwave, from the forcing dict) each kernel computes

  * the 3-D radiation-stress tensor (Sxx, Sxy, Syy) with its vertical
    structure functions;
  * the flux-form momentum forcing rustr3d/rvstr3d (the horizontal stress
    divergence plus a vertical term) and its column sums rustr2d/rvstr2d;
  * the Stokes drift u_stokes/v_stokes and its vertical means.

The step (stepping.py) subtracts rustr3d from ru and rustr2d from rufrc,
and adds the Stokes transport to the mass fluxes, the fast loop's depth
fluxes and the corrected fluxes, as roms_tpu's does.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from .. import constants as C
from ..config import Config
from ..grid import Grid
from .stencil import ip1, im1, jp1, jm1, at_p

_EPS = 1.0e-14
_KDMAX = 5.0
_LWAVE_MIN = 1.0


class NearshoreForcing(NamedTuple):
    rustr3d: torch.Tensor      # (N,Ny,Nx) flux-form u forcing (m4/s2)
    rvstr3d: torch.Tensor
    rustr2d: torch.Tensor      # column sums (Ny,Nx)
    rvstr2d: torch.Tensor
    u_stokes: torch.Tensor     # (N,Ny,Nx) Stokes drift (m/s)
    v_stokes: torch.Tensor
    ubar_stokes: torch.Tensor  # vertical means (Ny,Nx)
    vbar_stokes: torch.Tensor
    Sxx: torch.Tensor          # (N,Ny,Nx) radiation stresses (m3/s2)
    Sxy: torch.Tensor
    Syy: torch.Tensor


def _column(c, like):
    """A (K,) stretching table as a (K,1,1) tensor of `like`'s kind."""
    return torch.as_tensor(c, dtype=like.dtype,
                           device=like.device)[:, None, None]


def _wave_numbers(grid: Grid, zeta, Hwave, Dwave, Lwave):
    """The wave fields both kernels share: (Dstp, waven, owaven, wavenx,
    waveny, waveE, kD, wavec)."""
    Dstp = zeta + grid.h
    waven = 2.0 * math.pi / torch.clamp(Lwave, min=_LWAVE_MIN)
    owaven = 1.0 / waven
    cdir = 1.5 * math.pi - Dwave - grid.angler
    wavenx = waven * torch.cos(cdir)
    waveny = waven * torch.sin(cdir)
    waveE = 0.0625 * C.g * Hwave * Hwave
    # depth floor: wet/dry can leave Dstp ~ 0 (or below in halo rows); the
    # stresses on dry cells are masked anyway
    kD = torch.clamp(waven * torch.clamp(Dstp, min=0.01) + _EPS,
                     max=_KDMAX)
    wavec = torch.sqrt(C.g * owaven * torch.tanh(kD))
    return Dstp, waven, owaven, wavenx, waveny, waveE, kD, wavec


def _flux_divergence(grid: Grid, Hz, Sxx, Syy, Sxy):
    """The horizontal stress divergence in flux form (:495-540) and the
    metrics om_u, on_v it uses."""
    on_u = grid.on_u
    om_u = 2.0 / (torch.roll(grid.pm, 1, -1) + grid.pm)
    om_v = grid.om_v
    on_v = 2.0 / (torch.roll(grid.pn, 1, -2) + grid.pn)
    SxxH = Sxx * Hz
    SyyH = Syy * Hz
    rustr = (SxxH - im1(SxxH)) * on_u
    rvstr = (SyyH - jm1(SyyH)) * om_v
    UFe = at_p(Hz) * at_p(Sxy)               # psi-point cross stress
    rustr = rustr + (jp1(UFe) - UFe) * om_u
    rvstr = rvstr + (ip1(UFe) - UFe) * on_v
    return rustr, rvstr, on_u, om_u, om_v, on_v


def _stokes(cfg: Config, grid: Grid, Hz, Dstp, waveE, wavenx, waveny,
            wavec, kD, fac2):
    """The Stokes drift (:560-585), tapered to zero as a wet/dry column
    dries, and its vertical means."""
    o2sinh = 1.0 / torch.sinh(2.0 * kD)
    u_st = (im1(waveE) + waveE) * (im1(wavenx) + wavenx) / \
        (im1(wavec) + wavec) * torch.cosh((im1(kD) + kD) * fac2) * \
        0.5 * (im1(o2sinh) + o2sinh) * grid.umask
    v_st = (jm1(waveE) + waveE) * (jm1(waveny) + waveny) / \
        (jm1(wavec) + wavec) * torch.cosh((jm1(kD) + kD) * fac2) * \
        0.5 * (jm1(o2sinh) + o2sinh) * grid.vmask
    if cfg.wetdry:
        # the Stokes flux bypasses the wet/dry limiter, which acts on the
        # Eulerian ubar only: an untapered transport would keep pumping
        # water through nearly dry cells
        dcrit = cfg.dcrit
        fac = torch.clamp((Dstp - dcrit) / (9.0 * dcrit), 0.0, 1.0)
        u_st = u_st * 0.5 * (im1(fac) + fac)
        v_st = v_st * 0.5 * (jm1(fac) + fac)
    Hz_u = 0.5 * (im1(Hz) + Hz)
    Hz_v = 0.5 * (jm1(Hz) + Hz)
    D_u = torch.sum(Hz_u, dim=0)
    D_v = torch.sum(Hz_v, dim=0)
    ubar_st = torch.sum(Hz_u * u_st, dim=0) / torch.clamp(D_u, min=_EPS)
    vbar_st = torch.sum(Hz_v * v_st, dim=0) / torch.clamp(D_v, min=_EPS)
    return u_st, v_st, ubar_st, vbar_st


def _forcing(rustr, rvstr, stokes, Sxx, Sxy, Syy) -> NearshoreForcing:
    u_st, v_st, ubar_st, vbar_st = stokes
    return NearshoreForcing(
        rustr3d=rustr, rvstr3d=rvstr, rustr2d=torch.sum(rustr, dim=0),
        rvstr2d=torch.sum(rvstr, dim=0), u_stokes=u_st, v_stokes=v_st,
        ubar_stokes=ubar_st, vbar_stokes=vbar_st, Sxx=Sxx, Sxy=Sxy,
        Syy=Syy)


def radiation_stress(cfg: Config, grid: Grid, zeta, Hz, Cs_r, Cs_w,
                     Hwave, Dwave, Lwave) -> NearshoreForcing:
    """Mellor05 radiation stresses and Stokes velocities
    (nearshore_mellor05.h).  zeta: the free surface at the rhs time level;
    Hz: the level thicknesses; Hwave (m), Dwave (rad, the direction the
    waves travel toward, nautical convention), Lwave (m)."""
    (Dstp, waven, owaven, wavenx, waveny, waveE, kD,
     wavec) = _wave_numbers(grid, zeta, Hwave, Dwave, Lwave)
    ocosh = 1.0 / torch.cosh(kD)
    osinh = 1.0 / torch.sinh(kD)

    # ---- vertical structure at rho levels (fac2 = 1 + Cs_r; :455-485) ----
    fac2 = 1.0 + _column(Cs_r, Hz)
    FCCr = torch.cosh(kD * fac2) * ocosh
    FCSr = torch.cosh(kD * fac2) * osinh
    FSSr = torch.sinh(kD * fac2) * osinh
    waveEr = waven * waveE * FCSr * FCCr
    cff4 = waveE * waven * FCSr * (FCCr - FSSr)
    ow2 = owaven * owaven
    Sxx = cff4 + waveEr * wavenx * wavenx * ow2
    Syy = cff4 + waveEr * waveny * waveny * ow2
    Sxy = waveEr * wavenx * waveny * ow2

    rustr, rvstr, on_u, om_u, om_v, on_v = _flux_divergence(
        grid, Hz, Sxx, Syy, Sxy)

    # ---- vertical Szx/Szy terms (w-level structure; :790-905) ----
    fac2w = 1.0 + _column(Cs_w, Hz)

    def vert_term(kD_s, E_s, dE, dkD, pn_half):
        FCC = torch.cosh(kD_s * fac2w) / torch.cosh(kD_s)
        FCS = torch.cosh(kD_s * fac2w) / torch.sinh(kD_s)
        FSS = torch.sinh(kD_s * fac2w) / torch.sinh(kD_s)
        otanh = 1.0 / torch.tanh(kD_s)
        CF = pn_half * (FSS * dE + E_s * dkD * (FCS * fac2w - FSS * otanh))
        FC = (FSS - FCC) * CF
        return FC[1:] - FC[:-1]              # (N,Ny,Nx)

    kD_u = 0.5 * (im1(kD) + kD)
    Szx = vert_term(torch.clamp(kD_u, min=_EPS), im1(waveE) + waveE,
                    waveE - im1(waveE), kD - im1(kD),
                    0.25 * (im1(grid.pn) + grid.pn))
    kD_v = 0.5 * (jm1(kD) + kD)
    Szy = vert_term(torch.clamp(kD_v, min=_EPS), jm1(waveE) + waveE,
                    waveE - jm1(waveE), kD - jm1(kD),
                    0.25 * (jm1(grid.pm) + grid.pm))
    rustr = (rustr + Szx * om_u * on_u) * grid.umask
    rvstr = (rvstr + Szy * om_v * on_v) * grid.vmask

    stokes = _stokes(cfg, grid, Hz, Dstp, waveE, wavenx, waveny, wavec, kD,
                     fac2)
    return _forcing(rustr, rvstr, stokes, Sxx, Sxy, Syy)


def radiation_stress08(cfg: Config, grid: Grid, zeta, Hz, z_r, Cs_r, Cs_w,
                       Hwave, Dwave, Lwave) -> NearshoreForcing:
    """Mellor (2008) radiation stresses (nearshore_mellor08.h, no roller):
    the diagonal stress's vertical structure is -kE FSC FSS + ED
    cosh(2 pi (1 + Cs) gamr)/orad_int (:489-505), the surface wave energy
    ED = E/2 over a near-surface layer of relative thickness gamr =
    min(0.707 D/Hwave, 1), and the vertical flux term is the s-surface
    slope correction from the w-level stress profiles (:733-790).  As in
    roms_tpu, the forcing keeps the Mellor05 flux-form units (m4/s2) and
    leaves out the reference's final pm pn conversion."""
    (Dstp, waven, owaven, wavenx, waveny, waveE, kD,
     wavec) = _wave_numbers(grid, zeta, Hwave, Dwave, Lwave)
    ocosh = 1.0 / torch.cosh(kD)
    osinh = 1.0 / torch.sinh(kD)

    # near-surface ED distribution (:411-418)
    gamr = torch.clamp(0.707 * Dstp / (Hwave + _EPS), max=1.0)
    fac2 = 1.0 + _column(Cs_r, Hz)
    coshg = torch.cosh(2.0 * math.pi * fac2 * gamr)
    orad = 1.0 / (torch.sum(Hz * coshg, dim=0) + _EPS)

    # ---- stresses at rho levels (:461-505) ----
    kE = waven * waveE
    FCCr = torch.cosh(kD * fac2) * ocosh
    FCSr = torch.cosh(kD * fac2) * osinh
    FSCr = torch.sinh(kD * fac2) * ocosh
    FSSr = torch.sinh(kD * fac2) * osinh
    waveEr = kE * FCSr * FCCr
    ED = 0.5 * waveE
    cff4 = -kE * FSCr * FSSr + ED * coshg * orad
    ow2 = owaven * owaven
    Sxx = cff4 + waveEr * wavenx * wavenx * ow2
    Syy = cff4 + waveEr * waveny * waveny * ow2
    Sxy = waveEr * wavenx * waveny * ow2

    rustr, rvstr, on_u, om_u, om_v, on_v = _flux_divergence(
        grid, Hz, Sxx, Syy, Sxy)

    # ---- s-surface slope vertical term (:733-790) ----
    fac2w = 1.0 + _column(Cs_w, Hz)

    def wprof(kD_s, kE_s, knn, gam2, orad2, ED2, ow2_s):
        FCC = torch.cosh(kD_s * fac2w) / torch.cosh(kD_s)
        FCS = torch.cosh(kD_s * fac2w) / torch.sinh(kD_s)
        FSC = torch.sinh(kD_s * fac2w) / torch.cosh(kD_s)
        FSS = torch.sinh(kD_s * fac2w) / torch.sinh(kD_s)
        Ew = kE_s * FCS * FCC
        coshw = torch.cosh(math.pi * fac2w * gam2)
        # A defect copied from roms_tpu, so that the two agree: orad2 is
        # the sum of the two neighbours' orad, not their mean, so the
        # near-surface ED term is twice the reference's formula (gam2,
        # also a sum, enters as pi gam2 = 2 pi mean, which is right).
        c4 = -kE_s * FSC * FSS + 0.5 * ED2 * coshw * orad2
        return c4 + Ew * knn[0] * ow2_s, Ew * knn[1] * ow2_s

    # u points
    kD_u = torch.clamp(0.5 * (im1(kD) + kD), min=_EPS)
    kE_u = 0.5 * (im1(kE) + kE)
    Sn_u = (0.5 * (im1(wavenx * wavenx) + wavenx * wavenx),
            0.5 * (im1(wavenx * waveny) + wavenx * waveny))
    FCCu, FCSu = wprof(kD_u, kE_u, Sn_u, im1(gamr) + gamr,
                       im1(orad) + orad, 0.5 * (im1(waveE) + waveE),
                       0.5 * (im1(ow2) + ow2))
    z_p = at_p(z_r)
    dzx_u = z_r - im1(z_r)
    dzp_u = jp1(z_p) - z_p
    rustr = rustr - (dzx_u * on_u * (FCCu[1:] - FCCu[:-1]) +
                     dzp_u * om_u * (FCSu[1:] - FCSu[:-1]))
    # v points
    kD_v = torch.clamp(0.5 * (jm1(kD) + kD), min=_EPS)
    kE_v = 0.5 * (jm1(kE) + kE)
    Sn_v = (0.5 * (jm1(waveny * waveny) + waveny * waveny),
            0.5 * (jm1(wavenx * waveny) + wavenx * waveny))
    FCCv, FCSv = wprof(kD_v, kE_v, Sn_v, jm1(gamr) + gamr,
                       jm1(orad) + orad, 0.5 * (jm1(waveE) + waveE),
                       0.5 * (jm1(ow2) + ow2))
    dzy_v = z_r - jm1(z_r)
    dzp_v = ip1(z_p) - z_p
    rvstr = rvstr - (dzy_v * om_v * (FCCv[1:] - FCCv[:-1]) +
                     dzp_v * on_v * (FCSv[1:] - FCSv[:-1]))
    rustr = rustr * grid.umask
    rvstr = rvstr * grid.vmask

    stokes = _stokes(cfg, grid, Hz, Dstp, waveE, wavenx, waveny, wavec, kD,
                     fac2)
    return _forcing(rustr, rvstr, stokes, Sxx, Sxy, Syy)
