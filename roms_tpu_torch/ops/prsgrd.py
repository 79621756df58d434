"""Baroclinic pressure gradient (counterpart of ``roms_tpu/ops/prsgrd.py``).

Only the default scheme is ported: "djs", the splines density Jacobian of
Shchepetkin & McWilliams 2003 (prsgrd32.h).  Returns the contribution to
ru/rv (m4/s2).  Arrays are [k, j, i], k=0 bottom.
"""

from __future__ import annotations

import torch

from .. import constants as C
from ..config import Config
from .stencil import im1, jm1

_EPS = 1.0e-10


def _harm_clamped(a, b):
    """Monotonized harmonic mean: 2ab/(a+b) where 2ab > eps, else 0."""
    cff = 2.0 * a * b
    safe = torch.where(cff > _EPS, a + b, torch.ones_like(a))
    return torch.where(cff > _EPS, cff / safe, torch.zeros_like(a))


def _rcumsum(inc, top):
    """Integrate increments downward from the top: out[k] = top +
    sum_{m>=k} inc[m]; out has one more level than inc (out[-1]=top)."""
    rc = torch.flip(torch.cumsum(torch.flip(inc, (0,)), dim=0), (0,))
    return torch.cat([top[None] + rc, top[None]], dim=0)


def prsgrd32(cfg: Config, grid, rho, z_r, z_w, Hz, eq_tide=None):
    """Splines density-Jacobian pressure gradient (prsgrd32.h:119-285).
    eq_tide: equilibrium tidal elevation subtracted from the surface
    pressure (prsgrd32.h:271)."""
    g = C.g
    GRho = g / cfg.rho0
    HalfGRho = 0.5 * GRho
    OneFifth = 0.2
    OneTwelfth = 1.0 / 12.0

    # ---- vertical monotonized differences (prsgrd32.h:134-160) ----
    dR = rho[1:] - rho[:-1]
    dZ = z_r[1:] - z_r[:-1]
    dR = torch.cat([dR[:1], dR, dR[-1:]], dim=0)
    dZ = torch.cat([dZ[:1], dZ, dZ[-1:]], dim=0)
    dRm = _harm_clamped(dR[1:], dR[:-1])
    dZm = 2.0 * dZ[1:] * dZ[:-1] / (dZ[1:] + dZ[:-1])

    # ---- kinematic pressure P/rho0 (prsgrd32.h:162-186) ----
    N = rho.shape[0]
    zwN = z_w[-1]
    cff2 = 0.5 * (rho[N - 1] - rho[N - 2]) * (zwN - z_r[N - 1]) / \
        (z_r[N - 1] - z_r[N - 2])
    P_top = g * zwN + GRho * (rho[N - 1] + cff2) * (zwN - z_r[N - 1])
    if eq_tide is not None:
        P_top = P_top - g * eq_tide
    inc = HalfGRho * (
        (rho[1:] + rho[:-1]) * (z_r[1:] - z_r[:-1]) -
        OneFifth * ((dRm[1:] - dRm[:-1]) *
                    (z_r[1:] - z_r[:-1] - OneTwelfth * (dZm[1:] + dZm[:-1])) -
                    (dZm[1:] - dZm[:-1]) *
                    (rho[1:] - rho[:-1] - OneTwelfth * (dRm[1:] + dRm[:-1]))))
    P = _rcumsum(inc, P_top)

    # ---- XI-component (prsgrd32.h:188-238) ----
    dzu = z_r - im1(z_r)
    dru = rho - im1(rho)
    dZx = _harm_clamped(dzu, torch.roll(dzu, -1, -1))
    dRx = _harm_clamped(dru, torch.roll(dru, -1, -1))
    ru_pg = grid.on_u * 0.5 * (Hz + im1(Hz)) * (
        im1(P) - P - HalfGRho * (
            (rho + im1(rho)) * dzu -
            OneFifth * ((dRx - im1(dRx)) *
                        (dzu - OneTwelfth * (dZx + im1(dZx))) -
                        (dZx - im1(dZx)) *
                        (dru - OneTwelfth * (dRx + im1(dRx))))))

    # ---- ETA-component (prsgrd32.h:240-285) ----
    dzv = z_r - jm1(z_r)
    drv = rho - jm1(rho)
    dZe = _harm_clamped(dzv, torch.roll(dzv, -1, -2))
    dRe = _harm_clamped(drv, torch.roll(drv, -1, -2))
    rv_pg = grid.om_v * 0.5 * (Hz + jm1(Hz)) * (
        jm1(P) - P - HalfGRho * (
            (rho + jm1(rho)) * dzv -
            OneFifth * ((dRe - jm1(dRe)) *
                        (dzv - OneTwelfth * (dZe + jm1(dZe))) -
                        (dZe - jm1(dZe)) *
                        (drv - OneTwelfth * (dRe + jm1(dRe))))))
    return ru_pg, rv_pg


def prsgrd(cfg: Config, grid, rho, z_r, z_w, Hz, eq_tide=None):
    """Dispatch on cfg.prsgrd_scheme; only "djs" is ported.  The
    tide-generating force (eq_tide) enters djs only, as in roms_tpu."""
    if eq_tide is not None and cfg.prsgrd_scheme != "djs":
        raise ValueError("TIDE_GENERATING_FORCES is wired into the default "
                         "djs (prsgrd32) scheme only")
    if cfg.prsgrd_scheme != "djs":
        raise NotImplementedError(
            f"pressure-gradient scheme {cfg.prsgrd_scheme!r} (only the "
            "default djs / prsgrd32 is ported)")
    return prsgrd32(cfg, grid, rho, z_r, z_w, Hz, eq_tide=eq_tide)
