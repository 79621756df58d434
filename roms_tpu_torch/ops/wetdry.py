"""Wetting-and-drying masks (WET_DRY; counterpart of
``roms_tpu/ops/wetdry.py``; ROMS/Nonlinear/wetdry.F and the WET_DRY blocks
of step2d_LF_AM3.h).

Cells whose total depth falls to the critical depth Dcrit are dry; a
momentum face touching a dry cell admits flow into the dry cell
(rewetting), never out of it.

Mask encoding (wetdry.F wetdry_mask_tile:557-721):
  rmask_wet   : 1 wet / 0 dry at rho points
  u/vmask_wet : 2 both neighbours wet, 0 both dry, +1 upstream (west or
                south) wet and downstream dry, -1 upstream dry and
                downstream wet
  pmask_wet   : 1 for four or three wet of four, 2 for an edge-adjacent
                wet pair, 0 otherwise
The directional limiter (step2d_LF_AM3.h:2123-2131)
  cff5 = | |m| - 1 |,  cff6 = 0.5 + sign(0.5, x) * m,
  cff7 = 0.5 * m * cff5 + cff6 * (1 - cff5)      (in {0, 1})
multiplies the new velocity (and the stored rhs) each fast substep.  The
codes are exact small floats, so the masks compare them with ==, as the
reference does.
"""

from __future__ import annotations

import torch

from ..config import Config
from .stencil import im1, jm1

_EPS = 1.0e-10


def rho_wet(cfg: Config, grid, zeta):
    """1/0 wet mask at rho points (wetdry.F:194-204)."""
    wd = torch.where(zeta + grid.h <= cfg.dcrit + _EPS, 0.0, 1.0).to(
        zeta.dtype)
    return wd * grid.rmask


def face_masks(wd):
    """(umask_wet, vmask_wet) in the {0, +-1, 2} encoding."""
    def face(wm):
        s = wm + wd
        return torch.where(s == 1.0, wm - wd, s)
    return face(im1(wd)), face(jm1(wd))


def psi_wet(wd):
    """pmask_wet at psi points from the four surrounding rho flags: three
    or four wet -> 1; exactly two wet sharing an edge -> 2; else 0."""
    a = im1(jm1(wd))   # (i-1, j-1)
    b = jm1(wd)        # (i,   j-1)
    c = im1(wd)        # (i-1, j  )
    d = wd             # (i,   j  )
    nwet = a + b + c + d
    adjacent = ((a == c) & (b == d)) | ((a == b) & (c == d))
    one = torch.ones_like(wd)
    return torch.where(nwet >= 3.0, one,
                       torch.where((nwet == 2.0) & adjacent, 2.0 * one,
                                   0.0 * one))


def limit(m, x):
    """Directional wet/dry multiplier cff7 in {0, 1} for flow x through a
    face of code m; blocks outflow from dry cells.  The test x >= 0 takes
    +0.5 for -0.0 too, as roms_tpu's limit does (torch.sign would give
    0)."""
    cff5 = torch.abs(torch.abs(m) - 1.0)
    half_sign = torch.where(x >= 0.0, 0.5, -0.5).to(x.dtype)
    cff6 = 0.5 + half_sign * m
    return 0.5 * m * cff5 + cff6 * (1.0 - cff5)


def avg_face_masks(wd_avg, DU_avg1, DV_avg1):
    """Fast-time-averaged directional face masks for the 3-D kernels
    (wetdry_avg_mask_tile:786-824): the {0, +-1, 2} code collapsed to
    {0, 1} by the sign of the averaged transport, a lone pond (zero
    transport next to a dry cell) forced dry."""
    def one(wm, flux):
        s = wm + wd_avg
        m = torch.where(s == 1.0, wm - wd_avg, s)
        msk = limit(m, flux)
        lone = (flux == 0.0) & (s <= 1.0)
        return torch.where(lone, torch.zeros_like(msk), msk)
    return one(im1(wd_avg), DU_avg1), one(jm1(wd_avg), DV_avg1)


def clamp_zeta(cfg: Config, grid, zeta):
    """Keep the depth at Dcrit on land-masked cells
    (step2d_LF_AM3.h:855-866)."""
    return zeta + (cfg.dcrit - grid.h) * (1.0 - grid.rmask)
