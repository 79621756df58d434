"""Field diagnostics and filters (ROMS/Utility/vorticity.F, shapiro.F,
interpolate.F analogs); counterpart of ``roms_tpu/utils/fields.py``.

All functions take padded [..., eta, xi] tensors.
"""

from __future__ import annotations

import torch

from ..config import Config
from ..grid import Grid
from ..ops.stencil import im1, jm1, ip1, jp1


def vorticity_bar(cfg: Config, grid: Grid, zeta, ubar, vbar):
    """2-D relative (1/s) and potential ((m s)^-1) vorticity at PSI
    points (vorticity.F:395-431)."""
    pm, pn = grid.pm, grid.pn
    # staggered metrics (metrics.F): on_v = dy at v, om_u = dx at u
    on_v = 2.0 / (jm1(pn) + pn)
    om_u = 2.0 / (im1(pm) + pm)
    cff = pm * pn
    dVdx_p = (on_v * vbar - im1(on_v * vbar)) * grid.pmask
    dUde_p = (om_u * ubar - jm1(om_u * ubar)) * grid.pmask
    fomn_p = 0.25 * (im1(jm1(grid.f)) + im1(grid.f) + jm1(grid.f) +
                     grid.f)
    cffp = 0.0625 * (im1(jm1(pm)) + im1(pm) + jm1(pm) + pm) * \
        (im1(jm1(pn)) + im1(pn) + jm1(pn) + pn)
    fomn_p = fomn_p / cffp
    rvor = cff * (dVdx_p - dUde_p)
    pvor = cff * (fomn_p + dVdx_p - dUde_p) / (grid.h + zeta)
    return rvor, pvor


def vorticity3d(cfg: Config, grid: Grid, u, v, pden, z_r, rho0=1025.0):
    """3-D relative (1/s) and Ertel potential ((m s)^-1) vorticity at
    PSI points and RHO levels (vorticity.F:240-393)."""
    pm, pn = grid.pm, grid.pn
    on_v = 2.0 / (jm1(pn) + pn)
    om_u = 2.0 / (im1(pm) + pm)

    dVdx = (on_v * v - im1(on_v * v)) * grid.pmask        # at psi
    dUde = (om_u * u - jm1(om_u * u)) * grid.pmask
    cffp = 0.0625 * (im1(jm1(pm)) + im1(pm) + jm1(pm) + pm) * \
        (im1(jm1(pn)) + im1(pn) + jm1(pn) + pn)
    fomn_p = 0.25 * (im1(jm1(grid.f)) + im1(grid.f) + jm1(grid.f) +
                     grid.f) / cffp

    # horizontal density gradients at u/v points
    dRdx = 0.5 * (pm + im1(pm)) * grid.umask * (pden - im1(pden))
    dRde = 0.5 * (pn + jm1(pn)) * grid.vmask * (pden - jm1(pden))

    # vertical derivatives at interior W levels, zero at top/bottom
    def ddz(q, z):
        d = (q[1:] - q[:-1]) / (z[1:] - z[:-1])
        zpad = torch.zeros_like(d[:1])
        return torch.cat([zpad, d, zpad], dim=0)   # (N+1,...)

    z_u = 0.5 * (z_r + im1(z_r))
    z_v = 0.5 * (z_r + jm1(z_r))
    dRdz = ddz(pden, z_r)
    dUdz = ddz(u, z_u)
    dVdz = ddz(v, z_v)

    # cell-centered (k1+k2 pair sums in the reference become the sum of
    # the bracketing W-level values)
    dRdz_pr = 0.125 * ((dRdz[:-1] + dRdz[1:]) +
                       im1(dRdz[:-1] + dRdz[1:]) +
                       jm1(dRdz[:-1] + dRdz[1:]) +
                       im1(jm1(dRdz[:-1] + dRdz[1:])))
    dUdz_pr = (dUdz[:-1] + dUdz[1:]) + jm1(dUdz[:-1] + dUdz[1:])
    dVdz_pr = (dVdz[:-1] + dVdz[1:]) + im1(dVdz[:-1] + dVdz[1:])
    dRde_pr = dRde + im1(dRde)
    dRdx_pr = dRdx + jm1(dRdx)

    rvor = cffp * (dVdx - dUde)
    pvor = (1.0 / rho0) * (
        cffp * dRdz_pr * (fomn_p + dVdx - dUde) +
        0.125 * (dUdz_pr * dRde_pr - dVdz_pr * dRdx_pr))
    return rvor, pvor


def shapiro2d(a, mask=None):
    """Order-2 Shapiro (1970) smoother with mask-edge order reduction
    (shapiro.F shapiro2d_tile): one 1-2-1 pass per direction applied as
    corrections.  Operates on the last two axes."""
    if mask is None:
        d1 = 0.25 * (jm1(a) + jp1(a) - 2.0 * a)
        a2 = a + d1
        d2 = 0.25 * (im1(a2) + ip1(a2) - 2.0 * a2)
        return a2 + d2
    d1 = 0.25 * (jm1(a * mask) + jp1(a * mask) - 2.0 * a * mask) * \
        jm1(mask) * jp1(mask) * mask
    a2 = a + d1
    d2 = 0.25 * (im1(a2 * mask) + ip1(a2 * mask) - 2.0 * a2 * mask) * \
        im1(mask) * ip1(mask) * mask
    return a2 + d2


def linterp2d(a, gi, gj):
    """Bilinear interpolation of padded field `a` at fractional padded
    indices (gi, gj) along (xi, eta) (interpolate.F linterp2d).  gi/gj
    broadcastable tensors; returns values at those points."""
    i0 = torch.floor(gi).long().clamp(0, a.shape[-1] - 2)
    j0 = torch.floor(gj).long().clamp(0, a.shape[-2] - 2)
    fi = gi - i0
    fj = gj - j0
    a00 = a[..., j0, i0]
    a01 = a[..., j0, i0 + 1]
    a10 = a[..., j0 + 1, i0]
    a11 = a[..., j0 + 1, i0 + 1]
    return ((1 - fj) * ((1 - fi) * a00 + fi * a01) +
            fj * ((1 - fi) * a10 + fi * a11))
