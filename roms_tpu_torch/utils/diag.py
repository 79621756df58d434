"""Per-step global diagnostics and blowup detection.

Counterpart of ``roms_tpu/utils/diag.py``; reference ROMS/Nonlinear/diag.F:
volume-averaged kinetic/potential energy, total volume, max Courant/speed,
NaN detection (:515-537).  Every result is a 0-d tensor on the state's
device, so a caller waits for the card only when it reads one.
"""

from __future__ import annotations

import torch

from .. import constants as C
from ..config import Config
from ..grid import Grid, hc_of
from .. import vgrid
from ..ops import eos
from ..ops.stencil import ip1, jp1
from ..state import State


def interior2d(cfg: Config, a):
    H = cfg.halo
    return a[..., H:H + cfg.Mm, H:H + cfg.Lm]


def diagnostics(cfg: Config, grid: Grid, state: State):
    """Returns dict with volume, ke, pe (volume-averaged, m2/s2), max |u|,
    max |zeta|, and a finite flag."""
    hc = hc_of(cfg)
    z_r, z_w, Hz = vgrid.set_depth(grid.h, state.zeta, hc, grid.sc_r,
                                   grid.Cs_r, grid.sc_w, grid.Cs_w,
                                   cfg.vtransform)
    area = interior2d(cfg, grid.omn)
    Hzi = interior2d(cfg, Hz)
    vol_cells = Hzi * area
    volume = vol_cells.sum(0).sum()

    # KE at rho points: 0.5*(u^2 avg + v^2 avg) per cell volume
    u2 = 0.5 * (state.u ** 2 + ip1(state.u) ** 2)
    v2 = 0.5 * (state.v ** 2 + jp1(state.v) ** 2)
    ke_density = 0.5 * interior2d(cfg, u2 + v2)
    ke = (ke_density * vol_cells).sum() / volume

    # PE relative to z (diag.F uses g*z*rho/rho0 integral)
    rho_anom = eos.rho_eos(cfg, state.t, z_r) if cfg.ntracers else 0.0
    pe_density = C.g * interior2d(cfg, z_r * (1000.0 + rho_anom)) / cfg.rho0
    pe = (pe_density * vol_cells).sum() / volume

    umax = torch.maximum(interior2d(cfg, state.u).abs().amax(),
                         interior2d(cfg, state.v).abs().amax())
    zmax = interior2d(cfg, state.zeta).abs().amax()
    finite = torch.isfinite(umax) & torch.isfinite(zmax) & \
        torch.isfinite(interior2d(cfg, state.t).abs().amax())
    return dict(volume=volume, ke=ke, pe=pe, umax=umax, zmax=zmax,
                finite=finite)


def blowup(cfg: Config, diags, max_speed: float = 20.0,
           max_zeta: float = 100.0):
    """Blowup condition matching diag.F:515-537 semantics."""
    return (~diags["finite"]) | (diags["umax"] > max_speed) | \
        (diags["zmax"] > max_zeta)


def stiffness(cfg: Config, grid: Grid):
    """Grid stiffness ratios (ROMS/Utility/stiffness.F): rx0 (Beckmann &
    Haidvogel bathymetry slope number) and rx1 (Haney number over the
    terrain-following levels at rest).  Returns (rx0, rx1) 0-d tensors."""
    hc = hc_of(cfg)
    zeta0 = torch.zeros_like(grid.h)
    _, z_w, _ = vgrid.set_depth(grid.h, zeta0, hc, grid.sc_r, grid.Cs_r,
                                grid.sc_w, grid.Cs_w, cfg.vtransform)
    H = cfg.halo

    # u-face neighbours over the interior (i and i-1), v-faces likewise
    def faces(a):
        ai = a[..., H:H + cfg.Mm, H:H + cfg.Lm]
        aim = a[..., H:H + cfg.Mm, H - 1:H + cfg.Lm - 1]
        aj = ai
        ajm = a[..., H - 1:H + cfg.Mm - 1, H:H + cfg.Lm]
        return (ai, aim), (aj, ajm)

    (hu, hum), (hv, hvm) = faces(grid.h)
    (mu, mum), (mv, mvm) = faces(grid.rmask)
    wu = mu * mum
    wv = mv * mvm
    rx0 = torch.maximum(
        (wu * (hu - hum).abs() / (hu + hum)).amax(),
        (wv * (hv - hvm).abs() / (hv + hvm)).amax())

    (zu, zum), (zv, zvm) = faces(z_w)
    num_u = (zu[1:] - zum[1:] + zu[:-1] - zum[:-1]).abs()
    den_u = zu[1:] + zum[1:] - zu[:-1] - zum[:-1]
    num_v = (zv[1:] - zvm[1:] + zv[:-1] - zvm[:-1]).abs()
    den_v = zv[1:] + zvm[1:] - zv[:-1] - zvm[:-1]
    rx1 = torch.maximum(
        (wu * num_u / den_u.clamp(min=1e-30)).amax(),
        (wv * num_v / den_v.clamp(min=1e-30)).amax())
    return rx0, rx1
