"""Lagrangian floats (counterpart of ``roms_tpu/floats.py``;
step_floats.F's fourth-order Milne predictor and Hamming corrector, with
interp_floats.F's interpolation of the velocities to the floats).

Positions are fractional grid coordinates (the reference's
track(ixgrd/iygrd/izgrd)): xg is the rho i-index, yg the rho j-index and zg
in w-level units [0, N].  Every quantity is a tensor over the floats, with a
history of four time levels (n-3 .. n, newest last).  The caller steps the
floats after each model step from that step's u, v, W and Hz, as roms_tpu's
tests do; the model step does not drive them.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .config import Config
from .grid import Grid


class FloatsState(NamedTuple):
    """Position and velocity histories (time levels n-3..n, nfloats)."""
    xg: torch.Tensor      # (4, nf) fractional rho i-index
    yg: torch.Tensor
    zg: torch.Tensor      # (4, nf) w-level units
    ug: torch.Tensor      # (4, nf) dxg/dt histories (grid units a second)
    vg: torch.Tensor
    wg: torch.Tensor
    nsteps: int           # completed float steps (the start-up ladder)


def _positions(a, device=None) -> torch.Tensor:
    a = torch.as_tensor(a, device=device)
    return a if a.is_floating_point() else a.to(torch.float64)


def init_floats(x0, y0, z0, device=None) -> FloatsState:
    """Floats released at (x0, y0, z0), every history level there and the
    velocity histories zero; integer positions become float64."""
    x0, y0, z0 = (_positions(a, device) for a in (x0, y0, z0))

    def rep(a):
        return a.expand((4,) + a.shape).clone()

    z = torch.zeros_like(x0)
    return FloatsState(xg=rep(x0), yg=rep(y0), zg=rep(z0), ug=rep(z),
                       vg=rep(z), wg=rep(z), nsteps=0)


def _take(f, *idx):
    """f[idx] with roms_tpu's gather semantics: a negative index counts
    from the end and an index past an edge is clamped to it."""
    out = []
    for ax, i in enumerate(idx):
        n = f.shape[f.dim() - len(idx) + ax]
        i = torch.where(i < 0, i + n, i)
        out.append(torch.clamp(i, 0, n - 1))
    return f[tuple(out)]


def _bilinear(field2, x, y):
    """Bilinear sample of a 2-D padded array at fractional array coords."""
    i1 = torch.floor(x).to(torch.int64)
    j1 = torch.floor(y).to(torch.int64)
    p2 = x - i1
    q2 = y - j1
    p1 = 1.0 - p2
    q1 = 1.0 - q2
    f = field2
    return (p1 * q1 * _take(f, j1, i1) + p2 * q1 * _take(f, j1, i1 + 1) +
            p1 * q2 * _take(f, j1 + 1, i1) +
            p2 * q2 * _take(f, j1 + 1, i1 + 1))


def _bilinear_gather(field3, k, x, y):
    """Bilinear sample of level k (one a float) of a 3-D padded array."""
    i1 = torch.floor(x).to(torch.int64)
    j1 = torch.floor(y).to(torch.int64)
    p2 = x - i1
    q2 = y - j1
    p1 = 1.0 - p2
    q1 = 1.0 - q2
    f = field3
    return (p1 * q1 * _take(f, k, j1, i1) +
            p2 * q1 * _take(f, k, j1, i1 + 1) +
            p1 * q2 * _take(f, k, j1 + 1, i1) +
            p2 * q2 * _take(f, k, j1 + 1, i1 + 1))


def _trilinear(field3, x, y, zlev):
    """Linear-in-k of bilinear horizontal samples; zlev in rho-level
    fractional units (level k at zlev = k - 0.5, k = 1..N)."""
    N = field3.shape[0]
    zc = torch.clamp(zlev - 0.5, 0.0, N - 1.0)
    k1 = torch.clamp(torch.floor(zc).to(torch.int64), 0, N - 2)
    r2 = torch.clamp(zc - k1, 0.0, 1.0)
    lo = _bilinear_gather(field3, k1, x, y)
    hi = _bilinear_gather(field3, k1 + 1, x, y)
    return (1.0 - r2) * lo + r2 * hi


def _w_level(N: int, zg):
    """The w level below zg and the fraction of the way to the next."""
    kz = torch.clamp(zg, 0.0, N * 1.0)
    k1 = torch.clamp(torch.floor(kz).to(torch.int64), 0, N - 1)
    return k1, kz - k1


def _grid_velocity(cfg: Config, grid: Grid, u, v, W, Hz, xg, yg, zg):
    """Velocities in grid units at float positions (interp_floats.F):
    dxg/dt = u pm at u points, dzg/dt = omega/Hz at w points."""
    off = cfg.halo - 1.0
    # rho(i) sits at xg = i, array index i + H - 1; u(i) at xg = i - 0.5
    xr = xg + off
    yr = yg + off
    pm_f = _bilinear(grid.pm, xr, yr)
    pn_f = _bilinear(grid.pn, xr, yr)
    ug = _trilinear(u, xg + 0.5 + off, yr, zg) * pm_f
    vg = _trilinear(v, xr, yg + 0.5 + off, zg) * pn_f
    # omega/Hz in w-level units: W (N+1 levels) linear in zg
    N = cfg.N
    k1, r = _w_level(N, zg)
    Wlo = _bilinear_gather(W, k1, xr, yr)
    Whi = _bilinear_gather(W, torch.clamp(k1 + 1, max=N), xr, yr)
    Hz_f = _bilinear_gather(Hz, torch.clamp(k1, 0, N - 1), xr, yr)
    wg = ((1.0 - r) * Wlo + r * Whi) * pm_f * pn_f / \
        torch.clamp(Hz_f, min=1e-12)
    return ug, vg, wg


def vwalk_velocity(cfg: Config, grid: Grid, Akt_w, Hz, fl: FloatsState,
                   rwalk):
    """The vertical random-walk velocity (vwalk_floats.F:208-219, Hunter,
    Craig & Philips 1993): sqrt(2 Akt/dt) N(0,1) + dAkt/dz at the float,
    in w-level units (1/s).  Akt_w: the diffusivity at w points
    (N+1,Ny,Nx); rwalk: one standard-normal draw a float, made by the
    caller."""
    off = cfg.halo - 1.0
    x_n, y_n, z_n = fl.xg[3], fl.yg[3], fl.zg[3]
    xr, yr = x_n + off, y_n + off
    N = cfg.N
    k1, r = _w_level(N, z_n)
    a_lo = _bilinear_gather(Akt_w, k1, xr, yr)
    a_hi = _bilinear_gather(Akt_w, torch.clamp(k1 + 1, max=N), xr, yr)
    akt_f = (1.0 - r) * a_lo + r * a_hi
    # dAkt/dz at rho levels (mod_mixing dAktdz), sampled at the float
    dak = (Akt_w[1:] - Akt_w[:-1]) / torch.clamp(Hz, min=1e-12)
    dak_f = _trilinear(dak, xr, yr, z_n)
    Hz_f = _bilinear_gather(Hz, torch.clamp(k1, 0, N - 1), xr, yr)
    w_rw = torch.sqrt((2.0 / cfg.dt) * torch.clamp(akt_f, min=0.0)) * \
        rwalk + dak_f
    return w_rw / torch.clamp(Hz_f, min=1e-12)


def step_floats(cfg: Config, grid: Grid, u, v, W, Hz, fl: FloatsState,
                w_vwalk=None) -> FloatsState:
    """Advance the floats one baroclinic step (step_floats.F): the Milne
    predictor on three velocity histories, the Hamming corrector with the
    velocity at the predicted position, Euler steps until three histories
    exist.  w_vwalk: an optional vertical random-walk or behavioural
    velocity (w-level units), applied forward outside the ladder
    (vwalk_floats.F VWALK_FORWARD)."""
    dt = cfg.dt
    N = cfg.N
    x_n, y_n, z_n = fl.xg[3], fl.yg[3], fl.zg[3]
    u_n, v_n, w_n = _grid_velocity(cfg, grid, u, v, W, Hz, x_n, y_n, z_n)
    ug = torch.cat([fl.ug[1:], u_n[None]], dim=0)
    vg = torch.cat([fl.vg[1:], v_n[None]], dim=0)
    wg = torch.cat([fl.wg[1:], w_n[None]], dim=0)

    started = fl.nsteps >= 3
    if started:
        # Milne predictor (needs three velocity histories)
        c1, c2 = 8.0 / 3.0, 4.0 / 3.0
        xp = fl.xg[0] + dt * (c1 * ug[3] - c2 * ug[2] + c1 * ug[1])
        yp = fl.yg[0] + dt * (c1 * vg[3] - c2 * vg[2] + c1 * vg[1])
        zp = fl.zg[0] + dt * (c1 * wg[3] - c2 * wg[2] + c1 * wg[1])
    else:
        xp = x_n + dt * ug[3]
        yp = y_n + dt * vg[3]
        zp = z_n + dt * wg[3]

    if started:
        # the velocity at the predicted position, then Hamming's corrector
        u_p, v_p, w_p = _grid_velocity(cfg, grid, u, v, W, Hz, xp, yp,
                                       torch.clamp(zp, 0.0, 1.0 * N))
        h1, h2, h3, h4 = 9.0 / 8.0, 1.0 / 8.0, 3.0 / 8.0, 6.0 / 8.0
        x1 = h1 * fl.xg[3] - h2 * fl.xg[1] + dt * (h3 * u_p + h4 * ug[3] -
                                                   h3 * ug[2])
        y1 = h1 * fl.yg[3] - h2 * fl.yg[1] + dt * (h3 * v_p + h4 * vg[3] -
                                                   h3 * vg[2])
        z1 = h1 * fl.zg[3] - h2 * fl.zg[1] + dt * (h3 * w_p + h4 * wg[3] -
                                                   h3 * wg[2])
    else:
        x1, y1, z1 = xp, yp, zp
    if w_vwalk is not None:
        # forward-Euler random-walk displacement, outside the ladder so
        # that the white noise's variance is not filtered
        z1 = z1 + dt * w_vwalk

    # keep in bounds: periodic wrap or clamp to the interior
    if cfg.ew_periodic:
        x1 = torch.remainder(x1 - 0.5, 1.0 * cfg.Lm) + 0.5
    else:
        x1 = torch.clamp(x1, 0.6, cfg.Lm + 0.4)
    if cfg.ns_periodic:
        y1 = torch.remainder(y1 - 0.5, 1.0 * cfg.Mm) + 0.5
    else:
        y1 = torch.clamp(y1, 0.6, cfg.Mm + 0.4)
    z1 = torch.clamp(z1, 0.0, 1.0 * N)

    def push(hist, new):
        return torch.cat([hist[1:], new[None]], dim=0)

    return FloatsState(xg=push(fl.xg, x1), yg=push(fl.yg, y1),
                       zg=push(fl.zg, z1), ug=ug, vg=vg, wg=wg,
                       nsteps=fl.nsteps + 1)
