"""MPDATA recursive anti-diffusive tracer advection corrector (counterpart of
``roms_tpu/ops/mpdata.py``; mpdata_adiff.F and the MPDATA branches of
step3d_t.F:408-428, 1167-1180 and 1213-1318).

The Smolarkiewicz & Grabowski (1990) flux-corrected limiter with the
reference's default build: the ``fac`` limit is 1 (TS_MPDATA_LIMIT off)
and the series stops at first order (MPDATA_HOT off).  Fields are
halo-padded [..., eta, xi]; u-point i spans rho cells i-1 and i.
"""

from __future__ import annotations

import torch

from ..config import Config
from ..grid import Grid
from . import bc as bc_mod
from .stencil import ip1, im1, jp1, jm1

_EPS = 1.0e-18
_EPS2 = 1.0e-10
_LARGE = 1.0e+20
_FAC = 1.0  # TS_MPDATA_LIMIT off


def _xyz(A, B, Cc, Um, Vm, Wm):
    X = (torch.abs(Um) - Um * Um) * A - B * Um * Vm - Cc * Um * Wm
    Y = (torch.abs(Vm) - Vm * Vm) * B - A * Um * Vm - Cc * Vm * Wm
    Z = (torch.abs(Wm) - Wm * Wm) * Cc - A * Um * Wm - B * Vm * Wm
    return X, Y, Z


def _guard(q_a, q_b, vel):
    """Zero the velocity where either neighbour is not positive or the two
    are equal to _EPS2 (mpdata_adiff.F)."""
    bad = (q_a <= 0.0) | (q_b <= 0.0) | (torch.abs(q_a - q_b) <= _EPS2)
    return torch.where(bad, torch.zeros_like(vel), vel)


def _limit(a, lim):
    """min(|a|, _FAC |lim|) with the sign of a."""
    return torch.minimum(torch.abs(a), _FAC * torch.abs(lim)) * torch.sign(a)


def _neigh_extreme(q, mask, red):
    """The extreme of q over the cell, its four horizontal neighbours and
    the levels above and below (the cell itself at the end levels), each
    times its column mask."""
    out = red(im1(q) * im1(mask)[None], q * mask[None])
    for v in (ip1(q) * ip1(mask)[None], jm1(q) * jm1(mask)[None],
              jp1(q) * jp1(mask)[None]):
        out = red(out, v)
    qm = q * mask[None]
    q_dn = torch.cat([qm[:1], qm[:-1]], dim=0)
    q_up = torch.cat([qm[1:], qm[-1:]], dim=0)
    return red(red(out, q_dn), q_up)


def mpdata_adiff(cfg: Config, grid: Grid, t3, Ta, Huon, Hvom, W, oHz, z_r,
                 wet=None):
    """Anti-diffusive, monotonically limited velocities (Ua, Va, Wa) ready
    for the corrected flux pass.  Ta is the upstream-advected intermediate
    tracer (halos filled); t3 the centred level the limiter also reads;
    wet the averaged wet/dry masks or None."""
    dt = cfg.dt
    N = cfg.N
    pm, pn = grid.pm, grid.pn
    pmn = pm * pn
    umask, vmask, rmask = grid.umask, grid.vmask, grid.rmask
    umw = wet["umask_wet"] if wet is not None else 1.0
    vmw = wet["vmask_wet"] if wet is not None else 1.0
    rmw = wet["rmask_wet"] if wet is not None else 1.0

    # inverse vertical spacing at the interior interfaces
    # (mpdata_adiff.F:228)
    odz = 1.0 / (z_r[1:] - z_r[:-1])          # (N-1, Ny, Nx)

    # the vertical-gradient and z-span stacks of C
    G = (Ta[1:] - Ta[:-1]) * odz
    gs = torch.cat([G[:1], G[1:] + G[:-1], G[-1:]], dim=0)
    zspan = torch.cat([(z_r[1] - z_r[0])[None], z_r[2:] - z_r[:-2],
                       (z_r[-1] - z_r[-2])[None]], dim=0)
    # the end levels take 0.25, the interior 0.0625 (mpdata_adiff.F:240-282)
    cfac = torch.full((N,), 0.0625, dtype=Ta.dtype, device=Ta.device)
    cfac[0] = 0.25
    cfac[-1] = 0.25
    cfac = cfac[:, None, None]

    # the W Courant stacks for Wm at u/v points
    wc_low = (W[1] * odz[0])[None]
    wc_int = W[1:N - 1] * odz[:-1] + W[2:N] * odz[1:]
    wc_top = (W[N - 1] * odz[-1])[None]
    wcol = torch.cat([wc_low, wc_int, wc_top], dim=0) * pmn

    # the masked cross-direction gradients (mpdata_adiff.F:305-330)
    bcol = ((jp1(Ta) - Ta) * (pn + jp1(pn)) * jp1(vmask) +
            (Ta - jm1(Ta)) * (jm1(pn) + pn) * vmask)
    acol = ((ip1(Ta) - Ta) * (pm + ip1(pm)) * ip1(umask) +
            (Ta - im1(Ta)) * (pm + im1(pm)) * umask)
    # the transverse-flux Courant stacks
    vterm = Hvom * (pm + jm1(pm)) * (pn + jm1(pn)) * (oHz + jm1(oHz))
    uterm = Huon * (pm + im1(pm)) * (pn + im1(pn)) * (oHz + im1(oHz))

    # ---- the u anti-diffusive velocity (Courant number) ----
    TaS = Ta + im1(Ta) + _EPS
    Cu = cfac * (gs + im1(gs)) * (zspan + im1(zspan)) / TaS
    Wmu = 0.25 * dt * (wcol + im1(wcol))
    Au = (Ta - im1(Ta)) / TaS
    on_v = grid.on_v
    Bu = 0.03125 * (bcol + im1(bcol)) * \
        (on_v + jp1(on_v) + im1(on_v) + im1(jp1(on_v))) / TaS
    Umu = 0.125 * dt * Huon * (pm + im1(pm)) * (pn + im1(pn)) * \
        (oHz + im1(oHz))
    vsum = vterm + jp1(vterm)
    Vmu = 0.03125 * dt * (vsum + im1(vsum))
    X, _, _ = _xyz(Au, Bu, Cu, Umu, Vmu, Wmu)
    Ua = _limit(X / (1.0 - torch.abs(Au) + _EPS), Umu)
    Ua = _guard(im1(Ta), Ta, Ua) * umask * umw

    # ---- the v anti-diffusive velocity ----
    TaSv = Ta + jm1(Ta) + _EPS
    Cv = cfac * (gs + jm1(gs)) * (zspan + jm1(zspan)) / TaSv
    Wmv = 0.25 * dt * (wcol + jm1(wcol))
    Bv = (Ta - jm1(Ta)) / TaSv
    om_u = grid.om_u
    Av = 0.03125 * (acol + jm1(acol)) * \
        (om_u + ip1(om_u) + jm1(om_u) + jm1(ip1(om_u))) / TaSv
    Vmv = 0.125 * dt * Hvom * (pn + jm1(pn)) * (pm + jm1(pm)) * \
        (oHz + jm1(oHz))
    usum = uterm + ip1(uterm)
    Umv = 0.03125 * dt * (usum + jm1(usum))
    _, Y, _ = _xyz(Av, Bv, Cv, Umv, Vmv, Wmv)
    Va = _limit(Y / (1.0 - torch.abs(Bv) + _EPS), Vmv)
    Va = _guard(jm1(Ta), Ta, Va) * vmask * vmw

    Ua = _uv_edge_bc(cfg, Ua, "u")
    Va = _uv_edge_bc(cfg, Va, "v")

    # ---- the w anti-diffusive velocity at interfaces 1..N-1 ----
    TaSw = Ta[1:] + Ta[:-1] + _EPS
    Cw = (Ta[1:] - Ta[:-1]) / TaSw
    Aw = 0.0625 * (acol[1:] + acol[:-1]) * (om_u + ip1(om_u)) / TaSw
    Bw = 0.0625 * (bcol[1:] + bcol[:-1]) * (on_v + jp1(on_v)) / TaSw
    ur = uterm + ip1(uterm)
    vr = vterm + jp1(vterm)
    Umw = 0.03125 * dt * (ur[1:] + ur[:-1])
    Vmw = 0.03125 * dt * (vr[1:] + vr[:-1])
    Wmw = W[1:N] * odz * pmn * dt
    _, _, Z = _xyz(Aw, Bw, Cw, Umw, Vmw, Wmw)
    Wa = _limit(Z / (1.0 - torch.abs(Cw) + _EPS), Wmw)
    Wa = _guard(Ta[:-1], Ta[1:], Wa) * rmask * rmw

    # ---- the beta-ratio monotonic limiter (Smolarkiewicz & Grabowski) ----
    mask_up = rmask
    mask_dn = torch.clamp((1.0 - rmask) * _LARGE, min=1.0)
    zeros = torch.zeros_like(Wa[:1])
    Wa_full = torch.cat([zeros, Wa, zeros], dim=0)          # (N+1,...)

    Tmax = torch.maximum(_neigh_extreme(Ta, mask_up, torch.maximum),
                         _neigh_extreme(t3, mask_up, torch.maximum))
    Tmin = torch.minimum(_neigh_extreme(Ta, mask_dn, torch.minimum),
                         _neigh_extreme(t3, mask_dn, torch.minimum))

    Uap = torch.clamp(Ua, min=0.0)
    Uan = torch.clamp(Ua, max=0.0)
    Vap = torch.clamp(Va, min=0.0)
    Van = torch.clamp(Va, max=0.0)
    Wap = torch.clamp(Wa_full, min=0.0)
    Wan = torch.clamp(Wa_full, max=0.0)

    influx = (im1(Ta) * Uap - ip1(Ta) * ip1(Uan) +
              jm1(Ta) * Vap - jp1(Ta) * jp1(Van) +
              torch.cat([zeros, Ta[:-1]], dim=0) * Wap[:-1] -
              torch.cat([Ta[1:], zeros], dim=0) * Wan[1:])
    beta_up = (Tmax - Ta) / (influx + _EPS)
    outflux = Ta * (ip1(Uap) - Uan + jp1(Vap) - Van + Wap[1:] - Wan[:-1])
    beta_dn = (Ta - Tmin) / (outflux + _EPS)

    land = (mask_up == 0.0)[None]
    two = torch.full_like(beta_up, 2.0)
    beta_up = torch.where(land, two, beta_up)
    beta_dn = torch.where(land, two, beta_dn)

    # the monotonic velocities, back in dimensional units
    odt = 1.0 / dt
    cu1 = torch.clamp(torch.minimum(im1(beta_dn), beta_up), max=1.0)
    cu2 = torch.clamp(torch.minimum(im1(beta_up), beta_dn), max=1.0)
    Ua = (cu1 * Uap + cu2 * Uan) * odt * grid.om_u * umask * umw
    cv1 = torch.clamp(torch.minimum(jm1(beta_dn), beta_up), max=1.0)
    cv2 = torch.clamp(torch.minimum(jm1(beta_up), beta_dn), max=1.0)
    Va = (cv1 * Vap + cv2 * Van) * odt * grid.on_v * vmask * vmw
    cw1 = torch.clamp(torch.minimum(beta_dn[:-1], beta_up[1:]), max=1.0)
    cw2 = torch.clamp(torch.minimum(beta_up[:-1], beta_dn[1:]), max=1.0)
    Wa = (cw1 * torch.clamp(Wa, min=0.0) + cw2 * torch.clamp(Wa, max=0.0)) \
        * odt * grid.omn * (z_r[1:] - z_r[:-1]) * rmask * rmw

    Ua = _uv_edge_bc(cfg, Ua, "u")
    Va = _uv_edge_bc(cfg, Va, "v")
    return Ua, Va, torch.cat([zeros, Wa, zeros], dim=0)


def _uv_edge_bc(cfg: Config, a, kind: str):
    """The anti-diffusive velocities at the domain edges
    (mpdata_adiff.F:585-650): a closed edge zeroes its boundary face, an
    open one copies the first interior face."""
    H = cfg.halo
    if kind == "u":
        if not cfg.ew_periodic:
            lbc = cfg.lbc_u
            wv = 0.0 if lbc.west == "Clo" else a[..., :, H + 1]
            a = bc_mod.set_col(a, H, wv, "west")
            ev = 0.0 if lbc.east == "Clo" else a[..., :, H + cfg.Lm - 1]
            a = bc_mod.set_col(a, H + cfg.Lm, ev, "east")
    else:
        if not cfg.ns_periodic:
            lbc = cfg.lbc_v
            sv = 0.0 if lbc.south == "Clo" else a[..., H + 1, :]
            a = bc_mod.set_row(a, H, sv, "south")
            nv = 0.0 if lbc.north == "Clo" else a[..., H + cfg.Mm - 1, :]
            a = bc_mod.set_row(a, H + cfg.Mm, nv, "north")
    return a


def mpdata_corrected_fluxes(grid: Grid, Ta, Ua, Va, Wa, Hz):
    """The second pass's upstream fluxes with the anti-diffusive velocities
    (step3d_t.F:1240-1266, 1283-1292)."""
    FX = (torch.clamp(Ua, min=0.0) * im1(Ta) +
          torch.clamp(Ua, max=0.0) * Ta) * 0.5 * (Hz + im1(Hz)) * grid.on_u
    FE = (torch.clamp(Va, min=0.0) * jm1(Ta) +
          torch.clamp(Va, max=0.0) * Ta) * 0.5 * (Hz + jm1(Hz)) * grid.om_v
    FC = torch.clamp(Wa[1:-1], min=0.0) * Ta[:-1] + \
        torch.clamp(Wa[1:-1], max=0.0) * Ta[1:]
    zero = torch.zeros_like(FC[:1])
    return FX, FE, torch.cat([zero, FC, zero], dim=0)
