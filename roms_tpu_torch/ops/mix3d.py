"""Horizontal mixing (counterpart of ``roms_tpu/ops/mix3d.py``).

Along s-surfaces: harmonic viscosity uv3dmix2 (uv3dmix2_s.h, with the
Smagorinsky viscosity of hmixing.F) and diffusion t3dmix2 (t3dmix2_s.h),
and their biharmonic forms uv3dmix4 and t3dmix4 (uv3dmix4_s.h,
t3dmix4_s.h).  Rotated: tracer diffusion along geopotentials or isopycnals,
harmonic or biharmonic (t3dmix{2,4}_{geo,iso}.h, one driver
_t3dmix_rot), and viscosity along geopotentials (uv3dmix{2,4}_geo.h).
"""

from __future__ import annotations

import torch

from ..config import BC_CLOSED, Config
from ..grid import Grid
from . import bc
from .stencil import ip1, im1, jp1, jm1


def smagorinsky_visc(cfg: Config, grid: Grid, u, v):
    """Deformation-rate-dependent viscosity (hmixing.F UV_SMAGORINSKY):
    visc = SmagorCoef * (cell area) * |D| added to the background."""
    pm, pn = grid.pm, grid.pn
    DefRate = torch.sqrt(
        ((ip1(u) - u) * pm) ** 2 + ((jp1(v) - v) * pn) ** 2 +
        0.5 * (0.25 * pn * (jp1(u) + ip1(jp1(u)) - jm1(u) - ip1(jm1(u))) +
               0.25 * pm * (ip1(v) + ip1(jp1(v)) - im1(v) - im1(jp1(v)))
               ) ** 2)
    return cfg.smagor_coef * grid.omn * DefRate


def uv3dmix2(cfg: Config, grid: Grid, u, v, Hz, u_nnew, v_nnew,
             rufrc, rvfrc, dt: float):
    """Harmonic s-surface viscosity (uv3dmix2_s.h K_LOOP): u/v and Hz at
    nrhs; returns the updated (u_nnew, v_nnew, rufrc, rvfrc)."""
    pm, pn = grid.pm, grid.pn
    visc2 = cfg.visc2 * grid.visc_factor if cfg.use_sponge else cfg.visc2
    if cfg.uv_smagorinsky:
        visc2 = visc2 + smagorinsky_visc(cfg, grid, u, v)
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
    if cfg.use_sponge or cfg.uv_smagorinsky:
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


def uv3dmix4(cfg: Config, grid: Grid, u, v, Hz, u_nnew, v_nnew,
             rufrc, rvfrc, dt: float):
    """Biharmonic s-surface viscosity (uv3dmix4_s.h): the harmonic operator
    twice with sqrt(visc4) a pass (the reference stores sqrt(VISC4) at
    input, read_phypar.F)."""
    pm, pn = grid.pm, grid.pn
    vis = cfg.visc4 ** 0.5
    sum_pm = im1(jm1(pm)) + im1(pm) + jm1(pm) + pm
    sum_pn = im1(jm1(pn)) + im1(pn) + jm1(pn) + pn
    om_p = 4.0 / sum_pm
    on_p = 4.0 / sum_pn

    def harmonic(uu, vv, hz_weight):
        cff_r = 0.5 * (
            (pm / pn) * ((pn + ip1(pn)) * ip1(uu) - (im1(pn) + pn) * uu) -
            (pn / pm) * ((pm + jp1(pm)) * jp1(vv) - (jm1(pm) + pm) * vv))
        if hz_weight is not None:
            cff_r = cff_r * hz_weight
        UFx = grid.on_r * grid.on_r * vis * cff_r
        VFe = grid.om_r * grid.om_r * vis * cff_r
        cff_p = 0.5 * (
            (sum_pm / sum_pn) *
            ((jm1(pn) + pn) * vv - (im1(jm1(pn)) + im1(pn)) * im1(vv)) +
            (sum_pn / sum_pm) *
            ((im1(pm) + pm) * uu - (im1(jm1(pm)) + jm1(pm)) * jm1(uu)))
        if hz_weight is not None:
            hz_p = 0.25 * (im1(Hz) + Hz + im1(jm1(Hz)) + jm1(Hz))
            cff_p = cff_p * hz_p
        cff_p = cff_p * grid.pmask
        UFe = om_p * om_p * vis * cff_p
        VFx = on_p * on_p * vis * cff_p
        du = 0.5 * (im1(pn) + pn) * (UFx - im1(UFx)) + \
            0.5 * (im1(pm) + pm) * (jp1(UFe) - UFe)
        dv = 0.5 * (jm1(pn) + pn) * (ip1(VFx) - VFx) - \
            0.5 * (jm1(pm) + pm) * (VFe - jm1(VFe))
        return du, dv

    # first pass (no Hz): the velocity Laplacian, LapU = 0.125 (pm sum)
    # (pn sum) T with harmonic() returning 0.5 T
    du, dv = harmonic(u, v, None)
    LapU = 0.25 * (im1(pm) + pm) * (im1(pn) + pn) * du
    LapV = 0.25 * (jm1(pm) + pm) * (jm1(pn) + pn) * dv
    LapU, LapV = _lapuv_bc(cfg, LapU, LapV)

    # second pass (with Hz): the flux divergence of the Laplacian
    du, dv = harmonic(LapU, LapV, Hz)
    cffu = dt * 0.25 * (im1(pm) + pm) * (im1(pn) + pn)
    cffv = dt * 0.25 * (jm1(pm) + pm) * (jm1(pn) + pn)
    rufrc = rufrc - torch.sum(du, dim=0)
    u_nnew = u_nnew - cffu * du
    rvfrc = rvfrc - torch.sum(dv, dim=0)
    v_nnew = v_nnew - cffv * dv
    return u_nnew, v_nnew, rufrc, rvfrc


def _lapuv_bc(cfg: Config, LapU, LapV):
    """Lateral closure of the first-pass momentum Laplacian (closed: 0 at
    the normal face, gamma2-slip tangential; uv3dmix4_s.h:233-330,
    uv3dmix4_geo.h:805-960), then the halo fill."""
    H = cfg.halo
    L, M = cfg.Lm, cfg.Mm
    if not cfg.ew_periodic:
        if cfg.lbc_u.west == BC_CLOSED:
            LapU = bc.set_col(LapU, H, 0.0, "west")
            LapV = bc.set_col(LapV, H - 1, cfg.gamma2 * LapV[..., :, H],
                              "west")
        else:
            LapU = bc.set_col(LapU, H, LapU[..., :, H + 1], "west")
            LapV = bc.set_col(LapV, H - 1, 0.0, "west")
        if cfg.lbc_u.east == BC_CLOSED:
            LapU = bc.set_col(LapU, H + L, 0.0, "east")
            LapV = bc.set_col(LapV, H + L,
                              cfg.gamma2 * LapV[..., :, H + L - 1], "east")
        else:
            LapU = bc.set_col(LapU, H + L, LapU[..., :, H + L - 1], "east")
            LapV = bc.set_col(LapV, H + L, 0.0, "east")
    if not cfg.ns_periodic:
        if cfg.lbc_v.south == BC_CLOSED:
            LapV = bc.set_row(LapV, H, 0.0, "south")
            LapU = bc.set_row(LapU, H - 1, cfg.gamma2 * LapU[..., H, :],
                              "south")
        else:
            LapV = bc.set_row(LapV, H, LapV[..., H + 1, :], "south")
            LapU = bc.set_row(LapU, H - 1, 0.0, "south")
        if cfg.lbc_v.north == BC_CLOSED:
            LapV = bc.set_row(LapV, H + M, 0.0, "north")
            LapU = bc.set_row(LapU, H + M,
                              cfg.gamma2 * LapU[..., H + M - 1, :], "north")
        else:
            LapV = bc.set_row(LapV, H + M, LapV[..., H + M - 1, :], "north")
            LapU = bc.set_row(LapU, H + M, 0.0, "north")
    return bc.fill_halo(cfg, LapU), bc.fill_halo(cfg, LapV)


def _lap_bc(cfg: Config, LapT):
    """Boundary closure of a tracer's first biharmonic pass (t3dmix4_s.h,
    t3dmix4_geo.h:485-560): zero on the boundary ring of a non-periodic
    direction, then the halo fill."""
    H = cfg.halo
    L, M = cfg.Lm, cfg.Mm
    if not cfg.ew_periodic:
        LapT = bc.set_col(LapT, H - 1, 0.0, "west")
        LapT = bc.set_col(LapT, H + L, 0.0, "east")
    if not cfg.ns_periodic:
        LapT = bc.set_row(LapT, H - 1, 0.0, "south")
        LapT = bc.set_row(LapT, H + M, 0.0, "north")
    return bc.fill_halo(cfg, LapT)


def t3dmix4(cfg: Config, grid: Grid, t, Hz, t_nnew, dt: float):
    """Biharmonic s-surface tracer diffusion (t3dmix4_s.h): a harmonic
    pass, the boundary closure of the Laplacian, a second harmonic pass."""
    pm, pn = grid.pm, grid.pn
    pmn = pm * pn
    pmon_u = (im1(pm) + pm) / (im1(pn) + pn)
    pnom_v = (jm1(pn) + pn) / (jm1(pm) + pm)
    out = []
    for itrc in range(cfg.ntracers):
        diff4 = (cfg.tnu4[itrc] if itrc < len(cfg.tnu4) else 0.0) ** 0.5
        if diff4 == 0.0:
            out.append(t_nnew[itrc])
            continue
        q = t[itrc]
        FX = 0.25 * (2.0 * diff4) * pmon_u * (Hz + im1(Hz)) * (q - im1(q))
        FE = 0.25 * (2.0 * diff4) * pnom_v * (Hz + jm1(Hz)) * (q - jm1(q))
        LapT = _lap_bc(cfg, pmn * ((ip1(FX) - FX) + (jp1(FE) - FE)) / Hz)
        FX2 = 0.25 * (2.0 * diff4) * pmon_u * (Hz + im1(Hz)) * \
            (LapT - im1(LapT))
        FE2 = 0.25 * (2.0 * diff4) * pnom_v * (Hz + jm1(Hz)) * \
            (LapT - jm1(LapT))
        out.append(t_nnew[itrc] - dt * pmn *
                   ((ip1(FX2) - FX2) + (jp1(FE2) - FE2)))
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


def _triad_fluxes_iso(cfg: Config, grid: Grid, q, pden, Hz, z_r, diff2):
    """Rotated-to-isopycnal triad fluxes for one tracer (t3dmix2_iso.h):
    slopes from the potential density, the vertical tracer gradient taken
    per unit density with the stability floor eps = 0.5 kg/m3
    (t3dmix2_iso.h:355-360 default branch)."""
    pm, pn = grid.pm, grid.pn
    eps = 0.5
    cffu = 0.5 * (pm + im1(pm)) * grid.umask
    dRdx = cffu * (pden - im1(pden))
    dTdx = cffu * (q - im1(q))
    cffv = 0.5 * (pn + jm1(pn)) * grid.vmask
    dRde = cffv * (pden - jm1(pden))
    dTde = cffv * (q - jm1(q))

    # interfaces kw=1..N-1: cff = -1/max(rho(k)-rho(k+1), eps)
    zpad = torch.zeros_like(q[:1])
    crho = -1.0 / torch.clamp(pden[:-1] - pden[1:], min=eps)
    dTdr = torch.cat([zpad, crho * (q[1:] - q[:-1]), zpad], dim=0)
    FSbase = crho * (z_r[1:] - z_r[:-1])           # (N-1, ...)

    dRdx_m = torch.clamp(dRdx, max=0.0)
    dRdx_p = torch.clamp(dRdx, min=0.0)
    dRde_m = torch.clamp(dRde, max=0.0)
    dRde_p = torch.clamp(dRde, min=0.0)

    # horizontal fluxes at levels (t3dmix2_iso.h:352-389): MAX pairs with
    # (below(i-1), above(i)), opposite to the geopotential rotation because
    # density decreases where depth increases
    cfx = 0.25 * (2.0 * diff2) * grid.on_u * (Hz + im1(Hz))
    FX = cfx * (dTdx - 0.5 * (
        dRdx_p * (im1(dTdr)[:-1] + dTdr[1:]) +
        dRdx_m * (im1(dTdr)[1:] + dTdr[:-1])))
    cfe = 0.25 * (2.0 * diff2) * grid.om_v * (Hz + jm1(Hz))
    FE = cfe * (dTde - 0.5 * (
        dRde_p * (jm1(dTdr)[:-1] + dTdr[1:]) +
        dRde_m * (jm1(dTdr)[1:] + dTdr[:-1])))

    # vertical cross flux at interior interfaces (t3dmix2_iso.h:392-418)
    c1 = dRdx_p[:-1]                       # level k   at u(i)
    c2 = ip1(dRdx_p)[1:]                   # level k+1 at u(i+1)
    c3 = dRdx_m[1:]                        # level k+1 at u(i)
    c4 = ip1(dRdx_m)[:-1]                  # level k   at u(i+1)
    dtr = dTdr[1:-1]
    tri = (c1 * (c1 * dtr - dTdx[:-1]) +
           c2 * (c2 * dtr - ip1(dTdx)[1:]) +
           c3 * (c3 * dtr - dTdx[1:]) +
           c4 * (c4 * dtr - ip1(dTdx)[:-1]))
    e1 = dRde_p[:-1]
    e2 = jp1(dRde_p)[1:]
    e3 = dRde_m[1:]
    e4 = jp1(dRde_m)[:-1]
    tri = tri + (e1 * (e1 * dtr - dTde[:-1]) +
                 e2 * (e2 * dtr - jp1(dTde)[1:]) +
                 e3 * (e3 * dtr - dTde[1:]) +
                 e4 * (e4 * dtr - jp1(dTde)[:-1]))
    FS = 0.5 * diff2 * tri * FSbase
    return FX, FE, torch.cat([zpad, FS, zpad], dim=0)


def _rotated_div(cfg: Config, grid: Grid, FX, FE, FSfull):
    """dt-free Hz-weighted tendency from rotated triad fluxes."""
    pmn = grid.pm * grid.pn
    return (pmn * ((ip1(FX) - FX) + (jp1(FE) - FE)) +
            (FSfull[1:] - FSfull[:-1]))


def _t3dmix_rot(cfg: Config, grid: Grid, t, Hz, z_r, t_nnew, dt: float,
                coefs, biharmonic: bool, pden=None):
    """The rotated tracer-mixing family: geopotential triads, or isopycnal
    ones where pden is given; harmonic, or biharmonic as two harmonic
    passes with sqrt(coef) each (t3dmix4_geo/iso.h; read_phypar stores
    sqrt(TNU4)).  A tracer whose coefficient is 0 passes through
    unchanged."""
    def triads(q, d):
        if pden is None:
            return _triad_fluxes_geo(cfg, grid, q, Hz, z_r, d)
        return _triad_fluxes_iso(cfg, grid, q, pden, Hz, z_r, d)

    out = []
    for itrc in range(cfg.ntracers):
        dcoef = coefs[itrc] if itrc < len(coefs) else 0.0
        if dcoef == 0.0:
            out.append(t_nnew[itrc])
            continue
        if not biharmonic:
            FX, FE, FS = triads(t[itrc], dcoef)
            out.append(t_nnew[itrc] + dt * _rotated_div(cfg, grid, FX,
                                                        FE, FS))
        else:
            d4 = dcoef ** 0.5
            FX, FE, FS = triads(t[itrc], d4)
            LapT = _lap_bc(cfg, _rotated_div(cfg, grid, FX, FE, FS) / Hz)
            FX, FE, FS = triads(LapT, d4)
            out.append(t_nnew[itrc] - dt * _rotated_div(cfg, grid, FX,
                                                        FE, FS))
    return torch.stack(out, dim=0)


def _uv_rot_stress(cfg: Config, grid: Grid, u, v, Hz, z_r,
                   visc_r, visc_p, with_hz: bool):
    """Rotated viscous stress divergence shared by uv3dmix2_geo and both
    passes of uv3dmix4_geo: slope-upwinded triads for the horizontal and
    vertical flux components (uv3dmix2_geo.h / uv3dmix4_geo.h K_LOOPs).

    with_hz: weight the horizontal fluxes by the level thickness (the
    harmonic operator / second biharmonic pass); the first biharmonic
    pass computes a plain velocity Laplacian (uv3dmix4_geo.h:494-560, no
    Hz factor).  Returns (duh, dus, dvh, dvs): the horizontal and
    vertical-interface flux-divergence parts for u and v."""
    pm, pn = grid.pm, grid.pn
    sum_pm = im1(jm1(pm)) + im1(pm) + jm1(pm) + pm
    sum_pn = im1(jm1(pn)) + im1(pn) + jm1(pn) + pn
    pm_p = 0.25 * sum_pm
    pn_p = 0.25 * sum_pn
    om_p = 1.0 / pm_p
    on_p = 1.0 / pn_p

    # geopotential slopes (uv3dmix2_geo.h:300-345)
    zx_u = 0.5 * (im1(pm) + pm) * grid.umask * (z_r - im1(z_r))
    zy_v = 0.5 * (jm1(pn) + pn) * grid.vmask * (z_r - jm1(z_r))
    dZdx_p = 0.5 * (jm1(zx_u) + zx_u)
    dZde_p = 0.5 * (im1(zy_v) + zy_v)
    dZdx_r = 0.5 * (zx_u + ip1(zx_u))
    dZde_r = 0.5 * (zy_v + jp1(zy_v))

    # horizontal momentum gradients (:349-410)
    dnUdx = 0.5 * pm * grid.rmask * ((pn + ip1(pn)) * ip1(u) -
                                     (im1(pn) + pn) * u)
    dmUde = 0.125 * sum_pn * grid.pmask * (
        (im1(pm) + pm) * u - (im1(jm1(pm)) + jm1(pm)) * jm1(u))
    dnVdx = 0.125 * sum_pm * grid.pmask * (
        (jm1(pn) + pn) * v - (im1(jm1(pn)) + im1(pn)) * im1(v))
    dmVde = 0.5 * pn * grid.rmask * ((pm + jp1(pm)) * jp1(v) -
                                     (jm1(pm) + pm) * v)

    # vertical shears at interfaces (N+1; zero at surface/bottom)
    zpad_u = torch.zeros_like(u[:1])
    zpad_v = torch.zeros_like(v[:1])
    dz_u = 0.5 * ((im1(z_r)[1:] - im1(z_r)[:-1]) + (z_r[1:] - z_r[:-1]))
    dUdz = torch.cat([zpad_u, (u[1:] - u[:-1]) / dz_u, zpad_u], dim=0)
    dz_v = 0.5 * ((jm1(z_r)[1:] - jm1(z_r)[:-1]) + (z_r[1:] - z_r[:-1]))
    dVdz = torch.cat([zpad_v, (v[1:] - v[:-1]) / dz_v, zpad_v], dim=0)

    mn = lambda a: torch.clamp(a, max=0.0)
    mx = lambda a: torch.clamp(a, min=0.0)
    blw = lambda a: a[:-1]          # interface below level k (kw=k)
    abv = lambda a: a[1:]           # interface above level k (kw=k+1)

    # --- horizontal rotated fluxes at levels (:460-540) ---
    cff_r = (
        grid.on_r * (dnUdx - 0.5 * pn * (
            mn(dZdx_r) * (blw(dUdz) + ip1(abv(dUdz))) +
            mx(dZdx_r) * (abv(dUdz) + ip1(blw(dUdz))))) -
        grid.om_r * (dmVde - 0.5 * pm * (
            mn(dZde_r) * (blw(dVdz) + jp1(abv(dVdz))) +
            mx(dZde_r) * (abv(dVdz) + jp1(blw(dVdz)))))) * grid.rmask
    if with_hz:
        cff_r = Hz * cff_r
    UFx = grid.on_r * grid.on_r * visc_r * cff_r
    VFe = grid.om_r * grid.om_r * visc_r * cff_r

    cff_p = (
        on_p * (dnVdx - 0.5 * pn_p * (
            mn(dZdx_p) * (im1(blw(dVdz)) + abv(dVdz)) +
            mx(dZdx_p) * (im1(abv(dVdz)) + blw(dVdz)))) +
        om_p * (dmUde - 0.5 * pm_p * (
            mn(dZde_p) * (jm1(blw(dUdz)) + abv(dUdz)) +
            mx(dZde_p) * (jm1(abv(dUdz)) + blw(dUdz))))) * grid.pmask
    if with_hz:
        Hz_p = 0.25 * (im1(Hz) + Hz + im1(jm1(Hz)) + jm1(Hz))
        cff_p = Hz_p * cff_p
    UFe = om_p * om_p * visc_p * cff_p
    VFx = on_p * on_p * visc_p * cff_p

    # --- vertical rotated fluxes at interior interfaces (:545-700) ---
    # level pairs at interface kw: below = level kw-1, above = level kw
    lb = lambda a: a[:-1]           # level below interface (kw-1)
    la = lambda a: a[1:]            # level above interface (kw)
    fac1_u = 0.25 * (visc_r + im1(visc_r)) * grid.on_u
    fac2_u = 0.25 * (visc_r + im1(visc_r)) * grid.om_u
    duz = dUdz[1:-1]
    dvz_u = 0.25 * (im1(jp1(dVdz)) + jp1(dVdz) + im1(dVdz) + dVdz)[1:-1]
    dnUdz = 0.5 * (im1(pn) + pn) * duz
    dnVdz = 0.5 * (im1(pn) + pn) * dvz_u
    dmUdz = 0.5 * (im1(pm) + pm) * duz
    dmVdz = 0.5 * (im1(pm) + pm) * dvz_u

    c1 = mn(im1(lb(dZdx_r)))
    c2 = mn(la(dZdx_r))
    c3 = mx(im1(la(dZdx_r)))
    c4 = mx(lb(dZdx_r))
    UFsx = fac1_u * (c1 * (c1 * dnUdz - im1(lb(dnUdx))) +
                     c2 * (c2 * dnUdz - la(dnUdx)) +
                     c3 * (c3 * dnUdz - im1(la(dnUdx))) +
                     c4 * (c4 * dnUdz - lb(dnUdx)))
    e1 = mn(lb(dZde_p))
    e2 = mn(jp1(la(dZde_p)))
    e3 = mx(la(dZde_p))
    e4 = mx(jp1(lb(dZde_p)))
    UFse = fac2_u * (e1 * (e1 * dmUdz - lb(dmUde)) +
                     e2 * (e2 * dmUdz - jp1(la(dmUde))) +
                     e3 * (e3 * dmUdz - la(dmUde)) +
                     e4 * (e4 * dmUdz - jp1(lb(dmUde))))
    x5 = mn(lb(dZdx_p))
    x6 = mn(jp1(la(dZdx_p)))
    x7 = mx(la(dZdx_p))
    x8 = mx(jp1(lb(dZdx_p)))
    UFsx = UFsx + fac1_u * (e1 * (x5 * dnVdz - lb(dnVdx)) +
                            e2 * (x6 * dnVdz - jp1(la(dnVdx))) +
                            e3 * (x7 * dnVdz - la(dnVdx)) +
                            e4 * (x8 * dnVdz - jp1(lb(dnVdx))))
    y5 = mn(im1(lb(dZde_r)))
    y6 = mn(la(dZde_r))
    y7 = mx(im1(la(dZde_r)))
    y8 = mx(lb(dZde_r))
    UFse = UFse - fac2_u * (c1 * (y5 * dmVdz - im1(lb(dmVde))) +
                            c2 * (y6 * dmVdz - la(dmVde)) +
                            c3 * (y7 * dmVdz - im1(la(dmVde))) +
                            c4 * (y8 * dmVdz - lb(dmVde)))

    fac1_v = 0.25 * (visc_r + jm1(visc_r)) * grid.on_v
    fac2_v = 0.25 * (visc_r + jm1(visc_r)) * grid.om_v
    dvz = dVdz[1:-1]
    duz_v = 0.25 * (dUdz + ip1(dUdz) + jm1(dUdz) + ip1(jm1(dUdz)))[1:-1]
    dnUdz_v = 0.5 * (jm1(pn) + pn) * duz_v
    dnVdz_v = 0.5 * (jm1(pn) + pn) * dvz
    dmUdz_v = 0.5 * (jm1(pm) + pm) * duz_v
    dmVdz_v = 0.5 * (jm1(pm) + pm) * dvz

    p1 = mn(lb(dZdx_p))
    p2 = mn(ip1(la(dZdx_p)))
    p3 = mx(la(dZdx_p))
    p4 = mx(ip1(lb(dZdx_p)))
    VFsx = fac1_v * (p1 * (p1 * dnVdz_v - lb(dnVdx)) +
                     p2 * (p2 * dnVdz_v - ip1(la(dnVdx))) +
                     p3 * (p3 * dnVdz_v - la(dnVdx)) +
                     p4 * (p4 * dnVdz_v - ip1(lb(dnVdx))))
    q1 = mn(jm1(lb(dZde_r)))
    q2 = mn(la(dZde_r))
    q3 = mx(jm1(la(dZde_r)))
    q4 = mx(lb(dZde_r))
    VFse = fac2_v * (q1 * (q1 * dmVdz_v - jm1(lb(dmVde))) +
                     q2 * (q2 * dmVdz_v - la(dmVde)) +
                     q3 * (q3 * dmVdz_v - jm1(la(dmVde))) +
                     q4 * (q4 * dmVdz_v - lb(dmVde)))
    r5 = mn(jm1(lb(dZdx_r)))
    r6 = mn(la(dZdx_r))
    r7 = mx(jm1(la(dZdx_r)))
    r8 = mx(lb(dZdx_r))
    VFsx = VFsx - fac1_v * (q1 * (r5 * dnUdz_v - jm1(lb(dnUdx))) +
                            q2 * (r6 * dnUdz_v - la(dnUdx)) +
                            q3 * (r7 * dnUdz_v - jm1(la(dnUdx))) +
                            q4 * (r8 * dnUdz_v - lb(dnUdx)))
    s5 = mn(lb(dZde_p))
    s6 = mn(ip1(la(dZde_p)))
    s7 = mx(la(dZde_p))
    s8 = mx(ip1(lb(dZde_p)))
    VFse = VFse + fac2_v * (p1 * (s5 * dmUdz_v - lb(dmUde)) +
                            p2 * (s6 * dmUdz_v - ip1(la(dmUde))) +
                            p3 * (s7 * dmUdz_v - la(dmUde)) +
                            p4 * (s8 * dmUdz_v - ip1(lb(dmUde))))

    zpu = torch.zeros_like(UFsx[:1])
    zpv = torch.zeros_like(VFsx[:1])
    UFsx = torch.cat([zpu, UFsx, zpu], dim=0)
    UFse = torch.cat([zpu, UFse, zpu], dim=0)
    VFsx = torch.cat([zpv, VFsx, zpv], dim=0)
    VFse = torch.cat([zpv, VFse, zpv], dim=0)

    # --- flux divergences (:710-760) ---
    duh = 0.5 * (im1(pn) + pn) * (UFx - im1(UFx)) + \
        0.5 * (im1(pm) + pm) * (jp1(UFe) - UFe)
    dus = (UFsx[1:] - UFsx[:-1]) + (UFse[1:] - UFse[:-1])
    dvh = 0.5 * (jm1(pn) + pn) * (ip1(VFx) - VFx) - \
        0.5 * (jm1(pm) + pm) * (VFe - jm1(VFe))
    dvs = (VFsx[1:] - VFsx[:-1]) + (VFse[1:] - VFse[:-1])
    return duh, dus, dvh, dvs


def _geo_visc_arrays(cfg: Config, grid: Grid, u, v, visc_const: float,
                     smag: bool):
    """visc at rho- and psi-points (sponge factor + Smagorinsky)."""
    visc_r = visc_const * grid.visc_factor if cfg.use_sponge else \
        visc_const * torch.ones_like(grid.pm)
    if smag and cfg.uv_smagorinsky:
        visc_r = visc_r + smagorinsky_visc(cfg, grid, u, v)
    visc_p = 0.25 * (visc_r + im1(visc_r) + jm1(visc_r) +
                     im1(jm1(visc_r)))
    return visc_r, visc_p


def uv3dmix2_geo(cfg: Config, grid: Grid, u, v, Hz, z_r, u_nnew, v_nnew,
                 rufrc, rvfrc, dt: float):
    """Harmonic viscosity rotated to geopotential surfaces
    (uv3dmix2_geo.h): full rotated stress tensor with slope-upwinded
    triads for both the horizontal and the vertical flux components."""
    pm, pn = grid.pm, grid.pn
    visc_r, visc_p = _geo_visc_arrays(cfg, grid, u, v, cfg.visc2, True)
    duh, dus, dvh, dvs = _uv_rot_stress(cfg, grid, u, v, Hz, z_r,
                                        visc_r, visc_p, with_hz=True)
    cffu = dt * 0.25 * (im1(pm) + pm) * (im1(pn) + pn)
    rufrc = rufrc + torch.sum(duh + dus, dim=0)
    u_nnew = u_nnew + cffu * duh + dt * dus
    cffv = dt * 0.25 * (jm1(pm) + pm) * (jm1(pn) + pn)
    rvfrc = rvfrc + torch.sum(dvh + dvs, dim=0)
    v_nnew = v_nnew + cffv * dvh + dt * dvs
    return u_nnew, v_nnew, rufrc, rvfrc


def uv3dmix4_geo(cfg: Config, grid: Grid, u, v, Hz, z_r, u_nnew, v_nnew,
                 rufrc, rvfrc, dt: float):
    """Biharmonic viscosity rotated to geopotential surfaces
    (uv3dmix4_geo.h): the rotated harmonic operator applied twice with
    sqrt(visc4) per pass.  Pass 1 is a plain velocity Laplacian (no Hz
    weighting, vertical part normalized by the level thickness,
    uv3dmix4_geo.h:758-800); after lateral closure of (LapU, LapV) the
    second Hz-weighted pass is subtracted (:1380-1463)."""
    pm, pn = grid.pm, grid.pn
    vr = grid.visc_factor * cfg.visc4 if cfg.use_sponge else cfg.visc4
    visc_r = torch.sqrt(vr * torch.ones_like(pm))
    visc_p = 0.25 * (visc_r + im1(visc_r) + jm1(visc_r) +
                     im1(jm1(visc_r)))

    duh, dus, dvh, dvs = _uv_rot_stress(cfg, grid, u, v, Hz, z_r,
                                        visc_r, visc_p, with_hz=False)
    oHz_u = 1.0 / (0.5 * (Hz + im1(Hz)))
    oHz_v = 1.0 / (0.5 * (Hz + jm1(Hz)))
    LapU = (0.25 * (im1(pm) + pm) * (im1(pn) + pn) * duh +
            oHz_u * dus) * grid.umask
    LapV = (0.25 * (jm1(pm) + pm) * (jm1(pn) + pn) * dvh +
            oHz_v * dvs) * grid.vmask
    LapU, LapV = _lapuv_bc(cfg, LapU, LapV)

    duh, dus, dvh, dvs = _uv_rot_stress(cfg, grid, LapU, LapV, Hz, z_r,
                                        visc_r, visc_p, with_hz=True)
    cffu = dt * 0.25 * (im1(pm) + pm) * (im1(pn) + pn)
    rufrc = rufrc - torch.sum(duh + dus, dim=0)
    u_nnew = u_nnew - (cffu * duh + dt * dus)
    cffv = dt * 0.25 * (jm1(pm) + pm) * (jm1(pn) + pn)
    rvfrc = rvfrc - torch.sum(dvh + dvs, dim=0)
    v_nnew = v_nnew - (cffv * dvh + dt * dvs)
    return u_nnew, v_nnew, rufrc, rvfrc


def t3dmix2_geo(cfg: Config, grid: Grid, t, Hz, z_r, t_nnew, dt: float):
    """Harmonic tracer diffusion rotated to geopotential surfaces
    (t3dmix2_geo.h: mixed-derivative triad scheme with slope upwinding);
    t at nrhs, updates the mass-weighted t_nnew (NT,N,Ny,Nx)."""
    return _t3dmix_rot(cfg, grid, t, Hz, z_r, t_nnew, dt, cfg.tnu2,
                       biharmonic=False)


def t3dmix4_geo(cfg: Config, grid: Grid, t, Hz, z_r, t_nnew, dt: float):
    """Biharmonic geopotential-rotated diffusion (t3dmix4_geo.h)."""
    return _t3dmix_rot(cfg, grid, t, Hz, z_r, t_nnew, dt, cfg.tnu4,
                       biharmonic=True)


def t3dmix2_iso(cfg: Config, grid: Grid, t, pden, Hz, z_r, t_nnew,
                dt: float):
    """Harmonic isopycnal (epineutral) diffusion (t3dmix2_iso.h)."""
    return _t3dmix_rot(cfg, grid, t, Hz, z_r, t_nnew, dt, cfg.tnu2,
                       biharmonic=False, pden=pden)


def t3dmix4_iso(cfg: Config, grid: Grid, t, pden, Hz, z_r, t_nnew,
                dt: float):
    """Biharmonic isopycnal diffusion (t3dmix4_iso.h)."""
    return _t3dmix_rot(cfg, grid, t, Hz, z_r, t_nnew, dt, cfg.tnu4,
                       biharmonic=True, pden=pden)
