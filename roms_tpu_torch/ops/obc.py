"""Open (active) lateral boundary conditions (counterpart of
``roms_tpu/ops/obc.py``).

The reference's runtime-selectable open-boundary algorithms:
 * implicit upstream radiation with optional nudging (zetabc.F:108-238 and
   the matching u2dbc/v2dbc/u3dbc/v3dbc/t3dbc forms; the tangential phase
   speed Ce is zero, as in the reference without RADIATION_2D),
 * Chapman explicit/implicit for the free surface,
 * Flather, Shchepetkin and reduced physics for 2-D normal momentum,
 * clamped (external data).

External boundary data arrives as a dict ``bry`` with keys like
"zeta_west": tensors along the whole padded side ((ny_tot,) or (nx_tot,),
(N, side) for 3-D fields, (NT, N, side) stacked tracers under "t_<side>")
or host scalars (mod_boundary.F's BOUNDARY arrays).

Every routine takes the field at the previous time level (know) and the
updated field (kout) and returns a new kout with the boundary ring
replaced; the caller then refreshes the halo (bc.fill_halo).  Nothing is
written in place, so a caller's tensors are never changed.
"""

from __future__ import annotations

import torch

from .. import constants as C
from . import bc
from ..config import (Config, LBC, BC_RADIATION, BC_CHAPMAN_EXPLICIT,
                      BC_CHAPMAN_IMPLICIT, BC_FLATHER, BC_CLAMPED,
                      BC_SHCHEPETKIN, BC_REDUCED)

_EPS = 1.0e-20
_CO = 1.0 / (2.0 + 2.0 ** 0.5)      # Shchepetkin Co (mod_scalars.F:4175)

# side descriptors: (axis, is_low_end)
_SIDES = {"west": (-1, True), "east": (-1, False),
          "south": (-2, True), "north": (-2, False)}


def _ax(a, axis):
    """`a` with `axis` moved to the last position (a view)."""
    return a.transpose(-2, -1) if axis == -2 else a


def _col(a, i):
    return a[..., i]


def _set_ring(q, side, ab, qb):
    """A copy of q with the boundary ring ab of `side` set to qb; under a
    ParCtx only on the block that owns that side (roms_tpu/ops/obc.py:
    49-67)."""
    if bc._skips(side):
        return q
    out = q.clone()
    _ax(out, _SIDES[side][0])[..., ab] = qb
    return out


def radiation(cfg: Config, q_know, q_kout, side: str, ab: int,
              nudg_in: float = 0.0, nudg_out: float = 0.0,
              ext=None, dt: float = 0.0, mask=None):
    """Implicit upstream radiation at one boundary (zetabc.F:145-197 and
    twins).  ab: padded index of the boundary ring for this field kind."""
    axis, low = _SIDES[side]
    qn = _ax(q_know, axis)
    qo = _ax(q_kout, axis)
    step = 1 if low else -1
    ai = ab + step
    ai2 = ab + 2 * step

    dqdt = _col(qn, ai) - _col(qo, ai)
    dqdx = _col(qo, ai) - _col(qo, ai2)
    dqdt = torch.where(dqdt * dqdx < 0.0, 0.0, dqdt)
    # tangential gradient (upwinded) along the remaining axis
    gi = _col(qn, ai)
    grad = gi - torch.roll(gi, 1, -1)           # grad[j] = q[j]-q[j-1]
    gradp = torch.roll(grad, -1, -1)            # grad[j+1]
    dqde = torch.where(dqdt * (grad + gradp) > 0.0, grad, gradp)
    cff = torch.clamp(dqdx * dqdx + dqde * dqde, min=_EPS)
    Cx = dqdt * dqdx
    # Ce = 0 (reference default without RADIATION_2D)
    qb = (cff * _col(qn, ab) + Cx * _col(qo, ai)) / (cff + Cx)
    if ext is not None and (nudg_in != 0.0 or nudg_out != 0.0):
        tau = torch.where(dqdt * dqdx < 0.0, torch.full_like(qb, nudg_in),
                          torch.full_like(qb, nudg_out)) * dt
        qb = qb + tau * (ext - _col(qn, ab))
    if mask is not None:
        qb = qb * _col(_ax(mask, axis), ab)
    return _set_ring(q_kout, side, ab, qb)


def chapman(cfg: Config, grid, z_know, z_kout, side: str,
            implicit: bool, dt2d: float, mask=None):
    """Chapman free-surface BC (zetabc.F:200-233): the boundary ring
    follows the shallow-water gravity-wave phase speed."""
    axis, low = _SIDES[side]
    H = cfg.halo
    ab = H - 1 if low else H + (cfg.Lm if axis == -1 else cfg.Mm)
    ai = ab + (1 if low else -1)
    zn = _ax(z_know, axis)
    zo = _ax(z_kout, axis)
    pmn = grid.pm if axis == -1 else grid.pn
    pmn_i = _col(_ax(pmn, axis), ai)
    h_i = _col(_ax(grid.h, axis), ai)
    cffc = dt2d * pmn_i * torch.sqrt(C.g * (h_i + _col(zn, ai)))
    if implicit:
        zb = (_col(zn, ab) + cffc * _col(zo, ai)) / (1.0 + cffc)
    else:
        zb = (1.0 - cffc) * _col(zn, ab) + cffc * _col(zn, ai)
    if mask is not None:
        zb = zb * _col(_ax(mask, axis), ab)
    return _set_ring(z_kout, side, ab, zb)


def flather(cfg: Config, grid, ub_kout, z_know, side: str,
            ext_ubar, ext_zeta=None, mask=None):
    """Flather 2-D normal-momentum BC (u2dbc_im.F Flather):
    ubar_b = ubar_ext - sqrt(g/D)*(0.5*(zeta_b+zeta_i) - zeta_ext)."""
    axis, low = _SIDES[side]
    H = cfg.halo
    ab = H if low else H + (cfg.Lm if axis == -1 else cfg.Mm)
    zn = _ax(z_know, axis)
    hh = _ax(grid.h, axis)
    # u(ab) sits between rho(ab-1) and rho(ab)
    D = 0.5 * (_col(hh, ab - 1) + _col(zn, ab - 1) +
               _col(hh, ab) + _col(zn, ab))
    Cx = torch.sqrt(C.g / torch.clamp(D, min=_EPS))
    zavg = 0.5 * (_col(zn, ab - 1) + _col(zn, ab))
    zext = 0.0 if ext_zeta is None else ext_zeta
    sign = 1.0 if low else -1.0
    ub = ext_ubar - sign * Cx * (zavg - zext)
    if mask is not None:
        ub = ub * _col(_ax(mask, axis), ab)
    return _set_ring(ub_kout, side, ab, ub)


def shchepetkin(cfg: Config, grid, ub_know, ub_kout, z_know, z_kout,
                side: str, dt2d, ext_ubar=0.0, ext_zeta=0.0, mask=None):
    """Shchepetkin 2-D normal-momentum BC (u2dbc_im.F:286-360 / v2dbc_im.F
    twins): free-surface-consistent outgoing characteristic with a
    supercritical-Courant correction."""
    axis, low = _SIDES[side]
    H = cfg.halo
    ab = H if low else H + (cfg.Lm if axis == -1 else cfg.Mm)
    un = _ax(ub_know, axis)
    zn = _ax(z_know, axis)
    zo = _ax(z_kout, axis)
    hh = _ax(grid.h, axis)
    pmn = _ax(grid.pm if axis == -1 else grid.pn, axis)
    g = C.g
    # "in" = interior rho column, "out" = exterior; the boundary u/v
    # point ab sits between rho columns ab-1 and ab
    i_in = ab if low else ab - 1
    i_out = ab - 1 if low else ab
    u_inner = ab + 1 if low else ab - 1

    if cfg.wetdry:
        D = 0.5 * (_col(hh, i_out) + _col(zn, i_out) +
                   _col(hh, i_in) + _col(zn, i_in))
    else:
        D = 0.5 * (_col(hh, i_out) + _col(hh, i_in))
    cff1 = torch.sqrt(g / torch.clamp(D, min=_EPS))
    Cx = dt2d * cff1 * D * 0.5 * (_col(pmn, i_out) + _col(pmn, i_in))
    Zx = (0.5 + Cx) * _col(zn, i_in) + (0.5 - Cx) * _col(zn, i_out)
    # supercritical correction (u2dbc_im.F:345-350)
    cff2 = (1.0 - _CO / torch.clamp(Cx, min=_EPS)) ** 2
    cff3 = _col(zo, i_in) + Cx * _col(zn, i_out) - \
        (1.0 + Cx) * _col(zn, i_in)
    Zx = torch.where(Cx > _CO, Zx + cff2 * cff3, Zx)
    sign = 1.0 if low else -1.0
    ub = 0.5 * ((1.0 - Cx) * _col(un, ab) + Cx * _col(un, u_inner) +
                ext_ubar - sign * cff1 * (Zx - ext_zeta))
    if mask is not None:
        ub = ub * _col(_ax(mask, axis), ab)
    return _set_ring(ub_kout, side, ab, ub)


def reduced(cfg: Config, grid, ub_know, ub_kout, z_know, vt_know,
            side: str, dt2d, sstr=None, bstr=None, ext_zeta=None,
            mask=None):
    """Reduced-physics 2-D normal-momentum BC (u2dbc_im.F:390-430 /
    v2dbc_im.F:392-433): the boundary point integrates only the surface
    pressure gradient, Coriolis and the surface/bottom stress.

    vt_know: tangential depth-averaged velocity at know (vbar for the u
    boundary, ubar for the v boundary); sstr/bstr: kinematic surface and
    bottom stress components normal to the boundary."""
    axis, low = _SIDES[side]
    H = cfg.halo
    ab = H if low else H + (cfg.Lm if axis == -1 else cfg.Mm)
    un = _ax(ub_know, axis)
    zn = _ax(z_know, axis)
    vt = _ax(vt_know, axis)
    hh = _ax(grid.h, axis)
    ff = _ax(grid.f, axis)
    pmn = _ax(grid.pm if axis == -1 else grid.pn, axis)
    g = C.g
    i_in = ab if low else ab - 1
    i_out = ab - 1 if low else ab

    if ext_zeta is not None:
        # gradient against the external value
        sign = 1.0 if low else -1.0
        bry_pgr = -g * sign * (_col(zn, i_in) - ext_zeta) * \
            0.5 * _col(pmn, i_in)
    else:
        # one-sided interior gradient, oriented along the axis
        z_lo, z_hi = (_col(zn, i_out), _col(zn, i_in)) if low else \
            (_col(zn, i_in), _col(zn, i_out))
        bry_pgr = -g * (z_hi - z_lo) * \
            0.5 * (_col(pmn, i_out) + _col(pmn, i_in))
    if cfg.uv_cor:
        # tangential velocity averaged to the boundary point
        v4 = (_col(vt, i_out) + torch.roll(_col(vt, i_out), -1, -1) +
              _col(vt, i_in) + torch.roll(_col(vt, i_in), -1, -1))
        cor_sign = 1.0 if axis == -1 else -1.0
        bry_cor = cor_sign * 0.125 * v4 * (_col(ff, i_out) +
                                           _col(ff, i_in))
    else:
        bry_cor = 0.0
    D = 0.5 * (_col(hh, i_out) + _col(zn, i_out) +
               _col(hh, i_in) + _col(zn, i_in))
    bry_str = 0.0
    if sstr is not None:
        bry_str = bry_str + _col(_ax(sstr, axis), ab) / D
    if bstr is not None:
        bry_str = bry_str - _col(_ax(bstr, axis), ab) / D
    ub = _col(un, ab) + dt2d * (bry_pgr + bry_cor + bry_str)
    if mask is not None:
        ub = ub * _col(_ax(mask, axis), ab)
    return _set_ring(ub_kout, side, ab, ub)


def clamped(cfg: Config, q_kout, side: str, ab: int, ext, mask=None):
    """The boundary ring set to the external value `ext`."""
    axis, _ = _SIDES[side]
    qb = ext + 0.0 * _col(_ax(q_kout, axis), ab)
    if mask is not None:
        qb = qb * _col(_ax(mask, axis), ab)
    return _set_ring(q_kout, side, ab, qb)


# ---------------------------------------------------------------------------
# field-level dispatchers
# ---------------------------------------------------------------------------
def _ring_rho(cfg: Config, side: str) -> int:
    H = cfg.halo
    return {"west": H - 1, "east": H + cfg.Lm,
            "south": H - 1, "north": H + cfg.Mm}[side]


def _ring_normal_u(cfg: Config, side: str) -> int:
    H = cfg.halo
    return {"west": H, "east": H + cfg.Lm,
            "south": H, "north": H + cfg.Mm}[side]


def _periodic(cfg: Config, side: str) -> bool:
    return cfg.ew_periodic if side in ("west", "east") else cfg.ns_periodic


def zetabc(cfg: Config, grid, lbc: LBC, z_know, z_kout, dt2d,
           bry=None, nudg=(0.0, 0.0)):
    """Open free-surface BCs per side; the simple kinds (periodic, closed,
    gradient) are bc.apply_bc_rho's and skipped here."""
    bry = bry or {}
    for side in ("west", "south", "east", "north"):
        if _periodic(cfg, side):
            continue
        kind = getattr(lbc, side)
        ab = _ring_rho(cfg, side)
        ext = bry.get(f"zeta_{side}")
        if kind == BC_RADIATION:
            z_kout = radiation(cfg, z_know, z_kout, side, ab,
                               nudg[0], nudg[1], ext, dt2d,
                               mask=grid.rmask)
        elif kind == BC_CHAPMAN_EXPLICIT:
            z_kout = chapman(cfg, grid, z_know, z_kout, side, False, dt2d,
                             mask=grid.rmask)
        elif kind == BC_CHAPMAN_IMPLICIT:
            z_kout = chapman(cfg, grid, z_know, z_kout, side, True, dt2d,
                             mask=grid.rmask)
        elif kind == BC_CLAMPED and ext is not None:
            z_kout = clamped(cfg, z_kout, side, ab, ext, mask=grid.rmask)
    return z_kout


def u2dbc(cfg: Config, grid, lbc: LBC, ub_know, ub_kout, z_know,
          dt2d, bry=None, z_kout=None, vb_know=None,
          sustr=None, bustr=None):
    """Open 2-D u-momentum BCs: Flather, Shchepetkin, reduced, radiation
    or clamped on the normal (west/east) sides; radiation or clamped on
    the tangential ones."""
    bry = bry or {}
    for side in ("west", "east"):
        if cfg.ew_periodic:
            continue
        kind = getattr(lbc, side)
        ab = _ring_normal_u(cfg, side)
        ext = bry.get(f"ubar_{side}", 0.0)
        if kind == BC_FLATHER:
            ub_kout = flather(cfg, grid, ub_kout, z_know, side, ext,
                              bry.get(f"zeta_{side}"), mask=grid.umask)
        elif kind == BC_SHCHEPETKIN:
            ub_kout = shchepetkin(
                cfg, grid, ub_know, ub_kout, z_know,
                z_kout if z_kout is not None else z_know, side, dt2d,
                ext, bry.get(f"zeta_{side}", 0.0), mask=grid.umask)
        elif kind == BC_REDUCED:
            ub_kout = reduced(
                cfg, grid, ub_know, ub_kout, z_know,
                vb_know if vb_know is not None
                else torch.zeros_like(ub_know), side, dt2d,
                sstr=sustr, bstr=bustr, ext_zeta=bry.get(f"zeta_{side}"),
                mask=grid.umask)
        elif kind == BC_RADIATION:
            ub_kout = radiation(cfg, ub_know, ub_kout, side, ab,
                                mask=grid.umask)
        elif kind == BC_CLAMPED:
            ub_kout = clamped(cfg, ub_kout, side, ab, ext, mask=grid.umask)
    for side in ("south", "north"):
        if cfg.ns_periodic:
            continue
        kind = getattr(lbc, side)
        ab = _ring_rho(cfg, side)
        if kind == BC_RADIATION:
            ub_kout = radiation(cfg, ub_know, ub_kout, side, ab,
                                mask=grid.umask)
        elif kind == BC_CLAMPED:
            ub_kout = clamped(cfg, ub_kout, side, ab,
                              bry.get(f"ubar_{side}", 0.0),
                              mask=grid.umask)
    return ub_kout


def v2dbc(cfg: Config, grid, lbc: LBC, vb_know, vb_kout, z_know,
          dt2d, bry=None, z_kout=None, ub_know=None,
          svstr=None, bvstr=None):
    """Open 2-D v-momentum BCs (u2dbc's twin: south/north normal)."""
    bry = bry or {}
    for side in ("south", "north"):
        if cfg.ns_periodic:
            continue
        kind = getattr(lbc, side)
        ab = _ring_normal_u(cfg, side)
        ext = bry.get(f"vbar_{side}", 0.0)
        if kind == BC_FLATHER:
            vb_kout = flather(cfg, grid, vb_kout, z_know, side, ext,
                              bry.get(f"zeta_{side}"), mask=grid.vmask)
        elif kind == BC_SHCHEPETKIN:
            vb_kout = shchepetkin(
                cfg, grid, vb_know, vb_kout, z_know,
                z_kout if z_kout is not None else z_know, side, dt2d,
                ext, bry.get(f"zeta_{side}", 0.0), mask=grid.vmask)
        elif kind == BC_REDUCED:
            vb_kout = reduced(
                cfg, grid, vb_know, vb_kout, z_know,
                ub_know if ub_know is not None
                else torch.zeros_like(vb_know), side, dt2d,
                sstr=svstr, bstr=bvstr, ext_zeta=bry.get(f"zeta_{side}"),
                mask=grid.vmask)
        elif kind == BC_RADIATION:
            vb_kout = radiation(cfg, vb_know, vb_kout, side, ab,
                                mask=grid.vmask)
        elif kind == BC_CLAMPED:
            vb_kout = clamped(cfg, vb_kout, side, ab, ext, mask=grid.vmask)
    for side in ("west", "east"):
        if cfg.ew_periodic:
            continue
        kind = getattr(lbc, side)
        ab = _ring_rho(cfg, side)
        if kind == BC_RADIATION:
            vb_kout = radiation(cfg, vb_know, vb_kout, side, ab,
                                mask=grid.vmask)
        elif kind == BC_CLAMPED:
            vb_kout = clamped(cfg, vb_kout, side, ab,
                              bry.get(f"vbar_{side}", 0.0),
                              mask=grid.vmask)
    return vb_kout


def t3dbc(cfg: Config, grid, lbc: LBC, t_know, t_kout, bry=None,
          name: str = "t"):
    """3-D tracer radiation/clamped BCs (t3dbc_im.F); broadcasts over the
    leading k."""
    bry = bry or {}
    for side in ("west", "south", "east", "north"):
        if _periodic(cfg, side):
            continue
        kind = getattr(lbc, side)
        ab = _ring_rho(cfg, side)
        ext = bry.get(f"{name}_{side}")
        if kind == BC_RADIATION:
            t_kout = radiation(cfg, t_know, t_kout, side, ab,
                               mask=grid.rmask)
        elif kind == BC_CLAMPED and ext is not None:
            t_kout = clamped(cfg, t_kout, side, ab, ext, mask=grid.rmask)
    return t_kout


def u3dbc(cfg: Config, grid, lbc: LBC, u_know, u_kout, bry=None):
    """3-D u-momentum radiation/clamped BCs (u3dbc_im.F)."""
    bry = bry or {}
    for sides, ring, periodic in ((("west", "east"), _ring_normal_u,
                                   cfg.ew_periodic),
                                  (("south", "north"), _ring_rho,
                                   cfg.ns_periodic)):
        if periodic:
            continue
        for side in sides:
            kind = getattr(lbc, side)
            ab = ring(cfg, side)
            if kind == BC_RADIATION:
                u_kout = radiation(cfg, u_know, u_kout, side, ab,
                                   mask=grid.umask)
            elif kind == BC_CLAMPED:
                u_kout = clamped(cfg, u_kout, side, ab,
                                 bry.get(f"u_{side}", 0.0), mask=grid.umask)
    return u_kout


def v3dbc(cfg: Config, grid, lbc: LBC, v_know, v_kout, bry=None):
    """3-D v-momentum radiation/clamped BCs (v3dbc_im.F)."""
    bry = bry or {}
    for sides, ring, periodic in ((("south", "north"), _ring_normal_u,
                                   cfg.ns_periodic),
                                  (("west", "east"), _ring_rho,
                                   cfg.ew_periodic)):
        if periodic:
            continue
        for side in sides:
            kind = getattr(lbc, side)
            ab = ring(cfg, side)
            if kind == BC_RADIATION:
                v_kout = radiation(cfg, v_know, v_kout, side, ab,
                                   mask=grid.vmask)
            elif kind == BC_CLAMPED:
                v_kout = clamped(cfg, v_kout, side, ab,
                                 bry.get(f"v_{side}", 0.0), mask=grid.vmask)
    return v_kout


def obc_volcons(cfg: Config, grid, ubar, vbar, zeta, volcons):
    """Integral volume conservation across open boundaries (obc_volcons.F
    obc_flux_tile): the net inflow over the sides in `volcons` (e.g.
    {"west", "east"}) removed by a uniform cross-section correction
    velocity at every participating open-boundary face.

    Under a ParCtx each block sums its own share of the faces it owns,
    and the shares are summed over all blocks (obc_volcons.F:487
    mp_reduce, roms_tpu/ops/obc.py:483-545); the face corrections land on
    the owning blocks only."""
    H = cfg.halo
    L, M = cfg.Lm, cfg.Mm
    ctx = bc.current_ctx()
    D = zeta + grid.h
    area = torch.zeros((), dtype=ubar.dtype, device=ubar.device)
    flux = torch.zeros_like(area)
    jj = slice(H, H + M)
    ii = slice(H, H + L)

    def owns(side):
        return ctx is None or getattr(ctx, side)

    if "west" in volcons and owns("west"):
        cff = 0.5 * (D[jj, H - 1] + D[jj, H])
        on_u_w = 2.0 / (grid.pn[jj, H - 1] + grid.pn[jj, H])
        cw = cff * on_u_w * grid.umask[jj, H]
        area = area + torch.sum(cw)
        flux = flux + torch.sum(cw * ubar[jj, H])
    if "east" in volcons and owns("east"):
        cff = 0.5 * (D[jj, H + L - 1] + D[jj, H + L])
        on_u_e = 2.0 / (grid.pn[jj, H + L - 1] + grid.pn[jj, H + L])
        ce = cff * on_u_e * grid.umask[jj, H + L]
        area = area + torch.sum(ce)
        flux = flux - torch.sum(ce * ubar[jj, H + L])
    if "south" in volcons and owns("south"):
        cff = 0.5 * (D[H - 1, ii] + D[H, ii])
        om_v_s = 2.0 / (grid.pm[H - 1, ii] + grid.pm[H, ii])
        cs = cff * om_v_s * grid.vmask[H, ii]
        area = area + torch.sum(cs)
        flux = flux + torch.sum(cs * vbar[H, ii])
    if "north" in volcons and owns("north"):
        cff = 0.5 * (D[H + M - 1, ii] + D[H + M, ii])
        om_v_n = 2.0 / (grid.pm[H + M - 1, ii] + grid.pm[H + M, ii])
        cn = cff * om_v_n * grid.vmask[H + M, ii]
        area = area + torch.sum(cn)
        flux = flux - torch.sum(cn * vbar[H + M, ii])
    if ctx is not None:
        area, flux = ctx.exchange.sum(torch.stack([area, flux]))
    ubar_xs = flux / torch.clamp(area, min=_EPS)

    ubar = ubar.clone()
    vbar = vbar.clone()
    if "west" in volcons and owns("west"):
        ubar[jj, H] -= ubar_xs
    if "east" in volcons and owns("east"):
        ubar[jj, H + L] += ubar_xs
    if "south" in volcons and owns("south"):
        vbar[H, ii] -= ubar_xs
    if "north" in volcons and owns("north"):
        vbar[H + M, ii] += ubar_xs
    return ubar, vbar
