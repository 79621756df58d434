"""Lateral boundary conditions and halo filling.

Counterpart of ``roms_tpu/ops/bc.py`` for one device: the periodic, closed
and gradient kinds.  Open-boundary kinds (radiation, Chapman, Flather,
clamped; ``roms_tpu/ops/obc.py``) raise NotImplementedError.

Index map (ops/stencil.py): padded array index a = roms_index + H - 1.
Boundary rho ring: west a=H-1, east a=H+Lm; u-wall west a=H, east a=H+Lm;
south a=H-1 / v-wall a=H, north a=H+Mm.  Writes are functional (each
returns a new tensor), so a caller's tensor is never changed.
"""

from __future__ import annotations

import torch

from ..config import (Config, BC_PERIODIC, BC_CLOSED, BC_GRADIENT,
                      BC_CLAMPED, BC_RADIATION, BC_CHAPMAN_EXPLICIT,
                      BC_CHAPMAN_IMPLICIT, BC_FLATHER, LBC)

_ADVANCED = {BC_RADIATION, BC_CHAPMAN_EXPLICIT, BC_CHAPMAN_IMPLICIT,
             BC_FLATHER, BC_CLAMPED}
_SIMPLE = {BC_PERIODIC, BC_CLOSED, BC_GRADIENT}
_SIDES = ("west", "south", "east", "north")


def has_advanced(lbc: LBC) -> bool:
    """True when any side uses an open BC that needs the previous time
    level or external data (``roms_tpu/ops/obc.py``)."""
    return any(getattr(lbc, s) in _ADVANCED for s in _SIDES)


def _check_simple(cfg: Config, lbc: LBC):
    for side in _SIDES:
        periodic = cfg.ew_periodic if side in ("west", "east") \
            else cfg.ns_periodic
        kind = getattr(lbc, side)
        if not periodic and kind not in _SIMPLE:
            raise NotImplementedError(
                f"lateral BC {kind!r} on the {side} side (open boundaries, "
                "ops/obc.py, are not ported)")


# ---------------------------------------------------------------------------
# Halo filling (the single-device analog of mp_exchange / exchange_2d)
# ---------------------------------------------------------------------------
def fill_halo(cfg: Config, f):
    """Fill the halo ring: periodic wrap (period Lm/Mm) in periodic
    directions, edge replication in closed directions; E-W first, then
    N-S, so the corners follow the reference.  Works on any [..., j, i]."""
    H = cfg.halo
    L, M = cfg.Lm, cfg.Mm
    if cfg.ew_periodic:
        f = torch.cat(
            [f[..., L:L + H], f[..., H:H + L], f[..., H:H + H]], dim=-1)
    else:
        rep = f.shape[:-1] + (H - 1,)
        f = torch.cat([f[..., H - 1:H].expand(rep), f[..., H - 1:H + L + 1],
                       f[..., H + L:H + L + 1].expand(rep)], dim=-1)
    if cfg.ns_periodic:
        f = torch.cat(
            [f[..., M:M + H, :], f[..., H:H + M, :], f[..., H:H + H, :]],
            dim=-2)
    else:
        rep = f.shape[:-2] + (H - 1, f.shape[-1])
        f = torch.cat([f[..., H - 1:H, :].expand(rep),
                       f[..., H - 1:H + M + 1, :],
                       f[..., H + M:H + M + 1, :].expand(rep)], dim=-2)
    return f


# ---------------------------------------------------------------------------
# Column/row writes (functional: copy, then write)
# ---------------------------------------------------------------------------
def set_col(f, a_dst, values):
    out = f.clone()
    out[..., :, a_dst] = values
    return out


def set_row(f, a_dst, values):
    out = f.clone()
    out[..., a_dst, :] = values
    return out


def add_col(f, a_dst, delta):
    out = f.clone()
    out[..., :, a_dst] += delta
    return out


def add_row(f, a_dst, delta):
    out = f.clone()
    out[..., a_dst, :] += delta
    return out


def apply_bc_rho(cfg: Config, lbc: LBC, f, mask=None):
    """BCs for a rho-point field (zetabc.F closed == zero gradient onto
    the boundary ring), then mask, then halo fill."""
    _check_simple(cfg, lbc)
    H = cfg.halo
    L, M = cfg.Lm, cfg.Mm
    grad = (BC_CLOSED, BC_GRADIENT)
    if not cfg.ew_periodic:
        if lbc.west in grad:
            f = set_col(f, H - 1, f[..., :, H])
        if lbc.east in grad:
            f = set_col(f, H + L, f[..., :, H + L - 1])
    if not cfg.ns_periodic:
        if lbc.south in grad:
            f = set_row(f, H - 1, f[..., H, :])
        if lbc.north in grad:
            f = set_row(f, H + M, f[..., H + M - 1, :])
    if mask is not None:
        f = f * mask
    return fill_halo(cfg, f)


def apply_bc_u(cfg: Config, lbc: LBC, f, gamma2: float = 1.0, mask=None):
    """BCs for a u-point field (u2dbc_im.F): west/east normal (closed ->
    u=0 on the wall face), south/north tangential (closed -> gamma2 slip).
    The write order decides the corners and follows the reference."""
    _check_simple(cfg, lbc)
    H = cfg.halo
    L, M = cfg.Lm, cfg.Mm
    if not cfg.ew_periodic:
        if lbc.west == BC_CLOSED:
            f = set_col(f, H, 0.0)
        elif lbc.west == BC_GRADIENT:
            f = set_col(f, H, f[..., :, H + 1])
        # pin the u ghost column west of the boundary face (it has no
        # reference counterpart and is the source column of the fill)
        f = set_col(f, H - 1, f[..., :, H])
        if lbc.east == BC_CLOSED:
            f = set_col(f, H + L, 0.0)
        elif lbc.east == BC_GRADIENT:
            f = set_col(f, H + L, f[..., :, H + L - 1])
    if not cfg.ns_periodic:
        if lbc.south == BC_CLOSED:
            f = set_row(f, H - 1, gamma2 * f[..., H, :])
        elif lbc.south == BC_GRADIENT:
            f = set_row(f, H - 1, f[..., H, :])
        if lbc.north == BC_CLOSED:
            f = set_row(f, H + M, gamma2 * f[..., H + M - 1, :])
        elif lbc.north == BC_GRADIENT:
            f = set_row(f, H + M, f[..., H + M - 1, :])
    if mask is not None:
        f = f * mask
    return fill_halo(cfg, f)


def apply_bc_v(cfg: Config, lbc: LBC, f, gamma2: float = 1.0, mask=None):
    """BCs for a v-point field (v2dbc_im.F): south/north normal, west/east
    tangential."""
    _check_simple(cfg, lbc)
    H = cfg.halo
    L, M = cfg.Lm, cfg.Mm
    if not cfg.ns_periodic:
        if lbc.south == BC_CLOSED:
            f = set_row(f, H, 0.0)
        elif lbc.south == BC_GRADIENT:
            f = set_row(f, H, f[..., H + 1, :])
        # pin the v ghost row south of the boundary face (see apply_bc_u)
        f = set_row(f, H - 1, f[..., H, :])
        if lbc.north == BC_CLOSED:
            f = set_row(f, H + M, 0.0)
        elif lbc.north == BC_GRADIENT:
            f = set_row(f, H + M, f[..., H + M - 1, :])
    if not cfg.ew_periodic:
        if lbc.west == BC_CLOSED:
            f = set_col(f, H - 1, gamma2 * f[..., :, H])
        elif lbc.west == BC_GRADIENT:
            f = set_col(f, H - 1, f[..., :, H])
        if lbc.east == BC_CLOSED:
            f = set_col(f, H + L, gamma2 * f[..., :, H + L - 1])
        elif lbc.east == BC_GRADIENT:
            f = set_col(f, H + L, f[..., :, H + L - 1])
    if mask is not None:
        f = f * mask
    return fill_halo(cfg, f)


# ---------------------------------------------------------------------------
# Edge corrections for wide stencils (one-sided extrapolation at
# non-periodic edges, e.g. step2d_LF_AM3.h "grad(Istr,j)=grad(Istr+1,j)")
# ---------------------------------------------------------------------------
def extrap_west(cfg: Config, g, a: int):
    """g[:, a] = g[:, a+1] at a non-periodic western edge."""
    if cfg.ew_periodic:
        return g
    return set_col(g, a, g[..., :, a + 1])


def extrap_east(cfg: Config, g, a: int):
    if cfg.ew_periodic:
        return g
    return set_col(g, a, g[..., :, a - 1])


def extrap_south(cfg: Config, g, a: int):
    if cfg.ns_periodic:
        return g
    return set_row(g, a, g[..., a + 1, :])


def extrap_north(cfg: Config, g, a: int):
    if cfg.ns_periodic:
        return g
    return set_row(g, a, g[..., a - 1, :])
