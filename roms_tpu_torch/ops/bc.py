"""Lateral boundary conditions and halo filling.

Counterpart of ``roms_tpu/ops/bc.py`` for one device: the periodic, closed
and gradient kinds, and the clamped rho-point ring from a `clamp` dict.
The open-boundary kinds leave their sides to ``ops/obc.py``, which the
caller runs after these.

Index map (ops/stencil.py): padded array index a = roms_index + H - 1.
Boundary rho ring: west a=H-1, east a=H+Lm; u-wall west a=H, east a=H+Lm;
south a=H-1 / v-wall a=H, north a=H+Mm.  Writes are functional (each
returns a new tensor), so a caller's tensor is never changed.

Blocked runs (parallel/smap.py): under a ParCtx every op works on one
block of a decomposed domain, with its own halo ring.  fill_halo then
exchanges the halos with the neighbouring blocks (parallel/halo.py, the
mp_exchange analog), and a boundary write that names its `side` lands
only on the block that owns that physical edge (the reference's
DOMAIN(ng)%Western_Edge(tile) tests).  Without a ParCtx nothing changes.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Optional

import torch

from ..config import (Config, BC_CLOSED, BC_GRADIENT,
                      BC_CLAMPED, BC_RADIATION, BC_CHAPMAN_EXPLICIT,
                      BC_CHAPMAN_IMPLICIT, BC_FLATHER, LBC)

_ADVANCED = {BC_RADIATION, BC_CHAPMAN_EXPLICIT, BC_CHAPMAN_IMPLICIT,
             BC_FLATHER, BC_CLAMPED}
_SIDES = ("west", "south", "east", "north")


def has_advanced(lbc: LBC) -> bool:
    """True when any side uses an open BC that needs the previous time
    level or external data (``roms_tpu/ops/obc.py``)."""
    return any(getattr(lbc, s) in _ADVANCED for s in _SIDES)


# ---------------------------------------------------------------------------
# Parallel context (roms_tpu/ops/bc.py:36-58): the block a thread steps
# ---------------------------------------------------------------------------
@dataclass
class ParCtx:
    """Which physical edges the current block owns, and the exchange
    (parallel/halo.py InProcess or Distributed) that refreshes its halos
    and sums over all blocks."""
    west: bool
    east: bool
    south: bool
    north: bool
    exchange: object = None


_TLS = threading.local()


def push_ctx(ctx: ParCtx):
    _TLS.ctx = ctx


def pop_ctx():
    _TLS.ctx = None


def current_ctx() -> Optional[ParCtx]:
    return getattr(_TLS, "ctx", None)


def _skips(side) -> bool:
    """True when a write to `side` is another block's (under a ParCtx,
    a block that does not own that physical edge leaves it alone)."""
    ctx = current_ctx()
    return ctx is not None and side is not None and not getattr(ctx, side)


# ---------------------------------------------------------------------------
# Halo filling (the single-device analog of mp_exchange / exchange_2d)
# ---------------------------------------------------------------------------
def fill_halo(cfg: Config, f):
    """Fill the halo ring: periodic wrap (period Lm/Mm) in periodic
    directions, edge replication in closed directions; E-W first, then
    N-S, so the corners follow the reference.  Works on any [..., j, i].
    Under a ParCtx the block's halos come from its neighbours instead
    (_fill_halo_blocked)."""
    ctx = current_ctx()
    if ctx is not None:
        return _fill_halo_blocked(cfg, f, ctx)
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


def _fill_halo_blocked(cfg: Config, f, ctx: ParCtx):
    """The blocked halo refresh (roms_tpu/ops/bc.py:147-186): the xi
    exchange, then the eta exchange, which carries the corners the first
    one filled (mp_exchange.F's two-phase order).  On a closed axis the
    boundary rho ring of an edge block lies inside the exchanged strip and
    holds real data, so it is kept from before the exchange and the outer
    halo replicates it, as the one-block fill does."""
    from ..parallel import halo
    H = cfg.halo
    ny, nx = f.shape[-2], f.shape[-1]
    if not cfg.ew_periodic:
        wring = f[..., :, H - 1:H]
        ering = f[..., :, nx - H:nx - H + 1]
    f = halo.exchange_axis(f, ctx.exchange, H, axis=-1)
    if not cfg.ew_periodic:
        if ctx.west:
            f[..., :, :H] = wring
        if ctx.east:
            f[..., :, nx - H:] = ering
    if not cfg.ns_periodic:
        sring = f[..., H - 1:H, :]
        nring = f[..., ny - H:ny - H + 1, :]
    f = halo.exchange_axis(f, ctx.exchange, H, axis=-2)
    if not cfg.ns_periodic:
        if ctx.south:
            f[..., :H, :] = sring
        if ctx.north:
            f[..., ny - H:, :] = nring
    return f


def fill_halo_multi(cfg: Config, *fields):
    """One halo refresh for several same-shaped fields (the reference
    packs up to 4 fields in an mp_exchange message,
    mp_exchange.F:290-293): stacked, exchanged once, unstacked."""
    if len(fields) == 1:
        return (fill_halo(cfg, fields[0]),)
    stacked = fill_halo(cfg, torch.stack(fields, dim=0))
    return tuple(stacked[i] for i in range(len(fields)))


# ---------------------------------------------------------------------------
# Column/row writes (functional: copy, then write).  `side` names the
# physical edge a write belongs to; under a ParCtx the blocks that do not
# own it skip the write.
# ---------------------------------------------------------------------------
def set_col(f, a_dst, values, side=None):
    if _skips(side):
        return f
    out = f.clone()
    out[..., :, a_dst] = values
    return out


def set_row(f, a_dst, values, side=None):
    if _skips(side):
        return f
    out = f.clone()
    out[..., a_dst, :] = values
    return out


def add_col(f, a_dst, delta, side=None):
    if _skips(side):
        return f
    out = f.clone()
    out[..., :, a_dst] += delta
    return out


def add_row(f, a_dst, delta, side=None):
    if _skips(side):
        return f
    out = f.clone()
    out[..., a_dst, :] += delta
    return out


def apply_bc_rho(cfg: Config, lbc: LBC, f, mask=None, clamp=None,
                 fill: bool = True):
    """BCs for a rho-point field (zetabc.F closed == zero gradient onto
    the boundary ring; clamped sides take clamp[side] when a dict `clamp`
    is given), then mask, then halo fill unless fill=False."""
    H = cfg.halo
    L, M = cfg.Lm, cfg.Mm
    grad = (BC_CLOSED, BC_GRADIENT)
    if not cfg.ew_periodic:
        if lbc.west in grad:
            f = set_col(f, H - 1, f[..., :, H], "west")
        elif lbc.west == BC_CLAMPED and clamp is not None:
            f = set_col(f, H - 1, clamp["west"], "west")
        if lbc.east in grad:
            f = set_col(f, H + L, f[..., :, H + L - 1], "east")
        elif lbc.east == BC_CLAMPED and clamp is not None:
            f = set_col(f, H + L, clamp["east"], "east")
    if not cfg.ns_periodic:
        if lbc.south in grad:
            f = set_row(f, H - 1, f[..., H, :], "south")
        elif lbc.south == BC_CLAMPED and clamp is not None:
            f = set_row(f, H - 1, clamp["south"], "south")
        if lbc.north in grad:
            f = set_row(f, H + M, f[..., H + M - 1, :], "north")
        elif lbc.north == BC_CLAMPED and clamp is not None:
            f = set_row(f, H + M, clamp["north"], "north")
    if mask is not None:
        f = f * mask
    return fill_halo(cfg, f) if fill else f


def apply_bc_u(cfg: Config, lbc: LBC, f, gamma2: float = 1.0, mask=None,
               fill: bool = True):
    """BCs for a u-point field (u2dbc_im.F): west/east normal (closed ->
    u=0 on the wall face), south/north tangential (closed -> gamma2 slip).
    The write order decides the corners and follows the reference."""
    H = cfg.halo
    L, M = cfg.Lm, cfg.Mm
    if not cfg.ew_periodic:
        if lbc.west == BC_CLOSED:
            f = set_col(f, H, 0.0, "west")
        elif lbc.west == BC_GRADIENT:
            f = set_col(f, H, f[..., :, H + 1], "west")
        # pin the u ghost column west of the boundary face (it has no
        # reference counterpart and is the source column of the fill)
        f = set_col(f, H - 1, f[..., :, H], "west")
        if lbc.east == BC_CLOSED:
            f = set_col(f, H + L, 0.0, "east")
        elif lbc.east == BC_GRADIENT:
            f = set_col(f, H + L, f[..., :, H + L - 1], "east")
    if not cfg.ns_periodic:
        if lbc.south == BC_CLOSED:
            f = set_row(f, H - 1, gamma2 * f[..., H, :], "south")
        elif lbc.south == BC_GRADIENT:
            f = set_row(f, H - 1, f[..., H, :], "south")
        if lbc.north == BC_CLOSED:
            f = set_row(f, H + M, gamma2 * f[..., H + M - 1, :], "north")
        elif lbc.north == BC_GRADIENT:
            f = set_row(f, H + M, f[..., H + M - 1, :], "north")
    if mask is not None:
        f = f * mask
    return fill_halo(cfg, f) if fill else f


def apply_bc_v(cfg: Config, lbc: LBC, f, gamma2: float = 1.0, mask=None,
               fill: bool = True):
    """BCs for a v-point field (v2dbc_im.F): south/north normal, west/east
    tangential."""
    H = cfg.halo
    L, M = cfg.Lm, cfg.Mm
    if not cfg.ns_periodic:
        if lbc.south == BC_CLOSED:
            f = set_row(f, H, 0.0, "south")
        elif lbc.south == BC_GRADIENT:
            f = set_row(f, H, f[..., H + 1, :], "south")
        # pin the v ghost row south of the boundary face (see apply_bc_u)
        f = set_row(f, H - 1, f[..., H, :], "south")
        if lbc.north == BC_CLOSED:
            f = set_row(f, H + M, 0.0, "north")
        elif lbc.north == BC_GRADIENT:
            f = set_row(f, H + M, f[..., H + M - 1, :], "north")
    if not cfg.ew_periodic:
        if lbc.west == BC_CLOSED:
            f = set_col(f, H - 1, gamma2 * f[..., :, H], "west")
        elif lbc.west == BC_GRADIENT:
            f = set_col(f, H - 1, f[..., :, H], "west")
        if lbc.east == BC_CLOSED:
            f = set_col(f, H + L, gamma2 * f[..., :, H + L - 1], "east")
        elif lbc.east == BC_GRADIENT:
            f = set_col(f, H + L, f[..., :, H + L - 1], "east")
    if mask is not None:
        f = f * mask
    return fill_halo(cfg, f) if fill else f


# ---------------------------------------------------------------------------
# Edge corrections for wide stencils (one-sided extrapolation at
# non-periodic edges, e.g. step2d_LF_AM3.h "grad(Istr,j)=grad(Istr+1,j)")
# ---------------------------------------------------------------------------
def extrap_west(cfg: Config, g, a: int):
    """g[:, a] = g[:, a+1] at a non-periodic western edge."""
    if cfg.ew_periodic:
        return g
    return set_col(g, a, g[..., :, a + 1], "west")


def extrap_east(cfg: Config, g, a: int):
    if cfg.ew_periodic:
        return g
    return set_col(g, a, g[..., :, a - 1], "east")


def extrap_south(cfg: Config, g, a: int):
    if cfg.ns_periodic:
        return g
    return set_row(g, a, g[..., a + 1, :], "south")


def extrap_north(cfg: Config, g, a: int):
    if cfg.ns_periodic:
        return g
    return set_row(g, a, g[..., a - 1, :], "north")
