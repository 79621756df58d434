"""Blocked domain decomposition with explicit halo exchange (counterpart of
``roms_tpu/parallel/smap.py``; the reference's MPI tiling, NtileI x
NtileJ tiles with mp_exchange halo swaps).

The global domain is split into blocks that carry their own `halo`-wide
ghost ring; the physics runs verbatim on each block (ops/* under a
bc.ParCtx), every halo refresh is an exchange with the neighbouring blocks
(parallel/halo.py), boundary writes land on the blocks that own the
physical edge, and obc_volcons sums its face integrals over all blocks.
Every kernel gate is off under a ParCtx, so a blocked step runs the plain
path.

A layout is an (eta_blocks, xi_blocks) pair, or a ``Layout`` with the
exchange attached (``halo.InProcess`` by default, ``halo.Distributed``
for a block a rank).  Interiors that do not divide evenly are split as
the reference's tile bounds split them: the first blocks of a row or
column one point wider.  A blocked tree is a dict {(row, column): tree
of that block}; leaves whose trailing dims are the padded horizontal
extents are split, all others (scalars, vertical tables, weights) shared.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Callable, Optional

import torch

from ..config import Config
from ..ops import bc
from . import halo


@dataclass
class Layout:
    """Blocks along eta and xi, and the exchange between them."""
    eta: int
    xi: int
    exchange: object = None

    def __post_init__(self):
        if self.exchange is None:
            self.exchange = halo.InProcess(self.eta, self.xi)
        if tuple(self.exchange.shape) != (self.eta, self.xi):
            raise ValueError(f"exchange of shape {self.exchange.shape} for "
                             f"a {self.eta}x{self.xi} layout")


def as_layout(layout) -> Layout:
    return layout if isinstance(layout, Layout) else Layout(*layout)


def supported(cfg: Config) -> bool:
    """Configurations the blocked path computes exactly: all of them that
    roms_tpu's smap takes (open boundaries through the edge-gated ring
    writes, wetting-drying, volume conservation through the all-block sum,
    `bry` built from the grid argument)."""
    return True


def _splits(n: int, parts: int):
    """Offsets and sizes of `parts` blocks of an `n`-point interior, the
    first n % parts one point wider."""
    if parts < 1 or parts > n:
        raise ValueError(f"{n} points in {parts} blocks")
    sizes = [n // parts + (1 if k < n % parts else 0) for k in range(parts)]
    offs = [sum(sizes[:k]) for k in range(parts)]
    return offs, sizes


def bounds(cfg: Config, layout, pos):
    """(eta offset, Mm, xi offset, Lm) of block `pos`'s interior in the
    global interior."""
    lay = as_layout(layout)
    joffs, jsz = _splits(cfg.Mm, lay.eta)
    ioffs, isz = _splits(cfg.Lm, lay.xi)
    r, c = pos
    return joffs[r], jsz[r], ioffs[c], isz[c]


def local_config(cfg: Config, layout, pos=(0, 0)) -> Config:
    _, m, _, l = bounds(cfg, layout, pos)
    return cfg.replace(Lm=l, Mm=m)


def _is_field(cfg: Config, a) -> bool:
    return (isinstance(a, torch.Tensor) and a.ndim >= 2 and
            a.shape[-1] == cfg.nx_tot and a.shape[-2] == cfg.ny_tot)


def _map(tree, fn):
    """fn over the tensor leaves of a dataclass (State, Grid) or dict."""
    if isinstance(tree, dict):
        return {k: fn(v) for k, v in tree.items()}
    if dataclasses.is_dataclass(tree):
        return dataclasses.replace(tree, **{
            f.name: fn(getattr(tree, f.name))
            for f in dataclasses.fields(tree)})
    return fn(tree)


def block(cfg: Config, layout, tree) -> dict:
    """Global padded tree -> {pos: block tree} of the blocks this process
    steps (all of them in process).  Each block is a copy of the slice of
    the global padded array covering its interior and its halo ring, so
    blocks start out bitwise equal to the global values."""
    lay = as_layout(layout)
    H = cfg.halo
    out = {}
    for pos in lay.exchange.blocks():
        j0, m, i0, l = bounds(cfg, lay, pos)

        def blk(a, j0=j0, m=m, i0=i0, l=l):
            if not _is_field(cfg, a):
                return a
            return a[..., j0:j0 + m + 2 * H, i0:i0 + l + 2 * H].clone()
        out[pos] = _map(tree, blk)
    return out


def unblock(cfg: Config, layout, blocks: dict):
    """{pos: block tree} of every block -> global padded tree.  Interiors
    are stitched, the physical boundary rings come from the edge blocks'
    halos and the outer halo is rebuilt with the global fill."""
    lay = as_layout(layout)
    H = cfg.halo
    first = blocks[(0, 0)]
    cfg00 = local_config(cfg, lay, (0, 0))

    def unblk(get):
        a00 = get(first)
        if not _is_field(cfg00, a00):
            return a00
        rows = []
        for r in range(lay.eta):
            cols = []
            for c in range(lay.xi):
                _, m, _, l = bounds(cfg, lay, (r, c))
                j0 = H - 1 if r == 0 else H
                j1 = H + m + 1 if r == lay.eta - 1 else H + m
                i0 = H - 1 if c == 0 else H
                i1 = H + l + 1 if c == lay.xi - 1 else H + l
                cols.append(get(blocks[(r, c)])[..., j0:j1, i0:i1])
            rows.append(torch.cat(cols, dim=-1))
        core = torch.cat(rows, dim=-2)        # rings + interior
        pad = torch.nn.functional.pad(core, (H - 1, H - 1, H - 1, H - 1))
        return bc.fill_halo(cfg, pad)

    if isinstance(first, dict):
        return {k: unblk(lambda b, k=k: b[k]) for k in first}
    if dataclasses.is_dataclass(first):
        return dataclasses.replace(first, **{
            f.name: unblk(lambda b, n=f.name: getattr(b, n))
            for f in dataclasses.fields(first)})
    return unblk(lambda b: b)


def make_ctx(layout, pos) -> bc.ParCtx:
    """Edge ownership from the block's position (the reference's
    DOMAIN(ng)%Western_Edge(tile) tests)."""
    lay = as_layout(layout)
    r, c = pos
    return bc.ParCtx(west=c == 0, east=c == lay.xi - 1, south=r == 0,
                     north=r == lay.eta - 1, exchange=lay.exchange)


def run_blocked(layout, fn, blocks: dict) -> dict:
    """{pos: fn(pos, blocks[pos])} for the blocks this process steps, each
    under its ParCtx (a thread a block in process)."""
    lay = as_layout(layout)

    def local(pos, b):
        bc.push_ctx(make_ctx(lay, pos))
        try:
            return fn(pos, b)
        finally:
            bc.pop_ctx()
    return lay.exchange.map(local, blocks)


def make_smap_stepper(cfg: Config, grid, layout,
                      forcing_fn: Optional[Callable] = None,
                      nsub: int = 1):
    """A stepper over blocked states: {pos: state} -> {pos: state}, `nsub`
    slow steps a call.  Use block() / unblock() at the boundaries (I/O,
    initialisation).

    forcing_fn is called with the block's config and grid, so boundary
    data built from the grid argument comes out block-sized and lands on
    the right rows and columns (the mp_exchange2d_bry analog); the ring
    writes are edge-gated, so blocks off the edge ignore them.
    File-driven `bry` lines must be blocked by the caller."""
    from .. import stepping
    lay = as_layout(layout)
    grids = block(cfg, lay, grid)
    cfgs = {pos: local_config(cfg, lay, pos) for pos in grids}

    def local(pos, s):
        for _ in range(nsub):
            s = stepping.step(cfgs[pos], grids[pos], s, forcing_fn)
        return s

    return lambda blocks: run_blocked(lay, local, blocks)
