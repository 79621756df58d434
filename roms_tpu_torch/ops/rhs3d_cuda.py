"""The slow momentum right-hand side: its CUDA kernel, its plain version, and
the momentum phase of the step that chains it.

rhs3d        - Coriolis, curvilinear terms and U3/C4 advection added to the
               pressure gradient ru/rv (and the stresses as body forces
               under BODYFORCE), and the barotropic forcing rufrc/rvfrc;
               with ``start``, also pre_step3d's momentum start
               u_nnew/v_nnew.  Replaces the TPU kernel
               roms_tpu/ops/rhs3d_pallas.py::rhs3d_fused.
momentum_rhs - the momentum side of the rhs3d phase, as
               rhs3d_pallas.momentum_rhs_fused: momentum_init -> prsgrd32
               -> rhs3d -> uv3dmix2, which on the card is three launches
               (prsgrd_cuda.prsgrd32, rhs3d with the start folded in,
               mix3d_cuda.uv3dmix2).

``rhs3d`` and ``momentum_rhs`` take their plain versions (``*_plain``) for
CPU tensors only.  For CUDA tensors ``rhs3d`` launches the kernel of
csrc/rhs3d.cu, both directions in one launch, or raises; it never falls
back.  The kernel runs on 2-D tiles of padded points whose level planes a
block keeps in shared memory; ``rhs3d_plan`` sizes the tile and the block,
``rhs3d_layout`` reports the kernel's registers and stack frame on the
card.  ``rhs3d.launches`` counts kernel launches.  ``use_kernels`` decides,
as the JAX step's ``rhs3d_pallas.use_pallas`` does, whether the step takes
``momentum_rhs`` at all.
"""

from __future__ import annotations

import torch

from ..config import Config
from ..grid import Grid
from . import bc, mix3d_cuda, prsgrd_cuda
from ._kernels import SMEM_MAX, check_tensors, column_ints, kernel_layout, \
    launch, on_card, tile_plan
from .pre_step3d import ab3_start_coefs, momentum_init
from .rhs3d import rhs3d_momentum

THREADS = 256       # threads a block, at most (csrc/rhs3d.cu kMaxThreads)


def rhs3d_plan(dtype, N: int, ny: int, nx: int,
               bodyforce: bool = False) -> dict:
    """The kernel's launch on a padded ny x nx grid of N levels: {"tile":
    (points along xi, along eta), "levels": level slots, "blocks",
    "threads": a block, "smem_bytes": its dynamic shared memory}.  A block
    is `levels` slots of one thread a tile point, at most THREADS threads,
    each slot with two sets of planes over the tile's region and its face
    arrays (csrc/rhs3d.cuh RhsLayout), halved while they leave no room for
    three blocks an SM; _kernels.tile_plan picks the tile.  The shared
    memory does not depend on N; BODYFORCE adds four coefficients a tile
    point."""
    del N   # every slot walks its levels; nothing a block holds is per level
    word = 8 if dtype == torch.float64 else 4

    def smem(tx, ty, ks):
        ra, fa = (tx + 6) * (ty + 6), (tx + 1) * (ty + 1)
        words = ks * (12 * ra + 8 * fa) + 3 * fa + \
            (6 if bodyforce else 2) * tx * ty
        return words * word + 4 * (ra + fa)

    def make(tx, ty):
        ks = max(THREADS // (tx * ty), 1)
        while ks > 1 and smem(tx, ty, ks) > SMEM_MAX // 3:
            ks //= 2
        return dict(tile=(tx, ty), levels=ks,
                    blocks=-(-nx // tx) * -(-ny // ty),
                    threads=tx * ty * ks, smem_bytes=smem(tx, ty, ks))
    return tile_plan(make)


def rhs3d_layout(dtype, bodyforce: bool = False) -> dict:
    """The kernel (BODYFORCE's, a kernel of its own) on the current card:
    {"registers": a thread, "stack_bytes": its stack frame a thread}."""
    return kernel_layout("roms_rhs3d_layout", dtype, int(bodyforce))


def supported(cfg: Config) -> bool:
    """The configurations whose momentum phase the kernels compute
    (rhs3d_pallas.supported), never in a blocked run."""
    return (cfg.prsgrd_scheme == "djs" and bc.current_ctx() is None
            and not cfg.use_sponge and not cfg.uv_smagorinsky
            and not cfg.uv_mix_geo and not (cfg.uv_vis4 and cfg.visc4)
            and cfg.uv_cor and cfg.uv_adv)


def use_kernels(cfg: Config, clm=None, want_diags: bool = False) -> bool:
    """The gate of the momentum phase (rhs3d_pallas.use_pallas without its
    environment switches)."""
    return cfg.pallas2d and supported(cfg) and clm is None \
        and not want_diags


def rhs3d_plain(cfg: Config, grid: Grid, u, v, Huon, Hvom, W, Hz, ru, rv,
                sustr, svstr, bustr, bvstr, start=None):
    """momentum_init (with ``start``) followed by rhs3d_momentum; returns
    (ru, rv, rufrc, rvfrc), then (u_nnew, v_nnew) with ``start``."""
    out = ()
    if start is not None:
        a1, a2, ru_prev, ru_prev2, rv_prev, rv_prev2 = start
        out = momentum_init(cfg, grid.pm, grid.pn, a1, a2, u, v, Hz,
                            ru_prev, ru_prev2, rv_prev, rv_prev2, sustr,
                            svstr, bustr, bvstr)
    return rhs3d_momentum(cfg, grid, u, v, Huon, Hvom, W, Hz, ru, rv, sustr,
                          svstr, bustr, bvstr) + tuple(out)


def rhs3d(cfg: Config, grid: Grid, u, v, Huon, Hvom, W, Hz, ru, rv, sustr,
          svstr, bustr, bvstr, start=None):
    """The contract of rhs3d_pallas.rhs3d_fused: returns (ru, rv, rufrc,
    rvfrc).  ``start`` = (a1, a2, ru_prev, ru_prev2, rv_prev, rv_prev2),
    the AB3 coefficients and history of momentum_init (which also reads
    u, v, Hz and the four stresses given here), makes the same launch
    return momentum_init's (u_nnew, v_nnew) after them."""
    if not on_card(u):
        return rhs3d_plain(cfg, grid, u, v, Huon, Hvom, W, Hz, ru, rv, sustr,
                           svstr, bustr, bvstr, start=start)
    ints = column_ints(cfg, "rhs3d")
    s2 = (cfg.ny_tot, cfg.nx_tot)
    s3, sw = (cfg.N,) + s2, (cfg.N + 1,) + s2
    curv = cfg.curvgrid and cfg.uv_adv
    ins = dict(u=u, v=v, Huon=Huon, Hvom=Hvom, W=W, Hz=Hz, ru=ru, rv=rv,
               sustr=sustr, svstr=svstr, bustr=bustr, bvstr=bvstr,
               pm=grid.pm, pn=grid.pn, f=grid.f)
    if curv:
        ins.update(dndx=grid.dndx, dmde=grid.dmde)
    a1 = a2 = 0.0
    if start is not None:
        a1, a2, *hist = start
        ins.update(zip(("ru_prev", "ru_prev2", "rv_prev", "rv_prev2"), hist))
    shapes = dict.fromkeys(ins, s2)
    shapes.update(dict.fromkeys(
        ("u", "v", "Huon", "Hvom", "Hz", "ru", "rv", "ru_prev", "ru_prev2",
         "rv_prev", "rv_prev2"), s3), W=sw)
    f64 = check_tensors("roms_rhs3d", ins, shapes, u.dtype, u.device)
    outs = [torch.empty_like(ru), torch.empty_like(rv),
            torch.empty_like(sustr), torch.empty_like(svstr)]
    if start is not None:
        outs += [torch.empty_like(u), torch.empty_like(v)]
    get = ins.get
    plan = rhs3d_plan(u.dtype, cfg.N, *s2, bodyforce=cfg.bodyforce)
    launch("roms_rhs3d", f64,
           [u, v, Huon, Hvom, W, Hz, ru, rv, sustr, svstr, bustr, bvstr,
            grid.pm, grid.pn, grid.f, get("dndx"), get("dmde"),
            get("ru_prev"), get("rv_prev"), get("ru_prev2"),
            get("rv_prev2")] + outs + [None] * (6 - len(outs)),
           ints + [int(cfg.uv_cor), int(cfg.uv_adv), int(curv),
                   int(start is not None), int(cfg.bodyforce),
                   cfg.levsfrc - 1, cfg.levbfrc, *plan["tile"],
                   plan["levels"], plan["threads"], plan["smem_bytes"]],
           [cfg.dt, a1, a2], torch.cuda.current_stream(u.device))
    rhs3d.launches += 1
    return tuple(outs)


def momentum_rhs_plain(cfg: Config, grid: Grid, iic: int, u, v, Hz, z_r,
                       z_w, rho, Huon, Hvom, W, ru_prev, ru_prev2, rv_prev,
                       rv_prev2, sustr, svstr, bustr, bvstr, eq_tide=None):
    """The chain of rhs3d_pallas.momentum_rhs_fused on the plain versions:
    momentum_init -> prsgrd32 -> rhs3d_momentum -> uv3dmix2."""
    a1, a2 = ab3_start_coefs(iic)
    u_nnew, v_nnew = momentum_init(cfg, grid.pm, grid.pn, a1, a2, u, v, Hz,
                                   ru_prev, ru_prev2, rv_prev, rv_prev2,
                                   sustr, svstr, bustr, bvstr)
    ru, rv = prsgrd_cuda.prsgrd32_plain(cfg, grid, rho, z_r, z_w, Hz,
                                        eq_tide=eq_tide)
    ru, rv, rufrc, rvfrc = rhs3d_momentum(cfg, grid, u, v, Huon, Hvom, W, Hz,
                                          ru, rv, sustr, svstr, bustr, bvstr)
    if cfg.uv_vis2 and cfg.visc2 != 0.0:
        u_nnew, v_nnew, rufrc, rvfrc = mix3d_cuda.uv3dmix2_plain(
            cfg, grid, u, v, Hz, u_nnew, v_nnew, rufrc, rvfrc, cfg.dt)
    return u_nnew, v_nnew, ru, rv, rufrc, rvfrc


def momentum_rhs(cfg: Config, grid: Grid, iic: int, u, v, Hz, z_r, z_w,
                 rho, Huon, Hvom, W, ru_prev, ru_prev2, rv_prev, rv_prev2,
                 sustr, svstr, bustr, bvstr, eq_tide=None):
    """The contract of rhs3d_pallas.momentum_rhs_fused: returns (u_nnew,
    v_nnew, ru, rv, rufrc, rvfrc)."""
    if not on_card(u):
        return momentum_rhs_plain(cfg, grid, iic, u, v, Hz, z_r, z_w, rho,
                                  Huon, Hvom, W, ru_prev, ru_prev2, rv_prev,
                                  rv_prev2, sustr, svstr, bustr, bvstr,
                                  eq_tide=eq_tide)
    if not supported(cfg):
        raise ValueError("momentum_rhs kernels: the configuration is outside "
                         "rhs3d_pallas.supported")
    ru, rv = prsgrd_cuda.prsgrd32(cfg, grid, rho, z_r, z_w, Hz,
                                  eq_tide=eq_tide)
    a1, a2 = ab3_start_coefs(iic)
    ru, rv, rufrc, rvfrc, u_nnew, v_nnew = rhs3d(
        cfg, grid, u, v, Huon, Hvom, W, Hz, ru, rv, sustr, svstr, bustr,
        bvstr, start=(a1, a2, ru_prev, ru_prev2, rv_prev, rv_prev2))
    if cfg.uv_vis2 and cfg.visc2 != 0.0:
        u_nnew, v_nnew, rufrc, rvfrc = mix3d_cuda.uv3dmix2(
            cfg, grid, u, v, Hz, u_nnew, v_nnew, rufrc, rvfrc, cfg.dt)
    return u_nnew, v_nnew, ru, rv, rufrc, rvfrc


rhs3d.launches = 0
