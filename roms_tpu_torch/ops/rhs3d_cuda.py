"""The slow momentum right-hand side: its CUDA kernel, its plain version, and
the momentum phase of the step that chains it.

rhs3d        - Coriolis, curvilinear terms and U3/C4 advection added to the
               pressure gradient ru/rv, and the barotropic forcing
               rufrc/rvfrc; with ``start``, also pre_step3d's momentum start
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
back.  ``rhs3d.launches`` counts kernel launches.  ``use_kernels`` decides,
as the JAX step's ``rhs3d_pallas.use_pallas`` does, whether the step takes
``momentum_rhs`` at all.
"""

from __future__ import annotations

import torch

from ..config import Config
from ..grid import Grid
from . import mix3d_cuda, prsgrd_cuda
from ._kernels import check_tensors, column_ints, launch, on_card
from .pre_step3d import ab3_start_coefs, momentum_init
from .rhs3d import rhs3d_momentum


def supported(cfg: Config) -> bool:
    """The configurations whose momentum phase the kernels compute
    (rhs3d_pallas.supported)."""
    return (cfg.prsgrd_scheme == "djs"
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
    if cfg.bodyforce:
        raise NotImplementedError("BODYFORCE stresses")
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
    f64 = check_tensors(ins, shapes, u.dtype, u.device)
    outs = [torch.empty_like(ru), torch.empty_like(rv),
            torch.empty_like(sustr), torch.empty_like(svstr)]
    if start is not None:
        outs += [torch.empty_like(u), torch.empty_like(v)]
    get = ins.get
    launch("roms_rhs3d", f64,
           [u, v, Huon, Hvom, W, Hz, ru, rv, sustr, svstr, bustr, bvstr,
            grid.pm, grid.pn, grid.f, get("dndx"), get("dmde"),
            get("ru_prev"), get("rv_prev"), get("ru_prev2"),
            get("rv_prev2")] + outs + [None] * (6 - len(outs)),
           ints + [int(cfg.uv_cor), int(cfg.uv_adv), int(curv),
                   int(start is not None)],
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
