"""The horizontal mixing kernels and their plain versions.

uv3dmix2    - harmonic viscosity along s-surfaces.  Replaces the TPU kernel
              roms_tpu/ops/mix3d_pallas.py::uv3dmix2_fused; its plain
              version is the port's ops/mix3d.py::uv3dmix2.
t3dmix2_geo - harmonic tracer diffusion rotated to geopotential surfaces.
              Replaces mix3d_pallas.t3dmix2_geo_fused; its plain version
              is ops/mix3d.py::t3dmix2_geo.

Each wrapper takes its plain version for CPU tensors only; for CUDA tensors
it launches its kernel of csrc/mix3d.cu, one launch for both directions or
for every tracer with tnu2 != 0, or raises.  Each kernel gives a block a
2-D tile of points whose level planes it stages in shared memory:
``uv3dmix2_plan`` sizes uv3dmix2's tile and block and ``uv3dmix2_layout``
reports its registers and stack frame on the card; ``geo_layout`` reports
t3dmix2_geo's tile and bytes.  On the card the kernels add
into their outputs in place and return them, as the Pallas kernels donate
them (u_nnew, v_nnew, rufrc, rvfrc; t_nnew): a caller does not read those
inputs again, and they must not alias each other or the other arguments.
``wrapper.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from ..config import Config
from ..grid import Grid
from ._kernels import MAX_TRACERS, SMEM_MAX, check_tensors, column_ints, \
    kernel_layout, launch, library, on_card, tile_plan
from .mix3d import t3dmix2_geo as t3dmix2_geo_plain
from .mix3d import uv3dmix2 as uv3dmix2_plain

THREADS = 256       # uv3dmix2: threads a block, at most (mix3d.cu kMaxThreads)


def uv3dmix2_plan(dtype, N: int, ny: int, nx: int) -> dict:
    """uv3dmix2's launch on a padded ny x nx grid of N levels: {"tile":
    (points along xi, along eta), "levels": level slots, "blocks",
    "threads": a block, "smem_bytes": its dynamic shared memory}.  A block
    is `levels` slots of one thread a tile point, at most THREADS threads,
    each slot with two sets of u, v, Hz planes over the tile's region (the
    tile and one point around it) and its four face arrays, beside the
    region's and the rectangles' metric factors and, with more than one
    slot, each level's terms of the column sums (csrc/mix3d.cuh
    MixLayout); the slots are halved while they leave no room for three
    blocks an SM; _kernels.tile_plan picks the tile."""
    word = 8 if dtype == torch.float64 else 4

    def smem(tx, ty, ks):
        ra, fa = (tx + 2) * (ty + 2), (tx + 1) * (ty + 1)
        words = ks * (6 * ra + 4 * fa) + 4 * ra + 9 * fa + \
            (2 * N * tx * ty if ks > 1 else 0)
        return words * word + 4 * ra

    def make(tx, ty):
        ks = max(THREADS // (tx * ty), 1)
        while ks > 1 and smem(tx, ty, ks) > SMEM_MAX // 3:
            ks //= 2
        return dict(tile=(tx, ty), levels=ks,
                    blocks=-(-nx // tx) * -(-ny // ty),
                    threads=tx * ty * ks, smem_bytes=smem(tx, ty, ks))
    return tile_plan(make)


def uv3dmix2_layout(dtype) -> dict:
    """uv3dmix2's kernel on the current card: {"registers": a thread,
    "stack_bytes": its stack frame a thread}."""
    return kernel_layout("roms_uv3dmix2_layout", dtype)


def supported(cfg: Config) -> bool:
    """The configurations the kernel computes (mix3d_pallas.supported): no
    sponge and no Smagorinsky viscosity."""
    return not (cfg.use_sponge or cfg.uv_smagorinsky)


def use_kernels(cfg: Config) -> bool:
    """The gate of both kernels (mix3d_pallas.use_pallas without its
    environment switches, which the JAX step asks for both)."""
    return cfg.pallas2d and supported(cfg)


def uv3dmix2(cfg: Config, grid: Grid, u, v, Hz, u_nnew, v_nnew, rufrc,
             rvfrc, dt: float):
    """Returns the updated (u_nnew, v_nnew, rufrc, rvfrc)."""
    if not on_card(u):
        return uv3dmix2_plain(cfg, grid, u, v, Hz, u_nnew, v_nnew, rufrc,
                              rvfrc, dt)
    if not supported(cfg):
        raise ValueError("uv3dmix2 kernel: sponge and Smagorinsky viscosity "
                         "are not in it")
    ints = column_ints(cfg, "uv3dmix2")
    s2 = (cfg.ny_tot, cfg.nx_tot)
    s3 = (cfg.N,) + s2
    ins = dict(u=u, v=v, Hz=Hz, pm=grid.pm, pn=grid.pn, pmask=grid.pmask,
               u_nnew=u_nnew, v_nnew=v_nnew, rufrc=rufrc, rvfrc=rvfrc)
    shapes = dict.fromkeys(ins, s3)
    shapes.update(dict.fromkeys(("pm", "pn", "pmask", "rufrc", "rvfrc"), s2))
    f64 = check_tensors("roms_uv3dmix2", ins, shapes, u.dtype, u.device)
    outs = {t.data_ptr() for t in (u_nnew, v_nnew, rufrc, rvfrc)}
    reads = {t.data_ptr() for t in (u, v, Hz, grid.pm, grid.pn, grid.pmask)}
    if len(outs) != 4 or outs & reads:
        raise ValueError("uv3dmix2 kernel updates u_nnew, v_nnew, rufrc and "
                         "rvfrc in place: they must not alias each other or "
                         "its other arguments")
    plan = uv3dmix2_plan(u.dtype, cfg.N, cfg.ny_tot, cfg.nx_tot)
    launch("roms_uv3dmix2", f64, list(ins.values()),
           ints + list(plan["tile"]) + [plan["levels"], plan["threads"],
                                        plan["smem_bytes"]],
           [dt, cfg.visc2], torch.cuda.current_stream(u.device))
    uv3dmix2.launches += 1
    return u_nnew, v_nnew, rufrc, rvfrc


uv3dmix2.launches = 0


def geo_tracers(cfg: Config) -> list:
    """The tracers t3dmix2_geo's kernel mixes, those with tnu2 != 0 (a
    block row each); raise for more than MAX_TRACERS of them."""
    active = [k for k in range(cfg.ntracers)
              if k < len(cfg.tnu2) and cfg.tnu2[k] != 0.0]
    if len(active) > MAX_TRACERS:
        raise ValueError(f"t3dmix2_geo kernel: {len(active)} mixed tracers, "
                         f"more than {MAX_TRACERS}")
    return active


def t3dmix2_geo(cfg: Config, grid: Grid, t, Hz, z_r, t_nnew, dt: float):
    """Returns the updated t_nnew (NT,N,Ny,Nx); tracers with tnu2 = 0 are
    left as they are."""
    if not on_card(t):
        return t3dmix2_geo_plain(cfg, grid, t, Hz, z_r, t_nnew, dt)
    if not supported(cfg):
        raise ValueError("t3dmix2_geo kernel: the sponge is not in it")
    ints = column_ints(cfg, "t3dmix2_geo")
    nt = cfg.ntracers
    active = geo_tracers(cfg)
    s2 = (cfg.ny_tot, cfg.nx_tot)
    s3 = (cfg.N,) + s2
    ins = dict(t=t, Hz=Hz, z_r=z_r, pm=grid.pm, pn=grid.pn, t_nnew=t_nnew)
    shapes = dict(t=(nt,) + s3, Hz=s3, z_r=s3, pm=s2, pn=s2,
                  t_nnew=(nt,) + s3)
    f64 = check_tensors("roms_t3dmix2_geo", ins, shapes, t.dtype,
                        t.device)
    reads = {x.data_ptr() for x in (t, Hz, z_r, grid.pm, grid.pn)}
    if t_nnew.data_ptr() in reads:
        raise ValueError("t3dmix2_geo kernel updates t_nnew in place: it "
                         "must not alias its other arguments")
    if not active:
        return t_nnew
    coefs = [c for k in active
             for c in (0.25 * (2.0 * cfg.tnu2[k]), 0.5 * cfg.tnu2[k])]
    launch("roms_t3dmix2_geo", f64, list(ins.values()),
           ints + [len(active)] + active, [dt] + coefs,
           torch.cuda.current_stream(t.device))
    t3dmix2_geo.launches += 1
    return t_nnew


t3dmix2_geo.launches = 0


def geo_layout(dtype) -> dict:
    """t3dmix2_geo's kernel on the current card: {"tile": (points along
    xi, along eta), "shared_bytes": its static shared memory a block,
    "registers": a thread}."""
    out = (ctypes.c_int * 4)()
    err = library().roms_t3dmix2_geo_layout(int(dtype == torch.float64), out)
    if err != 0:
        raise RuntimeError(f"roms_t3dmix2_geo_layout: CUDA error {err}")
    return dict(tile=(out[0], out[1]), shared_bytes=out[2],
                registers=out[3])
