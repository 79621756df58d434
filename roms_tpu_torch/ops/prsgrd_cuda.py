"""The baroclinic pressure gradient prsgrd32: its CUDA kernel and its plain
version.

Replaces the TPU kernel roms_tpu/ops/prsgrd_pallas.py::prsgrd32_fused.
``prsgrd32_plain`` is the port's ops/prsgrd.py::prsgrd32.  ``prsgrd32``
takes it for CPU tensors only; for CUDA tensors it launches the kernel of
csrc/prsgrd.cu or raises.  The kernel runs on 2-D tiles of padded points
whose water columns a block keeps in shared memory; ``prsgrd_plan`` sizes
the tile and the block, ``prsgrd_layout`` reports the kernel's registers
and stack frame on the card.  ``prsgrd32.launches`` counts kernel launches.
"""

from __future__ import annotations

import torch

from .. import constants as C
from ..config import Config
from ..grid import Grid
from ._kernels import check_tensors, column_ints, kernel_layout, launch, \
    on_card, tile_plan
from .prsgrd import prsgrd32 as prsgrd32_plain

THREADS = 256       # threads a block (csrc/prsgrd.cu kMaxThreads)


def prsgrd_plan(dtype, N: int, ny: int, nx: int) -> dict:
    """The kernel's launch on a padded ny x nx grid: {"tile": (points along
    xi, along eta), "blocks", "threads": a block, "smem_bytes": its dynamic
    shared memory}.  A block keeps rho, z_r and P of its tile's region, the
    tile's columns and one more to the west and the south, at every level
    (csrc/prsgrd.cuh prsgrd_smem); _kernels.tile_plan picks the tile."""
    word = 8 if dtype == torch.float64 else 4

    def make(tx, ty):
        return dict(tile=(tx, ty), blocks=-(-nx // tx) * -(-ny // ty),
                    threads=THREADS,
                    smem_bytes=(tx + 1) * (ty + 1) * (3 * N * word + 4))
    return tile_plan(make)


def prsgrd_layout(dtype) -> dict:
    """The kernel on the current card: {"registers": a thread,
    "stack_bytes": its stack frame a thread}."""
    return kernel_layout("roms_prsgrd32_layout", dtype)


def supported(cfg: Config) -> bool:
    """The kernel's gate (prsgrd_pallas.use_pallas without its environment
    switches): kernels on and the splines density-Jacobian scheme."""
    return cfg.pallas2d and cfg.prsgrd_scheme == "djs"


def prsgrd32(cfg: Config, grid: Grid, rho, z_r, z_w, Hz, eq_tide=None):
    """Returns (ru, rv), the pressure-gradient terms (N,Ny,Nx)."""
    if not on_card(rho):
        return prsgrd32_plain(cfg, grid, rho, z_r, z_w, Hz, eq_tide=eq_tide)
    ints = column_ints(cfg, "prsgrd32")
    N = cfg.N
    s2 = (cfg.ny_tot, cfg.nx_tot)
    s3, sw = (N,) + s2, (N + 1,) + s2
    ins = dict(rho=rho, z_r=z_r, z_w=z_w, Hz=Hz, pm=grid.pm, pn=grid.pn)
    shapes = dict(rho=s3, z_r=s3, z_w=sw, Hz=s3, pm=s2, pn=s2)
    if eq_tide is not None:
        ins["eq_tide"] = eq_tide
        shapes["eq_tide"] = s2
    f64 = check_tensors("roms_prsgrd32", ins, shapes, rho.dtype,
                        rho.device)
    ru, rv = torch.empty_like(rho), torch.empty_like(rho)
    GRho = C.g / cfg.rho0
    plan = prsgrd_plan(rho.dtype, N, *s2)
    launch("roms_prsgrd32", f64,
           [rho, z_r, z_w, Hz, grid.pm, grid.pn, eq_tide, ru, rv],
           ints + [*plan["tile"], plan["threads"], plan["smem_bytes"]],
           [C.g, GRho, 0.5 * GRho],
           torch.cuda.current_stream(rho.device))
    prsgrd32.launches += 1
    return ru, rv


prsgrd32.launches = 0
