"""The fused fast barotropic loop: its CUDA kernel and its plain version.

Replaces the TPU kernel roms_tpu/ops/step2d_pallas.py::fast_loop_fused,
whose math core is ``_core`` (:92-245): the FE predictor and first
corrector of fast step 1, nfast-1 LF/AM3 substeps, the auxiliary averaging
step, and the AB3 coupling of the depth-integrated slow forcing.

``fast_loop_plain`` is that core in plain PyTorch: the general loop of
ops/step2d.py on the kernel's subset.  ``fast_loop`` takes it for CPU
tensors only; for CUDA tensors it launches the kernel of
csrc/fast_loop.cu, one cooperative grid of FAST_THREADS-thread blocks that
runs the whole loop with a grid barrier between its phases, or raises on a
launch error: nothing falls back to one block or to the plain version.
``fast_loop.launches`` counts kernel launches; ``launch_plan`` says how
many blocks a launch takes.
"""

from __future__ import annotations

import ctypes

import torch

from ..config import Config
from ..grid import Grid
from ._kernels import (BC_CODE, bc_kinds, check_tensors, geometry, launch,
                       library, on_card)
from .step2d import FS_FIELDS, Fast2DState, _g, ab3_coupling_weights
from .step2d import fast_loop as general_fast_loop

GRID_FIELDS = ("h", "f", "pm", "pn", "dndx", "dmde",
               "rmask", "umask", "vmask", "pmask")
# threads a block of the kernel (a multiple of 32, at most 512): the
# fastest of 128, 256 and 512 on BENCHMARK1 (PERF.md)
FAST_THREADS = 512


def supported(cfg: Config, bry=None, sources=None, clm=None) -> bool:
    """True when the fused loop implements this configuration exactly
    (step2d_pallas.supported: no wetting-drying, open-boundary data,
    sources, climatology or Stokes drift; only the periodic, closed and
    gradient BC kinds)."""
    if not cfg.solve3d or cfg.wetdry or cfg.volcons:
        return False
    if cfg.nearshore is not None:
        return False
    if bry is not None or sources is not None or clm is not None:
        return False
    for lbc in (cfg.lbc_zeta, cfg.lbc_ubar, cfg.lbc_vbar):
        if any(getattr(lbc, s) not in BC_CODE
               for s in ("west", "south", "east", "north")):
            return False
    return cfg.nfast >= 2


def fast_loop_plain(cfg: Config, grid: Grid, fs: Fast2DState, rufrc, rvfrc,
                    ru0_nm1, ru0_nm2, rv0_nm1, rv0_nm2, iic: int):
    """The fused loop's plain version: the general loop (ops/step2d.py) on
    the configurations the kernel takes, which it computes without open
    boundaries, sources or volume conservation; returns (fs, rufrc_c,
    rvfrc_c)."""
    if not supported(cfg):
        raise NotImplementedError(
            "fast loop outside the fused subset (wetting-drying, open "
            "boundaries, sources, climatology, Stokes drift)")
    fs, rufrc_c, rvfrc_c, _ = general_fast_loop(
        cfg, grid, fs, rufrc, rvfrc, ru0_nm1, ru0_nm2, rv0_nm1, rv0_nm2, iic)
    return fs, rufrc_c, rvfrc_c


def fast_loop(cfg: Config, grid: Grid, fs: Fast2DState, rufrc, rvfrc,
              ru0_nm1, ru0_nm2, rv0_nm1, rv0_nm2, iic: int):
    """The fused fast loop; returns (fs, rufrc_c, rvfrc_c).

    On CUDA the 17 fields of ``fs`` are updated IN PLACE and the returned
    fs holds the same tensors (the JAX kernel donates these buffers to its
    outputs; here that saves a copy of each).  They must be distinct
    tensors: aliased fields raise."""
    if not on_card(fs.zeta_n):
        return fast_loop_plain(cfg, grid, fs, rufrc, rvfrc, ru0_nm1, ru0_nm2,
                               rv0_nm1, rv0_nm2, iic)
    if not supported(cfg):
        raise ValueError("fast_loop kernel: unsupported configuration")
    dtype, device = fs.zeta_n.dtype, fs.zeta_n.device
    shape = (cfg.ny_tot, cfg.nx_tot)
    named = {k: getattr(fs, k) for k in FS_FIELDS}
    named.update(zip(("rufrc", "rvfrc", "ru0_nm1", "ru0_nm2", "rv0_nm1",
                      "rv0_nm2"),
                     (rufrc, rvfrc, ru0_nm1, ru0_nm2, rv0_nm1, rv0_nm2)))
    named.update((k, getattr(grid, k)) for k in GRID_FIELDS)
    shapes = dict.fromkeys(named, shape)
    named.update(weight1=grid.weight1, weight2=grid.weight2)
    shapes.update(weight1=(2 * cfg.ndtfast + 2,),
                  weight2=(2 * cfg.ndtfast + 2,))
    f64 = check_tensors("roms_fast_loop", named, shapes, dtype, device)
    if len({getattr(fs, k).data_ptr() for k in FS_FIELDS}) != len(FS_FIELDS):
        raise ValueError("fast_loop kernel updates the 17 Fast2DState "
                         "fields in place: they must not alias")
    kw = dict(dtype=dtype, device=device)
    rufrc_c, rvfrc_c = torch.empty(shape, **kw), torch.empty(shape, **kw)
    scratch = torch.empty(
        (library().roms_fast_loop_scratch_planes(),) + shape, **kw)
    kinds = [code for lbc in (cfg.lbc_zeta, cfg.lbc_ubar, cfg.lbc_vbar)
             for code in bc_kinds(lbc)]
    ints = geometry(cfg) + kinds + [
        int(cfg.uv_adv), int(cfg.uv_cor), int(cfg.curvgrid),
        int(cfg.uv_vis2 and cfg.visc2 != 0.0), cfg.nfast, FAST_THREADS]
    doubles = [cfg.dtfast, _g(cfg), cfg.visc2, cfg.gamma2,
               *ab3_coupling_weights(iic)]
    launch("roms_fast_loop", f64,
           list(named.values()) + [rufrc_c, rvfrc_c, scratch],
           ints, doubles, torch.cuda.current_stream(device))
    fast_loop.launches += 1
    return fs, rufrc_c, rvfrc_c


fast_loop.launches = 0


def launch_plan(dtype, points: int, threads: int | None = None) -> dict:
    """The kernel's launch on the current card for `points` padded points:
    {"blocks", "threads", "per_sm", "sms"}, where blocks is the smaller of
    the blocks the points need at one a thread and the blocks that can be
    co-resident (per_sm on each of sms SMs)."""
    threads = threads or FAST_THREADS
    out = (ctypes.c_int * 3)()
    err = library().roms_fast_loop_plan(int(dtype == torch.float64),
                                        threads, points, out)
    if err != 0:
        raise RuntimeError(f"roms_fast_loop_plan: CUDA error {err}")
    return dict(blocks=out[0], threads=threads, per_sm=out[1], sms=out[2])
