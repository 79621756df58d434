"""The harmonic viscosity uv3dmix2: its CUDA kernel and its plain version.

Replaces the TPU kernel roms_tpu/ops/mix3d_pallas.py::uv3dmix2_fused.
``uv3dmix2_plain`` is the port's ops/mix3d.py::uv3dmix2.  ``uv3dmix2``
takes it for CPU tensors only; for CUDA tensors it launches the kernel of
csrc/mix3d.cu, both directions in one launch, or raises.  On the card the
kernel adds into u_nnew, v_nnew, rufrc and rvfrc in place and returns
them, as the Pallas kernel donates them: a caller does not read those
inputs again, and they must not alias each other or the other arguments.
``uv3dmix2.launches`` counts kernel launches.
"""

from __future__ import annotations

import torch

from ..config import Config
from ..grid import Grid
from ._kernels import check_tensors, column_ints, launch, on_card
from .mix3d import uv3dmix2 as uv3dmix2_plain


def supported(cfg: Config) -> bool:
    """The configurations the kernel computes (mix3d_pallas.supported): no
    sponge and no Smagorinsky viscosity."""
    return not (cfg.use_sponge or cfg.uv_smagorinsky)


def use_kernels(cfg: Config) -> bool:
    """The kernel's gate (mix3d_pallas.use_pallas without its environment
    switches)."""
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
    f64 = check_tensors(ins, shapes, u.dtype, u.device)
    outs = {t.data_ptr() for t in (u_nnew, v_nnew, rufrc, rvfrc)}
    reads = {t.data_ptr() for t in (u, v, Hz, grid.pm, grid.pn, grid.pmask)}
    if len(outs) != 4 or outs & reads:
        raise ValueError("uv3dmix2 kernel updates u_nnew, v_nnew, rufrc and "
                         "rvfrc in place: they must not alias each other or "
                         "its other arguments")
    launch("roms_uv3dmix2", f64, list(ins.values()), ints,
           [dt, cfg.visc2], torch.cuda.current_stream(u.device))
    uv3dmix2.launches += 1
    return u_nnew, v_nnew, rufrc, rvfrc


uv3dmix2.launches = 0
