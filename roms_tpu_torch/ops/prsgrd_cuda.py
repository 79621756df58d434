"""The baroclinic pressure gradient prsgrd32: its CUDA kernel and its plain
version.

Replaces the TPU kernel roms_tpu/ops/prsgrd_pallas.py::prsgrd32_fused.
``prsgrd32_plain`` is the port's ops/prsgrd.py::prsgrd32.  ``prsgrd32``
takes it for CPU tensors only; for CUDA tensors it launches the kernel of
csrc/prsgrd.cu or raises.  ``prsgrd32.launches`` counts kernel launches.
"""

from __future__ import annotations

import torch

from .. import constants as C
from ..config import Config
from ..grid import Grid
from ._kernels import check_tensors, column_ints, launch, on_card
from .prsgrd import prsgrd32 as prsgrd32_plain


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
    f64 = check_tensors(ins, shapes, rho.dtype, rho.device)
    ru, rv = torch.empty_like(rho), torch.empty_like(rho)
    GRho = C.g / cfg.rho0
    launch("roms_prsgrd32", f64,
           [rho, z_r, z_w, Hz, grid.pm, grid.pn, eq_tide, ru, rv],
           ints, [C.g, GRho, 0.5 * GRho],
           torch.cuda.current_stream(rho.device))
    prsgrd32.launches += 1
    return ru, rv


prsgrd32.launches = 0
