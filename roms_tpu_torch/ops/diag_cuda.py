"""The diagnostic ("time n") kernels of the step and their plain versions.

grid_flux - set_depth + set_massflux + omega: (zeta, u, v) -> (z_r, z_w,
            Hz, Huon, Hvom, W).  Replaces the TPU kernel
            roms_tpu/ops/diag_pallas.py::grid_flux_fused.
eos       - rho_eos_pden (+ brunt_vaisala): t -> (rho, pden[, bvf]).
            Replaces diag_pallas.eos_fused.
omega     - omega of the corrected fluxes (W2).  Replaces
            diag_pallas.omega_fused.

Each wrapper takes its plain version (``*_plain``, the stage functions of
this package in the order the JAX step calls them) for CPU tensors only.
For CUDA tensors it launches the CUDA kernel of csrc/diag.cu or raises; it
never falls back.  ``wrapper.launches`` counts kernel launches.
"""

from __future__ import annotations

import torch

from .. import constants as C
from ..config import Config
from ..grid import Grid
from .. import vgrid
from . import eos as _eos
from ._kernels import check_tensors, geometry, launch, on_card
from .omega import set_massflux, omega as _omega


def supported(cfg: Config, grid: Grid) -> bool:
    """True when the diag kernels implement this configuration exactly
    (the ice-shelf draft and the Stokes drift are outside them)."""
    return (grid.zice is None and cfg.nearshore is None
            and cfg.vtransform in (1, 2) and cfg.eos in ("linear", "jm95"))


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------
def grid_flux_plain(cfg: Config, grid: Grid, zeta, u, v, hc):
    z_r, z_w, Hz = vgrid.set_depth(grid.h, zeta, hc, grid.sc_r, grid.Cs_r,
                                   grid.sc_w, grid.Cs_w, cfg.vtransform)
    Huon, Hvom = set_massflux(cfg, grid, u, v, Hz)
    W = _omega(cfg, grid, Huon, Hvom, z_w)
    return z_r, z_w, Hz, Huon, Hvom, W


def eos_plain(cfg: Config, t, z_r, z_w, want_bvf: bool):
    if want_bvf:
        return _eos.rho_eos_pden_bvf(cfg, t, z_r, z_w)
    return _eos.rho_eos_pden(cfg, t, z_r)


def omega_plain(cfg: Config, grid: Grid, Huon, Hvom, z_w):
    return _omega(cfg, grid, Huon, Hvom, z_w)


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------
def grid_flux(cfg: Config, grid: Grid, zeta, u, v, hc):
    """Returns (z_r, z_w, Hz, Huon, Hvom, W)."""
    if not on_card(zeta):
        return grid_flux_plain(cfg, grid, zeta, u, v, hc)
    if not supported(cfg, grid):
        raise ValueError("grid_flux kernel: unsupported configuration")
    N = cfg.N
    s2, s3, sw = (cfg.ny_tot, cfg.nx_tot), (N, cfg.ny_tot, cfg.nx_tot), \
        (N + 1, cfg.ny_tot, cfg.nx_tot)
    ins = dict(zeta=zeta, h=grid.h, pm=grid.pm, pn=grid.pn, u=u, v=v,
               sc_r=grid.sc_r, Cs_r=grid.Cs_r, sc_w=grid.sc_w,
               Cs_w=grid.Cs_w)
    f64 = check_tensors(ins, dict(zeta=s2, h=s2, pm=s2, pn=s2, u=s3, v=s3,
                                  sc_r=(N,), Cs_r=(N,), sc_w=(N + 1,),
                                  Cs_w=(N + 1,)), zeta.dtype, zeta.device)
    kw = dict(dtype=zeta.dtype, device=zeta.device)
    z_r, Hz, Huon, Hvom = (torch.empty(s3, **kw) for _ in range(4))
    z_w, W = torch.empty(sw, **kw), torch.empty(sw, **kw)
    launch("roms_grid_flux", f64,
           list(ins.values()) + [z_r, z_w, Hz, Huon, Hvom, W],
           [N] + geometry(cfg) + [cfg.vtransform], [hc],
           torch.cuda.current_stream(zeta.device))
    grid_flux.launches += 1
    return z_r, z_w, Hz, Huon, Hvom, W


def eos(cfg: Config, t, z_r, z_w, want_bvf: bool):
    """Returns (rho, pden) or, with want_bvf, (rho, pden, bvf)."""
    if not on_card(t):
        return eos_plain(cfg, t, z_r, z_w, want_bvf)
    if cfg.eos not in ("linear", "jm95"):
        raise ValueError(f"eos kernel: unknown eos {cfg.eos!r}")
    NT, N, Ny, Nx = t.shape
    s3 = (N, Ny, Nx)
    ins = dict(t=t, z_r=z_r)
    shapes = dict(t=(NT, N, Ny, Nx), z_r=s3)
    if want_bvf:
        ins["z_w"] = z_w
        shapes["z_w"] = (N + 1, Ny, Nx)
    f64 = check_tensors(ins, shapes, t.dtype, t.device)
    kw = dict(dtype=t.dtype, device=t.device)
    rho, pden = torch.empty(s3, **kw), torch.empty(s3, **kw)
    bvf = torch.empty((N + 1, Ny, Nx), **kw) if want_bvf else None
    use_salt = cfg.ntracers >= 2 and cfg.Scoef != 0.0
    launch("roms_eos", f64,
           [t, z_r, z_w if want_bvf else None, rho, pden, bvf],
           [NT, N, Ny * Nx, int(cfg.eos == "jm95"), int(want_bvf),
            int(use_salt)],
           [cfg.R0, cfg.R0 * cfg.Tcoef, cfg.T0, cfg.R0 * cfg.Scoef, cfg.S0,
            -(C.g / cfg.rho0), -C.g],
           torch.cuda.current_stream(t.device))
    eos.launches += 1
    return (rho, pden, bvf) if want_bvf else (rho, pden)


def omega(cfg: Config, grid: Grid, Huon, Hvom, z_w):
    """W (N+1,Ny,Nx) from the fluxes (Huon, Hvom) and the depths z_w."""
    if not on_card(Huon):
        return omega_plain(cfg, grid, Huon, Hvom, z_w)
    N = cfg.N
    s3, sw = (N, cfg.ny_tot, cfg.nx_tot), (N + 1, cfg.ny_tot, cfg.nx_tot)
    f64 = check_tensors(dict(Huon=Huon, Hvom=Hvom, z_w=z_w),
                        dict(Huon=s3, Hvom=s3, z_w=sw), Huon.dtype,
                        Huon.device)
    W = torch.empty(sw, dtype=Huon.dtype, device=Huon.device)
    launch("roms_omega", f64, [Huon, Hvom, z_w, W],
           [N] + geometry(cfg) + [cfg.vtransform], [0.0],
           torch.cuda.current_stream(Huon.device))
    omega.launches += 1
    return W


grid_flux.launches = 0
eos.launches = 0
omega.launches = 0
