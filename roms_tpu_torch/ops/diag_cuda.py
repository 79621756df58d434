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
never falls back.  grid_flux runs on 2-D tiles of padded points and eos
with JM95 and bvf on runs of them, each keeping its tile in shared memory;
omega runs one thread a column.  ``grid_flux_plan`` and ``eos_plan`` size
the tile and the block; ``grid_flux_layout``, ``omega_layout`` and
``eos_layout`` report a kernel's registers and stack frame on the card.
``wrapper.launches`` counts kernel launches.
"""

from __future__ import annotations

import torch

from .. import constants as C
from ..config import Config
from ..grid import Grid
from .. import vgrid
from . import eos as _eos
from ._kernels import SMEM_MAX, check_tensors, geometry, kernel_layout, \
    launch, on_card, tile_plan
from .omega import set_massflux, omega as _omega

THREADS = 256     # threads a block, every kernel (csrc/diag.cu kThreads)
EOS_TILE = 32     # padded points of an eos tile, at most


def _word(dtype) -> int:
    return 8 if dtype == torch.float64 else 4


def grid_flux_plan(dtype, N: int, ny: int, nx: int) -> dict:
    """grid_flux's launch on a padded ny x nx grid of N levels: {"tile":
    (points along xi, along eta), "blocks", "threads": a block,
    "smem_bytes": its dynamic shared memory}.  A block keeps zeta, h,
    1/(hc+h), on_u and om_v of its region (the tile and one ring of points
    around it), the four stretching tables, the filled Huon and Hvom of its
    box (the tile, one column east and one row north) and omega's sums of
    every tile point at every level (csrc/diag.cuh flux_words);
    _kernels.tile_plan picks the tile, and the block has a thread per
    (level slot, tile point)."""
    def make(tx, ty):
        words = 5 * (tx + 2) * (ty + 2) + 4 * N + 2 + \
            2 * N * (tx + 1) * (ty + 1) + N * tx * ty
        return dict(tile=(tx, ty), blocks=-(-nx // tx) * -(-ny // ty),
                    threads=THREADS, smem_bytes=words * _word(dtype))
    return tile_plan(make)


def eos_plan(dtype, N: int, ny: int, nx: int, jm95: bool,
             want_bvf: bool) -> dict:
    """eos's launch on a padded ny x nx grid of N levels: {"tile", "blocks",
    "threads", "smem_bytes"}.  JM95 with bvf runs on tiles of consecutive
    padded points (the largest power of two up to EOS_TILE whose den1, K0,
    K1, K2, z_r and z_w columns leave room for three blocks an SM), a
    thread per (level slot, point); every other case a thread per point of
    the (N+1)-level w grid with no shared memory (tile None)."""
    if not (jm95 and want_bvf):
        return dict(tile=None, blocks=-(-(N + 1) * ny * nx // THREADS),
                    threads=THREADS, smem_bytes=0)
    col_bytes = 6 * N * _word(dtype)
    tile = EOS_TILE
    while tile > 1 and tile * col_bytes > SMEM_MAX // 3:
        tile //= 2
    return dict(tile=tile, blocks=-(-ny * nx // tile), threads=THREADS,
                smem_bytes=tile * col_bytes)


def grid_flux_layout(dtype) -> dict:
    """grid_flux's kernel on the current card: {"registers": a thread,
    "stack_bytes": its stack frame a thread}."""
    return kernel_layout("roms_grid_flux_layout", dtype)


def omega_layout(dtype) -> dict:
    """omega's kernel on the current card, as grid_flux_layout."""
    return kernel_layout("roms_omega_layout", dtype)


def eos_layout(dtype) -> dict:
    """eos's JM95-with-bvf kernel on the current card, as
    grid_flux_layout."""
    return kernel_layout("roms_eos_layout", dtype)


def supported(cfg: Config, grid: Grid) -> bool:
    """True when the diag kernels implement this configuration exactly
    (the ice-shelf draft is outside them; the step also keeps grid_flux
    and eos plain while the radiation stress is active, as roms_tpu's
    ns_active does)."""
    return (grid.zice is None and cfg.vtransform in (1, 2)
            and cfg.eos in ("linear", "jm95"))


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------
def grid_flux_plain(cfg: Config, grid: Grid, zeta, u, v, hc):
    z_r, z_w, Hz = vgrid.set_depth(grid.h, zeta, hc, grid.sc_r, grid.Cs_r,
                                   grid.sc_w, grid.Cs_w, cfg.vtransform,
                                   zice=grid.zice)
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
    f64 = check_tensors("roms_grid_flux", ins,
                        dict(zeta=s2, h=s2, pm=s2, pn=s2, u=s3, v=s3,
                             sc_r=(N,), Cs_r=(N,), sc_w=(N + 1,),
                             Cs_w=(N + 1,)), zeta.dtype, zeta.device)
    kw = dict(dtype=zeta.dtype, device=zeta.device)
    z_r, Hz, Huon, Hvom = (torch.empty(s3, **kw) for _ in range(4))
    z_w, W = torch.empty(sw, **kw), torch.empty(sw, **kw)
    plan = grid_flux_plan(zeta.dtype, N, cfg.ny_tot, cfg.nx_tot)
    launch("roms_grid_flux", f64,
           list(ins.values()) + [z_r, z_w, Hz, Huon, Hvom, W],
           [N] + geometry(cfg) + [cfg.vtransform, *plan["tile"],
                                  plan["threads"], plan["smem_bytes"]],
           [hc], torch.cuda.current_stream(zeta.device))
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
    f64 = check_tensors("roms_eos", ins, shapes, t.dtype, t.device)
    kw = dict(dtype=t.dtype, device=t.device)
    rho, pden = torch.empty(s3, **kw), torch.empty(s3, **kw)
    bvf = torch.empty((N + 1, Ny, Nx), **kw) if want_bvf else None
    use_salt = cfg.ntracers >= 2 and cfg.Scoef != 0.0
    jm95 = cfg.eos == "jm95"
    plan = eos_plan(t.dtype, N, Ny, Nx, jm95, want_bvf)
    launch("roms_eos", f64,
           [t, z_r, z_w if want_bvf else None, rho, pden, bvf],
           [NT, N, Ny * Nx, int(jm95), int(want_bvf), int(use_salt),
            plan["tile"] or 0, plan["threads"], plan["smem_bytes"]],
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
    f64 = check_tensors("roms_omega", dict(Huon=Huon, Hvom=Hvom, z_w=z_w),
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
