"""The fused fast barotropic loop: its CUDA kernel and its plain version.

Replaces the TPU kernel roms_tpu/ops/step2d_pallas.py::fast_loop_fused,
whose math core is ``_core`` (:92-245): the FE predictor and first
corrector of fast step 1, nfast-1 LF/AM3 substeps, the auxiliary averaging
step, and the AB3 coupling of the depth-integrated slow forcing.

``fast_loop_plain`` is that core in plain PyTorch.  ``fast_loop`` takes it
for CPU tensors only; for CUDA tensors it launches the kernel of
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
from . import bc
from ._kernels import (BC_CODE, bc_kinds, check_tensors, geometry, launch,
                       library, on_card)
from .stencil import ip1, jp1
from .step2d import (FS_FIELDS, Fast2DState, depth_fluxes, _g,
                     _rhs_momentum, _step_momentum)

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


def ab3_coupling_weights(iic: int):
    """(w_now, w_m1, w_m2) of the first predictor's 2-D/3-D coupling
    (step2d_LF_AM3.h:1868-1990), chosen on the host from the step count."""
    if iic == 0:
        return 1.0, 0.0, 0.0
    if iic == 1:
        return 1.5, 0.5, 0.0
    return 23.0 / 12.0, 16.0 / 12.0, 5.0 / 12.0


def fast_loop_plain(cfg: Config, grid: Grid, fs: Fast2DState, rufrc, rvfrc,
                    ru0_nm1, ru0_nm2, rv0_nm1, rv0_nm2, iic: int):
    """The restricted fast loop in plain PyTorch; returns (fs, rufrc_c,
    rvfrc_c).  Mirrors step2d_pallas._core step for step."""
    if not supported(cfg):
        raise NotImplementedError(
            "fast loop outside the fused subset (wetting-drying, open "
            "boundaries, sources, climatology, Stokes drift)")
    dtfast = cfg.dtfast
    h = grid.h
    pmn = grid.pm * grid.pn
    w1, w2 = grid.weight1, grid.weight2
    zero = torch.zeros_like(fs.zeta_n)

    def zbc(z_new):
        return bc.apply_bc_rho(cfg, cfg.lbc_zeta, z_new, mask=grid.rmask)

    def ubc(u_new):
        return bc.apply_bc_u(cfg, cfg.lbc_ubar, u_new, gamma2=cfg.gamma2,
                             mask=grid.umask)

    def vbc(v_new):
        return bc.apply_bc_v(cfg, cfg.lbc_vbar, v_new, gamma2=cfg.gamma2,
                             mask=grid.vmask)

    # ================= fast step 1 (peeled: FE predictor) =================
    Drhs, DUon, DVom = depth_fluxes(grid, fs.zeta_n, fs.ubar_n, fs.vbar_n)
    cff2 = (-1.0 / 12.0) * w2[1]
    fs = fs.replace(Zt_avg1=zero, DU_avg1=zero, DV_avg1=zero,
                    DU_avg2=cff2 * DUon, DV_avg2=cff2 * DVom)

    rhs_zeta = (DUon - ip1(DUon)) + (DVom - jp1(DVom))
    zeta_new = (fs.zeta_n + pmn * dtfast * rhs_zeta) * grid.rmask
    Dnew = zeta_new + h
    zwrk = 0.5 * (fs.zeta_n + zeta_new)
    zeta_p = zbc(zeta_new)

    rhs_ubar, rhs_vbar = _rhs_momentum(cfg, grid, fs.ubar_n, fs.vbar_n,
                                       Drhs, DUon, DVom, zwrk, zwrk * zwrk)

    # --- 2D-3D coupling on the first predictor (:1868-1990) ---
    rufrc_c = rufrc - rhs_ubar
    rvfrc_c = rvfrc - rhs_vbar
    w_now, w_m1, w_m2 = ab3_coupling_weights(iic)
    rhs_ubar = rhs_ubar + w_now * rufrc_c - w_m1 * ru0_nm1 + w_m2 * ru0_nm2
    rhs_vbar = rhs_vbar + w_now * rvfrc_c - w_m1 * rv0_nm1 + w_m2 * rv0_nm2

    ubar_p, vbar_p = _step_momentum(
        cfg, grid, fs.ubar_n, fs.vbar_n, fs.zeta_n + h, Dnew,
        0.5 * dtfast * rhs_ubar, 0.5 * dtfast * rhs_vbar)
    ubar_p = ubc(ubar_p)
    vbar_p = vbc(vbar_p)
    fs = fs.replace(
        rzeta_nm1=fs.rzeta_n, rzeta_n=bc.fill_halo(cfg, rhs_zeta),
        rubar_nm1=fs.rubar_n, rubar_n=rhs_ubar,
        rvbar_nm1=fs.rvbar_n, rvbar_n=rhs_vbar)

    def corrector(fs, zeta_p, ubar_p, vbar_p, cff2):
        Drhs, DUon, DVom = depth_fluxes(grid, zeta_p, ubar_p, vbar_p)
        fs = fs.replace(DU_avg2=fs.DU_avg2 + cff2 * DUon,
                        DV_avg2=fs.DV_avg2 + cff2 * DVom)

        rhs_zeta = (DUon - ip1(DUon)) + (DVom - jp1(DVom))
        c1 = dtfast * 5.0 / 12.0
        c2 = dtfast * 8.0 / 12.0
        c3 = dtfast * 1.0 / 12.0
        zeta_new = (fs.zeta_n + pmn * (c1 * rhs_zeta + c2 * fs.rzeta_n -
                                       c3 * fs.rzeta_nm1)) * grid.rmask
        Dnew = zeta_new + h
        cff4 = 2.0 / 5.0
        zwrk = (1.0 - cff4) * zeta_new + cff4 * zeta_p
        zeta_new = zbc(zeta_new)

        rhs_ubar, rhs_vbar = _rhs_momentum(cfg, grid, ubar_p, vbar_p, Drhs,
                                           DUon, DVom, zwrk, zwrk * zwrk)
        rhs_ubar = rhs_ubar + rufrc_c
        rhs_vbar = rhs_vbar + rvfrc_c

        cm1 = 0.5 * dtfast * 5.0 / 12.0
        cm2 = 0.5 * dtfast * 8.0 / 12.0
        cm3 = 0.5 * dtfast * 1.0 / 12.0
        ubar_new, vbar_new = _step_momentum(
            cfg, grid, fs.ubar_n, fs.vbar_n, fs.zeta_n + h, Dnew,
            cm1 * rhs_ubar + cm2 * fs.rubar_n - cm3 * fs.rubar_nm1,
            cm1 * rhs_vbar + cm2 * fs.rvbar_n - cm3 * fs.rvbar_nm1)
        ubar_new = ubc(ubar_new)
        vbar_new = vbc(vbar_new)
        return fs.replace(
            zeta_nm1=fs.zeta_n, zeta_n=zeta_new,
            ubar_nm1=fs.ubar_n, ubar_n=ubar_new,
            vbar_nm1=fs.vbar_n, vbar_n=vbar_new)

    # first corrector: cff2 = weight(2,iif) with iif=1 -> w2[0]
    fs = corrector(fs, zeta_p, ubar_p, vbar_p, w2[0])

    # ============== fast steps 2..nfast (LF / AM3) ==============
    for i in range(2, cfg.nfast + 1):
        Drhs, DUon, DVom = depth_fluxes(grid, fs.zeta_n, fs.ubar_n,
                                        fs.vbar_n)
        cff1 = w1[i - 2]                                  # weight(1,iif-1)
        cff2 = (8.0 / 12.0) * w2[i - 1] - (1.0 / 12.0) * w2[i]
        fs = fs.replace(
            Zt_avg1=fs.Zt_avg1 + cff1 * fs.zeta_n,
            DU_avg1=fs.DU_avg1 + cff1 * DUon,
            DV_avg1=fs.DV_avg1 + cff1 * DVom,
            DU_avg2=fs.DU_avg2 + cff2 * DUon,
            DV_avg2=fs.DV_avg2 + cff2 * DVom)

        rhs_zeta = (DUon - ip1(DUon)) + (DVom - jp1(DVom))
        zeta_new = (fs.zeta_nm1 + pmn * (2.0 * dtfast) * rhs_zeta) * \
            grid.rmask
        Dnew = zeta_new + h
        cff4 = 4.0 / 25.0
        cff5 = 1.0 - 2.0 * cff4
        zwrk = cff5 * fs.zeta_n + cff4 * (fs.zeta_nm1 + zeta_new)
        zeta_p = zbc(zeta_new)

        rhs_ubar, rhs_vbar = _rhs_momentum(cfg, grid, fs.ubar_n, fs.vbar_n,
                                           Drhs, DUon, DVom, zwrk,
                                           zwrk * zwrk)
        rhs_ubar = rhs_ubar + rufrc_c
        rhs_vbar = rhs_vbar + rvfrc_c

        ubar_p, vbar_p = _step_momentum(
            cfg, grid, fs.ubar_nm1, fs.vbar_nm1, fs.zeta_nm1 + h, Dnew,
            dtfast * rhs_ubar, dtfast * rhs_vbar)
        ubar_p = ubc(ubar_p)
        vbar_p = vbc(vbar_p)
        fs = fs.replace(
            rzeta_nm1=fs.rzeta_n, rzeta_n=bc.fill_halo(cfg, rhs_zeta),
            rubar_nm1=fs.rubar_n, rubar_n=rhs_ubar,
            rvbar_nm1=fs.rvbar_n, rvbar_n=rhs_vbar)
        # corrector: cff2 = (5/12)*weight(2,iif) -> w2[i-1]
        fs = corrector(fs, zeta_p, ubar_p, vbar_p, (5.0 / 12.0) * w2[i - 1])

    # ========== auxiliary predictor (iif = nfast+1): averages only ==========
    _, DUon, DVom = depth_fluxes(grid, fs.zeta_n, fs.ubar_n, fs.vbar_n)
    i = cfg.nfast + 1
    cff1 = w1[i - 2]
    cff2 = (8.0 / 12.0) * w2[i - 1] - (1.0 / 12.0) * w2[i]
    fs = fs.replace(
        Zt_avg1=bc.fill_halo(cfg, fs.Zt_avg1 + cff1 * fs.zeta_n),
        DU_avg1=bc.fill_halo(cfg, fs.DU_avg1 + cff1 * DUon),
        DV_avg1=bc.fill_halo(cfg, fs.DV_avg1 + cff1 * DVom),
        DU_avg2=bc.fill_halo(cfg, fs.DU_avg2 + cff2 * DUon),
        DV_avg2=bc.fill_halo(cfg, fs.DV_avg2 + cff2 * DVom))
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
    f64 = check_tensors(named, shapes, dtype, device)
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
