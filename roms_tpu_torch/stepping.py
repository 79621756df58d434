"""Baroclinic time-step orchestrator (counterpart of ``roms_tpu/stepping.py``;
main3d.F:183-868).

One call advances the State by one slow step, the nfast-substep barotropic
loop included, in main3d's order.  Ported here: the branches the UPWELLING
configuration takes (analytic surface stress, linear or quadratic drag,
constant mixing coefficients, prsgrd32, U3/C4/SPLINES advection, harmonic
viscosity and diffusion).  Every other branch raises NotImplementedError
naming the missing feature.

Kernels: with ``cfg.pallas2d`` true (the default), the kernel stages go
through their wrappers (ops/diag_cuda.py, prsgrd_cuda.py, rhs3d_cuda.py,
mix3d_cuda.py, step3d_cuda.py, step2d_cuda.py), in the JAX step's default
dispatch: where ``rhs3d_cuda.use_kernels`` holds (as the JAX gate
``rhs3d_pallas.use_pallas``), the momentum phase is one
``rhs3d_cuda.momentum_rhs`` call (prsgrd32, rhs3d with the momentum start,
uv3dmix2); otherwise its stages run one by one, uv3dmix2 as kernel or
plain by ``mix3d_cuda.use_kernels``.  The wrappers launch the CUDA kernels
for CUDA tensors and take the plain versions for CPU tensors.
``cfg.pallas2d=False`` runs the plain versions on any device.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from .config import Config
from .grid import Grid, hc_of
from .state import State
from . import vgrid
from .ops import diag_cuda, mix3d_cuda, prsgrd, prsgrd_cuda, rhs3d_cuda, \
    step2d_cuda, step3d_cuda
from .ops.mix3d import t3dmix2
from .ops.pre_step3d import ab3_start_coefs, momentum_init
from .ops.rhs3d import rhs3d_momentum
from .ops.step2d import Fast2DState
from .ops.vbc import set_vbc

_FORCING_KEYS = {"sustr", "svstr", "stflux", "btflux"}


def _check_slice(cfg: Config, grid: Grid, frc: dict, collect_diags: bool):
    """Raise NotImplementedError for every branch of the reference step
    that this port does not have yet."""
    missing = []
    if collect_diags:
        missing.append("budget diagnostics (collect_diags)")
    if cfg.bulk_fluxes:
        missing.append("COARE bulk fluxes (BULK_FLUXES)")
    if grid.zice is not None:
        missing.append("ice shelf (ICESHELF)")
    if cfg.sediment or cfg.sed_params is not None:
        missing.append("sediment (SEDIMENT)")
    if cfg.nearshore is not None:
        missing.append(f"nearshore radiation stress ({cfg.nearshore})")
    if cfg.bbl is not None:
        missing.append(f"bottom boundary layer ({cfg.bbl})")
    if cfg.vmix is not None:
        missing.append(f"vertical mixing closure ({cfg.vmix})")
    if cfg.tide_gen_forces:
        missing.append("tide-generating forces")
    if any(x != 0.0 for x in cfg.tnu2) and (cfg.ts_mix_iso
                                            or cfg.ts_mix_geo):
        missing.append("rotated harmonic tracer mixing (MIX_ISO/GEO_TS)")
    if cfg.ts_dif4 and any(x != 0.0 for x in cfg.tnu4):
        missing.append("biharmonic tracer mixing (TS_DIF4)")
    if cfg.uv_vis4 and cfg.visc4 != 0.0:
        missing.append("biharmonic viscosity (UV_VIS4)")
    if cfg.uv_vis2 and cfg.visc2 != 0.0 and cfg.uv_mix_geo:
        missing.append("rotated viscosity (MIX_GEO_UV)")
    if cfg.inert_age:
        missing.append("mean-age tracers (AGE_MEAN)")
    if cfg.biology is not None:
        missing.append(f"biology ({cfg.biology})")
    if not step2d_cuda.supported(cfg):
        missing.append("the general fast loop (wetting-drying, volume "
                       "conservation, open boundaries, other BC kinds)")
    extra = set(frc) - _FORCING_KEYS
    if extra:
        missing.append(f"forcing fields {sorted(extra)}")
    if missing:
        raise NotImplementedError("not ported: " + "; ".join(missing))


def step(cfg: Config, grid: Grid, state: State,
         forcing_fn: Optional[Callable] = None,
         collect_diags: bool = False) -> State:
    """One slow (baroclinic) step.  forcing_fn(cfg, grid, time) returns a
    dict with sustr, svstr (kinematic wind stress, m2/s2) and stflux,
    btflux ((NT,Ny,Nx) surface/bottom tracer fluxes)."""
    frc = forcing_fn(cfg, grid, state.time) if forcing_fn is not None else {}
    _check_slice(cfg, grid, frc, collect_diags)
    hc = hc_of(cfg)
    iic = state.iic
    zero2 = torch.zeros_like(state.zeta)
    nt = max(cfg.ntracers, 1)
    sustr = frc.get("sustr", zero2)
    svstr = frc.get("svstr", zero2)
    stflux = frc.get("stflux", torch.zeros((nt,) + zero2.shape,
                                           dtype=zero2.dtype,
                                           device=zero2.device))
    btflux = frc.get("btflux", torch.zeros_like(stflux))

    # --- vertical grid, mass fluxes and omega at time n (main3d.F:307,474)
    #     and density (main3d.F:314) ---
    kernels = cfg.pallas2d and diag_cuda.supported(cfg, grid)
    grid_flux = diag_cuda.grid_flux if kernels else diag_cuda.grid_flux_plain
    rho_eos = diag_cuda.eos if kernels else diag_cuda.eos_plain
    z_r, z_w, Hz, Huon, Hvom, W = grid_flux(cfg, grid, state.zeta, state.u,
                                            state.v, hc)
    rho, pden = rho_eos(cfg, state.t, z_r, z_w, want_bvf=False)

    # --- surface/bottom fluxes (main3d.F:386-396) ---
    bustr, bvstr, stflx, btflx = set_vbc(cfg, grid, state.u, state.v,
                                         state.t, stflux, btflux)
    # constant background mixing coefficients (vmix None)
    Akv, Akt = state.Akv, state.Akt

    # --- rhs3d phase (main3d.F:563): pre_step3d, prsgrd, t3dmix, rhs,
    #     uv3dmix ---
    tr_kernels = step3d_cuda.use_tracer(cfg)
    tracer_predictor = step3d_cuda.tracer_predictor if tr_kernels \
        else step3d_cuda.tracer_predictor_plain
    t3, t_nnew = tracer_predictor(cfg, grid, iic, state.t, state.t_prev, Hz,
                                  Huon, Hvom, W, Akt, stflx, btflx)
    if rhs3d_cuda.use_kernels(cfg):
        # momentum_init -> prsgrd32 -> rhs3d -> uv3dmix2 as one phase
        u_nnew, v_nnew, ru, rv, rufrc, rvfrc = rhs3d_cuda.momentum_rhs(
            cfg, grid, iic, state.u, state.v, Hz, z_r, z_w, rho, Huon, Hvom,
            W, state.ru_prev, state.ru_prev2, state.rv_prev, state.rv_prev2,
            sustr, svstr, bustr, bvstr)
    else:
        a1, a2 = ab3_start_coefs(iic)
        u_nnew, v_nnew = momentum_init(
            cfg, grid.pm, grid.pn, a1, a2, state.u, state.v, Hz,
            state.ru_prev, state.ru_prev2, state.rv_prev, state.rv_prev2,
            sustr, svstr, bustr, bvstr)
        prsgrd32 = prsgrd_cuda.prsgrd32 if prsgrd_cuda.supported(cfg) \
            else prsgrd.prsgrd
        ru, rv = prsgrd32(cfg, grid, rho, z_r, z_w, Hz)
        ru, rv, rufrc, rvfrc = rhs3d_momentum(
            cfg, grid, state.u, state.v, Huon, Hvom, W, Hz, ru, rv,
            sustr, svstr, bustr, bvstr)
        if cfg.uv_vis2 and cfg.visc2 != 0.0:
            uv3dmix2 = mix3d_cuda.uv3dmix2 if mix3d_cuda.use_kernels(cfg) \
                else mix3d_cuda.uv3dmix2_plain
            u_nnew, v_nnew, rufrc, rvfrc = uv3dmix2(
                cfg, grid, state.u, state.v, Hz, u_nnew, v_nnew, rufrc,
                rvfrc, cfg.dt)
    if any(x != 0.0 for x in cfg.tnu2):
        t_nnew = t3dmix2(cfg, grid, state.t, Hz, t_nnew, cfg.dt)

    # --- fast barotropic loop (main3d.F:592-713).  Every field is its own
    #     tensor: the kernel updates them in place ---
    fs = Fast2DState(
        zeta_n=state.zeta.clone(), zeta_nm1=state.zeta.clone(),
        ubar_n=state.ubar.clone(), ubar_nm1=state.ubar.clone(),
        vbar_n=state.vbar.clone(), vbar_nm1=state.vbar.clone(),
        rzeta_n=state.rzeta.clone(), rzeta_nm1=torch.zeros_like(zero2),
        rubar_n=state.rubar.clone(), rubar_nm1=torch.zeros_like(zero2),
        rvbar_n=state.rvbar.clone(), rvbar_nm1=torch.zeros_like(zero2),
        Zt_avg1=torch.zeros_like(zero2), DU_avg1=torch.zeros_like(zero2),
        DV_avg1=torch.zeros_like(zero2), DU_avg2=torch.zeros_like(zero2),
        DV_avg2=torch.zeros_like(zero2))
    loop = step2d_cuda.fast_loop if cfg.pallas2d \
        else step2d_cuda.fast_loop_plain
    fs, rufrc_c, rvfrc_c = loop(
        cfg, grid, fs, rufrc, rvfrc, state.rufrc0_prev, state.rufrc0_prev2,
        state.rvfrc0_prev, state.rvfrc0_prev2, iic)

    # --- new depths from the filtered free surface (main3d.F:736) ---
    z_r2, z_w2, Hz2 = vgrid.set_depth(grid.h, fs.Zt_avg1, hc, grid.sc_r,
                                      grid.Cs_r, grid.sc_w, grid.Cs_w,
                                      cfg.vtransform)

    # --- 3D momentum corrector (main3d.F:762) ---
    uv_corrector = step3d_cuda.uv_corrector if step3d_cuda.use_uv(cfg) \
        else step3d_cuda.uv_corrector_plain
    u2, v2, ubar2, vbar2, Huon2, Hvom2 = uv_corrector(
        cfg, grid, iic, u_nnew, v_nnew, ru, rv, Hz2, Akv, fs.DU_avg1,
        fs.DV_avg1, fs.DU_avg2, fs.DV_avg2, Huon, Hvom)

    # --- omega with corrected fluxes (main3d.F:789) ---
    omega = diag_cuda.omega if cfg.pallas2d else diag_cuda.omega_plain
    W2 = omega(cfg, grid, Huon2, Hvom2, z_w2)

    # --- tracer corrector (main3d.F:814) ---
    tracer_corrector = step3d_cuda.tracer_corrector if tr_kernels \
        else step3d_cuda.tracer_corrector_plain
    t2 = tracer_corrector(cfg, grid, t_nnew, t3, Huon2, Hvom2, W2, Hz2, z_r2,
                          Akt)

    return state.replace(
        time=state.time + cfg.dt, iic=iic + 1,
        zeta=fs.Zt_avg1, ubar=ubar2, vbar=vbar2,
        u=u2, v=v2, t=t2, t_prev=state.t,
        ru_prev=ru, ru_prev2=state.ru_prev,
        rv_prev=rv, rv_prev2=state.rv_prev,
        rufrc0_prev=rufrc_c, rufrc0_prev2=state.rufrc0_prev,
        rvfrc0_prev=rvfrc_c, rvfrc0_prev2=state.rvfrc0_prev,
        rzeta=fs.rzeta_n, rubar=fs.rubar_n, rvbar=fs.rvbar_n,
        Akv=Akv, Akt=Akt,
        tke_prev=state.tke, gls_prev=state.gls,
        DU_avg1=fs.DU_avg1, DV_avg1=fs.DV_avg1,
        DU_avg2=fs.DU_avg2, DV_avg2=fs.DV_avg2)


def run(cfg: Config, grid: Grid, state: State, nsteps: int,
        forcing_fn: Optional[Callable] = None) -> State:
    """Advance nsteps slow steps."""
    if cfg.nfast <= 0:
        raise ValueError(
            "cfg.nfast is 0 - the fast barotropic loop would be empty. "
            "Use the cfg returned by build_grid/the case builder "
            "(it finalizes hmin and nfast).")
    for _ in range(nsteps):
        state = step(cfg, grid, state, forcing_fn)
    return state
