"""Baroclinic time-step orchestrator (counterpart of ``roms_tpu/stepping.py``;
main3d.F:183-868).

One call advances the State by one slow step, the nfast-substep barotropic
loop included, in main3d's order.  Ported here: the branches the UPWELLING
and BENCHMARK configurations take (analytic surface stress or COARE bulk
fluxes from an analytic atmosphere, linear or quadratic drag, constant
mixing coefficients or the KPP surface layer, prsgrd32, U3/C4/SPLINES
advection, harmonic viscosity, harmonic tracer diffusion along s-surfaces
or rotated to geopotential surfaces).  Every other branch raises
NotImplementedError naming the missing feature.

Kernels: with ``cfg.pallas2d`` true (the default), the kernel stages go
through their wrappers (ops/diag_cuda.py, prsgrd_cuda.py, rhs3d_cuda.py,
mix3d_cuda.py, step3d_cuda.py, step2d_cuda.py), in the JAX step's default
dispatch: where ``rhs3d_cuda.use_kernels`` holds (as the JAX gate
``rhs3d_pallas.use_pallas``), the momentum phase is one
``rhs3d_cuda.momentum_rhs`` call (prsgrd32, rhs3d with the momentum start,
uv3dmix2); otherwise its stages run one by one, uv3dmix2 as kernel or
plain by ``mix3d_cuda.use_kernels``, which also sends the geopotential
tracer diffusion to ``mix3d_cuda.t3dmix2_geo`` or its plain version.  The
wrappers launch the CUDA kernels for CUDA tensors and take the plain
versions for CPU tensors.  ``cfg.pallas2d=False`` runs the plain versions
on any device.
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
from .ops.bulk_flux import bulk_flux
from .ops.mix3d import t3dmix2
from .ops.vmix import lmd_vmix, swfrac
from .ops.pre_step3d import ab3_start_coefs, momentum_init
from .ops.rhs3d import rhs3d_momentum
from .ops.step2d import Fast2DState
from .ops.vbc import set_vbc

DIAGS_NOT_PORTED = "budget diagnostics (collect_diags)"
_FORCING_KEYS = {"sustr", "svstr", "stflux", "btflux"}
# the analytic atmosphere that feeds the bulk fluxes (cfg.bulk_fluxes)
_BULK_KEYS = {"Uwind", "Vwind", "Tair", "Pair", "Hair", "cloud", "rain",
              "srflx", "btflux"}


def _check_slice(cfg: Config, grid: Grid, frc: dict, collect_diags: bool):
    """Raise NotImplementedError for every branch of the reference step
    that this port does not have yet."""
    missing = []
    if collect_diags:
        missing.append(DIAGS_NOT_PORTED)
    if grid.zice is not None:
        missing.append("ice shelf (ICESHELF)")
    if cfg.sediment or cfg.sed_params is not None:
        missing.append("sediment (SEDIMENT)")
    if cfg.nearshore is not None:
        missing.append(f"nearshore radiation stress ({cfg.nearshore})")
    if cfg.bbl is not None:
        missing.append(f"bottom boundary layer ({cfg.bbl})")
    if cfg.vmix not in (None, "kpp"):
        missing.append(f"vertical mixing closure ({cfg.vmix})")
    if cfg.vmix == "kpp" and cfg.kpp_bottom:
        missing.append("KPP bottom boundary layer (LMD_BKPP)")
    if cfg.vmix == "kpp" and cfg.lmd_ddmix and cfg.ntracers >= 2:
        missing.append("KPP double-diffusive mixing (LMD_DDMIX)")
    if cfg.tide_gen_forces:
        missing.append("tide-generating forces")
    if any(x != 0.0 for x in cfg.tnu2) and cfg.ts_mix_iso:
        missing.append("isopycnal harmonic tracer mixing (MIX_ISO_TS)")
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
    extra = set(frc) - (_BULK_KEYS if cfg.bulk_fluxes else _FORCING_KEYS)
    if extra:
        missing.append(f"forcing fields {sorted(extra)}")
    if missing:
        raise NotImplementedError("not ported: " + "; ".join(missing))


def step(cfg: Config, grid: Grid, state: State,
         forcing_fn: Optional[Callable] = None,
         collect_diags: bool = False) -> State:
    """One slow (baroclinic) step.  forcing_fn(cfg, grid, time) returns a
    dict with sustr, svstr (kinematic wind stress, m2/s2) and stflux,
    btflux ((NT,Ny,Nx) surface/bottom tracer fluxes); with cfg.bulk_fluxes
    it returns the atmosphere instead (Uwind, Vwind, Tair, Pair, Hair,
    cloud, rain, srflx), from which the COARE fluxes give the stress and
    the surface heat flux."""
    frc = forcing_fn(cfg, grid, state.time) if forcing_fn is not None else {}
    _check_slice(cfg, grid, frc, collect_diags)
    hc = hc_of(cfg)
    iic = state.iic
    zero2 = torch.zeros_like(state.zeta)
    nt = max(cfg.ntracers, 1)
    zero_nt = torch.zeros((nt,) + zero2.shape, dtype=zero2.dtype,
                          device=zero2.device)
    srflx = None
    if cfg.bulk_fluxes:
        # COARE air-sea fluxes from the atmosphere and the SST
        # (main3d.F:386)
        srflx = frc.get("srflx", zero2)
        blk = bulk_flux(
            cfg, grid, state.t[0, -1], srflx,
            frc.get("Uwind", zero2), frc.get("Vwind", zero2),
            frc.get("Tair", zero2), frc.get("Pair", zero2 + 1013.0),
            frc.get("Hair", zero2), frc.get("cloud", zero2),
            frc.get("rain", zero2))
        sustr = blk["sustr"]
        svstr = blk["svstr"]
        stflux = torch.cat([blk["stflux_temp"][None], zero_nt[1:]], dim=0)
    else:
        sustr = frc.get("sustr", zero2)
        svstr = frc.get("svstr", zero2)
        stflux = frc.get("stflux", zero_nt)
    btflux = frc.get("btflux", torch.zeros_like(stflux))

    # --- vertical grid, mass fluxes and omega at time n (main3d.F:307,474)
    #     and density (main3d.F:314) ---
    kernels = cfg.pallas2d and diag_cuda.supported(cfg, grid)
    grid_flux = diag_cuda.grid_flux if kernels else diag_cuda.grid_flux_plain
    rho_eos = diag_cuda.eos if kernels else diag_cuda.eos_plain
    z_r, z_w, Hz, Huon, Hvom, W = grid_flux(cfg, grid, state.zeta, state.u,
                                            state.v, hc)
    kpp = cfg.vmix == "kpp"
    rho, pden, *bvf = rho_eos(cfg, state.t, z_r, z_w, want_bvf=kpp)

    # --- surface/bottom fluxes (main3d.F:386-396) ---
    bustr, bvstr, stflx, btflx = set_vbc(cfg, grid, state.u, state.v,
                                         state.t, stflux, btflux)

    # --- vertical mixing coefficients (main3d.F:465-469): KPP, or the
    #     constant background values (vmix None) ---
    hsbl, hbbl = state.hsbl, state.hbbl
    ghats = swdk_w = None
    if kpp:
        Akv, Akt, hsbl, hbbl, ghats = lmd_vmix(
            cfg, grid, state.u, state.v, state.t, rho, pden, bvf[0], Hz,
            z_r, z_w, sustr, svstr, bustr, bvstr, stflx,
            srflx if srflx is not None else zero2, hsbl, btflx=btflx,
            hbbl_prev=hbbl)
        if srflx is not None:
            swdk_w = swfrac(z_w[-1][None] - z_w)
    else:
        Akv, Akt = state.Akv, state.Akt

    # --- rhs3d phase (main3d.F:563): pre_step3d, prsgrd, t3dmix, rhs,
    #     uv3dmix ---
    tr_kernels = step3d_cuda.use_tracer(cfg)
    tracer_predictor = step3d_cuda.tracer_predictor if tr_kernels \
        else step3d_cuda.tracer_predictor_plain
    t3, t_nnew = tracer_predictor(cfg, grid, iic, state.t, state.t_prev, Hz,
                                  Huon, Hvom, W, Akt, stflx, btflx,
                                  srflx=srflx, ghats=ghats, swdk_w=swdk_w)
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
        if cfg.ts_mix_geo:
            t3dmix2_geo = mix3d_cuda.t3dmix2_geo \
                if mix3d_cuda.use_kernels(cfg) \
                else mix3d_cuda.t3dmix2_geo_plain
            t_nnew = t3dmix2_geo(cfg, grid, state.t, Hz, z_r, t_nnew, cfg.dt)
        else:
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
        Akv=Akv, Akt=Akt, hsbl=hsbl, hbbl=hbbl,
        tke_prev=state.tke, gls_prev=state.gls,
        DU_avg1=fs.DU_avg1, DV_avg1=fs.DV_avg1,
        DU_avg2=fs.DU_avg2, DV_avg2=fs.DV_avg2)


def _check_nfast(cfg: Config):
    if cfg.nfast <= 0:
        raise ValueError(
            "cfg.nfast is 0 - the fast barotropic loop would be empty. "
            "Use the cfg returned by build_grid/the case builder "
            "(it finalizes hmin and nfast).")


def make_stepper(cfg: Config, grid: Grid,
                 forcing_fn: Optional[Callable] = None):
    """Single-step function state -> state."""
    _check_nfast(cfg)
    return lambda s: step(cfg, grid, s, forcing_fn)


def run(cfg: Config, grid: Grid, state: State, nsteps: int,
        forcing_fn: Optional[Callable] = None) -> State:
    """Advance nsteps slow steps."""
    _check_nfast(cfg)
    for _ in range(nsteps):
        state = step(cfg, grid, state, forcing_fn)
    return state


def run_accum(cfg: Config, grid: Grid, state: State, nsteps: int,
              forcing_fn: Optional[Callable] = None,
              fields: tuple = ("zeta", "ubar", "vbar", "u", "v", "t"),
              derived: Optional[dict] = None):
    """Advance nsteps and sum the named State fields over the steps, on
    the state's device and in its dtype (the mod_average.F accumulators,
    sampled every step as set_avg.F does).

    derived: optional {name: fn(cfg, grid, state) -> tensor} computed and
    summed alongside (the set_avg.F:2352-3952 quadratic/derived fields:
    u*u, Huon means, rho, ...).  Each sum starts from zeros and adds one
    step at a time, the JAX scan's order.  Returns (state, sums dict)."""
    _check_nfast(cfg)
    if nsteps < 1:
        raise ValueError(f"run_accum needs nsteps >= 1, not {nsteps}")
    derived = derived or {}
    sums = None
    for _ in range(nsteps):
        state = step(cfg, grid, state, forcing_fn)
        vals = {**{k: getattr(state, k) for k in fields},
                **{k: fn(cfg, grid, state) for k, fn in derived.items()}}
        if sums is None:
            sums = {k: torch.zeros_like(v) for k, v in vals.items()}
        for k, v in vals.items():
            sums[k].add_(v)
    return state, sums
