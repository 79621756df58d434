"""Baroclinic time-step orchestrator (counterpart of ``roms_tpu/stepping.py``;
main3d.F:183-868).

One call advances the State by one slow step, the nfast-substep barotropic
loop included, in main3d's order.  Every branch of roms_tpu's step is
ported: the ones the cases of models/ and the file-driven case take
(analytic or file surface
stress and heat flux, or COARE bulk fluxes from an analytic atmosphere;
linear, quadratic or logarithmic drag, or the SSW, MB or SG wave-current
bottom boundary layer with the wave fields Hwave/Pwave/Dwave; constant
mixing coefficients (vmix None or "none"), Brunt-Vaisala mixing ("bvf"),
the KPP surface and bottom layers with double diffusion, GLS, or MY2.5;
all five pressure-gradient schemes, djs with the tide-generating force;
C2/U1/U3/C4/A4/SPLINES/HSIMT/MPDATA advection; harmonic or biharmonic
viscosity along s-surfaces or geopotentials, with Smagorinsky's; harmonic
or biharmonic tracer diffusion along s-surfaces, geopotentials or
isopycnals; open boundaries with their `bry` data, volume conservation
and point sources; wetting-drying; climatology nudging of ubar/vbar, u/v
and the tracers through `clm`; curvilinear and periodic grids; the ice
shelf (`grid.zice`: the ice-base drag, the floating-ice load and the
displaced levels), mean-age tracer pairs (`cfg.inert_age`), the eight
biology models of the biology slot (`cfg.biology`, ops/biology.py and
ops/bio_models.py), suspended sediment with its bed layers, bedload and
SED_MORPH (`cfg.sed_params`), the stresses as body forces
(`cfg.bodyforce`), and the Mellor05/Mellor08 radiation stress with the
Stokes drift (`cfg.nearshore` with the forcing's Hwave)), and the
DIAGNOSTICS_TS/UV budgets (`collect_diags`).  _check_slice raises
NotImplementedError for a vertical closure or forcing fields outside
these.

Kernels: with ``cfg.pallas2d`` true (the default), the kernel stages go
through their wrappers (ops/diag_cuda.py, prsgrd_cuda.py, rhs3d_cuda.py,
mix3d_cuda.py, step3d_cuda.py, step2d_cuda.py), in the JAX step's default
dispatch: where ``rhs3d_cuda.use_kernels`` holds (as the JAX gate
``rhs3d_pallas.use_pallas``), the momentum phase is one
``rhs3d_cuda.momentum_rhs`` call (prsgrd32, rhs3d with the momentum start,
uv3dmix2); otherwise its stages run one by one, uv3dmix2 as kernel or
plain by ``mix3d_cuda.use_kernels``, which also sends the geopotential
tracer diffusion to ``mix3d_cuda.t3dmix2_geo`` or its plain version.  The
tracer, momentum-corrector and fast-loop kernels are taken where their
gates hold with the step's `bry`, `sources`, `clm` and the fast loop's
wet/dry masks (``step3d_cuda.use_tracer``/``use_uv``,
``step2d_cuda.supported``, as the JAX step asks
``step3d_pallas.use_tracer_pallas``/``use_uv_pallas`` and
``step2d_pallas.use_pallas``; `clm` and the budget diagnostics also keep
the momentum phase staged, as ``rhs3d_pallas.use_pallas`` does, and the
active radiation stress keeps grid_flux and eos plain, as roms_tpu's
``ns_active`` does); otherwise the step runs the general plain
stages (ops/pre_step3d.py, step3d_t.py, step3d_uv.py, step2d.fast_loop)
on whatever device the state is on.  The wrappers launch the CUDA kernels
for CUDA tensors and take the plain versions for CPU tensors.
``cfg.pallas2d=False`` runs the plain versions on any device.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional

import torch

from .config import Config
from .grid import Grid, hc_of
from .state import State
from . import vgrid
from .ops import bbl, diag_cuda, eos, gls as gls_mod, mix3d, mix3d_cuda, \
    nearshore, prsgrd, prsgrd_cuda, rhs3d_cuda, step2d, step2d_cuda, \
    step3d_cuda
from .ops.biology import apply_biology
from .ops.bulk_flux import bulk_flux
from .ops.my25 import my25_corstep
from .ops.omega import set_massflux
from .ops.sediment import apply_sediment, bed_thickness_total
from .ops.tides import equilibrium_tide, harmonic_constituents
from .ops.vmix import bvf_mix, lmd_vmix, swfrac
from .ops.pre_step3d import ab3_start_coefs, momentum_init
from .ops.rhs3d import rhs3d_momentum
from .ops.stencil import im1, ip1, jm1, jp1
from .ops.step2d import Fast2DState
from .ops.vbc import set_vbc
from .state import _initial_bed_mass

# open-boundary data and point sources, taken with either set below
_BOUNDARY_KEYS = {"bry", "sources"}
_FORCING_KEYS = {"sustr", "svstr", "stflux", "btflux", "srflx"}
# the analytic atmosphere that feeds the bulk fluxes (cfg.bulk_fluxes)
_BULK_KEYS = {"Uwind", "Vwind", "Tair", "Pair", "Hair", "cloud", "rain",
              "srflx", "btflux"}
# the wave fields the bottom boundary layers, GLS and the nearshore
# radiation stress read
_WAVE_KEYS = {"Hwave", "Pwave", "Dwave", "Lwave"}
# the fields a biology model reads from the forcing besides the surface
# fluxes: the winds of the air-sea gas exchange, the respiration rate and
# the red tide's cyst map and DIN climatology
_BIO_KEYS = {"fennel": {"Uwind", "Vwind"},
             "hypoxia_srm": {"Uwind", "Vwind", "respiration"},
             "red_tide": {"CystIni", "DIN_obs"}}


def _check_slice(cfg: Config, frc: dict):
    """Raise NotImplementedError for a vertical closure other than the
    ported ones and for forcing fields outside the set the step reads (a
    biology model's own fields, _BIO_KEYS, under that model only)."""
    missing = []
    if cfg.vmix not in (None, "none", "kpp", "gls", "bvf", "my25"):
        missing.append(f"vertical mixing closure ({cfg.vmix})")
    extra = set(frc) - (_BULK_KEYS if cfg.bulk_fluxes else _FORCING_KEYS) \
        - _BOUNDARY_KEYS - {"clm"} - _WAVE_KEYS - \
        _BIO_KEYS.get(cfg.biology, set())
    if extra:
        missing.append(f"forcing fields {sorted(extra)}")
    if missing:
        raise NotImplementedError("not ported: " + "; ".join(missing))


def _under_ice(cfg: Config, grid: Grid, state: State, sustr, svstr,
               stflux, srflx):
    """ICESHELF surface fluxes (set_vbc.F:380-510): under the ice shelf the
    wind stress gives way to the ice-base drag on the top layer (the sea
    bed's drag law) and the surface tracer and shortwave fluxes vanish.
    Returns (sustr, svstr, stflux, srflx)."""
    icy = torch.abs(grid.zice) > 0.0
    icy_u = icy & im1(icy)
    icy_v = icy & jm1(icy)
    uN, vN = state.u[-1], state.v[-1]
    if cfg.bottom_drag == "linear":
        tau_iu = -cfg.rdrg * uN
        tau_iv = -cfg.rdrg * vN
    else:
        v_at_u = 0.25 * (vN + jp1(vN) + im1(vN) + im1(jp1(vN)))
        u_at_v = 0.25 * (uN + ip1(uN) + jm1(uN) + jm1(ip1(uN)))
        tau_iu = -cfg.rdrg2 * uN * torch.sqrt(uN ** 2 + v_at_u ** 2)
        tau_iv = -cfg.rdrg2 * vN * torch.sqrt(vN ** 2 + u_at_v ** 2)
    sustr = torch.where(icy_u, tau_iu, sustr)
    svstr = torch.where(icy_v, tau_iv, svstr)
    stflux = torch.where(icy[None], torch.zeros_like(stflux), stflux)
    if srflx is not None:
        srflx = torch.where(icy, torch.zeros_like(srflx), srflx)
    return sustr, svstr, stflux, srflx


def step(cfg: Config, grid: Grid, state: State,
         forcing_fn: Optional[Callable] = None,
         collect_diags: bool = False):
    """One slow (baroclinic) step.  forcing_fn(cfg, grid, time) returns a
    dict with sustr, svstr (kinematic wind stress, m2/s2), stflux, btflux
    ((NT,Ny,Nx) surface/bottom tracer fluxes) and srflx; with
    cfg.bulk_fluxes it returns the atmosphere instead (Uwind, Vwind, Tair,
    Pair, Hair, cloud, rain, srflx), from which the COARE fluxes give the
    stress and the surface heat flux.  Either may add "bry" (open-boundary
    data, ops/obc.py), "sources" (ops/sources.PointSources), "clm"
    (climatology and nudging coefficients: ubarclm/vbarclm with m2nudg,
    uclm/vclm with m3nudg, tclm with tnudg) and the wave fields Hwave,
    Pwave, Dwave and Lwave at rho points (the bottom boundary layers read
    the first three, GLS's surface roughness Hwave; with cfg.nearshore,
    Hwave switches the radiation stress on and it reads all but Pwave).

    collect_diags (DIAGNOSTICS_TS + DIAGNOSTICS_UV; mod_diags.F
    DiaTrc/DiaRU/DiaRV): return (state, the step's budget dict) instead of
    the state.  Tracer keys xadv/yadv/vadv/vdiff (from step3d_t), hdiff
    (t3dmix) and rate (the total change of t): concentration increments
    a step.  Momentum keys u_/v_ x {prestep, prsgrd, cor, xadv, yadv,
    vadv, hvisc, vvisc, rate}: velocity increments a step (m/s) at u/v
    points, with rate = the sum of the terms exactly.  roms_tpu's deltas
    from the reference's accumulation are kept: the terms use this step's
    AB3-weighted rhs (the reference spreads each term over its 3-step AB3
    history); pre_step3d's predictor contribution is one "prestep"
    bucket; "vvisc" is the closure remainder (the implicit vertical
    viscosity, the barotropic-mean replacement, the lateral BCs, masking
    and clm nudging), the reference's M3vvis analog."""
    frc = forcing_fn(cfg, grid, state.time) if forcing_fn is not None else {}
    _check_slice(cfg, frc)
    hc = hc_of(cfg)
    iic = state.iic
    zero2 = torch.zeros_like(state.zeta)
    nt = max(cfg.ntracers, 1)
    zero_nt = torch.zeros((nt,) + zero2.shape, dtype=zero2.dtype,
                          device=zero2.device)
    srflx = frc.get("srflx")
    bry = frc.get("bry")
    sources = frc.get("sources")
    clm = frc.get("clm")
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
    if grid.zice is not None:
        sustr, svstr, stflux, srflx = _under_ice(cfg, grid, state, sustr,
                                                 svstr, stflux, srflx)

    # --- SED_MORPH: the bed-thickness change reaches h (set_depth.F
    #     :166,214; deposition shoals the column).  grid.h is the virgin
    #     bathymetry; the offset is the evolving bed's departure from the
    #     configuration's initial bed ---
    sed = cfg.sed_params if cfg.sediment else None
    if sed is not None and sed.sed_morph:
        thick0 = bed_thickness_total(sed, _initial_bed_mass(cfg, zero2.device))
        grid = dataclasses.replace(
            grid, h=grid.h - (bed_thickness_total(sed, state.bed_mass) -
                              thick0))

    # --- vertical grid, mass fluxes and omega at time n (main3d.F:307,474)
    #     and density (main3d.F:314); the radiation stress keeps them
    #     plain, with omega from the fluxes that carry the Stokes transport
    #     (set_massflux.F:140-160) ---
    ns_active = cfg.nearshore in ("mellor05", "mellor08") and "Hwave" in frc
    kernels = cfg.pallas2d and diag_cuda.supported(cfg, grid) and \
        not ns_active
    rho_eos = diag_cuda.eos if kernels else diag_cuda.eos_plain
    if ns_active:
        z_r, z_w, Hz = vgrid.set_depth(grid.h, state.zeta, hc, grid.sc_r,
                                       grid.Cs_r, grid.sc_w, grid.Cs_w,
                                       cfg.vtransform, zice=grid.zice)
        Huon, Hvom = set_massflux(cfg, grid, state.u, state.v, Hz)
    else:
        grid_flux = diag_cuda.grid_flux if kernels \
            else diag_cuda.grid_flux_plain
        z_r, z_w, Hz, Huon, Hvom, W = grid_flux(cfg, grid, state.zeta,
                                                state.u, state.v, hc)
    kpp = cfg.vmix == "kpp"
    rho, pden, *bvf = rho_eos(cfg, state.t, z_r, z_w,
                              want_bvf=cfg.vmix in ("kpp", "bvf"))
    ns = None
    if ns_active:
        # wave radiation stresses and Stokes drift (main3d's
        # radiation_stress call)
        waves = (frc["Hwave"], frc.get("Dwave", zero2),
                 frc.get("Lwave", zero2 + 100.0))
        if cfg.nearshore == "mellor08":
            ns = nearshore.radiation_stress08(cfg, grid, state.zeta, Hz, z_r,
                                              grid.Cs_r, grid.Cs_w, *waves)
        else:
            ns = nearshore.radiation_stress(cfg, grid, state.zeta, Hz,
                                            grid.Cs_r, grid.Cs_w, *waves)
        Huon = Huon + 0.5 * (Hz + torch.roll(Hz, 1, -1)) * ns.u_stokes * \
            grid.on_u
        Hvom = Hvom + 0.5 * (Hz + torch.roll(Hz, 1, -2)) * ns.v_stokes * \
            grid.om_v
        W = diag_cuda.omega_plain(cfg, grid, Huon, Hvom, z_w)

    # --- surface/bottom fluxes (main3d.F:386-396) ---
    bustr, bvstr, stflx, btflx = set_vbc(cfg, grid, state.u, state.v,
                                         state.t, stflux, btflux,
                                         z_r=z_r, z_w=z_w)

    # --- wave-current bottom boundary layer (main3d.F:389 bblm): it
    #     replaces the drag law's bottom stress and gives sediment the
    #     maximum combined stress; another cfg.bbl runs none, as in
    #     roms_tpu ---
    rheight, rlength, tau_cwmax = state.rheight, state.rlength, \
        state.tau_cwmax
    if cfg.bbl in ("ssw", "sg", "mb"):
        waves = (frc.get("Hwave", zero2), frc.get("Pwave", zero2 + 8.0),
                 frc.get("Dwave", zero2))
        if cfg.bbl == "ssw":
            out = bbl.bblm(cfg, grid, cfg.bbl_params or bbl.BBLParams(),
                           state.u, state.v, z_r, z_w, *waves, state.rheight,
                           state.rlength, state.tau_cwmax)
        elif cfg.bbl == "sg":
            out = bbl.bblm_sg(cfg, grid, cfg.bbl_params or bbl.SGBBLParams(),
                              state.u, state.v, z_r, z_w, rho[0], *waves)
        else:
            out = bbl.bblm_mb(cfg, grid, cfg.bbl_params or bbl.MBBBLParams(),
                              state.u, state.v, z_r, z_w, rho[0], *waves,
                              state.rheight, state.rlength)
        bustr, bvstr, tau_c_b, tau_w_b, tau_cwmax, rheight, rlength = out

    # --- vertical mixing coefficients (main3d.F:465-469): KPP, BVF, or
    #     last step's values (constant background with vmix None or
    #     "none"; GLS updates them in its corrector below) ---
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
    elif cfg.vmix == "bvf":
        Akv, Akt = bvf_mix(cfg, bvf[0])
    else:
        Akv, Akt = state.Akv, state.Akt

    # --- rhs3d phase (main3d.F:563): pre_step3d, prsgrd, t3dmix, rhs,
    #     uv3dmix ---
    tr_kernels = step3d_cuda.use_tracer(cfg, bry=bry, clm=clm,
                                        sources=sources,
                                        want_diags=collect_diags)
    if tr_kernels:
        t3, t_nnew = step3d_cuda.tracer_predictor(
            cfg, grid, iic, state.t, state.t_prev, Hz, Huon, Hvom, W, Akt,
            stflx, btflx, srflx=srflx, ghats=ghats, swdk_w=swdk_w)
    else:
        t3, t_nnew = step3d_cuda.tracer_predictor_plain(
            cfg, grid, iic, state.t, state.t_prev, Hz, Huon, Hvom, W, Akt,
            stflx, btflx, srflx=srflx, ghats=ghats, swdk_w=swdk_w,
            sources=sources)
    eq_tide = None
    if cfg.tide_gen_forces:
        # equilibrium-tide body force, through prsgrd32's surface pressure
        # (main3d.F equilibrium_tide call)
        eq_tide = equilibrium_tide(
            grid, state.time, harmonic_constituents(cfg.tide_ref_datenum))
    if grid.zice is not None:
        # floating-ice load: the water pressure at the ice base carries the
        # weight of the displaced water column, g*|zice|*(1 + rho'/rho0)
        # with rho' just below the ice base, through prsgrd's surface
        # pressure slot (roms_tpu's reduced-pressure form of ICESHELF)
        ice_load = -torch.abs(grid.zice) * (1.0 + rho[-1] / cfg.rho0)
        eq_tide = ice_load if eq_tide is None else eq_tide + ice_load
    if rhs3d_cuda.use_kernels(cfg, clm=clm, want_diags=collect_diags):
        # momentum_init -> prsgrd32 -> rhs3d -> uv3dmix2 as one phase
        u_nnew, v_nnew, ru, rv, rufrc, rvfrc = rhs3d_cuda.momentum_rhs(
            cfg, grid, iic, state.u, state.v, Hz, z_r, z_w, rho, Huon, Hvom,
            W, state.ru_prev, state.ru_prev2, state.rv_prev, state.rv_prev2,
            sustr, svstr, bustr, bvstr, eq_tide=eq_tide)
        if ns is not None:
            ru, rv, rufrc, rvfrc = _radiation_force(ns, ru, rv, rufrc,
                                                    rvfrc)
    else:
        a1, a2 = ab3_start_coefs(iic)
        u_nnew, v_nnew = momentum_init(
            cfg, grid.pm, grid.pn, a1, a2, state.u, state.v, Hz,
            state.ru_prev, state.ru_prev2, state.rv_prev, state.rv_prev2,
            sustr, svstr, bustr, bvstr)
        pgf = prsgrd_cuda.prsgrd32 if prsgrd_cuda.supported(cfg) \
            else prsgrd.prsgrd
        ru, rv = pgf(cfg, grid, rho, z_r, z_w, Hz, eq_tide=eq_tide)
        if collect_diags:
            # the budget terms' snapshots: the pressure gradient, and the
            # momentum start before the viscosity (whose kernel updates
            # u_nnew and v_nnew in place)
            ru_prs, rv_prs = ru, rv
            u_nnew_pre, v_nnew_pre = u_nnew.clone(), v_nnew.clone()
        ru, rv, rufrc, rvfrc, *dia_rhs = rhs3d_momentum(
            cfg, grid, state.u, state.v, Huon, Hvom, W, Hz, ru, rv,
            sustr, svstr, bustr, bvstr, clm=clm, want_diags=collect_diags)
        if ns is not None:
            ru, rv, rufrc, rvfrc = _radiation_force(ns, ru, rv, rufrc,
                                                    rvfrc)
        if cfg.uv_vis2 and cfg.visc2 != 0.0:
            if cfg.uv_mix_geo:
                u_nnew, v_nnew, rufrc, rvfrc = mix3d.uv3dmix2_geo(
                    cfg, grid, state.u, state.v, Hz, z_r, u_nnew, v_nnew,
                    rufrc, rvfrc, cfg.dt)
            else:
                uv3dmix2 = mix3d_cuda.uv3dmix2 \
                    if mix3d_cuda.use_kernels(cfg) \
                    else mix3d_cuda.uv3dmix2_plain
                u_nnew, v_nnew, rufrc, rvfrc = uv3dmix2(
                    cfg, grid, state.u, state.v, Hz, u_nnew, v_nnew, rufrc,
                    rvfrc, cfg.dt)
    if cfg.uv_vis4 and cfg.visc4 != 0.0:
        if cfg.uv_mix_geo:
            u_nnew, v_nnew, rufrc, rvfrc = mix3d.uv3dmix4_geo(
                cfg, grid, state.u, state.v, Hz, z_r, u_nnew, v_nnew, rufrc,
                rvfrc, cfg.dt)
        else:
            u_nnew, v_nnew, rufrc, rvfrc = mix3d.uv3dmix4(
                cfg, grid, state.u, state.v, Hz, u_nnew, v_nnew, rufrc,
                rvfrc, cfg.dt)
    # tracer mixing (main3d's t3dmix): harmonic, then biharmonic, each
    # along isopycnals, geopotentials or s-surfaces
    # (t3dmix2_geo's kernel updates t_nnew in place)
    t_nnew_premix = t_nnew.clone() if collect_diags else None
    if any(x != 0.0 for x in cfg.tnu2):
        if cfg.ts_mix_iso:
            t_nnew = mix3d.t3dmix2_iso(cfg, grid, state.t, pden, Hz, z_r,
                                       t_nnew, cfg.dt)
        elif cfg.ts_mix_geo:
            t3dmix2_geo = mix3d_cuda.t3dmix2_geo \
                if mix3d_cuda.use_kernels(cfg) \
                else mix3d_cuda.t3dmix2_geo_plain
            t_nnew = t3dmix2_geo(cfg, grid, state.t, Hz, z_r, t_nnew, cfg.dt)
        else:
            t_nnew = mix3d.t3dmix2(cfg, grid, state.t, Hz, t_nnew, cfg.dt)
    if cfg.ts_dif4 and any(x != 0.0 for x in cfg.tnu4):
        if cfg.ts_mix_iso:
            t_nnew = mix3d.t3dmix4_iso(cfg, grid, state.t, pden, Hz, z_r,
                                       t_nnew, cfg.dt)
        elif cfg.ts_mix_geo:
            t_nnew = mix3d.t3dmix4_geo(cfg, grid, state.t, Hz, z_r, t_nnew,
                                       cfg.dt)
        else:
            t_nnew = mix3d.t3dmix4(cfg, grid, state.t, Hz, t_nnew, cfg.dt)

    # --- GLS predictor (main3d.F:565-567); my25_prestep.F is
    #     gls_prestep.F ---
    if cfg.vmix in ("gls", "my25"):
        tke3, gls3, tke_nnew, gls_nnew = gls_mod.gls_prestep(
            cfg, grid, cfg.gls_params, iic, state.tke, state.gls,
            state.tke_prev, state.gls_prev, Hz, Huon, Hvom, W)

    # --- fast barotropic loop (main3d.F:592-713): the fused kernel where
    #     its gate holds, else the general loop, which also returns the
    #     averaged wet/dry masks under WET_DRY.  Every field is its own
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
    wet = None
    us2d = None
    if ns is not None:
        us2d = step2d.stokes_transport(grid, state.zeta,
                                       (ns.ubar_stokes, ns.vbar_stokes))
    if cfg.pallas2d and step2d_cuda.supported(cfg, bry, sources, clm):
        fs, rufrc_c, rvfrc_c = step2d_cuda.fast_loop(
            cfg, grid, fs, rufrc, rvfrc, state.rufrc0_prev,
            state.rufrc0_prev2, state.rvfrc0_prev, state.rvfrc0_prev2, iic)
    else:
        fs, rufrc_c, rvfrc_c, wet = step2d.fast_loop(
            cfg, grid, fs, rufrc, rvfrc, state.rufrc0_prev,
            state.rufrc0_prev2, state.rvfrc0_prev, state.rvfrc0_prev2, iic,
            bry=bry, sources=sources, clm=clm, us2d=us2d)

    # --- new depths from the filtered free surface (main3d.F:736) ---
    z_r2, z_w2, Hz2 = vgrid.set_depth(grid.h, fs.Zt_avg1, hc, grid.sc_r,
                                      grid.Cs_r, grid.sc_w, grid.Cs_w,
                                      cfg.vtransform, zice=grid.zice)

    # --- 3D momentum corrector (main3d.F:762).  Under the radiation
    #     stress the time-centred target DU_avg2 is Eulerian + Stokes; the
    #     corrector takes the Eulerian part (step3d_uv.F:473 DCs) ---
    DU2_t, DV2_t = fs.DU_avg2, fs.DV_avg2
    if us2d is not None:
        DU2_t = DU2_t - us2d[0]
        DV2_t = DV2_t - us2d[1]
    if step3d_cuda.use_uv(cfg, bry=bry, sources=sources, wet=wet):
        u2, v2, ubar2, vbar2, Huon2, Hvom2 = step3d_cuda.uv_corrector(
            cfg, grid, iic, u_nnew, v_nnew, ru, rv, Hz2, Akv, fs.DU_avg1,
            fs.DV_avg1, DU2_t, DV2_t, Huon, Hvom)
    else:
        u2, v2, ubar2, vbar2, Huon2, Hvom2 = step3d_cuda.uv_corrector_plain(
            cfg, grid, iic, u_nnew, v_nnew, ru, rv, Hz2, Akv, fs.DU_avg1,
            fs.DV_avg1, DU2_t, DV2_t, Huon, Hvom, u_old=state.u,
            v_old=state.v, bry=bry, sources=sources, z_w_new=z_w2, wet=wet)
    if ns is not None:
        # tracer advection and omega see the total transport: the 3-D
        # Stokes flux keeps the u_stokes profile, its column sum pinned to
        # the frozen 2-D transport, so that sum_k Huon2 = DU_avg2 exactly
        Hz2_u = 0.5 * (Hz2 + torch.roll(Hz2, 1, -1))
        Hz2_v = 0.5 * (Hz2 + torch.roll(Hz2, 1, -2))
        FSu = Hz2_u * ns.u_stokes * grid.on_u
        FSv = Hz2_v * ns.v_stokes * grid.om_v
        D2_u = torch.sum(Hz2_u, dim=0)
        D2_v = torch.sum(Hz2_v, dim=0)
        FSu = FSu + (us2d[0] - torch.sum(FSu, dim=0)) * Hz2_u / D2_u
        FSv = FSv + (us2d[1] - torch.sum(FSv, dim=0)) * Hz2_v / D2_v
        Huon2 = Huon2 + FSu
        Hvom2 = Hvom2 + FSv
    if wet is not None:
        # the stored AB3 rhs history is limited too (step3d_uv.F:563)
        ru = ru * wet["umask_wet"]
        rv = rv * wet["vmask_wet"]

    if collect_diags:
        dia_uv = _momentum_budget(cfg, grid, state, iic, Hz2, u_nnew_pre,
                                  v_nnew_pre, u_nnew, v_nnew, ru_prs, rv_prs,
                                  dia_rhs[0], u2, v2)

    # --- omega with corrected fluxes (main3d.F:789) ---
    omega = diag_cuda.omega if diag_cuda.use_omega(cfg) \
        else diag_cuda.omega_plain
    W2 = omega(cfg, grid, Huon2, Hvom2, z_w2)

    # --- GLS corrector (main3d.F:791-793): new Akv/Akt for the tracer
    #     step ---
    tke_new, gls_new = state.tke, state.gls
    Akk_new, Akp_new, Lscale_new = state.Akk, state.Akp, state.Lscale
    if cfg.vmix == "my25":
        # the Mellor-Yamada 2.5 corrector (my25_corstep.F)
        bvf_g = eos.brunt_vaisala(cfg, state.t, z_r, z_w)
        (tke_new, gls_new, Akv, Akt, Akk_new, Lscale_new) = my25_corstep(
            cfg, grid, iic, state.tke, state.gls, tke3, gls3, tke_nnew,
            gls_nnew, state.u, state.v, bvf_g, Hz2, z_r2, z_w2, Huon2, Hvom2,
            W2, state.Akv, state.Akt, state.Akk, state.Lscale, sustr, svstr,
            bustr, bvstr, kantha_clayson=cfg.my25_kantha_clayson)
        Akp_new = Akk_new
    elif cfg.vmix == "gls":
        bvf_g = eos.brunt_vaisala(cfg, state.t, z_r, z_w)
        (tke_new, gls_new, Akv, Akt, Akk_new, Akp_new,
         Lscale_new) = gls_mod.gls_corstep(
            cfg, grid, cfg.gls_params, iic, state.tke, state.gls, tke3,
            gls3, tke_nnew, gls_nnew, state.u, state.v, bvf_g, Hz2, z_r2,
            z_w2, Huon2, Hvom2, W2, state.Akv, state.Akt, state.Akk,
            state.Akp, state.Lscale, sustr, svstr, bustr, bvstr,
            Hwave=frc.get("Hwave"))

    # --- tracer corrector (main3d.F:814) ---
    if tr_kernels:
        t2 = step3d_cuda.tracer_corrector(cfg, grid, t_nnew, t3, Huon2,
                                          Hvom2, W2, Hz2, z_r2, Akt)
    else:
        t2 = step3d_cuda.tracer_corrector_plain(
            cfg, grid, t_nnew, t3, Huon2, Hvom2, W2, Hz2, z_r2, Akt,
            t_old=state.t, bry=bry, sources=sources, clm=clm,
            want_diags=collect_diags)
        if collect_diags:
            t2, dia = t2
            dia["hdiff"] = (t_nnew - t_nnew_premix) / Hz2

    # --- mean-age tracer pairs (AGE_MEAN; step3d_t.F:1507-1539): the age
    #     concentration grows by dt times its conservative partner ---
    for icons, iage in cfg.inert_age:
        t_age = t2.clone()
        t_age[iage] = t2[iage] + cfg.dt * t2[icons]
        t2 = t_age

    # --- biological source and sink terms (main3d.F biology call): the
    #     increment from the old tracers onto the new ---
    if cfg.biology is not None:
        t2 = apply_biology(cfg, grid, state.t, t2, Hz2, z_w2, srflx,
                           z_r=z_r2, sustr=sustr, svstr=svstr,
                           uwind=frc.get("Uwind"), vwind=frc.get("Vwind"),
                           frc=frc, time=state.time)

    # --- sediment settling, erosion and bed exchange (main3d.F sediment
    #     call; Sediment/sediment.F) ---
    bed_mass = state.bed_mass
    if sed is not None:
        sed_kw = {}
        if cfg.bbl and sed.bedload_method == "soulsby":
            # the wave/current stress split and the wave-current angle of
            # the Soulsby-Damgaard rates (sed_bedload.F:391-403)
            phic = torch.atan2(0.5 * (bvstr + jp1(bvstr)),
                               0.5 * (bustr + ip1(bustr)))
            sed_kw = dict(tau_c=tau_c_b, tau_wav=tau_w_b,
                          phicw=1.5 * math.pi - frc.get("Dwave", zero2) -
                          phic - grid.angler)
        t2, bed_mass = apply_sediment(
            cfg, grid, sed, t2, bed_mass, Hz2, z_w2, bustr, bvstr,
            tau_cw=tau_cwmax if cfg.bbl else None, **sed_kw)

    new_state = state.replace(
        time=state.time + cfg.dt, iic=iic + 1,
        zeta=fs.Zt_avg1, ubar=ubar2, vbar=vbar2,
        u=u2, v=v2, t=t2, t_prev=state.t,
        ru_prev=ru, ru_prev2=state.ru_prev,
        rv_prev=rv, rv_prev2=state.rv_prev,
        rufrc0_prev=rufrc_c, rufrc0_prev2=state.rufrc0_prev,
        rvfrc0_prev=rvfrc_c, rvfrc0_prev2=state.rvfrc0_prev,
        rzeta=fs.rzeta_n, rubar=fs.rubar_n, rvbar=fs.rvbar_n,
        Akv=Akv, Akt=Akt, hsbl=hsbl, hbbl=hbbl,
        tke=tke_new, gls=gls_new, tke_prev=state.tke, gls_prev=state.gls,
        Akk=Akk_new, Akp=Akp_new, Lscale=Lscale_new,
        DU_avg1=fs.DU_avg1, DV_avg1=fs.DV_avg1,
        DU_avg2=fs.DU_avg2, DV_avg2=fs.DV_avg2, bed_mass=bed_mass,
        rheight=rheight, rlength=rlength, tau_cwmax=tau_cwmax)
    if collect_diags:
        dia["rate"] = new_state.t - state.t
        dia.update(dia_uv)
        return new_state, dia
    return new_state


def _radiation_force(ns, ru, rv, rufrc, rvfrc):
    """The radiation stress as a body force on ru/rv (rhs3d.F:994), its
    column sum on rufrc/rvfrc, so that the fast loop carries it."""
    return (ru - ns.rustr3d, rv - ns.rvstr3d, rufrc - ns.rustr2d,
            rvfrc - ns.rvstr2d)


def _momentum_budget(cfg: Config, grid: Grid, state: State, iic: int, Hz2,
                     u_nnew_pre, v_nnew_pre, u_nnew, v_nnew, ru_prs, rv_prs,
                     dia_rhs, u2, v2) -> dict:
    """The DIAGNOSTICS_UV increments of the step (see step's docstring):
    each rhs term times this step's AB3 weight, dt and the metric factor,
    over the new level thickness; vvisc closes rate = sum of the terms."""
    ab3 = 1.0 if iic == 0 else (1.5 if iic == 1 else 23.0 / 12.0)
    pm, pn = grid.pm, grid.pn
    DC0u = 0.25 * cfg.dt * ab3 * (pm + im1(pm)) * (pn + im1(pn))
    DC0v = 0.25 * cfg.dt * ab3 * (pm + jm1(pm)) * (pn + jm1(pn))
    oHz_u = 1.0 / (0.5 * (Hz2 + im1(Hz2)))
    oHz_v = 1.0 / (0.5 * (Hz2 + jm1(Hz2)))
    dia = {"u_prestep": u_nnew_pre * oHz_u - state.u,
           "v_prestep": v_nnew_pre * oHz_v - state.v,
           "u_hvisc": (u_nnew - u_nnew_pre) * oHz_u,
           "v_hvisc": (v_nnew - v_nnew_pre) * oHz_v,
           "u_prsgrd": DC0u * ru_prs * oHz_u,
           "v_prsgrd": DC0v * rv_prs * oHz_v}
    for key, (tu, tv) in dia_rhs.items():
        dia["u_" + key] = DC0u * tu * oHz_u
        dia["v_" + key] = DC0v * tv * oHz_v
    dia["u_rate"] = u2 - state.u
    dia["v_rate"] = v2 - state.v
    terms = ("prestep", "hvisc", "prsgrd", "cor", "xadv", "yadv", "vadv")
    for d in "uv":
        dia[d + "_vvisc"] = dia[d + "_rate"] - sum(dia[f"{d}_{k}"]
                                                   for k in terms)
    return dia


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
