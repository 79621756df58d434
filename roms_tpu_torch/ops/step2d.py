"""The fast barotropic engine (counterpart of ``roms_tpu/ops/step2d.py``;
step2d_LF_AM3.h and the fast-loop index rotation of main3d.F:592-713 /
main2d.F:449-520).

Fast2DState carries the rotating storage of the reference's fast loop as
named fields.  depth_fluxes, _rhs_momentum and _step_momentum are the
building blocks of both entry points:

 * ``fast_loop``: SOLVE3D mode, the general plain loop of one slow step
   (open boundaries, volume conservation, point sources, wetting-drying
   and 2-D momentum climatology nudging), which the step takes where the
   fused kernel of ops/step2d_cuda.py does not apply, as the JAX step
   takes ``roms_tpu/ops/step2d.py::fast_loop`` where its Pallas kernel
   does not; with the nearshore forcing it also carries the frozen Stokes
   transport (``us2d``, ``stokes_transport``).
 * ``step_2d_only``: main2d mode (no SOLVE3D), one predictor/corrector
   pair a model step with the LF/AM3 history carried across steps and the
   surface and bottom stresses applied directly (SOLITON).  No kernel
   runs it, as no Pallas kernel runs roms_tpu's.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import NamedTuple, Optional

import torch

from .. import constants as C
from ..config import Config
from ..grid import Grid
from . import bc, obc, wetdry
from .stencil import ip1, im1, jp1, jm1, at_u, at_v, at_p

FS_FIELDS = ("zeta_n", "zeta_nm1", "ubar_n", "ubar_nm1", "vbar_n",
             "vbar_nm1", "rzeta_n", "rzeta_nm1", "rubar_n", "rubar_nm1",
             "rvbar_n", "rvbar_nm1", "Zt_avg1", "DU_avg1", "DV_avg1",
             "DU_avg2", "DV_avg2")


@dataclass
class Fast2DState:
    """Carried state of the fast loop (all (Ny,Nx) padded tensors):
    accepted fast levels n and n-1, the predictor RHS history, and the
    power-law filter accumulators (mod_coupling.F:12-49)."""
    zeta_n: torch.Tensor
    zeta_nm1: torch.Tensor
    ubar_n: torch.Tensor
    ubar_nm1: torch.Tensor
    vbar_n: torch.Tensor
    vbar_nm1: torch.Tensor
    rzeta_n: torch.Tensor
    rzeta_nm1: torch.Tensor
    rubar_n: torch.Tensor
    rubar_nm1: torch.Tensor
    rvbar_n: torch.Tensor
    rvbar_nm1: torch.Tensor
    Zt_avg1: torch.Tensor
    DU_avg1: torch.Tensor
    DV_avg1: torch.Tensor
    DU_avg2: torch.Tensor
    DV_avg2: torch.Tensor

    def replace(self, **kw) -> "Fast2DState":
        return dataclasses.replace(self, **kw)


def make_fast_state(cfg: Config, zeta, ubar, vbar) -> Fast2DState:
    """The 2-D-only mode's state at the start of a run: both fast levels at
    (zeta, ubar, vbar), the rhs history and the filter sums zero but
    Zt_avg1 = zeta."""
    z = torch.zeros_like(zeta)
    return Fast2DState(
        zeta_n=zeta, zeta_nm1=zeta, ubar_n=ubar, ubar_nm1=ubar,
        vbar_n=vbar, vbar_nm1=vbar,
        rzeta_n=z, rzeta_nm1=z, rubar_n=z, rubar_nm1=z,
        rvbar_n=z, rvbar_nm1=z,
        Zt_avg1=zeta, DU_avg1=z, DV_avg1=z, DU_avg2=z, DV_avg2=z)


class Forcing2D(NamedTuple):
    """Direct forcing of the 2-D-only mode: kinematic surface stresses
    (m2/s2) at u and v points.  In SOLVE3D mode the stresses enter through
    rufrc instead."""
    sustr: Optional[torch.Tensor] = None
    svstr: Optional[torch.Tensor] = None


def depth_fluxes(grid: Grid, zeta, ubar, vbar, us2d=None):
    """Total depth and vertically integrated mass fluxes
    (step2d_LF_AM3.h:499-516).  us2d: the depth-integrated Stokes
    transports (TSu, TSv), which NEARSHORE adds to the fluxes continuity
    and 2-D advection see (step2d_LF_AM3.h:529-541 DUSon/DVSom).  As in
    roms_tpu, the transport is held fixed over the fast loop (the reference
    rescales ubar_stokes by the instantaneous depth; the difference is
    O(ubar_stokes dzeta), a documented delta)."""
    Drhs = zeta + grid.h
    DUon = ubar * at_u(Drhs) * grid.on_u
    DVom = vbar * at_v(Drhs) * grid.om_v
    if us2d is not None:
        DUon = DUon + us2d[0]
        DVom = DVom + us2d[1]
    return Drhs, DUon, DVom


def stokes_transport(grid: Grid, zeta, us2d_vel):
    """The depth-integrated Stokes transports (TSu, TSv) of the vertical
    mean Stokes velocities at the step-start free surface."""
    us, vs = us2d_vel
    Drhs = zeta + grid.h
    return us * at_u(Drhs) * grid.on_u, vs * at_v(Drhs) * grid.om_v


def _g(cfg: Config) -> float:
    return cfg.g_override if cfg.g_override is not None else C.g


def _rhs_momentum(cfg: Config, grid: Grid, ubar, vbar, Drhs, DUon, DVom,
                  gzeta, gzeta2, pmask_wet=None, clm=None,
                  forcing: Optional[Forcing2D] = None):
    """RHS of the 2-D momentum equations (step2d_LF_AM3.h:929-1844):
    surface-slope pressure gradient, 4th-order advection, Coriolis,
    curvilinear terms, harmonic viscosity (its corner stress times
    pmask_wet under WET_DRY), nudging toward the 2-D momentum climatology
    clm["ubarclm"/"vbarclm"] with clm["m2nudg"] (1/s, a scalar or a
    rho-point field) and, without SOLVE3D, the surface stress of `forcing`
    and the linear or quadratic bottom drag applied directly."""
    H = cfg.halo
    h = grid.h
    g = _g(cfg)
    sixth = 1.0 / 6.0

    # --- surface-slope pressure gradient (:936-1027) ---
    rhs_ubar = 0.5 * g * grid.on_u * (
        (im1(h) + h) * (im1(gzeta) - gzeta) + (im1(gzeta2) - gzeta2))
    rhs_vbar = 0.5 * g * grid.om_v * (
        (jm1(h) + h) * (jm1(gzeta) - gzeta) + (jm1(gzeta2) - gzeta2))

    # --- 4th-order centered advection (:1079-1287) ---
    if cfg.uv_adv:
        gr = im1(ubar) - 2.0 * ubar + ip1(ubar)
        Dg = im1(DUon) - 2.0 * DUon + ip1(DUon)
        gr = bc.extrap_west(cfg, gr, H)
        Dg = bc.extrap_west(cfg, Dg, H)
        gr = bc.extrap_east(cfg, gr, H + cfg.Lm)
        Dg = bc.extrap_east(cfg, Dg, H + cfg.Lm)
        UFx = 0.25 * (ubar + ip1(ubar) - sixth * (gr + ip1(gr))) * \
            (DUon + ip1(DUon) - sixth * (Dg + ip1(Dg)))

        gr = jm1(ubar) - 2.0 * ubar + jp1(ubar)
        gr = bc.extrap_south(cfg, gr, H - 1)
        gr = bc.extrap_north(cfg, gr, H + cfg.Mm)
        Dg = im1(DVom) - 2.0 * DVom + ip1(DVom)
        UFe = 0.25 * (ubar + jm1(ubar) - sixth * (gr + jm1(gr))) * \
            (DVom + im1(DVom) - sixth * (Dg + im1(Dg)))

        gr = im1(vbar) - 2.0 * vbar + ip1(vbar)
        gr = bc.extrap_west(cfg, gr, H - 1)
        gr = bc.extrap_east(cfg, gr, H + cfg.Lm)
        Dg = jm1(DUon) - 2.0 * DUon + jp1(DUon)
        VFx = 0.25 * (vbar + im1(vbar) - sixth * (gr + im1(gr))) * \
            (DUon + jm1(DUon) - sixth * (Dg + jm1(Dg)))

        gr = jm1(vbar) - 2.0 * vbar + jp1(vbar)
        Dg = jm1(DVom) - 2.0 * DVom + jp1(DVom)
        gr = bc.extrap_south(cfg, gr, H)
        Dg = bc.extrap_south(cfg, Dg, H)
        gr = bc.extrap_north(cfg, gr, H + cfg.Mm)
        Dg = bc.extrap_north(cfg, Dg, H + cfg.Mm)
        VFe = 0.25 * (vbar + jp1(vbar) - sixth * (gr + jp1(gr))) * \
            (DVom + jp1(DVom) - sixth * (Dg + jp1(Dg)))

        rhs_ubar = rhs_ubar - (UFx - im1(UFx)) - (jp1(UFe) - UFe)
        rhs_vbar = rhs_vbar - (ip1(VFx) - VFx) - (VFe - jm1(VFe))

    # --- Coriolis (:1288-1326) ---
    if cfg.uv_cor:
        cor = 0.5 * Drhs * grid.fomn
        UFxc = cor * (vbar + jp1(vbar))
        VFec = cor * (ubar + ip1(ubar))
        rhs_ubar = rhs_ubar + 0.5 * (UFxc + im1(UFxc))
        rhs_vbar = rhs_vbar - 0.5 * (VFec + jm1(VFec))

    # --- curvilinear metric advection terms (:1330-1403) ---
    if cfg.curvgrid and cfg.uv_adv:
        cff = 0.5 * (vbar + jp1(vbar)) * grid.dndx - \
            0.5 * (ubar + ip1(ubar)) * grid.dmde
        cffu = 0.5 * Drhs * cff * (ubar + ip1(ubar))
        cffv = 0.5 * Drhs * cff * (vbar + jp1(vbar))
        rhs_ubar = rhs_ubar + 0.5 * (cffv + im1(cffv))
        rhs_vbar = rhs_vbar - 0.5 * (cffu + jm1(cffu))

    # --- harmonic viscosity (:1405-1474) ---
    if cfg.uv_vis2 and cfg.visc2 != 0.0:
        pm, pn = grid.pm, grid.pn
        Drhs_p = at_p(Drhs)
        cff_r = cfg.visc2 * Drhs * 0.5 * (
            (pm / pn) * ((pn + ip1(pn)) * ip1(ubar) - (im1(pn) + pn) * ubar) -
            (pn / pm) * ((pm + jp1(pm)) * jp1(vbar) - (jm1(pm) + pm) * vbar))
        UFxv = grid.on_r * grid.on_r * cff_r
        VFev = grid.om_r * grid.om_r * cff_r

        sum_pm = im1(jm1(pm)) + im1(pm) + jm1(pm) + pm
        sum_pn = im1(jm1(pn)) + im1(pn) + jm1(pn) + pn
        cff_p = cfg.visc2 * Drhs_p * 0.5 * (
            (sum_pm / sum_pn) *
            ((jm1(pn) + pn) * vbar - (im1(jm1(pn)) + im1(pn)) * im1(vbar)) +
            (sum_pn / sum_pm) *
            ((im1(pm) + pm) * ubar - (im1(jm1(pm)) + jm1(pm)) * jm1(ubar)))
        cff_p = cff_p * grid.pmask
        if pmask_wet is not None:              # step2d_LF_AM3.h:1436-1439
            cff_p = cff_p * pmask_wet
        om_p = 4.0 / sum_pm
        on_p = 4.0 / sum_pn
        UFev = om_p * om_p * cff_p
        VFxv = on_p * on_p * cff_p

        rhs_ubar = rhs_ubar + \
            0.5 * (im1(pn) + pn) * (UFxv - im1(UFxv)) + \
            0.5 * (im1(pm) + pm) * (jp1(UFev) - UFev)
        rhs_vbar = rhs_vbar + \
            0.5 * (jm1(pn) + pn) * (ip1(VFxv) - VFxv) - \
            0.5 * (jm1(pm) + pm) * (VFev - jm1(VFev))

    # --- 2-D momentum climatology nudging (step2d_LF_AM3.h:1822-1844
    #     LnudgeM2CLM): the face average of m2nudg times the cell area,
    #     times the face depth ---
    if clm is not None and "ubarclm" in clm:
        nud = clm.get("m2nudg", 0.0)
        field = isinstance(nud, torch.Tensor)
        cff_u = 0.25 * (im1(nud) + nud) * grid.om_u * grid.on_u if field \
            else 0.5 * nud * grid.om_u * grid.on_u
        rhs_ubar = rhs_ubar + cff_u * (im1(Drhs) + Drhs) * \
            (clm["ubarclm"] - ubar)
        cff_v = 0.25 * (jm1(nud) + nud) * grid.om_v * grid.on_v if field \
            else 0.5 * nud * grid.om_v * grid.on_v
        rhs_vbar = rhs_vbar + cff_v * (jm1(Drhs) + Drhs) * \
            (clm["vbarclm"] - vbar)

    # --- 2-D-only mode: the surface and bottom stresses directly (the
    #     reference's non-SOLVE3D branches; with SOLVE3D they come through
    #     rufrc) ---
    if not cfg.solve3d:
        area_u = grid.om_u * grid.on_u
        area_v = grid.om_v * grid.on_v
        if forcing is not None and forcing.sustr is not None:
            rhs_ubar = rhs_ubar + forcing.sustr * area_u
        if forcing is not None and forcing.svstr is not None:
            rhs_vbar = rhs_vbar + forcing.svstr * area_v
        if cfg.bottom_drag == "linear":
            rhs_ubar = rhs_ubar - cfg.rdrg * ubar * area_u
            rhs_vbar = rhs_vbar - cfg.rdrg * vbar * area_v
        elif cfg.bottom_drag == "quadratic":
            vbar_at_u = 0.25 * (vbar + jp1(vbar) + im1(vbar) +
                                im1(jp1(vbar)))
            ubar_at_v = 0.25 * (ubar + ip1(ubar) + jm1(ubar) +
                                jm1(ip1(ubar)))
            rhs_ubar = rhs_ubar - cfg.rdrg2 * \
                torch.sqrt(ubar * ubar + vbar_at_u * vbar_at_u) * ubar * \
                area_u
            rhs_vbar = rhs_vbar - cfg.rdrg2 * \
                torch.sqrt(ubar_at_v * ubar_at_v + vbar * vbar) * vbar * \
                area_v
    return rhs_ubar, rhs_vbar


def _step_momentum(cfg: Config, grid: Grid, u_kstp, v_kstp, Dstp, Dnew,
                   dtau_u, dtau_v):
    """ubar(knew) = (ubar(kstp)*(Dstp_i+Dstp_{i-1}) + cff*dtau) /
    (Dnew_i+Dnew_{i-1}) with cff = (pm_i+pm_{i-1})*(pn_i+pn_{i-1})
    (step2d_LF_AM3.h:2093-2258); dtau_* are the time-combined RHS."""
    pm, pn = grid.pm, grid.pn
    ubar_new = (u_kstp * (Dstp + im1(Dstp)) +
                (pm + im1(pm)) * (pn + im1(pn)) * dtau_u) / \
        (Dnew + im1(Dnew))
    ubar_new = ubar_new * grid.umask
    vbar_new = (v_kstp * (Dstp + jm1(Dstp)) +
                (pm + jm1(pm)) * (pn + jm1(pn)) * dtau_v) / \
        (Dnew + jm1(Dnew))
    vbar_new = vbar_new * grid.vmask
    return ubar_new, vbar_new


def ab3_coupling_weights(iic: int):
    """(w_now, w_m1, w_m2) of the first predictor's 2-D/3-D coupling
    (step2d_LF_AM3.h:1868-1990), chosen on the host from the step count."""
    if iic == 0:
        return 1.0, 0.0, 0.0
    if iic == 1:
        return 1.5, 0.5, 0.0
    return 23.0 / 12.0, 16.0 / 12.0, 5.0 / 12.0


def _wet_masks(cfg: Config, grid: Grid, z_kstp):
    """New wet/dry masks from zeta at the kstp level (step2d_LF_AM3.h:729
    -> wetdry_tile): (rho, u, v, psi masks)."""
    wd = wetdry.rho_wet(cfg, grid, z_kstp)
    um, vm = wetdry.face_masks(wd)
    return wd, um, vm, wetdry.psi_wet(wd)


def _boundary_fns(cfg: Config, grid: Grid, bry, sources, sustr=None,
                  svstr=None):
    """The lateral conditions of a fast step, as (zbc, bcs, fill): zbc(z_new,
    z_know, dt2d) for the new free surface (the simple kinds, then the
    open ones through obc.zetabc, then the wet/dry clamp); bcs(u_new,
    v_new, u_know, v_know, z_know, dt2d, z_new, um, vm) for the new
    velocities: the simple kinds, the open ones through obc.u2dbc/v2dbc
    (with the surface stresses of the 2-D-only mode), the limiter again
    under WET_DRY (the reference limits the boundary points inside
    u2dbc/v2dbc, u2dbc_im.F:1187-1234; idempotent inside), then the volume
    conservation and the point sources.

    Under a ParCtx bcs leaves the halos of ubar and vbar stale, and
    fill(u_new, v_new, *more) refreshes them with the substep's other
    fields in one exchange at the end of the substep (mp_exchange.F packs
    up to 4 fields in a message; roms_tpu/ops/step2d.py:325-340); zeta
    keeps its own refresh, since its halo feeds the same substep's
    momentum.  Without a ParCtx bcs refreshes ubar and vbar itself and
    fill refreshes `more` only."""
    adv_z = bc.has_advanced(cfg.lbc_zeta)
    adv_u = bc.has_advanced(cfg.lbc_ubar)
    adv_v = bc.has_advanced(cfg.lbc_vbar)
    use_wd = cfg.wetdry
    blocked = bc.current_ctx() is not None
    halo = (lambda a: a) if blocked else (lambda a: bc.fill_halo(cfg, a))

    def zbc(z_new, z_know, dt2d):
        z_new = bc.apply_bc_rho(cfg, cfg.lbc_zeta, z_new, mask=grid.rmask)
        if adv_z:
            z_new = bc.fill_halo(cfg, obc.zetabc(
                cfg, grid, cfg.lbc_zeta, z_know, z_new, dt2d, bry))
        if use_wd:
            z_new = wetdry.clamp_zeta(cfg, grid, z_new)
        return z_new

    def ubc(u_new, u_know, z_know, dt2d, z_new, v_know):
        u_new = bc.apply_bc_u(cfg, cfg.lbc_ubar, u_new, gamma2=cfg.gamma2,
                              mask=grid.umask, fill=not blocked)
        if adv_u:
            u_new = halo(obc.u2dbc(
                cfg, grid, cfg.lbc_ubar, u_know, u_new, z_know, dt2d, bry,
                z_kout=z_new, vb_know=v_know, sustr=sustr))
        return u_new

    def vbc(v_new, v_know, z_know, dt2d, z_new, u_know):
        v_new = bc.apply_bc_v(cfg, cfg.lbc_vbar, v_new, gamma2=cfg.gamma2,
                              mask=grid.vmask, fill=not blocked)
        if adv_v:
            v_new = halo(obc.v2dbc(
                cfg, grid, cfg.lbc_vbar, v_know, v_new, z_know, dt2d, bry,
                z_kout=z_new, ub_know=u_know, svstr=svstr))
        return v_new

    def srcs(u_new, v_new, z_new):
        if cfg.volcons:
            u_new, v_new = obc.obc_volcons(cfg, grid, u_new, v_new, z_new,
                                           set(cfg.volcons))
            u_new = halo(u_new)
            v_new = halo(v_new)
        if sources is None:
            return u_new, v_new
        from .sources import apply_ubar_sources
        u_new, v_new = apply_ubar_sources(sources, u_new, v_new, z_new,
                                          grid.h, grid.on_u, grid.om_v)
        return halo(u_new), halo(v_new)

    def bcs(u_new, v_new, u_know, v_know, z_know, dt2d, z_new, um, vm):
        u_new = ubc(u_new, u_know, z_know, dt2d, z_new, v_know)
        v_new = vbc(v_new, v_know, z_know, dt2d, z_new, u_know)
        if use_wd:
            u_new = u_new * wetdry.limit(um, u_new)
            v_new = v_new * wetdry.limit(vm, v_new)
        return srcs(u_new, v_new, z_new)

    def fill(u_new, v_new, *more):
        if blocked:
            return bc.fill_halo_multi(cfg, u_new, v_new, *more)
        return (u_new, v_new) + tuple(bc.fill_halo(cfg, a) for a in more)

    return zbc, bcs, fill


def fast_loop(cfg: Config, grid: Grid, fs: Fast2DState, rufrc=None,
              rvfrc=None, ru0_nm1=None, ru0_nm2=None, rv0_nm1=None,
              rv0_nm2=None, iic: int = 0, bry=None, sources=None, clm=None,
              us2d=None):
    """The full fast loop of one slow step (SOLVE3D mode): the peeled FE
    predictor and first corrector, nfast-1 LF/AM3 predictor/corrector
    pairs, and the auxiliary averaging step (roms_tpu/ops/step2d.py:
    271-630; step2d_LF_AM3.h).

    rufrc/rvfrc are the depth-integrated slow RHS; the first predictor
    turns them into forcing increments with the AB3-like extrapolation
    against the (ru0_nm1, ru0_nm2) history (step2d_LF_AM3.h:1868-1990);
    iic is the host step count that picks the start-up weights.  Open
    boundaries go through obc.zetabc/u2dbc/v2dbc after the simple kinds,
    cfg.volcons through obc.obc_volcons, `sources` through
    sources.apply_ubar_sources, and `clm` (ubarclm/vbarclm/m2nudg) into
    the momentum rhs.  Under cfg.wetdry the wet/dry masks are made anew
    from zeta at the kstp level of every substep, the directional limiter
    multiplies the new velocities and the stored rhs, zeta keeps Dcrit on
    land, and the rho masks are summed for the averaged masks.

    Returns (fs, rufrc_c, rvfrc_c, wet): wet is None unless cfg.wetdry,
    else {"rmask_wet", "umask_wet", "vmask_wet"}, the fast-time-averaged
    masks for the 3-D step (wetdry.F wetdry_avg_mask_tile).  us2d: the
    frozen Stokes transports (stokes_transport) that NEARSHORE adds to
    every depth flux; DU_avg1/DV_avg1 average the Eulerian part only.
    Every tensor is new, so the caller's fs, bry and sources are
    unchanged."""
    dtfast = cfg.dtfast
    h = grid.h
    pmn = grid.pm * grid.pn
    w1, w2 = grid.weight1, grid.weight2
    nfast = cfg.nfast
    zero = torch.zeros_like(fs.zeta_n)

    use_wd = cfg.wetdry
    zbc, bcs, fill = _boundary_fns(cfg, grid, bry, sources)

    def eulerian(DUon, DVom):
        # DU_avg1 is the Eulerian fast-averaged transport: the 3-D
        # corrector replaces the Eulerian vertical mean only
        # (step2d_LF_AM3.h:645-655)
        if us2d is None:
            return DUon, DVom
        return DUon - us2d[0], DVom - us2d[1]

    if rufrc is None:
        rufrc = rvfrc = zero
        ru0_nm1 = ru0_nm2 = rv0_nm1 = rv0_nm2 = zero

    # ================= fast step 1 (peeled: FE predictor) =================
    um_w = vm_w = pw_w = wet_avg = None
    if use_wd:                 # FIRST_2D_STEP predictor: kstp = n
        wet_avg, um_w, vm_w, pw_w = _wet_masks(cfg, grid, fs.zeta_n)
    Drhs, DUon, DVom = depth_fluxes(grid, fs.zeta_n, fs.ubar_n, fs.vbar_n,
                                    us2d)
    # averaging reset (:611-634); weight(2,iif+1) with iif=1 -> w2[1]
    cff2 = (-1.0 / 12.0) * w2[1]
    fs = fs.replace(Zt_avg1=zero, DU_avg1=zero, DV_avg1=zero,
                    DU_avg2=cff2 * DUon, DV_avg2=cff2 * DVom)

    rhs_zeta = (DUon - ip1(DUon)) + (DVom - jp1(DVom))
    zeta_new = (fs.zeta_n + pmn * dtfast * rhs_zeta) * grid.rmask
    Dnew = zeta_new + h
    zwrk = 0.5 * (fs.zeta_n + zeta_new)
    zeta_p = zbc(zeta_new, fs.zeta_n, dtfast)

    rhs_ubar, rhs_vbar = _rhs_momentum(cfg, grid, fs.ubar_n, fs.vbar_n,
                                       Drhs, DUon, DVom, zwrk, zwrk * zwrk,
                                       pmask_wet=pw_w, clm=clm)

    # --- 2D-3D coupling on the first predictor (:1868-1990) ---
    rufrc_c = rufrc - rhs_ubar
    rvfrc_c = rvfrc - rhs_vbar
    w_now, w_m1, w_m2 = ab3_coupling_weights(iic)
    rhs_ubar = rhs_ubar + w_now * rufrc_c - w_m1 * ru0_nm1 + w_m2 * ru0_nm2
    rhs_vbar = rhs_vbar + w_now * rvfrc_c - w_m1 * rv0_nm1 + w_m2 * rv0_nm2

    # momentum FE step (:2104-2140): cff1 = 0.5*dtfast
    ubar_p, vbar_p = _step_momentum(
        cfg, grid, fs.ubar_n, fs.vbar_n, fs.zeta_n + h, Dnew,
        0.5 * dtfast * rhs_ubar, 0.5 * dtfast * rhs_vbar)
    if use_wd:
        # the limiter on the new velocity, the stored rhs and (first
        # predictor only) the coupling forcing (step2d_LF_AM3.h:2123-2146)
        c7u = wetdry.limit(um_w, ubar_p)
        c7v = wetdry.limit(vm_w, vbar_p)
        ubar_p = ubar_p * c7u
        vbar_p = vbar_p * c7v
        rhs_ubar = rhs_ubar * c7u
        rhs_vbar = rhs_vbar * c7v
        rufrc_c = rufrc_c * c7u
        rvfrc_c = rvfrc_c * c7v
    ubar_p, vbar_p = bcs(ubar_p, vbar_p, fs.ubar_n, fs.vbar_n, fs.zeta_n,
                         dtfast, zeta_p, um_w, vm_w)
    ubar_p, vbar_p, rhs_zeta = fill(ubar_p, vbar_p, rhs_zeta)
    fs = fs.replace(
        rzeta_nm1=fs.rzeta_n, rzeta_n=rhs_zeta,
        rubar_nm1=fs.rubar_n, rubar_n=rhs_ubar,
        rvbar_nm1=fs.rvbar_n, rvbar_n=rhs_vbar)

    def corrector(i, fs, zeta_p, ubar_p, vbar_p, first: bool, wet_avg):
        um_c = vm_c = pw_c = None
        if use_wd:             # corrector: kstp = n -> masks from zeta_n
            wd_c, um_c, vm_c, pw_c = _wet_masks(cfg, grid, fs.zeta_n)
            wet_avg = wet_avg + wd_c
        Drhs, DUon, DVom = depth_fluxes(grid, zeta_p, ubar_p, vbar_p, us2d)
        # averaging, corrector branch (:688-713): weight(2,iif) -> w2[i-1]
        cff2 = w2[i - 1] if first else (5.0 / 12.0) * w2[i - 1]
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
        zeta_new = zbc(zeta_new, fs.zeta_n, dtfast)

        rhs_ubar, rhs_vbar = _rhs_momentum(cfg, grid, ubar_p, vbar_p, Drhs,
                                           DUon, DVom, zwrk, zwrk * zwrk,
                                           pmask_wet=pw_c, clm=clm)
        rhs_ubar = rhs_ubar + rufrc_c
        rhs_vbar = rhs_vbar + rvfrc_c

        cm1 = 0.5 * dtfast * 5.0 / 12.0
        cm2 = 0.5 * dtfast * 8.0 / 12.0
        cm3 = 0.5 * dtfast * 1.0 / 12.0
        ubar_new, vbar_new = _step_momentum(
            cfg, grid, fs.ubar_n, fs.vbar_n, fs.zeta_n + h, Dnew,
            cm1 * rhs_ubar + cm2 * fs.rubar_n - cm3 * fs.rubar_nm1,
            cm1 * rhs_vbar + cm2 * fs.rvbar_n - cm3 * fs.rvbar_nm1)
        if use_wd:
            ubar_new = ubar_new * wetdry.limit(um_c, ubar_new)
            vbar_new = vbar_new * wetdry.limit(vm_c, vbar_new)
        ubar_new, vbar_new = bcs(ubar_new, vbar_new, fs.ubar_n, fs.vbar_n,
                                 fs.zeta_n, dtfast, zeta_new, um_c, vm_c)
        ubar_new, vbar_new = fill(ubar_new, vbar_new)
        return fs.replace(
            zeta_nm1=fs.zeta_n, zeta_n=zeta_new,
            ubar_nm1=fs.ubar_n, ubar_n=ubar_new,
            vbar_nm1=fs.vbar_n, vbar_n=vbar_new), wet_avg

    fs, wet_avg = corrector(1, fs, zeta_p, ubar_p, vbar_p, True, wet_avg)

    # ============== fast steps 2..nfast (LF / AM3) ==============
    for i in range(2, nfast + 1):
        um_p = vm_p = pw_p = None
        if use_wd:             # LF predictor: kstp = n-1
            wd_p, um_p, vm_p, pw_p = _wet_masks(cfg, grid, fs.zeta_nm1)
            wet_avg = wet_avg + wd_p
        Drhs, DUon, DVom = depth_fluxes(grid, fs.zeta_n, fs.ubar_n,
                                        fs.vbar_n, us2d)
        cff1 = w1[i - 2]                                  # weight(1,iif-1)
        cff2 = (8.0 / 12.0) * w2[i - 1] - (1.0 / 12.0) * w2[i]
        du1, dv1 = eulerian(DUon, DVom)
        fs = fs.replace(
            Zt_avg1=fs.Zt_avg1 + cff1 * fs.zeta_n,
            DU_avg1=fs.DU_avg1 + cff1 * du1,
            DV_avg1=fs.DV_avg1 + cff1 * dv1,
            DU_avg2=fs.DU_avg2 + cff2 * DUon,
            DV_avg2=fs.DV_avg2 + cff2 * DVom)

        rhs_zeta = (DUon - ip1(DUon)) + (DVom - jp1(DVom))
        zeta_new = (fs.zeta_nm1 + pmn * (2.0 * dtfast) * rhs_zeta) * \
            grid.rmask
        Dnew = zeta_new + h
        cff4 = 4.0 / 25.0
        cff5 = 1.0 - 2.0 * cff4
        zwrk = cff5 * fs.zeta_n + cff4 * (fs.zeta_nm1 + zeta_new)
        zeta_p = zbc(zeta_new, fs.zeta_n, 2.0 * dtfast)

        rhs_ubar, rhs_vbar = _rhs_momentum(cfg, grid, fs.ubar_n, fs.vbar_n,
                                           Drhs, DUon, DVom, zwrk,
                                           zwrk * zwrk, pmask_wet=pw_p,
                                           clm=clm)
        rhs_ubar = rhs_ubar + rufrc_c
        rhs_vbar = rhs_vbar + rvfrc_c

        ubar_p, vbar_p = _step_momentum(
            cfg, grid, fs.ubar_nm1, fs.vbar_nm1, fs.zeta_nm1 + h, Dnew,
            dtfast * rhs_ubar, dtfast * rhs_vbar)
        if use_wd:
            c7u = wetdry.limit(um_p, ubar_p)
            c7v = wetdry.limit(vm_p, vbar_p)
            ubar_p = ubar_p * c7u
            vbar_p = vbar_p * c7v
            rhs_ubar = rhs_ubar * c7u
            rhs_vbar = rhs_vbar * c7v
        ubar_p, vbar_p = bcs(ubar_p, vbar_p, fs.ubar_n, fs.vbar_n,
                             fs.zeta_n, 2.0 * dtfast, zeta_p, um_p, vm_p)
        ubar_p, vbar_p, rhs_zeta = fill(ubar_p, vbar_p, rhs_zeta)
        fs = fs.replace(
            rzeta_nm1=fs.rzeta_n, rzeta_n=rhs_zeta,
            rubar_nm1=fs.rubar_n, rubar_n=rhs_ubar,
            rvbar_nm1=fs.rvbar_n, rvbar_n=rhs_vbar)
        fs, wet_avg = corrector(i, fs, zeta_p, ubar_p, vbar_p, False,
                                wet_avg)

    # ========== auxiliary predictor (iif = nfast+1): averages only ==========
    _, DUon, DVom = depth_fluxes(grid, fs.zeta_n, fs.ubar_n, fs.vbar_n,
                                 us2d)
    i = nfast + 1
    cff1 = w1[i - 2]
    cff2 = (8.0 / 12.0) * w2[i - 1] - (1.0 / 12.0) * w2[i]
    du1, dv1 = eulerian(DUon, DVom)
    avgs = (fs.Zt_avg1 + cff1 * fs.zeta_n, fs.DU_avg1 + cff1 * du1,
            fs.DV_avg1 + cff1 * dv1, fs.DU_avg2 + cff2 * DUon,
            fs.DV_avg2 + cff2 * DVom)
    if bc.current_ctx() is not None:
        avgs = bc.fill_halo_multi(cfg, *avgs)
    else:
        avgs = tuple(bc.fill_halo(cfg, a) for a in avgs)
    fs = fs.replace(**dict(zip(
        ("Zt_avg1", "DU_avg1", "DV_avg1", "DU_avg2", "DV_avg2"), avgs)))

    # --- time-averaged wet masks for the 3-D step (the auxiliary wetdry
    #     call, wetdry.F:253-271): wet only if wet at all 2*nfast substeps,
    #     the direction from the sign of the averaged transport ---
    wet = None
    if use_wd:
        wd_avg = torch.floor(wet_avg / (2.0 * nfast))
        um_avg, vm_avg = wetdry.avg_face_masks(wd_avg, fs.DU_avg1,
                                               fs.DV_avg1)
        wet = {"rmask_wet": bc.fill_halo(cfg, wd_avg),
               "umask_wet": bc.fill_halo(cfg, um_avg),
               "vmask_wet": bc.fill_halo(cfg, vm_avg)}
    return fs, rufrc_c, rvfrc_c, wet


def step_2d_only(cfg: Config, grid: Grid, fs: Fast2DState, first: bool,
                 forcing: Optional[Forcing2D] = None, bry=None, sources=None,
                 clm=None) -> Fast2DState:
    """One model step of the 2-D-only (main2d) mode: a single LF predictor
    and AM3 corrector, the LF/AM3 history carried across steps in `fs`
    (roms_tpu/ops/step2d.py:633-791).  `first` takes the forward-Euler
    predictor of a run's first step (iic == ntfirst).  `forcing` gives the
    surface stresses, which the open boundaries see too; `bry`, `sources`
    and `clm` act as in fast_loop.  Returns a new Fast2DState."""
    dtfast = cfg.dtfast
    h = grid.h
    pmn = grid.pm * grid.pn
    use_wd = cfg.wetdry
    zbc, bcs, fill = _boundary_fns(
        cfg, grid, bry, sources,
        sustr=forcing.sustr if forcing is not None else None,
        svstr=forcing.svstr if forcing is not None else None)

    # --- predictor (FE on the first step, else LF) ---
    Drhs, DUon, DVom = depth_fluxes(grid, fs.zeta_n, fs.ubar_n, fs.vbar_n)
    rhs_zeta = (DUon - ip1(DUon)) + (DVom - jp1(DVom))
    if first:
        z_kstp, u_kstp, v_kstp = fs.zeta_n, fs.ubar_n, fs.vbar_n
        cz, cm = dtfast, 0.5 * dtfast
    else:
        z_kstp, u_kstp, v_kstp = fs.zeta_nm1, fs.ubar_nm1, fs.vbar_nm1
        cz, cm = 2.0 * dtfast, dtfast
    zeta_new = (z_kstp + pmn * cz * rhs_zeta) * grid.rmask
    Dnew = zeta_new + h
    if first:
        zwrk = 0.5 * (z_kstp + zeta_new)
    else:
        cff4 = 4.0 / 25.0
        zwrk = (1.0 - 2.0 * cff4) * fs.zeta_n + cff4 * (z_kstp + zeta_new)
    zeta_p = bc.apply_bc_rho(cfg, cfg.lbc_zeta, zeta_new, mask=grid.rmask)
    um_p = vm_p = pw_p = None
    if use_wd:
        _, um_p, vm_p, pw_p = _wet_masks(cfg, grid, z_kstp)
        zeta_p = wetdry.clamp_zeta(cfg, grid, zeta_p)

    rhs_ubar, rhs_vbar = _rhs_momentum(cfg, grid, fs.ubar_n, fs.vbar_n,
                                       Drhs, DUon, DVom, zwrk, zwrk * zwrk,
                                       pmask_wet=pw_p, clm=clm,
                                       forcing=forcing)
    ubar_p, vbar_p = _step_momentum(cfg, grid, u_kstp, v_kstp, z_kstp + h,
                                    Dnew, cm * rhs_ubar, cm * rhs_vbar)
    if use_wd:
        c7u = wetdry.limit(um_p, ubar_p)
        c7v = wetdry.limit(vm_p, vbar_p)
        ubar_p = ubar_p * c7u
        vbar_p = vbar_p * c7v
        rhs_ubar = rhs_ubar * c7u
        rhs_vbar = rhs_vbar * c7v
    ubar_p, vbar_p = bcs(ubar_p, vbar_p, fs.ubar_n, fs.vbar_n, fs.zeta_n,
                         dtfast, zeta_p, um_p, vm_p)
    ubar_p, vbar_p, rhs_zeta = fill(ubar_p, vbar_p, rhs_zeta)
    fs = fs.replace(
        rzeta_nm1=fs.rzeta_n, rzeta_n=rhs_zeta,
        rubar_nm1=fs.rubar_n, rubar_n=rhs_ubar,
        rvbar_nm1=fs.rvbar_n, rvbar_n=rhs_vbar)

    # --- corrector (AM3) ---
    Drhs, DUon, DVom = depth_fluxes(grid, zeta_p, ubar_p, vbar_p)
    rhs_zeta = (DUon - ip1(DUon)) + (DVom - jp1(DVom))
    c1 = dtfast * 5.0 / 12.0
    c2 = dtfast * 8.0 / 12.0
    c3 = dtfast * 1.0 / 12.0
    zeta_new = (fs.zeta_n + pmn * (c1 * rhs_zeta + c2 * fs.rzeta_n -
                                   c3 * fs.rzeta_nm1)) * grid.rmask
    Dnew = zeta_new + h
    cff4 = 2.0 / 5.0
    zwrk = (1.0 - cff4) * zeta_new + cff4 * zeta_p
    zeta_new = zbc(zeta_new, fs.zeta_n, dtfast)
    um_c = vm_c = pw_c = None
    if use_wd:
        _, um_c, vm_c, pw_c = _wet_masks(cfg, grid, fs.zeta_n)
    rhs_ubar, rhs_vbar = _rhs_momentum(cfg, grid, ubar_p, vbar_p, Drhs,
                                       DUon, DVom, zwrk, zwrk * zwrk,
                                       pmask_wet=pw_c, clm=clm,
                                       forcing=forcing)
    cm1 = 0.5 * dtfast * 5.0 / 12.0
    cm2 = 0.5 * dtfast * 8.0 / 12.0
    cm3 = 0.5 * dtfast * 1.0 / 12.0
    ubar_new, vbar_new = _step_momentum(
        cfg, grid, fs.ubar_n, fs.vbar_n, fs.zeta_n + h, Dnew,
        cm1 * rhs_ubar + cm2 * fs.rubar_n - cm3 * fs.rubar_nm1,
        cm1 * rhs_vbar + cm2 * fs.rvbar_n - cm3 * fs.rvbar_nm1)
    if use_wd:
        ubar_new = ubar_new * wetdry.limit(um_c, ubar_new)
        vbar_new = vbar_new * wetdry.limit(vm_c, vbar_new)
    ubar_new, vbar_new = bcs(ubar_new, vbar_new, fs.ubar_n, fs.vbar_n,
                             fs.zeta_n, dtfast, zeta_new, um_c, vm_c)
    ubar_new, vbar_new = fill(ubar_new, vbar_new)
    return fs.replace(
        zeta_nm1=fs.zeta_n, zeta_n=zeta_new,
        ubar_nm1=fs.ubar_n, ubar_n=ubar_new,
        vbar_nm1=fs.vbar_n, vbar_n=vbar_new)
