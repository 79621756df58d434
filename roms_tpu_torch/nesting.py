"""Refinement and composite nesting (counterpart of ``roms_tpu/nesting.py``;
mod_nesting.F / nesting.F / set_contact.F).

Refinement: a fine grid covers a rectangular block of parent cells with an
integer refinement `factor`; each parent step drives `factor` fine steps
whose lateral boundaries are clamped to donor data interpolated in space
(bilinear on the parent grid) and time (linear between the bracketing
parent states).  Two-way feedback replaces the covered parent cells with
block averages of the fine solution (Hz-weighted with ``conserve``), and
``flux_coupling`` reconciles the parent step with the fine grid's
time-integrated contact transports.

Composite: two same-resolution grids abut along an eta-parallel line with
an overlap of `olap` columns; each takes the other's interior as clamped
boundary data and the overlap is exchanged after each step.

The contact points collapse to dense fractional-index gathers: the parent
grids are uniform rectilinear, so receiver index -> donor fractional index
is affine.  Parent and child share the vertical coordinate (same N,
Vtransform 2).  The fine grid's `bry` and clamped sides keep the fused
fast loop and the column kernels off there, as the JAX gates do; the
parent's steps take every kernel their gates admit.  The steppers are
plain Python functions over States.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np
import torch

from .config import Config, LBC, BC_CLAMPED
from .grid import Grid, build_grid


@dataclass(frozen=True)
class RefineSpec:
    """Where the fine grid sits in the parent (ROMS 1-based interior
    rho-cell indices, inclusive) and the refinement ratio
    (mod_nesting.F RefineScale)."""
    istr: int
    iend: int
    jstr: int
    jend: int
    factor: int = 3

    @property
    def nci(self) -> int:
        return self.iend - self.istr + 1

    @property
    def ncj(self) -> int:
        return self.jend - self.jstr + 1


# ---------------------------------------------------------------------------
# donor-grid sampling
# ---------------------------------------------------------------------------
def _gather1d(a, idx_f, axis):
    """Linear interpolation of `a` at fractional indices (1-D float64)
    along `axis`."""
    n = a.shape[axis]
    idx = torch.as_tensor(idx_f, dtype=torch.float64, device=a.device)
    i0 = torch.clamp(torch.floor(idx).long(), 0, n - 2)
    w = (idx - i0).to(a.dtype)
    lo = torch.index_select(a, axis, i0)
    hi = torch.index_select(a, axis, i0 + 1)
    shape = [1] * lo.ndim
    shape[axis % a.ndim] = w.shape[0]
    w = w.reshape(shape)
    return lo * (1.0 - w) + hi * w


def _bilinear(a, gi, gj):
    """Bilinear sample of padded field a[..., j, i] at fractional padded
    indices (gj along -2, gi along -1; separable, 1-D)."""
    return _gather1d(_gather1d(a, gi, -1), gj, -2)


def _rho_index_map(spec: RefineSpec, cfg_f: Config, cfg_c: Config,
                   stag_x: bool = False, stag_y: bool = False):
    """Fractional PARENT padded indices of every FINE padded point.

    stag_x/stag_y: the sampled parent field lives at u/v stagger in that
    direction (u: stag_x, v: stag_y); rho otherwise.  Returns (gi, gj),
    float64 arrays of length nx_tot/ny_tot of the fine grid."""
    Hf, Hc, r = cfg_f.halo, cfg_c.halo, float(spec.factor)
    i_f = np.arange(cfg_f.nx_tot, dtype=np.float64) - Hf + 1  # ROMS i
    j_f = np.arange(cfg_f.ny_tot, dtype=np.float64) - Hf + 1
    if stag_x:
        gi = spec.istr + (i_f - 1.0) / r + Hc - 1.0      # parent u index
    else:
        gi = spec.istr - 0.5 + (i_f - 0.5) / r + Hc - 1.0
    if stag_y:
        gj = spec.jstr + (j_f - 1.0) / r + Hc - 1.0
    else:
        gj = spec.jstr - 0.5 + (j_f - 0.5) / r + Hc - 1.0
    return gi, gj


def _host(a) -> np.ndarray:
    return a.detach().to("cpu", torch.float64).numpy()


# ---------------------------------------------------------------------------
# fine-grid construction
# ---------------------------------------------------------------------------
def build_refined(cfg_c: Config, grid_c: Grid, spec: RefineSpec,
                  name: Optional[str] = None):
    """Build the receiver (fine) grid and config from a uniform-Cartesian
    parent by bilinear sampling of h and f (set_contact.F + get_grid for
    refinement grids), on the parent's device.  All four fine boundaries
    are clamped to donor data; the mask is the nearest parent cell's; x
    and y are in the parent's frame.  Requires Vtransform 2 (hc
    independent of depth) so parent and child share the vertical
    coordinate."""
    if cfg_c.vtransform != 2:
        raise ValueError("refinement nesting needs Vtransform=2 so hc "
                         "matches between parent and child grids")
    if spec.factor < 1:
        raise ValueError("refinement factor must be >= 1")
    clamp = LBC(west=BC_CLAMPED, south=BC_CLAMPED, east=BC_CLAMPED,
                north=BC_CLAMPED)
    cfg_f = cfg_c.replace(
        name=name or (cfg_c.name + f"_refined{spec.factor}"),
        Lm=spec.nci * spec.factor, Mm=spec.ncj * spec.factor,
        ew_periodic=False, ns_periodic=False,
        dt=cfg_c.dt / spec.factor,
        lbc_zeta=clamp, lbc_ubar=clamp, lbc_vbar=clamp,
        lbc_u=clamp, lbc_v=clamp, lbc_t=clamp)

    # parent spacing from the (uniform) interior metrics
    Hc = cfg_c.halo
    pm0 = float(grid_c.pm[Hc, Hc])
    pn0 = float(grid_c.pn[Hc, Hc])
    dxf = 1.0 / (pm0 * spec.factor)
    dyf = 1.0 / (pn0 * spec.factor)

    gi_r, gj_r = _rho_index_map(spec, cfg_f, cfg_c)
    h_f = _host(_bilinear(grid_c.h, gi_r, gj_r))
    f_f = _host(_bilinear(grid_c.f, gi_r, gj_r))
    # nearest-neighbour mask inheritance
    rmask = _host(_bilinear(grid_c.rmask, np.round(gi_r), np.round(gj_r)))
    rmask = np.where(rmask > 0.5, 1.0, 0.0)

    grid_f, cfg_f = build_grid(
        cfg_f, Xsize=dxf * cfg_f.Lm, Esize=dyf * cfg_f.Mm,
        f0=0.0, beta=0.0, depth_fn=lambda xr, yr, i, j, cfg: h_f,
        mask_fn=lambda xr, yr, i, j, cfg: rmask, device=grid_c.h.device)
    # the interpolated parent Coriolis in place of the analytic f = 0, and
    # the coordinates shifted into the parent frame
    x0 = float(grid_c.xr[Hc, Hc + spec.istr - 1]) - 0.5 / pm0
    y0 = float(grid_c.yr[Hc + spec.jstr - 1, Hc]) - 0.5 / pn0
    grid_f = dataclasses.replace(
        grid_f, f=torch.as_tensor(f_f, dtype=grid_f.f.dtype,
                                  device=grid_f.f.device),
        xr=grid_f.xr + x0, yr=grid_f.yr + y0)
    return cfg_f, grid_f


# ---------------------------------------------------------------------------
# donor boundary extraction (put_refine / bry contact points)
# ---------------------------------------------------------------------------
def extract_bry(cfg_c: Config, grid_c: Grid, state_c, spec: RefineSpec,
                cfg_f: Config):
    """Interpolate the donor state to the receiver's boundary rings.

    Returns the `bry` dict of ops/obc.py's clamped conditions: zeta, ubar,
    vbar (1-D padded lines) and u, v, t ((N, len) / (NT, N, len)) per side
    (nesting.F put_refine -> BOUNDARY arrays)."""
    Hf = cfg_f.halo
    gi_r, gj_r = _rho_index_map(spec, cfg_f, cfg_c)
    gi_u, _ = _rho_index_map(spec, cfg_f, cfg_c, stag_x=True)
    _, gj_v = _rho_index_map(spec, cfg_f, cfg_c, stag_y=True)

    rings = {"west": Hf - 1, "east": Hf + cfg_f.Lm,
             "south": Hf - 1, "north": Hf + cfg_f.Mm}
    u_rings = {"west": Hf, "east": Hf + cfg_f.Lm}
    v_rings = {"south": Hf, "north": Hf + cfg_f.Mm}

    def line_w_e(field, gi_line, gj_line, i_ring):
        # sample along a fixed-x column: all fine j, one fine i
        return _gather1d(_gather1d(field, gi_line[i_ring:i_ring + 1],
                                   -1)[..., 0], gj_line, -1)

    def line_s_n(field, gi_line, gj_line, j_ring):
        return _gather1d(_gather1d(field, gj_line[j_ring:j_ring + 1],
                                   -2)[..., 0, :], gi_line, -1)

    bry = {}
    for side in ("west", "east"):
        ir = rings[side]
        bry[f"zeta_{side}"] = line_w_e(state_c.zeta, gi_r, gj_r, ir)
        bry[f"vbar_{side}"] = line_w_e(state_c.vbar, gi_r, gj_v, ir)
        bry[f"v_{side}"] = line_w_e(state_c.v, gi_r, gj_v, ir)
        bry[f"t_{side}"] = line_w_e(state_c.t, gi_r, gj_r, ir)
        iu = u_rings[side]
        bry[f"ubar_{side}"] = line_w_e(state_c.ubar, gi_u, gj_r, iu)
        bry[f"u_{side}"] = line_w_e(state_c.u, gi_u, gj_r, iu)
    for side in ("south", "north"):
        jr = rings[side]
        bry[f"zeta_{side}"] = line_s_n(state_c.zeta, gi_r, gj_r, jr)
        bry[f"ubar_{side}"] = line_s_n(state_c.ubar, gi_u, gj_r, jr)
        bry[f"u_{side}"] = line_s_n(state_c.u, gi_u, gj_r, jr)
        bry[f"t_{side}"] = line_s_n(state_c.t, gi_r, gj_r, jr)
        jv = v_rings[side]
        bry[f"vbar_{side}"] = line_s_n(state_c.vbar, gi_r, gj_v, jv)
        bry[f"v_{side}"] = line_s_n(state_c.v, gi_r, gj_v, jv)
    return bry


def conserve_bry_flux(cfg_c: Config, grid_c: Grid, state_c,
                      spec: RefineSpec, cfg_f: Config, grid_f: Grid,
                      bry: dict) -> dict:
    """check_massflux analog (nesting.F:50): correct the interpolated
    fine-boundary normal velocities so that, per parent contact face, the
    summed fine transports ubar_f*D_f*dy_f equal the parent transport
    ubar_c*D_c*dy_c (bilinear interpolation alone does not conserve the
    contact-line volume flux)."""
    r = spec.factor
    Hc, Hf = cfg_c.halo, cfg_f.halo
    D_c = state_c.zeta + grid_c.h
    eps = 1.0e-30

    def scale_we(side):
        iu_c = Hc + spec.istr - 1 if side == "west" else Hc + spec.iend
        iu_f = Hf if side == "west" else Hf + cfg_f.Lm
        # parent transports along the contact column
        Du_c = 0.5 * (D_c[:, iu_c - 1] + D_c[:, iu_c])
        on_c = grid_c.on_u[:, iu_c]
        Tc = (state_c.ubar[:, iu_c] * Du_c * on_c)[
            Hc + spec.jstr - 1:Hc + spec.jend]              # (ncj,)
        # fine face geometry along the ring
        hu_f = 0.5 * (grid_f.h[:, iu_f - 1] + grid_f.h[:, iu_f])
        on_f = grid_f.on_u[:, iu_f]
        zl = bry[f"zeta_{side}"]
        ub = bry[f"ubar_{side}"]
        j0 = Hf
        n = cfg_f.Mm
        Dfdy = ((hu_f + zl) * on_f)[j0:j0 + n]
        Tf_g = (ub[j0:j0 + n] * Dfdy).reshape(n // r, r).sum(-1)
        # additive correction: the transport deficit as a uniform
        # velocity increment over the group's faces
        du = (Tc - Tf_g) / torch.clamp(
            Dfdy.reshape(n // r, r).sum(-1), min=eps)
        du_line = torch.zeros_like(ub)
        du_line[j0:j0 + n] = torch.repeat_interleave(du, r)
        bry[f"ubar_{side}"] = ub + du_line
        bry[f"u_{side}"] = bry[f"u_{side}"] + du_line

    def scale_sn(side):
        jv_c = Hc + spec.jstr - 1 if side == "south" else Hc + spec.jend
        jv_f = Hf if side == "south" else Hf + cfg_f.Mm
        Dv_c = 0.5 * (D_c[jv_c - 1, :] + D_c[jv_c, :])
        om_c = grid_c.om_v[jv_c, :]
        Tc = (state_c.vbar[jv_c, :] * Dv_c * om_c)[
            Hc + spec.istr - 1:Hc + spec.iend]
        hv_f = 0.5 * (grid_f.h[jv_f - 1, :] + grid_f.h[jv_f, :])
        om_f = grid_f.om_v[jv_f, :]
        zl = bry[f"zeta_{side}"]
        vb = bry[f"vbar_{side}"]
        i0 = Hf
        n = cfg_f.Lm
        Dfdx = ((hv_f + zl) * om_f)[i0:i0 + n]
        Tf_g = (vb[i0:i0 + n] * Dfdx).reshape(n // r, r).sum(-1)
        dv = (Tc - Tf_g) / torch.clamp(
            Dfdx.reshape(n // r, r).sum(-1), min=eps)
        dv_line = torch.zeros_like(vb)
        dv_line[i0:i0 + n] = torch.repeat_interleave(dv, r)
        bry[f"vbar_{side}"] = vb + dv_line
        bry[f"v_{side}"] = bry[f"v_{side}"] + dv_line

    bry = dict(bry)
    for side in ("west", "east"):
        scale_we(side)
    for side in ("south", "north"):
        scale_sn(side)
    return bry


def init_refined(cfg_c: Config, grid_c: Grid, state_c, spec: RefineSpec,
                 cfg_f: Config, grid_f: Grid):
    """The fine state by bilinear interpolation of the parent prognostic
    fields (the refinement branch of initial.F/get_state)."""
    from .state import initial_state
    gi_r, gj_r = _rho_index_map(spec, cfg_f, cfg_c)
    gi_u, _ = _rho_index_map(spec, cfg_f, cfg_c, stag_x=True)
    _, gj_v = _rho_index_map(spec, cfg_f, cfg_c, stag_y=True)
    sf = initial_state(cfg_f, device=state_c.zeta.device,
                       zeta=_bilinear(state_c.zeta, gi_r, gj_r),
                       ubar=_bilinear(state_c.ubar, gi_u, gj_r),
                       vbar=_bilinear(state_c.vbar, gi_r, gj_v),
                       u=_bilinear(state_c.u, gi_u, gj_r),
                       v=_bilinear(state_c.v, gi_r, gj_v),
                       t=_bilinear(state_c.t, gi_r, gj_r))
    return sf.replace(time=state_c.time, iic=state_c.iic * spec.factor)


# ---------------------------------------------------------------------------
# two-way feedback (fine2coarse)
# ---------------------------------------------------------------------------
def _block_mean(a, r):
    """(..., r*nj, r*ni) -> (..., nj, ni) block average."""
    sh = a.shape
    nj, ni = sh[-2] // r, sh[-1] // r
    return a.reshape(sh[:-2] + (nj, r, ni, r)).mean(dim=(-3, -1))


def _set_block(cfield, j0, j1, i0, i1, blk):
    out = cfield.clone()
    out[..., j0:j1, i0:i1] = blk.to(cfield.dtype)
    return out


def fine2coarse(cfg_c: Config, state_c, cfg_f: Config, state_f,
                spec: RefineSpec, margin: int = 1,
                grid_f: Optional[Grid] = None,
                preserve_volume: bool = False):
    """Two-way update: replace the parent cells covered by the fine grid
    (minus `margin` parent cells next to the contact boundary) with block
    averages of the fine solution (nesting.F fine2coarse).

    With grid_f given, the averaging is conservative in the reference's
    Hz-weighted sense: tracers are thickness*area-weighted means, so a
    coarse cell's tracer content equals the summed fine content, and u/v
    are transport-weighted (the fine face transports over the fine face
    areas).  Without grid_f, plain block means."""
    r = spec.factor
    Hc, Hf = cfg_c.halo, cfg_f.halo
    m = margin
    # parent interior block covered by the fine grid (padded indices)
    cj0, cj1 = Hc + spec.jstr - 1 + m, Hc + spec.jend - m
    ci0, ci1 = Hc + spec.istr - 1 + m, Hc + spec.iend - m
    # matching fine interior block
    fj0 = Hf + m * r
    fi0 = Hf + m * r
    njc = cj1 - cj0
    nic = ci1 - ci0

    if grid_f is not None:
        from . import vgrid
        from .grid import hc_of
        from .ops.stencil import im1, jm1
        _, _, Hz_f = vgrid.set_depth(grid_f.h, state_f.zeta, hc_of(cfg_f),
                                     grid_f.sc_r, grid_f.Cs_r, grid_f.sc_w,
                                     grid_f.Cs_w, cfg_f.vtransform)
        Hzu_f = 0.5 * (im1(Hz_f) + Hz_f)
        Hzv_f = 0.5 * (jm1(Hz_f) + Hz_f)
        area_f = 1.0 / (grid_f.pm * grid_f.pn)
    else:
        Hz_f = Hzu_f = Hzv_f = area_f = None

    def rho_avg(cfield, ffield, weight=None):
        blk_f = ffield[..., fj0:fj0 + njc * r, fi0:fi0 + nic * r]
        if weight is None:
            blk = _block_mean(blk_f, r)
        else:
            w = weight[..., fj0:fj0 + njc * r, fi0:fi0 + nic * r]
            blk = _block_mean(blk_f * w, r) / _block_mean(w, r)
        return _set_block(cfield, cj0, cj1, ci0, ci1, blk)

    zeta = rho_avg(state_c.zeta, state_f.zeta, weight=area_f)
    if area_f is not None and preserve_volume:
        # volume-preserving feedback (opt-in): the fine spatial structure
        # with the coarse block-mean free surface, so the composite volume
        # is exactly conserved at the cost of exact tracer constancy
        # (roms_tpu/nesting.py:375-389)
        sl = (Ellipsis, slice(cj0, cj1), slice(ci0, ci1))
        shift = torch.mean(state_c.zeta[sl]) - torch.mean(zeta[sl])
        zeta = zeta.clone()
        zeta[sl] += shift
    t = rho_avg(state_c.t, state_f.t,
                weight=(Hz_f * area_f) if Hz_f is not None else None)

    # u faces: parent u index iu in [istr+1+m .. iend+1-m) maps to fine u
    # index 1 + r*(iu - istr); average r tangential fine faces
    # (transport-weighted when fine thicknesses are available)
    def face_avg_u(cfield, ffield, weight):
        iu0, iu1 = spec.istr + m, spec.iend + 1 - m
        cu0, cu1 = Hc + iu0 - 1, Hc + iu1 - 1
        fu = Hf + r * (iu0 - spec.istr)                # fine padded col
        sl = (Ellipsis, slice(fj0, fj0 + njc * r),
              slice(fu, fu + (iu1 - iu0) * r, r))

        def grp(a):
            sh = a.shape
            return a.reshape(sh[:-2] + (njc, r, sh[-1])).sum(-2)

        if weight is None:
            blk = grp(ffield[sl]) / r
        else:
            w = weight[sl]
            blk = grp(ffield[sl] * w) / grp(w)
        return _set_block(cfield, cj0, cj1, cu0, cu1, blk)

    def face_avg_v(cfield, ffield, weight):
        jv0, jv1 = spec.jstr + m, spec.jend + 1 - m
        cv0, cv1 = Hc + jv0 - 1, Hc + jv1 - 1
        fv = Hf + r * (jv0 - spec.jstr)
        sl = (Ellipsis, slice(fv, fv + (jv1 - jv0) * r, r),
              slice(fi0, fi0 + nic * r))

        def grp(a):
            sh = a.shape
            return a.reshape(sh[:-2] + (sh[-2], nic, r)).sum(-1)

        if weight is None:
            blk = grp(ffield[sl]) / r
        else:
            w = weight[sl]
            blk = grp(ffield[sl] * w) / grp(w)
        return _set_block(cfield, cv0, cv1, ci0, ci1, blk)

    u = face_avg_u(state_c.u, state_f.u, Hzu_f)
    v = face_avg_v(state_c.v, state_f.v, Hzv_f)
    if Hzu_f is not None:
        ubar = face_avg_u(state_c.ubar, state_f.ubar, Hzu_f.sum(0))
        vbar = face_avg_v(state_c.vbar, state_f.vbar, Hzv_f.sum(0))
    else:
        ubar = face_avg_u(state_c.ubar, state_f.ubar, None)
        vbar = face_avg_v(state_c.vbar, state_f.vbar, None)

    from .ops import bc
    fh = lambda a: bc.fill_halo(cfg_c, a)
    return state_c.replace(zeta=fh(zeta), t=fh(t), u=fh(u), v=fh(v),
                           ubar=fh(ubar), vbar=fh(vbar))


# ---------------------------------------------------------------------------
# conservative contact-flux reconciliation (the in-step nmflx/n2way
# flux-substitution analog)
# ---------------------------------------------------------------------------
def contact_flux_correction(cfg_c: Config, grid_c: Grid, sc_new,
                            cfg_f: Config, spec: RefineSpec,
                            Tf: dict, margin: int = 1):
    """Reconcile the coarse step with the fine grid's time-integrated
    contact transports.

    The reference substitutes the refined grid's mass fluxes into the
    donor's continuity and tracer updates at its in-step sync points
    (nesting.F:41-60 check_massflux; main3d.F nmflx / n2way).  Under the
    one-parent-step coupling this equals correcting, after the fact, the
    first coarse cell outside the replaced block: the contact-face
    transport the coarse step used (dt * DU_avg2) is replaced by the fine
    grid's substep-integrated transport through the same line.  The zeta
    correction restores global volume conservation; the tracer columns
    are rescaled with a face tracer, so a spatially constant tracer is
    unchanged.

    Tf: {"w", "e", "s", "n"} -> the fine-integrated transports per coarse
    contact face of the replaced block (make_nested_stepper's substep
    loop; the sign of the coarse DU_avg2/DV_avg2 faces)."""
    Hc = cfg_c.halo
    m = margin
    cj0, cj1 = Hc + spec.jstr - 1 + m, Hc + spec.jend - m
    ci0, ci1 = Hc + spec.istr - 1 + m, Hc + spec.iend - m
    dtc = cfg_c.dt
    pmn = grid_c.pm * grid_c.pn
    zeta = sc_new.zeta
    t = sc_new.t
    D = grid_c.h + zeta

    def col_correct(zeta, t, jsl, i_out, dV):
        """A volume correction dV (m3 a cell) on the outside rho column
        i_out over rows jsl; the tracers rescaled with the face-mean
        tracer (constancy-exact)."""
        dz = pmn[jsl, i_out] * dV
        zeta = zeta.clone()
        zeta[jsl, i_out] += dz
        ratio = dz / D[jsl, i_out]                   # dV/Vol per column
        i_in = i_out + 1 if i_out < ci0 else i_out - 1
        t_face = 0.5 * (t[..., jsl, i_out] + t[..., jsl, i_in])
        new = (t[..., jsl, i_out] + ratio * t_face) / (1.0 + ratio)
        t = t.clone()
        t[..., jsl, i_out] = new
        return zeta, t

    def row_correct(zeta, t, j_out, isl, dV):
        dz = pmn[j_out, isl] * dV
        zeta = zeta.clone()
        zeta[j_out, isl] += dz
        ratio = dz / D[j_out, isl]
        j_in = j_out + 1 if j_out < cj0 else j_out - 1
        t_face = 0.5 * (t[..., j_out, isl] + t[..., j_in, isl])
        new = (t[..., j_out, isl] + ratio * t_face) / (1.0 + ratio)
        t = t.clone()
        t[..., j_out, isl] = new
        return zeta, t

    jsl = slice(cj0, cj1)
    isl = slice(ci0, ci1)
    # coarse step's contact-face transports (m3): dt * DU_avg2
    Tc_w = dtc * sc_new.DU_avg2[jsl, ci0]
    Tc_e = dtc * sc_new.DU_avg2[jsl, ci1]
    Tc_s = dtc * sc_new.DV_avg2[cj0, isl]
    Tc_n = dtc * sc_new.DV_avg2[cj1, isl]
    # west outside cell (col ci0-1): its east-face flux is replaced by the
    # fine transport, dV_out = +(Tc - Tf)
    zeta, t = col_correct(zeta, t, jsl, ci0 - 1, Tc_w - Tf["w"])
    zeta, t = col_correct(zeta, t, jsl, ci1, Tf["e"] - Tc_e)
    zeta, t = row_correct(zeta, t, cj0 - 1, isl, Tc_s - Tf["s"])
    zeta, t = row_correct(zeta, t, cj1, isl, Tf["n"] - Tc_n)

    from .ops import bc
    return sc_new.replace(zeta=bc.fill_halo(cfg_c, zeta),
                          t=bc.fill_halo(cfg_c, t))


def _fine_contact_transports(cfg_f: Config, sf, spec: RefineSpec,
                             njc: int, nic: int, margin: int = 1):
    """One fine substep's transports through the replaced-block contact
    faces, r fine faces grouped into 1 coarse face (m3)."""
    r = spec.factor
    Hf = cfg_f.halo
    m = margin
    dtf = cfg_f.dt
    fj0 = Hf + m * r
    fi0 = Hf + m * r

    def grp_u(col):
        seg = sf.DU_avg2[fj0:fj0 + njc * r, col]
        return dtf * seg.reshape(njc, r).sum(-1)

    def grp_v(row):
        seg = sf.DV_avg2[row, fi0:fi0 + nic * r]
        return dtf * seg.reshape(nic, r).sum(-1)

    return {"w": grp_u(fi0), "e": grp_u(fi0 + nic * r),
            "s": grp_v(fj0), "n": grp_v(fj0 + njc * r)}


# ---------------------------------------------------------------------------
# nested stepping driver (main3d's nesting sync points reduced to the
# refinement schedule: coarse step -> factor fine steps -> feedback)
# ---------------------------------------------------------------------------
def make_nested_stepper(cfg_c: Config, grid_c: Grid, cfg_f: Config,
                        grid_f: Grid, spec: RefineSpec,
                        forcing_c: Optional[Callable] = None,
                        forcing_f: Optional[Callable] = None,
                        two_way: bool = True,
                        conserve: bool = False,
                        flux_coupling: bool = False):
    """Returns step_nested(state_c, state_f) -> (state_c, state_f), one
    PARENT step of the pair: the parent step, then `factor` fine steps
    with their `bry` interpolated in time between the parent states
    before and after, then the two-way feedback.

    conserve: the contact-line mass-flux correction (conserve_bry_flux)
    and Hz-weighted fine->coarse feedback.  flux_coupling: also reconcile
    the parent step with the fine contact transports
    (contact_flux_correction), so global volume and tracer constancy hold
    together."""
    from . import stepping
    r = spec.factor
    m = 1
    Hc = cfg_c.halo
    njc = (Hc + spec.jend - m) - (Hc + spec.jstr - 1 + m)
    nic = (Hc + spec.iend - m) - (Hc + spec.istr - 1 + m)

    def step_nested(sc, sf):
        bry0 = extract_bry(cfg_c, grid_c, sc, spec, cfg_f)
        sc_new = stepping.step(cfg_c, grid_c, sc, forcing_c)
        bry1 = extract_bry(cfg_c, grid_c, sc_new, spec, cfg_f)
        if conserve:
            bry0 = conserve_bry_flux(cfg_c, grid_c, sc, spec,
                                     cfg_f, grid_f, bry0)
            bry1 = conserve_bry_flux(cfg_c, grid_c, sc_new, spec,
                                     cfg_f, grid_f, bry1)
        Tf = None
        for msub in range(1, r + 1):
            w = msub / r
            bry = {k: (1.0 - w) * bry0[k] + w * bry1[k] for k in bry0}

            def ffn_f(cfg, grid, time, _bry=bry):
                frc = dict(forcing_f(cfg, grid, time)) if forcing_f \
                    else {}
                frc["bry"] = _bry
                return frc

            sf = stepping.step(cfg_f, grid_f, sf, ffn_f)
            if flux_coupling:
                Ts = _fine_contact_transports(cfg_f, sf, spec, njc, nic,
                                              margin=m)
                Tf = Ts if Tf is None else {k: Tf[k] + Ts[k] for k in Tf}
        if two_way:
            sc_new = fine2coarse(cfg_c, sc_new, cfg_f, sf, spec,
                                 grid_f=grid_f if conserve else None)
            if flux_coupling:
                sc_new = contact_flux_correction(
                    cfg_c, grid_c, sc_new, cfg_f, spec, Tf, margin=m)
        return sc_new, sf

    return step_nested


# =====================================================================
# Composite grids (nesting.F composite class; DOGBONE-style)
# =====================================================================
@dataclass(frozen=True)
class CompositeSpec:
    """Two same-resolution grids abutting along an eta-parallel line,
    overlapping by `olap` rho columns (set_contact.F's composite contact
    regions; equal spacing makes every contact point a donor column).

    Grid A is the west grid, grid B the east: B's ROMS column i is A's
    column i + offset, offset = Lm_A - olap.  Both grids step together;
    each takes the other's interior as clamped boundary data on the
    contact side (get_composite, one-step lag)."""
    olap: int = 4


def composite_bry_pair(cfg_a: Config, state_a, cfg_b: Config, state_b,
                       spec: CompositeSpec):
    """Contact boundary data: (bry for A's east side, bry for B's west
    side), full padded columns ((N, ny) / (NT, N, ny) for 3-D fields) as
    ops/obc.py's clamped conditions read them."""
    Ha, Hb = cfg_a.halo, cfg_b.halo
    off = cfg_a.Lm - spec.olap

    def cols(state, rho_col, u_col):
        return {
            "zeta": state.zeta[..., :, rho_col],
            "vbar": state.vbar[..., :, rho_col],
            "v": state.v[..., :, rho_col],
            "t": state.t[..., :, rho_col],
            "ubar": state.ubar[..., :, u_col],
            "u": state.u[..., :, u_col],
        }

    # B's west rings: rho ring (B ROMS i=0) -> A col off+Ha-1; u ring (B
    # face i=1) -> A face off+Ha
    src_b = cols(state_a, off + Ha - 1, off + Ha)
    bry_b = {f"{k}_west": v for k, v in src_b.items()}
    # A's east rings: rho ring (A ROMS i=Lm+1) -> B col olap+Hb; u ring
    # (A face i=Lm+1) -> B face olap+Hb
    src_a = cols(state_b, spec.olap + Hb, spec.olap + Hb)
    bry_a = {f"{k}_east": v for k, v in src_a.items()}
    return bry_a, bry_b


def make_composite_stepper(cfg_a: Config, grid_a: Grid,
                           cfg_b: Config, grid_b: Grid,
                           spec: CompositeSpec,
                           ffn_a: Optional[Callable] = None,
                           ffn_b: Optional[Callable] = None):
    """(state_a, state_b) -> (state_a', state_b'): one step of both
    composite grids with each other's contact boundary data, then the
    overlap exchange."""
    from . import stepping

    def _wrap(ffn, bry):
        def f(cfg, grid, time, _bry=bry, _ffn=ffn):
            base = dict(_ffn(cfg, grid, time) or {}) if _ffn else {}
            merged = dict(base.get("bry", {}) or {})
            merged.update(_bry)
            base["bry"] = merged
            return base
        return f

    def step_pair(sa, sb):
        bry_a, bry_b = composite_bry_pair(cfg_a, sa, cfg_b, sb, spec)
        sa2 = stepping.step(cfg_a, grid_a, sa, _wrap(ffn_a, bry_a))
        sb2 = stepping.step(cfg_b, grid_b, sb, _wrap(ffn_b, bry_b))
        return composite_exchange(cfg_a, sa2, cfg_b, sb2, spec)

    return step_pair


def composite_exchange(cfg_a: Config, sa, cfg_b: Config, sb,
                       spec: CompositeSpec):
    """Post-step two-way contact-region refresh (nesting.F get_composite's
    in-step sync points): each grid's half of the overlap and its ghost
    ring take the other grid's interior solution, so the overlap acts as
    a once-a-step halo exchange.  The interface sits mid-overlap; the
    staleness of the boundary clamp reaches only the outer olap/2
    columns, which are replaced here."""
    Ha, Hb = cfg_a.halo, cfg_b.halo
    off = cfg_a.Lm - spec.olap
    half = spec.olap // 2
    na = cfg_a.nx_tot
    dev = sa.zeta.device

    # A gets B's solution for global ROMS columns > LA - half (through A's
    # ghost ring); B gets A's for global columns <= off + half
    a_lo = (cfg_a.Lm - half) + Ha          # first A padded col replaced
    b_cols = torch.arange(a_lo, na, device=dev) - Ha + 1 - off + Hb - 1
    b_hi = half + Hb                       # B padded cols [0, b_hi)
    a_cols = torch.arange(0, b_hi, device=dev) - Hb + 1 + off + Ha - 1

    def swap(xa, xb):
        xa2 = xa.clone()
        xa2[..., :, a_lo:] = torch.index_select(xb, -1, b_cols)
        xb2 = xb.clone()
        xb2[..., :, :b_hi] = torch.index_select(xa, -1, a_cols)
        return xa2, xb2

    fields = ("zeta", "ubar", "vbar", "u", "v", "t", "rzeta", "rubar",
              "rvbar", "rufrc0_prev", "rufrc0_prev2", "rvfrc0_prev",
              "rvfrc0_prev2", "ru_prev", "ru_prev2", "rv_prev",
              "rv_prev2", "t_prev")
    upd_a, upd_b = {}, {}
    for f in fields:
        xa = getattr(sa, f, None)
        xb = getattr(sb, f, None)
        if xa is None or xb is None or xa.ndim < 2 or xa.numel() == 0:
            continue
        upd_a[f], upd_b[f] = swap(xa, xb)
    return sa.replace(**upd_a), sb.replace(**upd_b)


def composite_lbc(side: str) -> LBC:
    """Clamped LBC on a contact side, closed elsewhere (for building
    composite members)."""
    kw = {"west": ("Cla", "Clo", "Clo", "Clo"),
          "east": ("Clo", "Clo", "Cla", "Clo")}[side]
    return LBC(*kw)
