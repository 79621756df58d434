"""roms_tpu_torch's MPDATA tracer advection against roms_tpu's, in float64 on
the CPU, and analogs of tests/test_mpdata.py on the port's step.

(a) mpdata_adiff and mpdata_corrected_fluxes on a small closed grid with
    land points and an open west side for u, on tracer fields that reach
    both sides of every select: the guard (a neighbour at or below zero,
    two equal neighbours, and ordinary ones), the limiter's land value and
    its beta ratios above and below 1;
(b) the MPDATA predictor (first-order upstream fluxes, gamma = 1/2) and
    corrector (the upstream pass, the anti-diffusive pass and the implicit
    vertical diffusion) of the step on the same fields, for iic 0 and 5;
(c) tests/test_mpdata.py's checks on the port's UPWELLING: a constant
    tracer stays constant, a blob stays within its range, MPDATA keeps a
    sharper peak than first-order upstream, and MPDATA in one direction
    only raises.

Tolerance 1e-12 x max|field| over the whole padded array (RTOL; one pass
of arithmetic, measured at most a few 1e-16 on this grid).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from roms_tpu import vgrid as jvgrid
from roms_tpu.config import Config as JConfig, LBC as JLBC
from roms_tpu.grid import hc_of
from roms_tpu.ops import mpdata as jmp, pre_step3d as jpre, \
    step3d_t as jst
from roms_tpu.ops.omega import omega as jomega, set_massflux as jmassflux
from roms_tpu_torch import stepping
from roms_tpu_torch.config import LBC
from roms_tpu_torch.models import upwelling as tup
from roms_tpu_torch.ops import bc as tbc, mpdata as tmp, \
    pre_step3d as tpre, step3d_t as tst
from roms_tpu_torch.ops.stencil import ip1, jp1
from test_torch_obc import J, T, _close, _depth, _mask, jit, regional_pair

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def case():
    """A closed 14 x 10 x 5 grid with land, u open (gradient) on the west,
    MPDATA tracers, a random flow and tracer fields that reach every
    branch."""
    cfg = JConfig(name="mpdata", Lm=14, Mm=10, N=5, ntracers=2,
                  ew_periodic=False, ns_periodic=False, dt=300.0,
                  ndtfast=10, theta_s=3.0, theta_b=0.0, tcline=25.0,
                  t_hadv=("MPDATA", "MPDATA"), t_vadv=("MPDATA", "MPDATA"),
                  splines_vdiff=False, akt_bak=(1e-5, 1e-5),
                  lbc_u=JLBC("Gra", "Clo", "Clo", "Clo"))
    cfg_j, grid_j, cfg_t, grid_t = regional_pair(
        cfg, 14 * 4.0e3, 10 * 4.0e3, 1.0e-4, _depth, _mask)
    rng = np.random.default_rng(17)
    N = cfg_j.N
    s2 = (cfg_j.ny_tot, cfg_j.nx_tot)
    s3, sw = (N,) + s2, (N + 1,) + s2

    def flow(zeta, u, v):
        z_r, z_w, Hz = jvgrid.set_depth(
            grid_j.h, zeta, hc_of(cfg_j), grid_j.sc_r, grid_j.Cs_r,
            grid_j.sc_w, grid_j.Cs_w, cfg_j.vtransform)
        Huon, Hvom = jmassflux(cfg_j, grid_j, u, v, Hz)
        return z_r, z_w, Hz, Huon, Hvom, jomega(cfg_j, grid_j, Huon, Hvom,
                                                z_w)

    zeta = 0.3 * rng.standard_normal(s2)
    out = jit(flow, J(zeta), J(0.3 * rng.standard_normal(s3)),
              J(0.3 * rng.standard_normal(s3)))
    f = dict(zip(("z_r", "z_w", "Hz", "Huon", "Hvom", "W"),
                 map(np.asarray, out)))

    def tracer():
        q = 1.0 + 0.5 * rng.random(s3)
        q[:, 3:5, 3:7] = 1.25                # equal neighbours
        q[0, 7, 8] = 0.0                     # the guard's q <= 0
        q[2, 8, 5] = -0.05
        q[1:3, 5:7, 10:12] *= 3.0            # a sharp local maximum
        return q

    f.update(Ta=tracer(), t3=tracer(),
             t=np.stack([tracer(), tracer()]),
             t_prev=np.stack([tracer(), tracer()]),
             t_nnew=np.stack([tracer(), tracer()]) * f["Hz"],
             Akt=1e-4 * (1.0 + rng.random((2,) + sw)),
             stflx=1e-5 * rng.standard_normal((2,) + s2),
             btflx=1e-6 * rng.standard_normal((2,) + s2))
    return cfg_j, grid_j, cfg_t, grid_t, f


def test_mpdata_adiff_and_fluxes(case):
    cfg_j, grid_j, cfg_t, grid_t, f = case
    oHz = 1.0 / f["Hz"]
    ref = jit(lambda *a: jmp.mpdata_adiff(cfg_j, grid_j, *a),
              J(f["t3"]), J(f["Ta"]), J(f["Huon"]), J(f["Hvom"]), J(f["W"]),
              J(oHz), J(f["z_r"]))
    got = tmp.mpdata_adiff(cfg_t, grid_t, T(f["t3"]), T(f["Ta"]),
                           T(f["Huon"]), T(f["Hvom"]), T(f["W"]), T(oHz),
                           T(f["z_r"]))
    for name, a, b in zip(("Ua", "Va", "Wa"), got, ref):
        _close(a, b, name)
    # the guard zeroed some faces and left others
    Ua = got[0].numpy()
    assert (Ua == 0.0).sum() > 0 and (Ua != 0.0).sum() > 100
    ref_f = jit(lambda *a: jmp.mpdata_corrected_fluxes(grid_j, *a),
                J(f["Ta"]), *map(J, ref), J(f["Hz"]))
    got_f = tmp.mpdata_corrected_fluxes(grid_t, T(f["Ta"]), *got,
                                        T(f["Hz"]))
    for name, a, b in zip(("FX", "FE", "FC"), got_f, ref_f):
        _close(a, b, name)


_PRE = ("t", "t_prev", "Hz", "z_r", "Huon", "Hvom", "W", "Akt", "stflx",
        "btflx")
_COR = ("t_nnew", "t3", "Huon", "Hvom", "W", "Hz", "z_r", "Akt")
ITERS = (0, 5)


@pytest.fixture(scope="module")
def reference_steps(case):
    """roms_tpu's predictor and corrector for each iic of ITERS, each
    compiled once with iic an argument."""
    cfg_j, grid_j, _, _, f = case
    z3 = J(np.zeros_like(f["Hz"]))
    z2 = J(np.zeros_like(f["stflx"][0]))

    def pre(iic, t, t_prev, Hz, z_r, Huon, Hvom, W, Akt, stflx, btflx):
        return jpre.pre_step3d(cfg_j, grid_j, iic, t, t_prev, z3, z3, Hz,
                               z_r, Huon, Hvom, W, Akt, z2, z2, z2, z2,
                               stflx, btflx, z3, z3, z3, z3,
                               momentum=False)[:2]

    pre = jax.jit(pre)
    cor = jax.jit(lambda iic, *a: jst.step3d_t(cfg_j, grid_j, iic, *a))
    vals = {**f, "t3": np.stack([f["t3"], f["Ta"]])}
    return {iic: (pre(iic, *(J(f[k]) for k in _PRE)),
                  cor(iic, *(J(vals[k]) for k in _COR)))
            for iic in ITERS}


@pytest.mark.parametrize("iic", ITERS)
def test_mpdata_predictor_and_corrector(case, reference_steps, iic):
    _, _, cfg_t, grid_t, f = case
    ref_pre, ref_cor = reference_steps[iic]
    got = tpre.tracer_phase(cfg_t, grid_t, iic, T(f["t"]), T(f["t_prev"]),
                            T(f["Hz"]), T(f["Huon"]), T(f["Hvom"]),
                            T(f["W"]), T(f["Akt"]), T(f["stflx"]),
                            T(f["btflx"]))
    for name, a, b in zip(("t3", "t_nnew"), got, ref_pre):
        _close(a, b, name)
    vals = {**f, "t3": np.stack([f["t3"], f["Ta"]])}
    got = tst.step3d_t(cfg_t, grid_t, *(T(vals[k]) for k in _COR))
    _close(got, ref_cor, "t_new")


# ---- tests/test_mpdata.py's checks on the port's step ----

def _make(hadv="MPDATA", vadv="MPDATA"):
    cfg = tup.make_config(Lm=16, Mm=24, N=8, ndtfast=10)
    cfg = cfg.replace(t_hadv=(hadv,) * 2, t_vadv=(vadv,) * 2)
    return tup.build(cfg, device="cpu")


def _interior(cfg, a):
    H = cfg.halo
    return a[..., H:H + cfg.Mm, H:H + cfg.Lm].numpy()


@pytest.fixture(scope="module")
def upw():
    return _make()


def test_mpdata_constancy(upw):
    cfg, grid, s0, ffn = upw
    tc = torch.stack([torch.full_like(s0.t[0], 14.0),
                      torch.full_like(s0.t[0], 35.0)])
    s = stepping.run(cfg, grid, s0.replace(t=tc, t_prev=tc.clone()), 8, ffn)
    assert np.abs(_interior(cfg, s.t[0]) - 14.0).max() < 1e-7
    assert np.abs(_interior(cfg, s.t[1]) - 35.0).max() < 1e-7


def test_mpdata_positivity_and_bounds(upw):
    """A positive blob in the upwelling flow stays within [0, 1] (the
    residual is the split-explicit constancy error, as in roms_tpu)."""
    cfg, grid, s0, ffn = upw
    H = cfg.halo
    t = s0.t.clone()
    t[1] = 0.0
    t[1, :, H + 8:H + 14, H + 4:H + 10] = 1.0
    s = stepping.run(cfg, grid, s0.replace(t=t, t_prev=t.clone()), 25, ffn)
    q = _interior(cfg, s.t[1])
    assert np.isfinite(q).all()
    assert q.min() > -1e-7
    assert q.max() < 1.0 + 1e-7


def test_mpdata_beats_upstream_diffusion():
    """Uniform 1-D advection of a Gaussian: the anti-diffusive pass keeps a
    much sharper peak than first-order upstream, and stays monotone."""
    cfg = tup.make_config(Lm=64, Mm=8, N=4, ndtfast=10)
    cfg = cfg.replace(ns_periodic=True, ew_periodic=True,
                      lbc_t=LBC.doubly_periodic())
    _, grid, s0, _ = tup.build(cfg, device="cpu")
    H = cfg.halo
    Ny, Nx = s0.zeta.shape
    N, dt = cfg.N, cfg.dt
    Hz = torch.full((N, Ny, Nx), 10.0, dtype=torch.float64)
    oHz = 1.0 / Hz
    Huon = 0.5 * Hz * grid.on_u          # u = 0.5 m/s, Courant 0.15
    Hvom = torch.zeros_like(Huon)
    W = torch.zeros((N + 1, Ny, Nx), dtype=torch.float64)
    z_r = torch.cumsum(Hz, 0) - 5.0 - 40.0
    pmn = grid.pm * grid.pn
    x = torch.arange(Nx, dtype=torch.float64)
    q0 = 1.0 + torch.exp(-0.5 * ((x - H - 20) / 3.0) ** 2)
    q = tbc.fill_halo(cfg, q0[None, None, :].expand(N, Ny, Nx))

    def step_u1(q):
        FX = torch.clamp(Huon, min=0.0) * torch.roll(q, 1, -1) + \
            torch.clamp(Huon, max=0.0) * q
        return tbc.fill_halo(cfg, (q * Hz - dt * pmn * (ip1(FX) - FX)) * oHz)

    def step_mp(q):
        Ta = step_u1(q)
        Ua, Va, Wa = tmp.mpdata_adiff(cfg, grid, q, Ta, Huon, Hvom, W, oHz,
                                      z_r)
        FX2, FE2, FC2 = tmp.mpdata_corrected_fluxes(grid, Ta, Ua, Va, Wa,
                                                    Hz)
        tn = Ta * Hz - dt * pmn * ((ip1(FX2) - FX2) + (jp1(FE2) - FE2) +
                                   (FC2[1:] - FC2[:-1]))
        return tbc.fill_halo(cfg, tn * oHz)

    qm, qu = q, q
    for _ in range(40):
        qm = step_mp(qm)
        qu = step_u1(qu)
    pm_prof = qm[0, H].numpy()
    pu_prof = qu[0, H].numpy()
    assert pm_prof.max() > pu_prof.max() + 0.1
    assert pm_prof.max() <= float(q0.max()) + 1e-12
    assert pm_prof.min() >= 1.0 - 1e-12


def test_mpdata_requires_both_directions():
    cfg, grid, s0, ffn = _make(hadv="MPDATA", vadv="C4")
    with pytest.raises(ValueError, match="both directions"):
        stepping.step(cfg, grid, s0, ffn)
