"""roms_tpu_torch stage parity, part 1: set_vbc, the tridiagonal solves,
tracer advection and pre_step3d against roms_tpu's functions, on a small
grid in float64, to 1e-12 x max|field| over the whole padded array."""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from roms_tpu import vgrid as jvgrid
from roms_tpu.config import LBC as JLBC, BC_GRADIENT
from roms_tpu.grid import build_grid as jbuild_grid, hc_of
from roms_tpu.models import upwelling as jup
from roms_tpu.ops import advection as jadv, pre_step3d as jpre, \
    stencil as jsten, tridiag as jtri, vbc as jvbc
from roms_tpu.ops.omega import omega as jomega, set_massflux as jmassflux
from roms_tpu_torch import convert
from roms_tpu_torch.models import upwelling as tup
from roms_tpu_torch.ops import advection as tadv, pre_step3d as tpre, \
    stencil as tsten, tridiag as ttri, vbc as tvbc

torch.set_num_threads(1)

RTOL = 1e-12


def _close(got, ref, name=""):
    got, ref = got.numpy(), np.asarray(ref)
    assert got.shape == ref.shape, name
    scale = max(np.abs(ref).max(), 1e-300)
    np.testing.assert_allclose(got, ref, rtol=0, atol=RTOL * scale,
                               err_msg=name)


T = lambda a: torch.tensor(np.asarray(a))      # noqa: E731
J = jnp.asarray


def build_pair(cfg):
    """An UPWELLING configuration and grid in both packages, on the CPU,
    each built by its own package from the same unfinished configuration.
    roms_tpu builds only the grid, with jup.build's arguments: its eager
    initial state is not needed here and costs ~1.4 s a shape."""
    grid_j, cfg_j = jbuild_grid(cfg, 1000.0 * cfg.Lm, 1000.0 * cfg.Mm,
                                f0=-8.26e-5, beta=0.0,
                                depth_fn=jup._depth_fn)
    cfg_t, grid_t, _, _ = tup.build(convert.config_from_reference(cfg),
                                    device="cpu")
    assert convert.config_from_reference(cfg_j) == cfg_t
    return cfg_j, grid_j, cfg_t, grid_t


@pytest.fixture(scope="module", params=["upwelling", "closed"])
def case(request):
    """A small grid and a consistent set of random fields, as numpy."""
    cfg = jup.make_config(Lm=14, Mm=12, N=6, ndtfast=6)
    if request.param == "closed":
        grad = JLBC(BC_GRADIENT, BC_GRADIENT, BC_GRADIENT, BC_GRADIENT)
        cfg = dataclasses.replace(
            cfg, ew_periodic=False, lbc_zeta=JLBC(), lbc_ubar=JLBC(),
            lbc_vbar=JLBC(), lbc_u=JLBC(), lbc_v=JLBC(), lbc_t=grad,
            gamma2=-1.0)
    cfg_j, grid_j, cfg_t, grid_t = build_pair(cfg)
    rng = np.random.default_rng(11)
    N = cfg_j.N
    s2 = (cfg_j.ny_tot, cfg_j.nx_tot)
    s3, sw = (N,) + s2, (N + 1,) + s2
    zeta = 0.3 * rng.standard_normal(s2)
    z_r, z_w, Hz = jvgrid.set_depth(grid_j.h, jnp.asarray(zeta),
                                    hc_of(cfg_j), grid_j.sc_r, grid_j.Cs_r,
                                    grid_j.sc_w, grid_j.Cs_w, 2)
    u = 0.2 * rng.standard_normal(s3)
    v = 0.2 * rng.standard_normal(s3)
    Huon, Hvom = jmassflux(cfg_j, grid_j, jnp.asarray(u), jnp.asarray(v),
                           Hz)
    W = jomega(cfg_j, grid_j, Huon, Hvom, z_w)
    f = dict(
        zeta=zeta, u=u, v=v, z_r=np.asarray(z_r), z_w=np.asarray(z_w),
        Hz=np.asarray(Hz), Huon=np.asarray(Huon), Hvom=np.asarray(Hvom),
        W=np.asarray(W),
        t=np.stack([14.0 + 4.0 * rng.random(s3), 35.0 + rng.random(s3)]),
        t_prev=np.stack([14.0 + 4.0 * rng.random(s3),
                         35.0 + rng.random(s3)]),
        Akv=1e-4 + 1e-2 * rng.random(sw),
        Akt=1e-5 + 1e-2 * rng.random((2,) + sw),
        stress=[1e-4 * rng.standard_normal(s2) for _ in range(4)],
        tflux=[1e-5 * rng.standard_normal((2,) + s2) for _ in range(2)],
        hist=[1e-2 * rng.standard_normal(s3) for _ in range(4)])
    return cfg_j, grid_j, cfg_t, grid_t, f


def test_stencil_helpers_match(case):
    _, _, _, _, f = case
    a = f["u"]
    for name in ("ip1", "im1", "jp1", "jm1", "at_u", "at_v", "at_p",
                 "u_to_r", "v_to_r", "dxi_r", "deta_r", "dxi_u", "deta_v"):
        _close(getattr(tsten, name)(T(a)), getattr(jsten, name)(J(a)), name)
    _close(tsten.shift(T(a), 2, -1), jsten.shift(J(a), 2, -1), "shift")
    ks = np.random.default_rng(5).integers(-1, a.shape[0] + 1,
                                           size=a.shape[1:])
    _close(tsten.take_k(T(a), torch.tensor(ks)), jsten.take_k(J(a), J(ks)),
           "take_k")
    _close(tsten.take_k(T(f["t"]).transpose(0, 1), torch.tensor(ks)),
           jsten.take_k(J(f["t"]).transpose(1, 0, 2, 3), J(ks)), "take_k 4-D")


@pytest.mark.parametrize("drag", ["linear", "quadratic", None])
def test_set_vbc_matches(case, drag):
    cfg_j, grid_j, cfg_t, grid_t, f = case
    cfg_j = dataclasses.replace(cfg_j, bottom_drag=drag)
    cfg_t = dataclasses.replace(cfg_t, bottom_drag=drag)
    ref = jvbc.set_vbc(cfg_j, grid_j, jnp.asarray(f["u"]),
                       jnp.asarray(f["v"]), jnp.asarray(f["t"]),
                       *[jnp.asarray(a) for a in f["tflux"]])
    got = tvbc.set_vbc(cfg_t, grid_t, T(f["u"]), T(f["v"]), T(f["t"]),
                       *[T(a) for a in f["tflux"]])
    for a, b, name in zip(got, ref, ("bustr", "bvstr", "stflx", "btflx")):
        _close(a, b, name)


def test_tridiagonal_solves_match(case):
    _, _, _, _, f = case
    dt = 300.0
    Hz, Akv, q = f["Hz"], f["Akv"], f["u"]
    _close(ttri.spline_vdiff_flux(dt, T(Hz), T(1.0 / Hz), T(Akv), T(q)),
           jtri.spline_vdiff_flux(dt, jnp.asarray(Hz),
                                  jnp.asarray(1.0 / Hz), jnp.asarray(Akv),
                                  jnp.asarray(q)), "spline_vdiff_flux")
    for ends in ((1.5, 0.5, 3.0, 2.0), (2.0, 1.0, 2.0, 1.0)):
        _close(ttri.spline_interp_flux(T(Hz), T(q), T(f["W"]), *ends),
               jtri.spline_interp_flux(jnp.asarray(Hz), jnp.asarray(q),
                                       jnp.asarray(f["W"]), *ends),
               f"spline_interp_flux {ends}")
    rhs = q * Hz
    _close(ttri.thomas_implicit(dt, 1.0, T(Hz), T(f["z_r"]), T(Akv),
                                T(rhs)),
           jtri.thomas_implicit(dt, 1.0, jnp.asarray(Hz),
                                jnp.asarray(f["z_r"]), jnp.asarray(Akv),
                                jnp.asarray(rhs)), "thomas_implicit")


@pytest.mark.parametrize("scheme", ["U3", "C4"])
def test_hadv_fluxes_match(case, scheme):
    cfg_j, _, cfg_t, _, f = case
    q = f["t"][0]
    ref = jadv.hadv_fluxes(cfg_j, scheme, jnp.asarray(q),
                           jnp.asarray(f["Huon"]), jnp.asarray(f["Hvom"]))
    got = tadv.hadv_fluxes(cfg_t, scheme, T(q), T(f["Huon"]),
                           T(f["Hvom"]))
    _close(got[0], ref[0], "FX")
    _close(got[1], ref[1], "FE")


@pytest.mark.parametrize("scheme,variant", [
    ("SPLINES", "predictor"), ("SPLINES", "corrector"), ("C4", "predictor"),
    ("C4", "corrector")])
def test_vadv_flux_matches(case, scheme, variant):
    _, _, _, _, f = case
    q = f["t"][0]
    ref = jadv.vadv_flux(scheme, jnp.asarray(q), jnp.asarray(f["W"]),
                         jnp.asarray(f["Hz"]), variant)
    _close(tadv.vadv_flux(scheme, T(q), T(f["W"]), T(f["Hz"]), variant),
           ref)


@pytest.mark.parametrize("iic", [0, 1, 5])
def test_pre_step3d_matches(case, iic):
    cfg_j, grid_j, cfg_t, grid_t, f = case
    names = ("t", "t_prev", "u", "v", "Hz", "z_r", "Huon", "Hvom", "W",
             "Akt")
    ref = jpre.pre_step3d(
        cfg_j, grid_j, iic, *[jnp.asarray(f[k]) for k in names],
        *[jnp.asarray(a) for a in f["stress"] + f["tflux"] + f["hist"]])
    got = tpre.pre_step3d(
        cfg_t, grid_t, iic, *[T(f[k]) for k in names],
        *[T(a) for a in f["stress"] + f["tflux"] + f["hist"]])
    for a, b, name in zip(got, ref, ("t3", "t_nnew", "u_nnew", "v_nnew")):
        _close(a, b, name)
