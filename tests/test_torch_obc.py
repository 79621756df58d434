"""roms_tpu_torch stage parity for the regional branches: every open-boundary
kind through obc.zetabc/u2dbc/v2dbc/t3dbc/u3dbc/v3dbc, obc_volcons, the
clamped ring of bc.apply_bc_rho, the three point-source functions, HSIMT
and first-order upstream advection in both flow directions, and the
logarithmic bottom drag, against roms_tpu's functions on a small closed
grid with land points, in float64.

Tolerance: 1e-12 x max|field| over the whole padded array (RTOL).  These
stages are one pass of arithmetic; measured on this grid every output is
within 2.35e-16 x max|field| (most are bitwise equal; the Chapman sqrt
and the drag's log are torch's, not XLA's)."""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import roms_tpu.config as jconfig
from roms_tpu import vgrid as jvgrid
from roms_tpu.config import (Config as JConfig, LBC as JLBC, BC_CLAMPED,
                             BC_CHAPMAN_EXPLICIT, BC_CHAPMAN_IMPLICIT,
                             BC_FLATHER, BC_RADIATION, BC_REDUCED,
                             BC_SHCHEPETKIN)
from roms_tpu.grid import build_grid as jbuild_grid, hc_of
from roms_tpu.ops import advection as jadv, bbl as jbbl, bc as jbc, \
    bio_models as jbio_models, biology as jbiology, obc as jobc, \
    sediment as jsediment, sources as jsrc, vbc as jvbc
from roms_tpu.ops.omega import omega as jomega, set_massflux as jmassflux
from roms_tpu_torch import convert
from roms_tpu_torch.grid import build_grid as tbuild_grid
from roms_tpu_torch.ops import advection as tadv, bc as tbc, obc as tobc, \
    sources as tsrc, vbc as tvbc

torch.set_num_threads(1)

RTOL = 1e-12
SIDES = ("west", "south", "east", "north")

T = lambda a: torch.tensor(np.asarray(a))      # noqa: E731
J = jnp.asarray


def jit(fn, *args, **kw):
    """fn(*args, **kw) under jax.jit: one compile, where eager JAX compiles
    every operation (the tensors pass as arguments, the rest is closed
    over)."""
    return jax.jit(lambda a, k: fn(*a, **k))(args, kw)


def _close(got, ref, name=""):
    got, ref = got.numpy(), np.asarray(ref)
    assert got.shape == ref.shape, name
    scale = max(np.abs(ref).max(), 1e-300)
    np.testing.assert_allclose(got, ref, rtol=0, atol=RTOL * scale,
                               err_msg=name)


def jax_config(cfg):
    """roms_tpu's Config with the field values of the port's (its nested
    parameter classes from roms_tpu.config, ops.sediment, ops.bbl,
    ops.biology or ops.bio_models)."""
    kw = {}
    for f in dataclasses.fields(jconfig.Config):
        val = getattr(cfg, f.name)
        if dataclasses.is_dataclass(val):
            name = type(val).__name__
            home = next(m for m in (jconfig, jsediment, jbbl, jbiology,
                                    jbio_models) if hasattr(m, name))
            val = getattr(home, name)(**dataclasses.asdict(val))
        kw[f.name] = val
    return jconfig.Config(**kw)


def regional_pair(cfg_j, Xsize, Esize, f0, depth_fn, mask_fn=None):
    """A configuration and grid in both packages, on the CPU, each grid
    built by its own package from the same unfinished configuration."""
    grid_j, cfg_j = jbuild_grid(cfg_j, Xsize, Esize, f0=f0, beta=0.0,
                                depth_fn=depth_fn, mask_fn=mask_fn)
    cfg_t = convert.config_from_reference(dataclasses.replace(
        cfg_j, hmin=0.0, nfast=0))
    grid_t, cfg_t = tbuild_grid(cfg_t, Xsize, Esize, f0=f0, beta=0.0,
                                depth_fn=depth_fn, mask_fn=mask_fn,
                                device="cpu")
    assert convert.config_from_reference(cfg_j) == cfg_t
    return cfg_j, grid_j, cfg_t, grid_t


def _depth(x, y, i, j, c):
    return 40.0 + 15.0 * np.sin(x / 9.0e3) * np.cos(y / 7.0e3)


def _mask(x, y, i, j, c):
    # land at two boundary points and a block inside
    land = ((i == 1) & (j == 3)) | ((i == c.Lm) & (j == 5)) | \
        ((i >= 6) & (i <= 7) & (j >= 4) & (j <= 5))
    return np.where(land, 0.0, 1.0)


@pytest.fixture(scope="module")
def case():
    cfg = JConfig(name="obc", Lm=14, Mm=10, N=4, ntracers=2,
                  ew_periodic=False, ns_periodic=False, dt=300.0,
                  ndtfast=10, theta_s=3.0, theta_b=0.0, tcline=25.0,
                  bottom_drag="logarithmic", zob=0.01,
                  t_hadv=("HSIMT", "U1"), t_vadv=("HSIMT", "U1"))
    cfg_j, grid_j, cfg_t, grid_t = regional_pair(
        cfg, 14 * 4.0e3, 10 * 4.0e3, 1.0e-4, _depth, _mask)
    rng = np.random.default_rng(5)
    N = cfg_j.N
    ny, nx = cfg_j.ny_tot, cfg_j.nx_tot
    s2, s3 = (ny, nx), (N, ny, nx)
    f = {k: 0.1 * rng.standard_normal(s2) for k in
         ("z_know", "z_kout", "ub_know", "ub_kout", "vb_know", "vb_kout",
          "sustr", "bustr", "svstr", "bvstr")}
    f.update({k: 0.2 * rng.standard_normal(s3) for k in
              ("u_know", "u_kout", "v_know", "v_kout")})
    f.update({k: 10.0 + rng.standard_normal(s3) for k in
              ("t_know", "t_kout")})
    bry = {}
    for side in SIDES:
        n = ny if side in ("west", "east") else nx
        bry[f"zeta_{side}"] = 0.1 * rng.standard_normal(n)
        bry[f"ubar_{side}"] = 0.1 * rng.standard_normal(n)
        bry[f"vbar_{side}"] = 0.1 * rng.standard_normal(n)
        bry[f"u_{side}"] = 0.1 * rng.standard_normal((N, n))
        bry[f"v_{side}"] = 0.1 * rng.standard_normal((N, n))
        bry[f"temp_{side}"] = 10.0 + rng.standard_normal((N, n))
    return cfg_j, grid_j, cfg_t, grid_t, f, bry, rng


def _with(cfg_j, cfg_t, **lbc):
    """Both configurations with the named LBC fields set."""
    lbc_j = {k: JLBC(*v) for k, v in lbc.items()}
    cfg_j = dataclasses.replace(cfg_j, **lbc_j)
    return cfg_j, convert.config_from_reference(cfg_j)


def _bry_j(bry):
    return {k: J(v) for k, v in bry.items()}


def _bry_t(cfg_t, bry):
    return convert.fields_from_numpy(cfg_t, bry, device="cpu")


@pytest.mark.parametrize("kind, nudg", [
    (BC_RADIATION, (0.0, 0.0)), (BC_RADIATION, (1.0 / 3600.0, 1.0 / 86400.0)),
    (BC_CHAPMAN_EXPLICIT, (0.0, 0.0)), (BC_CHAPMAN_IMPLICIT, (0.0, 0.0)),
    (BC_CLAMPED, (0.0, 0.0))])
def test_zetabc(case, kind, nudg):
    cfg_j, grid_j, cfg_t, grid_t, f, bry, _ = case
    cfg_j, cfg_t = _with(cfg_j, cfg_t, lbc_zeta=(kind,) * 4)
    ref = jit(lambda *a, **k: jobc.zetabc(cfg_j, grid_j, cfg_j.lbc_zeta,
                                          *a, 20.0, **k, nudg=nudg),
              J(f["z_know"]), J(f["z_kout"]), bry=_bry_j(bry))
    got = tobc.zetabc(cfg_t, grid_t, cfg_t.lbc_zeta, T(f["z_know"]),
                      T(f["z_kout"]), 20.0, _bry_t(cfg_t, bry), nudg=nudg)
    _close(got, ref, kind)
    # every side's ring was written
    assert not np.array_equal(got.numpy(), f["z_kout"])


@pytest.mark.parametrize("kind", [BC_FLATHER, BC_SHCHEPETKIN, BC_REDUCED,
                                  BC_RADIATION, BC_CLAMPED])
@pytest.mark.parametrize("comp", ["u", "v"])
def test_2d_momentum_bc(case, kind, comp):
    """u2dbc / v2dbc, the kind on every side (the tangential sides take
    radiation and clamped only)."""
    cfg_j, grid_j, cfg_t, grid_t, f, bry, _ = case
    key = "lbc_ubar" if comp == "u" else "lbc_vbar"
    cfg_j, cfg_t = _with(cfg_j, cfg_t, **{key: (kind,) * 4})
    if comp == "u":
        args = ("ub_know", "ub_kout", "z_know")
        kw = dict(z_kout="z_kout", vb_know="vb_know", sustr="sustr",
                  bustr="bustr")
        fj, ft = jobc.u2dbc, tobc.u2dbc
    else:
        args = ("vb_know", "vb_kout", "z_know")
        kw = dict(z_kout="z_kout", ub_know="ub_know", svstr="svstr",
                  bvstr="bvstr")
        fj, ft = jobc.v2dbc, tobc.v2dbc
    ref = jit(lambda *a, **k: fj(cfg_j, grid_j, getattr(cfg_j, key), *a,
                                 25.0, **k),
              *[J(f[a]) for a in args], bry=_bry_j(bry),
              **{k: J(f[v]) for k, v in kw.items()})
    got = ft(cfg_t, grid_t, getattr(cfg_t, key), *[T(f[a]) for a in args],
             25.0, _bry_t(cfg_t, bry), **{k: T(f[v]) for k, v in kw.items()})
    _close(got, ref, f"{comp} {kind}")


@pytest.mark.parametrize("kind", [BC_RADIATION, BC_CLAMPED])
@pytest.mark.parametrize("field", ["t", "u", "v"])
def test_3d_bc(case, kind, field):
    """t3dbc (temperature, the "temp_<side>" data), u3dbc and v3dbc."""
    cfg_j, grid_j, cfg_t, grid_t, f, bry, _ = case
    key = {"t": "lbc_t", "u": "lbc_u", "v": "lbc_v"}[field]
    cfg_j, cfg_t = _with(cfg_j, cfg_t, **{key: (kind,) * 4})
    know, kout = f[f"{field}_know"], f[f"{field}_kout"]
    if field == "t":
        ref = jit(lambda *a: jobc.t3dbc(cfg_j, grid_j, cfg_j.lbc_t, *a,
                                        name="temp"),
                  J(know), J(kout), _bry_j(bry))
        got = tobc.t3dbc(cfg_t, grid_t, cfg_t.lbc_t, T(know), T(kout),
                         _bry_t(cfg_t, bry), name="temp")
    else:
        fj = getattr(jobc, f"{field}3dbc")
        ft = getattr(tobc, f"{field}3dbc")
        ref = jit(lambda *a: fj(cfg_j, grid_j, getattr(cfg_j, key), *a),
                  J(know), J(kout), _bry_j(bry))
        got = ft(cfg_t, grid_t, getattr(cfg_t, key), T(know), T(kout),
                 _bry_t(cfg_t, bry))
    _close(got, ref, f"{field} {kind}")
    assert not np.array_equal(got.numpy(), kout)


@pytest.mark.parametrize("sides", [("west", "east"), SIDES])
def test_obc_volcons(case, sides):
    cfg_j, grid_j, cfg_t, grid_t, f, _, _ = case
    ref = jit(lambda *a: jobc.obc_volcons(cfg_j, grid_j, *a, set(sides)),
              J(f["ub_kout"]), J(f["vb_kout"]), J(f["z_kout"]))
    got = tobc.obc_volcons(cfg_t, grid_t, T(f["ub_kout"]), T(f["vb_kout"]),
                           T(f["z_kout"]), set(sides))
    for a, b, n in zip(got, ref, ("ubar", "vbar")):
        _close(a, b, n)


def test_apply_bc_rho_clamped_ring(case):
    """The clamped rho ring from a `clamp` dict, and fill=False."""
    cfg_j, grid_j, cfg_t, grid_t, f, bry, _ = case
    cfg_j, cfg_t = _with(cfg_j, cfg_t, lbc_zeta=(BC_CLAMPED, "Clo",
                                                 BC_CLAMPED, "Gra"))
    clamp = {s: bry[f"zeta_{s}"] for s in SIDES}
    for fill in (True, False):
        ref = jbc.apply_bc_rho(cfg_j, cfg_j.lbc_zeta, J(f["z_kout"]),
                               mask=grid_j.rmask, clamp=_bry_j(clamp),
                               fill=fill)
        got = tbc.apply_bc_rho(cfg_t, cfg_t.lbc_zeta, T(f["z_kout"]),
                               mask=grid_t.rmask, clamp=_bry_t(cfg_t, clamp),
                               fill=fill)
        _close(got, ref, f"fill={fill}")


def _sources(cfg, rng):
    """Two u-face sources and one v-face source inside the grid."""
    H, N = cfg.halo, cfg.N
    shape = rng.random((N, 3)) + 0.1
    return dict(isrc=np.array([H + 1, H + 4, H + 9]),
                jsrc=np.array([H + 2, H + 7, H + 1]),
                dsrc=np.array([0, 1, 0]),
                Qbar=np.array([150.0, -40.0, 800.0]),
                Qshape=shape / shape.sum(axis=0),
                Tsrc=np.stack([10.0 + rng.random((N, 3)),
                               rng.random((N, 3))]))


def test_ubar_and_uv_sources(case):
    cfg_j, grid_j, cfg_t, grid_t, f, _, rng = case
    src = _sources(cfg_j, rng)
    sj = jsrc.PointSources(**{k: J(v) for k, v in src.items()})
    st = convert.sources_from_numpy(cfg_t, src, device="cpu")
    args = ("ub_kout", "vb_kout", "z_kout")
    ref = jit(lambda sj, *a: jsrc.apply_ubar_sources(
        sj, *a, grid_j.h, grid_j.on_u, grid_j.om_v),
        sj, *[J(f[a]) for a in args])
    got = tsrc.apply_ubar_sources(st, *[T(f[a]) for a in args], grid_t.h,
                                  grid_t.on_u, grid_t.om_v)
    for a, b, n in zip(got, ref, ("ubar", "vbar")):
        _close(a, b, n)
    _, z_w, _ = jvgrid.set_depth(grid_j.h, J(f["z_kout"]), hc_of(cfg_j),
                                 grid_j.sc_r, grid_j.Cs_r, grid_j.sc_w,
                                 grid_j.Cs_w, cfg_j.vtransform)
    ref = jit(lambda sj, *a: jsrc.apply_uv_sources(
        sj, *a, grid_j.on_u, grid_j.om_v),
        sj, J(f["u_kout"]), J(f["v_kout"]), z_w)
    u_in, v_in = T(f["u_kout"]), T(f["v_kout"])
    got = tsrc.apply_uv_sources(st, u_in, v_in, T(z_w), grid_t.on_u,
                                grid_t.om_v)
    for a, b, n in zip(got, ref, ("u", "v")):
        _close(a, b, n)
    # the inputs are left unchanged
    assert np.array_equal(u_in.numpy(), f["u_kout"])
    assert np.array_equal(v_in.numpy(), f["v_kout"])


def test_tracer_flux_sources(case):
    cfg_j, grid_j, cfg_t, grid_t, f, _, rng = case
    src = _sources(cfg_j, rng)
    sj = jsrc.PointSources(**{k: J(v) for k, v in src.items()})
    st = convert.sources_from_numpy(cfg_t, src, device="cpu")
    FX, FE, Huon, Hvom = (rng.standard_normal(f["u_kout"].shape)
                          for _ in range(4))
    for itrc in (0, 1):
        ref = jit(lambda sj, *a: jsrc.apply_tracer_flux_sources(
            sj, itrc, *a), sj, J(FX), J(FE), J(Huon), J(Hvom))
        got = tsrc.apply_tracer_flux_sources(st, itrc, T(FX), T(FE),
                                             T(Huon), T(Hvom))
        for a, b, n in zip(got, ref, ("FX", "FE")):
            _close(a, b, f"{n} tracer {itrc}")


def _flow(cfg_j, grid_j, f, sign):
    """Depths and mass fluxes of the random state, the velocities times
    `sign` (so both flow directions cross every face type)."""
    def flow(zeta, u, v):
        z_r, z_w, Hz = jvgrid.set_depth(
            grid_j.h, zeta, hc_of(cfg_j), grid_j.sc_r, grid_j.Cs_r,
            grid_j.sc_w, grid_j.Cs_w, cfg_j.vtransform)
        Huon, Hvom = jmassflux(cfg_j, grid_j, u, v, Hz)
        return z_r, z_w, Hz, Huon, Hvom, jomega(cfg_j, grid_j, Huon, Hvom,
                                                z_w)
    return jit(flow, J(f["z_kout"]), sign * J(f["u_kout"]),
               sign * J(f["v_kout"]))


@pytest.mark.parametrize("sign", [1.0, -1.0])
@pytest.mark.parametrize("scheme", ["HSIMT", "U1"])
def test_tracer_advection(case, scheme, sign):
    """Horizontal and vertical fluxes, the flow and its reverse (HSIMT's
    inflow special cases at the west/east and south/north edges)."""
    cfg_j, grid_j, cfg_t, grid_t, f, _, _ = case
    z_r, _, Hz, Huon, Hvom, W = _flow(cfg_j, grid_j, f, sign)
    q = f["t_kout"]
    ref = jit(lambda q, Huon, Hvom, Hz: jadv.hadv_fluxes(
        cfg_j, scheme, q, Huon, Hvom, grid=grid_j, Hz=Hz, dt=cfg_j.dt),
        J(q), Huon, Hvom, Hz)
    got = tadv.hadv_fluxes(cfg_t, scheme, T(q), T(Huon), T(Hvom),
                           grid=grid_t, Hz=T(Hz), dt=cfg_t.dt)
    for a, b, n in zip(got, ref, ("FX", "FE")):
        _close(a, b, f"{scheme} {n}")
    pmn = grid_j.pm * grid_j.pn
    ref = jit(lambda q, W, Hz, z_r: jadv.vadv_flux(
        scheme, q, W, Hz, "corrector", z_r=z_r, pmn=pmn, dt=cfg_j.dt),
        J(q), W, Hz, z_r)
    got = tadv.vadv_flux(scheme, T(q), T(W), T(Hz), "corrector", z_r=T(z_r),
                         pmn=T(pmn), dt=cfg_t.dt)
    _close(got, ref, f"{scheme} vertical")
    assert float(torch.as_tensor(W).abs().max()) > 0.0


def test_logarithmic_drag(case):
    cfg_j, grid_j, cfg_t, grid_t, f, _, rng = case
    z_r, z_w, *_ = _flow(cfg_j, grid_j, f, 1.0)
    t = f["t_kout"][None].repeat(2, 0)
    flux = rng.standard_normal((2,) + f["z_kout"].shape) * 1e-5
    ref = jit(lambda *a, **k: jvbc.set_vbc(cfg_j, grid_j, *a, **k),
              J(f["u_kout"]), J(f["v_kout"]), J(t), J(flux), J(flux),
              z_r=z_r, z_w=z_w)
    got = tvbc.set_vbc(cfg_t, grid_t, T(f["u_kout"]), T(f["v_kout"]), T(t),
                       T(flux), T(flux), z_r=T(z_r), z_w=T(z_w))
    for a, b, n in zip(got, ref, ("bustr", "bvstr", "stflx", "btflx")):
        _close(a, b, n)
    assert float(got[0].abs().max()) > 0.0
