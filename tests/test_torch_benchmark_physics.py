"""roms_tpu_torch: the BENCHMARK physics against roms_tpu's functions, on a
small spherical strip in float64: build_spherical_grid, the COARE bulk
fluxes and the analytic shortwave, the KPP pieces (swfrac, the cube root,
lmd_vmix) and the JM95 check values of test_benchmark_case.py.

Inputs are made with numpy from a seed; each port function is held to
1e-12 x max|field| over the whole padded array.  The JAX grid comes from
roms_tpu.grid.build_spherical_grid alone (no eager roms_tpu build), and
the longer JAX functions (bulk_flux, lmd_vmix) run under jax.jit, which
costs a fraction of their eager op-by-op dispatch here.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from roms_tpu import vgrid as jvgrid
from roms_tpu.grid import build_spherical_grid as jbuild, hc_of
from roms_tpu.models import benchmark as jbm
from roms_tpu.ops import bulk_flux as jbf, eos as jeos, vmix as jvmix
from roms_tpu_torch import convert
from roms_tpu_torch.grid import Grid, build_spherical_grid as tbuild
from roms_tpu_torch.models import benchmark as tbm
from roms_tpu_torch.ops import bulk_flux as tbf, eos as teos, vmix as tvmix

torch.set_num_threads(1)

RTOL = 1e-12          # times max|field|
J = jnp.asarray


def T(a):
    return torch.tensor(np.asarray(a))


def _close(got, ref, name):
    got, ref = got.numpy(), np.asarray(ref)
    assert got.shape == ref.shape, name
    scale = max(np.abs(ref).max(), 1e-300)
    np.testing.assert_allclose(got, ref, rtol=0, atol=RTOL * scale,
                               err_msg=name)


def _pair(Lm=24, Mm=16, N=8):
    """A small BENCHMARK configuration and grid built by each package."""
    cfg = jbm.make_config(Lm=Lm, Mm=Mm, N=N, ndtfast=10)
    grid_j, cfg_j = jbuild(cfg, lon_size=360.0, lat_min=-70.0, lat_size=20.0,
                           depth_fn=jbm._depth_fn)
    grid_t, cfg_t = tbuild(convert.config_from_reference(cfg), 360.0, -70.0,
                           20.0, tbm._depth_fn, device="cpu")
    return cfg_j, grid_j, cfg_t, grid_t


@pytest.fixture(scope="module")
def pair():
    return _pair()


def test_spherical_grid(pair):
    cfg_j, grid_j, cfg_t, grid_t = pair
    assert convert.config_from_reference(cfg_j) == cfg_t
    for f in dataclasses.fields(Grid):
        ref = getattr(grid_j, f.name)
        if ref is None:
            assert getattr(grid_t, f.name) is None, f.name
            continue
        _close(getattr(grid_t, f.name), ref, f.name)
    # southern-hemisphere Coriolis everywhere, metrics growing poleward
    assert float(grid_t.f.max()) < 0.0
    assert float(grid_t.pm[3, 5]) > float(grid_t.pm[-4, 5])


@pytest.fixture(scope="module")
def atmos(pair):
    """The analytic atmosphere of the BENCHMARK forcing, with noise, and a
    sea-surface temperature around it, as numpy."""
    cfg_j, grid_j, _, _ = pair
    rng = np.random.default_rng(5)
    s2 = np.asarray(grid_j.h).shape
    latr = np.asarray(grid_j.yr)
    return dict(
        t_surf=4.0 + 3.0 * rng.standard_normal(s2),
        Uwind=15.0 * np.exp(-(0.2 * (60.0 + latr)) ** 2) +
        3.0 * rng.standard_normal(s2),
        Vwind=3.0 * rng.standard_normal(s2),
        Tair=4.0 + rng.standard_normal(s2),
        Pair=1025.0 + 5.0 * rng.standard_normal(s2),
        Hair=np.clip(0.8 + 0.1 * rng.standard_normal(s2), 0.3, 1.0),
        cloud=rng.random(s2),
        rain=np.where(rng.random(s2) < 0.3, 1e-4 * rng.random(s2), 0.0),
        srflx=1e-5 * rng.random(s2))


def test_bulk_flux(pair, atmos):
    cfg_j, grid_j, cfg_t, grid_t = pair
    a = atmos
    keys = ("Uwind", "Vwind", "Tair", "Pair", "Hair", "cloud", "rain")
    ref = jax.jit(lambda *x: jbf.bulk_flux(cfg_j, grid_j, *x))(
        J(a["t_surf"]), J(a["srflx"]), *(J(a[k]) for k in keys))
    got = tbf.bulk_flux(cfg_t, grid_t, T(a["t_surf"]), T(a["srflx"]),
                        *(T(a[k]) for k in keys))
    assert set(got) == set(ref)
    for k in ref:
        _close(got[k], ref[k], k)
    # both signs of the air-sea temperature difference were exercised
    dT = a["t_surf"] - a["Tair"]
    assert (dT > 0).any() and (dT < 0).any()


@pytest.mark.parametrize("tdays", [0.0, 0.3, 171.75, 400.5])
def test_ana_srflux_albedo(pair, atmos, tdays):
    cfg_j, grid_j, cfg_t, grid_t = pair
    a = atmos
    ref = jbf.ana_srflux_albedo(cfg_j, grid_j.xr, grid_j.yr, J(a["Tair"]),
                                J(a["Hair"]), J(a["cloud"]), tdays)
    got = tbf.ana_srflux_albedo(cfg_t, grid_t.xr, grid_t.yr, T(a["Tair"]),
                                T(a["Hair"]), T(a["cloud"]), tdays)
    _close(got, ref, f"srflx at day {tdays}")


def test_swfrac_and_cbrt():
    rng = np.random.default_rng(3)
    Z = -300.0 * rng.random((5, 7, 9))
    for jw in (1, 5, 9):
        _close(tvmix.swfrac(T(Z), jwtype=jw), jvmix.swfrac(J(Z), jwtype=jw),
               f"swfrac type {jw}")
    # the cube root that _wscale takes, over the decades KPP feeds it and
    # 0: within 1 ulp of libm's cbrt, and at round-off of jnp.cbrt, which
    # is itself up to 9 ulp from libm's (1e5 samples,
    # scripts/torch_benchmark_fixture.py --report)
    x = np.concatenate([10.0 ** rng.uniform(-24, 3, 4000), [0.0, 1.0, 8.0]])
    got = tvmix.cbrt(T(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(jnp.cbrt(J(x))), rtol=3e-15,
                               atol=0)
    assert (np.abs(got - np.cbrt(x)) <= np.spacing(np.cbrt(x))).all()
    assert got[-3:].tolist() == [0.0, 1.0, 2.0]


def test_jm95_check_values():
    """rho_eos.F header check values (test_benchmark_case.py:14-22)."""
    Tt = torch.tensor([[3.0]], dtype=torch.float64)
    S = torch.tensor([[35.5]], dtype=torch.float64)
    Z = torch.tensor([[-5000.0]], dtype=torch.float64)
    den = teos.rho_jm95(Tt, S, Z) + 1000.0
    np.testing.assert_allclose(float(den[0, 0]), 1050.3639165364, rtol=1e-9)
    den1 = teos.rho_jm95(Tt, S, torch.zeros_like(Z)) + 1000.0
    np.testing.assert_allclose(float(den1[0, 0]), 1028.2845117925, rtol=1e-9)


@pytest.fixture(scope="module")
def kpp_case(pair):
    """A stratified, wind-forced set of columns with a 250 m surface mixed
    layer and a sheared current: half heated (stabilizing surface flux, so
    the Ekman/Monin-Obukhov limit applies), half cooled (convective, so
    the boundary layer reaches below the first interface under the
    surface), with the depths and densities from roms_tpu, as numpy."""
    cfg_j, grid_j, _, _ = pair
    rng = np.random.default_rng(17)
    N = cfg_j.N
    s2 = np.asarray(grid_j.h).shape
    s3 = (N,) + s2
    zeta = 0.2 * rng.standard_normal(s2)
    z_r, z_w, Hz = jvgrid.set_depth(grid_j.h, J(zeta), hc_of(cfg_j),
                                    grid_j.sc_r, grid_j.Cs_r, grid_j.sc_w,
                                    grid_j.Cs_w, cfg_j.vtransform)
    zr = np.asarray(z_r)
    zml = np.minimum(zr + 250.0, 0.0)
    temp = 2.0 + 8.0 * np.exp(zml / 300.0) + 1e-3 * rng.standard_normal(s3)
    salt = 34.5 - 0.5 * np.exp(zml / 200.0) + 1e-4 * rng.standard_normal(s3)
    t = np.stack([temp, salt])
    rho, pden, bvf = jax.jit(lambda t, z_r, z_w: (
        *jeos.rho_eos_pden(cfg_j, t, z_r),
        jeos.brunt_vaisala(cfg_j, t, z_r, z_w)))(J(t), z_r, z_w)
    heated = np.arange(s2[1])[None, :] % 2 == 0
    heated = np.broadcast_to(heated, s2)
    srflx = 5e-6 * rng.random(s2)
    stflx_T = np.where(heated, srflx + 2e-5 + 1e-5 * rng.random(s2),
                       -4e-5 - 2e-5 * rng.random(s2))
    stflx = np.stack([stflx_T, 1e-7 * rng.standard_normal(s2)])
    return dict(
        u=0.2 * np.exp(zr / 100.0) + 0.01 * rng.standard_normal(s3),
        v=0.01 * rng.standard_normal(s3),
        t=t, rho=np.asarray(rho), pden=np.asarray(pden),
        bvf=np.asarray(bvf), Hz=np.asarray(Hz), z_r=zr, z_w=np.asarray(z_w),
        sustr=1e-4 + 2e-4 * rng.random(s2),
        svstr=5e-5 * rng.standard_normal(s2),
        bustr=1e-5 * rng.standard_normal(s2),
        bvstr=1e-5 * rng.standard_normal(s2),
        stflx=stflx, srflx=srflx,
        hsbl=-20.0 - 30.0 * rng.random(s2), hbbl=np.zeros(s2),
        heated=heated)


_KPP_ARGS = ("u", "v", "t", "rho", "pden", "bvf", "Hz", "z_r", "z_w",
             "sustr", "svstr", "bustr", "bvstr", "stflx", "srflx", "hsbl")


def test_lmd_vmix(pair, kpp_case):
    cfg_j, grid_j, cfg_t, grid_t = pair
    f = kpp_case
    ref = jax.jit(lambda *a: jvmix.lmd_vmix(cfg_j, grid_j, *a[:-1],
                                            hbbl_prev=a[-1]))(
        *(J(f[k]) for k in _KPP_ARGS + ("hbbl",)))
    got = tvmix.lmd_vmix(cfg_t, grid_t, *(T(f[k]) for k in _KPP_ARGS),
                         hbbl_prev=T(f["hbbl"]))
    for name, a, b in zip(("Akv", "Akt", "hsbl", "hbbl", "ghats"), got,
                          ref):
        _close(a, b, name)
    # the branches the case is built to take: in heated columns (Ustar > 0
    # and a stabilizing surface buoyancy flux) the Ekman depth limits the
    # layer, and binds in some; in cooled columns, where no limit applies,
    # the layer is interpolated between interfaces below the first one
    # under the surface (the search found ks > 1) and above the bottom
    H = cfg_t.halo
    inner = (slice(H, -H), slice(H, -H))
    hsbl = got[2].numpy()[inner]
    zsurf, z_w = f["z_w"][-1][inner], f["z_w"][:, H:-H, H:-H]
    depth = zsurf - hsbl
    heated = f["heated"][inner]
    Ustar = np.sqrt(np.sqrt(
        (0.5 * (f["sustr"] + np.roll(f["sustr"], -1, -1))) ** 2 +
        (0.5 * (f["svstr"] + np.roll(f["svstr"], -1, -2))) ** 2))[inner]
    hekman = tvmix.lmd_cekman * Ustar / np.abs(grid_t.f.numpy()[inner])
    assert (depth[heated] <= hekman[heated] * (1 + 1e-12)).all()
    assert (np.abs(depth - hekman) <= 1e-9 * hekman)[heated].any()
    below_top = (hsbl < z_w[-2]) & (hsbl > z_w[1])
    assert below_top[~heated].any()
    # the nonlocal flux is nonzero in convective columns only
    ghat = got[4].numpy()[0][(slice(None),) + inner]
    assert np.abs(ghat[:, ~heated]).max() > 0.0
    assert np.abs(ghat[:, heated]).max() == 0.0
