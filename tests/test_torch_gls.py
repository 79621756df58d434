"""roms_tpu_torch stage parity for the regional closures and the general
fast loop, against roms_tpu's functions in float64 on the CPU:

- gls_prestep, gls_corstep and the implicit solve _gls_tridiag on a small
  ESTUARY_TEST-like grid (k-epsilon, logarithmic-drag roughness);
- lmd_vmix with the KPP bottom layer (_lmd_bkpp) on the wind-forced
  columns of test_torch_benchmark_physics.py;
- the general plain fast loop (step2d.fast_loop) on a small KELVIN
  (24x16x4, as tests/test_smap.py), with its clamped and radiation open
  boundaries, and with volume conservation across them.

Tolerances, relative to max|field| over the whole padded array: 1e-12 for
the one-pass stages (measured at most 5.7e-16 for GLS, 2.6e-15 for the
KPP bottom layer's ghats; torch's CPU pow/exp/sqrt/log are not XLA's),
1e-10 for the fast loop, which compounds its round-off over nfast
substeps (measured at most 8.6e-15, DV_avg2)."""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from roms_tpu import vgrid as jvgrid
from roms_tpu.config import Config as JConfig
from roms_tpu.grid import build_grid as jbuild_grid, hc_of
from roms_tpu.ops import gls as jgls, step2d as jstep2d, vmix as jvmix
from roms_tpu.ops.omega import omega as jomega, set_massflux as jmassflux
from roms_tpu.ops.step2d import Fast2DState as JFast2DState
from roms_tpu_torch import convert, stepping
from roms_tpu_torch.models import cases as tcases
from roms_tpu_torch.ops import gls as tgls, step2d as tstep2d, \
    vmix as tvmix
from roms_tpu_torch.ops.step2d import FS_FIELDS, Fast2DState
from test_torch_obc import jax_config, jit, regional_pair
from test_torch_benchmark_physics import _KPP_ARGS, kpp_case, pair  # noqa

torch.set_num_threads(1)

T = lambda a: torch.tensor(np.asarray(a))      # noqa: E731
J = jnp.asarray


def _close(got, ref, rtol, name=""):
    got, ref = got.numpy(), np.asarray(ref)
    assert got.shape == ref.shape, name
    scale = max(np.abs(ref).max(), 1e-300)
    np.testing.assert_allclose(got, ref, rtol=0, atol=rtol * scale,
                               err_msg=name)


@pytest.fixture(scope="module")
def gls_case():
    """A small ESTUARY_TEST-like grid (closed N/S, 5-10 m deep) and a
    turbulent state: tke, gls and the mixing coefficients positive and
    varied, a stratification of both signs, sheared currents and stress."""
    cfg = JConfig(name="gls", Lm=12, Mm=6, N=6, ntracers=2,
                  ew_periodic=False, ns_periodic=False, dt=30.0,
                  ndtfast=10, vmix="gls", bottom_drag="logarithmic",
                  zob=0.005, theta_s=0.0, theta_b=0.0, tcline=1e16,
                  vtransform=1, vstretching=1, akv_bak=5.0e-6,
                  akt_bak=(5.0e-6, 5.0e-6))
    cfg_j, grid_j, cfg_t, grid_t = regional_pair(
        cfg, 12 * 500.0, 6 * 500.0, 1.0e-4,
        lambda x, y, i, j, c: 5.0 + 5.0 * (6.0e3 - x) / 6.0e3)
    rng = np.random.default_rng(23)
    N = cfg_j.N
    s2 = (cfg_j.ny_tot, cfg_j.nx_tot)
    s3, sw = (N,) + s2, (N + 1,) + s2
    zeta = 0.1 * rng.standard_normal(s2)

    def flow(zeta, u, v):
        z_r, z_w, Hz = jvgrid.set_depth(
            grid_j.h, zeta, hc_of(cfg_j), grid_j.sc_r, grid_j.Cs_r,
            grid_j.sc_w, grid_j.Cs_w, cfg_j.vtransform)
        Huon, Hvom = jmassflux(cfg_j, grid_j, u, v, Hz)
        return z_r, z_w, Hz, Huon, Hvom, jomega(cfg_j, grid_j, Huon, Hvom,
                                                z_w)

    u = 0.3 * rng.standard_normal(s3)
    v = 0.1 * rng.standard_normal(s3)
    out = jit(flow, J(zeta), J(u), J(v))
    f = dict(zip(("z_r", "z_w", "Hz", "Huon", "Hvom", "W"),
                 map(np.asarray, out)))
    pos = lambda lo, hi, shape: lo * (hi / lo) ** rng.random(shape)  # noqa
    f.update(
        u=u, v=v, tke=pos(1e-6, 1e-3, sw), gls=pos(1e-9, 1e-5, sw),
        tke_prev=pos(1e-6, 1e-3, sw), gls_prev=pos(1e-9, 1e-5, sw),
        bvf=1e-3 * rng.standard_normal(sw), Akv=pos(1e-5, 1e-2, sw),
        Akt=pos(1e-5, 1e-2, (2,) + sw), Akk=pos(1e-5, 1e-2, sw),
        Akp=pos(1e-5, 1e-2, sw), Lscale=pos(1e-2, 1.0, sw),
        sustr=1e-4 * rng.standard_normal(s2),
        svstr=1e-4 * rng.standard_normal(s2),
        bustr=1e-4 * rng.standard_normal(s2),
        bvstr=1e-4 * rng.standard_normal(s2))
    return cfg_j, grid_j, cfg_t, grid_t, f


_PRE = ("tke", "gls", "tke_prev", "gls_prev", "Hz", "Huon", "Hvom", "W")


@pytest.mark.parametrize("iic", [0, 5])
def test_gls_prestep(gls_case, iic):
    cfg_j, grid_j, cfg_t, grid_t, f = gls_case
    ref = jit(lambda *a: jgls.gls_prestep(cfg_j, grid_j, cfg_j.gls_params,
                                          iic, *a),
              *(J(f[k]) for k in _PRE))
    got = tgls.gls_prestep(cfg_t, grid_t, cfg_t.gls_params, iic,
                           *(T(f[k]) for k in _PRE))
    for name, a, b in zip(("tke3", "gls3", "tke_nnew", "gls_nnew"), got,
                          ref):
        _close(a, b, 1e-12, name)


@pytest.mark.parametrize("variant", ["k-epsilon", "craig-banner"])
def test_gls_corstep(gls_case, variant):
    """The corrector from gls_prestep's outputs; with the Craig-Banner
    wave-breaking surface flux and Charnok roughness as the second case."""
    cfg_j, grid_j, cfg_t, grid_t, f = gls_case
    if variant == "craig-banner":
        gp = dataclasses.replace(cfg_j.gls_params, craig_banner=True,
                                 charnok=True)
        cfg_j = dataclasses.replace(cfg_j, gls_params=gp)
        cfg_t = convert.config_from_reference(cfg_j)
    pre = jit(lambda *a: jgls.gls_prestep(cfg_j, grid_j, cfg_j.gls_params,
                                          3, *a),
              *(J(f[k]) for k in _PRE))
    pre = [np.asarray(a) for a in pre]
    args = (["tke", "gls"], pre, ["u", "v", "bvf", "Hz", "z_r", "z_w",
                                  "Huon", "Hvom", "W", "Akv", "Akt", "Akk",
                                  "Akp", "Lscale", "sustr", "svstr",
                                  "bustr", "bvstr"])
    vals = [f[k] for k in args[0]] + pre + [f[k] for k in args[2]]
    ref = jit(lambda *a: jgls.gls_corstep(cfg_j, grid_j, cfg_j.gls_params,
                                          3, *a), *map(J, vals))
    got = tgls.gls_corstep(cfg_t, grid_t, cfg_t.gls_params, 3,
                           *map(T, vals))
    names = ("tke", "gls", "Akv", "Akt", "Akk", "Akp", "Lscale")
    for name, a, b in zip(names, got, ref):
        _close(a, b, 1e-12, name)
    # the mixing changed from the background
    assert float((got[2] - cfg_t.akv_bak).abs().max()) > 1e-6


def test_gls_tridiag():
    """The implicit solve alone, with both boundary fluxes."""
    rng = np.random.default_rng(29)
    shape = (5, 4, 3)
    FC = -rng.random(shape)
    FC[0] = 0.0
    FC_up = np.concatenate([FC[1:], np.zeros_like(FC[:1])])
    BCd = 1.0 + rng.random(shape) - FC - FC_up
    rhs, ft, fb = rng.standard_normal(shape), rng.random(shape[1:]), \
        rng.random(shape[1:])
    ref = jit(jgls._gls_tridiag, *map(J, (BCd, FC, rhs, ft, fb)))
    got = tgls._gls_tridiag(*map(T, (BCd, FC, rhs, ft, fb)))
    _close(got, ref, 1e-12, "x")


def test_lmd_vmix_bottom_layer(pair, kpp_case):  # noqa: F811
    """lmd_vmix with cfg.kpp_bottom (lmd_bkpp.F): Akv, Akt, hsbl, hbbl and
    ghats; a bottom flux of heat as btflx, and bottom stress to raise a
    layer."""
    cfg_j, grid_j, cfg_t, grid_t = pair
    cfg_j = dataclasses.replace(cfg_j, kpp_bottom=True)
    cfg_t = dataclasses.replace(cfg_t, kpp_bottom=True)
    f = dict(kpp_case)
    rng = np.random.default_rng(31)
    s2 = f["sustr"].shape
    f["bustr"] = 3e-4 * rng.standard_normal(s2)
    f["bvstr"] = 3e-4 * rng.standard_normal(s2)
    f["btflx"] = np.stack([1e-6 * rng.standard_normal(s2),
                           1e-8 * rng.standard_normal(s2)])
    ref = jit(lambda *a: jvmix.lmd_vmix(cfg_j, grid_j, *a[:-2],
                                        btflx=a[-2], hbbl_prev=a[-1]),
              *(J(f[k]) for k in _KPP_ARGS + ("btflx", "hbbl")))
    got = tvmix.lmd_vmix(cfg_t, grid_t, *(T(f[k]) for k in _KPP_ARGS),
                         btflx=T(f["btflx"]), hbbl_prev=T(f["hbbl"]))
    for name, a, b in zip(("Akv", "Akt", "hsbl", "hbbl", "ghats"), got,
                          ref):
        _close(a, b, 1e-12, name)
    # a bottom layer formed: hbbl above the bottom in some columns
    H = cfg_t.halo
    inner = (slice(H, -H), slice(H, -H))
    assert (got[3].numpy()[inner] > f["z_w"][0][inner] + 1.0).any()


@pytest.fixture(scope="module")
def kelvin():
    """A small KELVIN in both packages (roms_tpu's grid alone, with the
    port builder's flat 100 m f-plane of 20 km cells), the port's state two
    steps on."""
    cfg = tcases.kelvin_config(Lm=24, Mm=16, N=4, ndtfast=10)
    grid_j, cfg_j = jbuild_grid(
        jax_config(cfg), 20e3 * cfg.Lm, 20e3 * cfg.Mm, f0=1.0e-4, beta=0.0,
        depth_fn=lambda x, y, i, j, c: 100.0 + 0 * x)
    cfg_t, grid_t, s0, ffn_t = tcases.kelvin(cfg, device="cpu")
    assert convert.config_from_reference(cfg_j) == cfg_t
    s = stepping.run(cfg_t, grid_t, s0, 2, ffn_t)
    return cfg_j, grid_j, cfg_t, grid_t, ffn_t, s


@pytest.mark.parametrize("volcons", [(), ("west", "east")])
def test_general_fast_loop_kelvin(kelvin, volcons):
    cfg_j, grid_j, cfg_t, grid_t, ffn_t, s = kelvin
    cfg_j = dataclasses.replace(cfg_j, volcons=volcons)
    cfg_t = dataclasses.replace(cfg_t, volcons=volcons)
    st = convert.state_to_numpy(s)
    zero = np.zeros_like(st["zeta"])
    fs = dict(zeta_n=st["zeta"], zeta_nm1=st["zeta"], ubar_n=st["ubar"],
              ubar_nm1=st["ubar"], vbar_n=st["vbar"], vbar_nm1=st["vbar"],
              rzeta_n=st["rzeta"], rzeta_nm1=zero, rubar_n=st["rubar"],
              rubar_nm1=zero, rvbar_n=st["rvbar"], rvbar_nm1=zero,
              Zt_avg1=zero, DU_avg1=zero, DV_avg1=zero, DU_avg2=zero,
              DV_avg2=zero)
    rng = np.random.default_rng(37)
    frc = [1e-4 * rng.standard_normal(zero.shape) for _ in range(2)] + \
        [st[k] for k in ("rufrc0_prev", "rufrc0_prev2", "rvfrc0_prev",
                         "rvfrc0_prev2")]
    bry_t = ffn_t(cfg_t, grid_t, s.time)["bry"]
    bry_keep = {k: v.clone() for k, v in bry_t.items()}
    fs_t = Fast2DState(**{k: torch.tensor(v) for k, v in fs.items()})
    out, ruc, rvc, wet = tstep2d.fast_loop(cfg_t, grid_t, fs_t,
                                           *map(T, frc), s.iic, bry=bry_t)
    assert wet is None
    ref, rucj, rvcj, _ = jstep2d.fast_loop(
        cfg_j, grid_j, JFast2DState(**{k: J(v) for k, v in fs.items()}),
        *map(J, frc), iic=s.iic,
        bry={k: J(v.numpy()) for k, v in bry_keep.items()})
    for k in FS_FIELDS:
        _close(getattr(out, k), getattr(ref, k), 1e-10, k)
    _close(ruc, rucj, 1e-10, "rufrc_c")
    _close(rvc, rvcj, 1e-10, "rvfrc_c")
    # the caller's fields and boundary data are left unchanged
    for k, v in fs.items():
        assert np.array_equal(getattr(fs_t, k).numpy(), v), k
    for k, v in bry_t.items():
        assert torch.equal(v, bry_keep[k]), k
