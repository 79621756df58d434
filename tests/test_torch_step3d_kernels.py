"""roms_tpu_torch: the kernel stages of the 3-D predictor/corrector and the
pressure gradient (ops/step3d_cuda.py, ops/prsgrd_cuda.py) against the TPU
kernels they replace, step3d_pallas.{tracer_predictor,uv_corrector,
tracer_corrector}_fused and prsgrd_pallas.prsgrd32_fused, run in Pallas
interpret mode on the CPU.

The same inputs, made with numpy from a seed on UPWELLING at 12x10x4, go
to the JAX kernel and to the port's wrapper, which on CPU tensors takes
its plain version and launches nothing.  One interpret call per branch of
each kernel; held to 1e-12 x max|field| in float64 over the whole padded
array.  The gates are held against the JAX gates they mirror.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from roms_tpu.config import LBC as JLBC
from roms_tpu.models import upwelling as jup
from roms_tpu.ops import prsgrd_pallas, step3d_pallas
from roms_tpu_torch import convert
from roms_tpu_torch.grid import hc_of
from roms_tpu_torch.ops import diag_cuda, prsgrd_cuda, step3d_cuda
from test_torch_stages import build_pair

torch.set_num_threads(1)

RTOL = 1e-12          # times max|field|
J = jnp.asarray


def T(a):
    return torch.tensor(np.asarray(a))


def _close(got, ref, name):
    for k, (a, b) in enumerate(zip(got, ref)):
        a, b = a.numpy(), np.asarray(b)
        assert a.shape == b.shape, name
        scale = max(np.abs(b).max(), 1e-300)
        np.testing.assert_allclose(a, b, rtol=0, atol=RTOL * scale,
                                   err_msg=f"{name}[{k}]")


def _closed_ew(cfg):
    return dataclasses.replace(cfg, ew_periodic=False, lbc_zeta=JLBC(),
                               lbc_ubar=JLBC(), lbc_vbar=JLBC(),
                               lbc_u=JLBC(), lbc_v=JLBC(), lbc_t=JLBC(),
                               gamma2=-1.0)


@pytest.fixture(scope="module")
def case():
    """UPWELLING at 12x10x4 and a consistent set of random fields (the
    depths and fluxes made by the port's plain functions, as numpy)."""
    cfg_j, grid_j, cfg_t, grid_t = build_pair(
        jup.make_config(Lm=12, Mm=10, N=4, ndtfast=6))
    rng = np.random.default_rng(2024)
    N = cfg_j.N
    s2 = (cfg_j.ny_tot, cfg_j.nx_tot)
    s3, sw = (N,) + s2, (N + 1,) + s2
    zeta = 0.3 * rng.standard_normal(s2)
    u = 0.2 * rng.standard_normal(s3)
    v = 0.2 * rng.standard_normal(s3)
    z_r, z_w, Hz, Huon, Hvom, W = diag_cuda.grid_flux_plain(
        cfg_t, grid_t, T(zeta), T(u), T(v), hc_of(cfg_t))
    f = {k: a.numpy() for k, a in dict(
        z_r=z_r, z_w=z_w, Hz=Hz, Huon=Huon, Hvom=Hvom, W=W).items()}
    f.update(
        u=u, v=v,
        t=np.stack([14.0 + 4.0 * rng.random(s3), 35.0 + rng.random(s3)]),
        t_prev=np.stack([14.0 + 4.0 * rng.random(s3),
                         35.0 + rng.random(s3)]),
        rho=0.5 * rng.standard_normal(s3) - 0.1 * f["z_r"],
        Akv=1e-4 + 1e-2 * rng.random(sw),
        Akt=1e-5 + 1e-2 * rng.random((2,) + sw),
        ghats=1e-3 * rng.standard_normal((2,) + sw),
        srflx=1e-4 * rng.random(s2),
        swdk_w=rng.random(sw),
        tflux=1e-5 * rng.standard_normal((2, 2) + s2),
        eq_tide=0.05 * rng.standard_normal(s2),
        ru=1e-2 * rng.standard_normal(s3),
        rv=1e-2 * rng.standard_normal(s3),
        D=10.0 * rng.standard_normal((4,) + s2))
    return cfg_j, grid_j, cfg_t, grid_t, f


def test_tracer_predictor_matches_pallas(case):
    cfg_j, grid_j, cfg_t, grid_t, f = case
    names = ("t", "t_prev", "Hz", "Huon", "Hvom", "W", "Akt")
    opt = ("ghats", "srflx", "swdk_w")
    iic = 3
    ref = step3d_pallas.tracer_predictor_fused(
        cfg_j, grid_j, iic, *[J(f[k]) for k in names],
        **{k: J(f[k]) for k in opt}, stflx=J(f["tflux"][0]),
        btflx=J(f["tflux"][1]), interpret=True)
    before = step3d_cuda.tracer_predictor.launches
    got = step3d_cuda.tracer_predictor(
        cfg_t, grid_t, iic, *[T(f[k]) for k in names], T(f["tflux"][0]),
        T(f["tflux"][1]), **{k: T(f[k]) for k in opt})
    assert step3d_cuda.tracer_predictor.launches == before
    _close(got, ref, "t3, t_nnew")


@pytest.mark.parametrize("splines", [True, False])
def test_tracer_corrector_matches_pallas(case, splines):
    cfg_j, grid_j, cfg_t, grid_t, f = case
    cfg_j = dataclasses.replace(cfg_j, splines_vdiff=splines)
    cfg_t = dataclasses.replace(cfg_t, splines_vdiff=splines)
    args = [f["t"] * f["Hz"], f["t_prev"], f["Huon"], f["Hvom"], f["W"],
            f["Hz"], f["z_r"], f["Akt"]]
    ref = step3d_pallas.tracer_corrector_fused(
        cfg_j, grid_j, *[J(a) for a in args], interpret=True)
    got = step3d_cuda.tracer_corrector(cfg_t, grid_t, *[T(a) for a in args])
    _close([got], [ref], f"t (splines_vdiff={splines})")


@pytest.mark.parametrize("walls", ["upwelling", "closed_ew"])
def test_uv_corrector_matches_pallas(case, walls):
    cfg_j, grid_j, cfg_t, grid_t, f = case
    if walls == "closed_ew":
        cfg_j, grid_j, cfg_t, grid_t = build_pair(_closed_ew(cfg_j))
    Hz = f["Hz"]
    D = f["D"]
    args = [f["u"] * Hz, f["v"] * Hz, f["ru"], f["rv"], Hz, f["Akv"],
            D[0], D[1], D[2], D[3], f["Huon"], f["Hvom"]]
    iic = 4
    ref = step3d_pallas.uv_corrector_fused(
        cfg_j, grid_j, iic, *[J(a) for a in args], interpret=True)
    got = step3d_cuda.uv_corrector(cfg_t, grid_t, iic, *[T(a) for a in args])
    _close(got, ref, f"u v ubar vbar Huon Hvom ({walls})")


def test_prsgrd32_matches_pallas(case):
    cfg_j, grid_j, cfg_t, grid_t, f = case
    args = [f[k] for k in ("rho", "z_r", "z_w", "Hz")]
    ref = prsgrd_pallas.prsgrd32_fused(cfg_j, grid_j, *[J(a) for a in args],
                                       eq_tide=J(f["eq_tide"]),
                                       interpret=True)
    before = prsgrd_cuda.prsgrd32.launches
    got = prsgrd_cuda.prsgrd32(cfg_t, grid_t, *[T(a) for a in args],
                               eq_tide=T(f["eq_tide"]))
    assert prsgrd_cuda.prsgrd32.launches == before
    _close(got, ref, "ru, rv")


@pytest.mark.parametrize("change", [
    {}, dict(pallas2d=False), dict(t_hadv=("U3", "HSIMT")),
    dict(t_vadv=("SPLINES", "MPDATA")), dict(ntracers=0),
    dict(lbc_t=JLBC(west="radiation")), dict(lbc_u=JLBC(north="flather")),
    dict(prsgrd_scheme="pj")])
def test_gates_mirror_pallas(case, monkeypatch, change):
    """use_tracer / use_uv / prsgrd_cuda.supported decide as the JAX gates
    do when its kernels are on (ROMS_PALLAS_INTERPRET on the CPU)."""
    monkeypatch.setenv("ROMS_PALLAS_INTERPRET", "1")
    cfg_j = dataclasses.replace(case[0], ew_periodic=False, **change)
    cfg_t = convert.config_from_reference(cfg_j)
    assert step3d_cuda.use_tracer(cfg_t) == \
        step3d_pallas.use_tracer_pallas(cfg_j)
    assert step3d_cuda.use_uv(cfg_t) == step3d_pallas.use_uv_pallas(cfg_j)
    assert prsgrd_cuda.supported(cfg_t) == prsgrd_pallas.use_pallas(cfg_j)
    for kw in (dict(bry={}), dict(sources={}), dict(clm={}),
               dict(want_diags=True)):
        assert not step3d_cuda.use_tracer(cfg_t, **kw)
    assert not step3d_cuda.use_uv(cfg_t, wet={})
