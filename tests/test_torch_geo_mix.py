"""roms_tpu_torch: the geopotential-rotated harmonic tracer diffusion, the
plain version of the t3dmix2_geo kernel (ops/mix3d.py::t3dmix2_geo, which
ops/mix3d_cuda.t3dmix2_geo takes on CPU tensors), against roms_tpu's
mix3d.t3dmix2_geo and against the TPU kernel it replaces,
mix3d_pallas.t3dmix2_geo_fused, run once in Pallas interpret mode; and the
step's dispatch to it.  Its gate, mix3d_cuda.use_kernels, is the one that
mix3d_pallas.use_pallas is for both JAX kernels
(test_torch_momentum_kernels.py::test_gates_mirror_pallas).

Inputs are made with numpy from a seed on a small BENCHMARK strip in
float64, held to 1e-12 x max|field| over the whole padded array.  A tracer
with tnu2 = 0 must come back unchanged.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from roms_tpu import vgrid as jvgrid
from roms_tpu.grid import hc_of
from roms_tpu.ops import mix3d as jmix, mix3d_pallas
from roms_tpu_torch import stepping
from roms_tpu_torch.models import benchmark as tbm
from roms_tpu_torch.ops import mix3d_cuda, rhs3d_cuda
from test_torch_benchmark_physics import _pair

torch.set_num_threads(1)

RTOL = 1e-12
J = jnp.asarray


def T(a):
    return torch.tensor(np.asarray(a))


def _close(got, ref, name):
    got, ref = got.numpy(), np.asarray(ref)
    assert got.shape == ref.shape, name
    scale = max(np.abs(ref).max(), 1e-300)
    np.testing.assert_allclose(got, ref, rtol=0, atol=RTOL * scale,
                               err_msg=name)


@pytest.fixture(scope="module")
def case():
    """BENCHMARK at 20x12x6, random tracers over its steep shelf (so both
    signs of every level slope occur), as numpy."""
    cfg_j, grid_j, cfg_t, grid_t = _pair(Lm=20, Mm=12, N=6)
    rng = np.random.default_rng(23)
    s2 = np.asarray(grid_j.h).shape
    s3 = (cfg_j.N,) + s2
    zeta = 0.3 * rng.standard_normal(s2)
    z_r, _, Hz = jvgrid.set_depth(grid_j.h, J(zeta), hc_of(cfg_j),
                                  grid_j.sc_r, grid_j.Cs_r, grid_j.sc_w,
                                  grid_j.Cs_w, cfg_j.vtransform)
    f = dict(t=np.stack([5.0 + rng.standard_normal(s3),
                         35.0 + 0.1 * rng.standard_normal(s3)]),
             Hz=np.asarray(Hz), z_r=np.asarray(z_r),
             t_nnew=np.asarray(Hz)[None] * (1.0 + rng.random((2,) + s3)))
    dzdx = np.diff(f["z_r"], axis=-1)
    assert (dzdx > 0).any() and (dzdx < 0).any()
    return cfg_j, grid_j, cfg_t, grid_t, f


def _args(f, conv):
    return conv(f["t"]), conv(f["Hz"]), conv(f["z_r"]), conv(f["t_nnew"])


@pytest.mark.parametrize("tnu2", [(500.0, 500.0), (0.0, 300.0)])
def test_plain_matches_mix3d(case, tnu2):
    cfg_j, grid_j, cfg_t, grid_t, f = case
    cfg_j = dataclasses.replace(cfg_j, tnu2=tnu2)
    cfg_t = cfg_t.replace(tnu2=tnu2)
    ref = jax.jit(lambda *a: jmix.t3dmix2_geo(cfg_j, grid_j, *a,
                                              cfg_j.dt))(*_args(f, J))
    got = mix3d_cuda.t3dmix2_geo(cfg_t, grid_t, *_args(f, T), cfg_t.dt)
    _close(got, ref, f"t3dmix2_geo tnu2={tnu2}")
    for k, d in enumerate(tnu2):
        changed = not np.array_equal(got[k].numpy(), f["t_nnew"][k])
        assert changed == (d != 0.0), k
    assert mix3d_cuda.t3dmix2_geo.launches == 0


def test_plain_matches_pallas_kernel(case):
    """One interpret run of the TPU kernel, with the second tracer at
    tnu2 = 0 (it passes through untouched, its t_nnew not donated)."""
    cfg_j, grid_j, cfg_t, grid_t, f = case
    cfg_j = dataclasses.replace(cfg_j, tnu2=(500.0, 0.0))
    cfg_t = cfg_t.replace(tnu2=(500.0, 0.0))
    ref = mix3d_pallas.t3dmix2_geo_fused(cfg_j, grid_j, *_args(f, J),
                                         cfg_j.dt, interpret=True)
    got = mix3d_cuda.t3dmix2_geo(cfg_t, grid_t, *_args(f, T), cfg_t.dt)
    _close(got, ref, "t3dmix2_geo against t3dmix2_geo_fused")
    assert np.array_equal(got[1].numpy(), f["t_nnew"][1])


@pytest.mark.parametrize("pallas2d", [True, False])
def test_step_dispatch(monkeypatch, pallas2d):
    """The step sends the rotated diffusion to the kernel wrapper under its
    gate and to the plain version otherwise, after the momentum phase."""
    cfg, grid, s, ffn = tbm.build(
        tbm.make_config(Lm=16, Mm=8, N=4, ndtfast=6).replace(
            pallas2d=pallas2d), device="cpu")
    seen = []
    sites = [(mix3d_cuda, "t3dmix2_geo"), (mix3d_cuda, "t3dmix2_geo_plain"),
             (rhs3d_cuda, "momentum_rhs"), (stepping, "rhs3d_momentum")]
    for mod, name in sites:
        fn = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, _f=fn, _n=name,
                            **k: seen.append(_n) or _f(*a, **k))
    s = stepping.step(cfg, grid, s, ffn)
    # on CPU tensors the wrapper goes on to its plain version
    assert seen == (["momentum_rhs", "t3dmix2_geo", "t3dmix2_geo_plain"]
                    if pallas2d else
                    ["rhs3d_momentum", "t3dmix2_geo_plain"])
    assert bool(torch.isfinite(s.t).all())
