"""roms_tpu_torch: the C2, U1 and A4 tracer advection schemes against
roms_tpu's, on the small grids of test_torch_stages.py (UPWELLING, E-W
periodic, and its closed variant) in float64, to 1e-12 x max|field| over
the whole padded array.

(a) the horizontal and vertical fluxes of each scheme
    (ops/advection.py);
(b) the predictor and corrector tracer stages, the plain versions that the
    tracer kernels' wrappers (ops/step3d_cuda.py) take on CPU tensors, with
    the scheme pairs of the kernels' chip checks, one pair a tracer;
(c) the kernels' scheme codes: every scheme the tracer gate admits and a
    ROMS configuration can name has a code, and the others raise as the
    plain versions do.

The JAX functions run under jax.jit.
"""

import dataclasses
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from roms_tpu.ops import advection as jadv, pre_step3d as jpre, \
    step3d_t as jst3t
from roms_tpu_torch import convert
from roms_tpu_torch.ops import advection as tadv, step3d_cuda
from test_torch_stages import T, _close, case  # noqa: F401  (fixture)

torch.set_num_threads(1)

J = jnp.asarray
HSCHEMES = ("C2", "U1", "U3", "C4", "A4")
VSCHEMES = ("C2", "U1", "C4", "A4", "SPLINES")
# the (horizontal, vertical) pairs of the kernels' chip checks, two a
# configuration (tracer 0, tracer 1)
PAIRS = [(("C2", "C2"), ("U1", "U1")), (("A4", "A4"), ("A4", "SPLINES")),
         (("C2", "C4"), ("U3", "A4"))]


@pytest.mark.parametrize("scheme", ["C2", "U1", "A4"])
def test_hadv_fluxes_match(case, scheme):
    cfg_j, _, cfg_t, _, f = case
    q = f["t"][0]
    ref = jax.jit(lambda *a: jadv.hadv_fluxes(cfg_j, scheme, *a))(
        J(q), J(f["Huon"]), J(f["Hvom"]))
    got = tadv.hadv_fluxes(cfg_t, scheme, T(q), T(f["Huon"]), T(f["Hvom"]))
    _close(got[0], ref[0], f"FX {scheme}")
    _close(got[1], ref[1], f"FE {scheme}")


def test_akima_select(case):
    """A4's gradient is zero where neighbouring differences change sign or
    twice their product is at most 1e-16, as in roms_tpu: a ramp of 7e-9 a
    cell with steps of 1e-9 gives products on both sides of the threshold
    along every direction."""
    cfg_j, _, cfg_t, _, f = case
    k, j, i = np.indices(f["t"][0].shape)
    q = 14.0 + 7e-9 * (i + j + k) + 1e-9 * (
        (i % 3 == 0) + (j % 2 == 0) + (k % 2 == 0))
    d = T(np.diff(q, axis=-1))
    grad = tadv._akima(d[..., 1:], d[..., :-1])
    assert (grad == 0).any() and (grad != 0).any()
    ref = jax.jit(lambda *a: jadv.hadv_fluxes(cfg_j, "A4", *a))(
        J(q), J(f["Huon"]), J(f["Hvom"]))
    got = tadv.hadv_fluxes(cfg_t, "A4", T(q), T(f["Huon"]), T(f["Hvom"]))
    _close(got[0], ref[0], "FX A4 steps")
    _close(got[1], ref[1], "FE A4 steps")
    refv = jax.jit(lambda *a: jadv.vadv_flux("A4", *a, "predictor"))(
        J(q), J(f["W"]), J(f["Hz"]))
    _close(tadv.vadv_flux("A4", T(q), T(f["W"]), T(f["Hz"]), "predictor"),
           refv, "vertical A4 steps")


@pytest.mark.parametrize("scheme", ["C2", "U1", "A4"])
def test_vadv_flux_matches(case, scheme):
    _, _, _, _, f = case
    q = f["t"][1]
    ref = jax.jit(lambda *a: jadv.vadv_flux(scheme, *a, "corrector"))(
        J(q), J(f["W"]), J(f["Hz"]))
    _close(tadv.vadv_flux(scheme, T(q), T(f["W"]), T(f["Hz"]), "corrector"),
           ref, f"vertical {scheme}")


def _with_schemes(cfg, pairs):
    (h0, v0), (h1, v1) = pairs
    return dataclasses.replace(cfg, t_hadv=(h0, h1), t_vadv=(v0, v1))


@pytest.mark.parametrize("pairs", PAIRS, ids=lambda p: "-".join(
    a + "/" + b for a, b in p))
def test_predictor_and_corrector_match(case, pairs):
    cfg_j, grid_j, _, grid_t, f = case
    cfg_j = _with_schemes(cfg_j, pairs)
    cfg_t = convert.config_from_reference(cfg_j)
    assert step3d_cuda.use_tracer(cfg_t)
    iic = 3
    names = ("t", "t_prev", "u", "v", "Hz", "z_r", "Huon", "Hvom", "W",
             "Akt")
    ref = jax.jit(lambda *a: jpre.pre_step3d(cfg_j, grid_j, iic, *a,
                                             momentum=False)[:2])(
        *[J(f[k]) for k in names],
        *[J(a) for a in f["stress"] + f["tflux"] + f["hist"]])
    got = step3d_cuda.tracer_predictor(
        cfg_t, grid_t, iic, *[T(f[k]) for k in ("t", "t_prev", "Hz", "Huon",
                                                "Hvom", "W", "Akt")],
        T(f["tflux"][0]), T(f["tflux"][1]))
    _close(got[0], ref[0], "t3")
    _close(got[1], ref[1], "t_nnew")

    args = [f["t"] * f["Hz"], f["t_prev"], f["Huon"], f["Hvom"], f["W"],
            f["Hz"], f["z_r"], f["Akt"]]
    ref = jax.jit(lambda *a: jst3t.step3d_t(cfg_j, grid_j, iic, *a))(
        *[J(a) for a in args])
    got = step3d_cuda.tracer_corrector(cfg_t, grid_t, *[T(a) for a in args])
    _close(got, ref, "t (corrector)")
    assert step3d_cuda.tracer_predictor.launches == 0
    assert step3d_cuda.tracer_corrector.launches == 0


def test_kernel_scheme_codes(case):
    """Every pair the gate admits that roms_tpu can advect has a kernel
    code; the gate's other schemes (SPLINES along a level, U3 in the
    vertical) raise in _tracer_ints as the plain fluxes raise."""
    cfg_t = case[2]
    for h, v in itertools.product(HSCHEMES, VSCHEMES):
        cfg = cfg_t.replace(t_hadv=(h, "U3"), t_vadv=(v, "C4"))
        assert step3d_cuda.use_tracer(cfg)
        for name in ("tracer_predictor", "tracer_corrector"):
            codes = step3d_cuda._tracer_ints(cfg, name)
            assert codes == [step3d_cuda._HADV_CODE[h], 0,
                             step3d_cuda._VADV_CODE[v], 0]
    assert len(set(step3d_cuda._HADV_CODE.values())) == len(HSCHEMES)
    assert len(set(step3d_cuda._VADV_CODE.values())) == len(VSCHEMES)
    for change in (dict(t_hadv=("SPLINES", "U3")),
                   dict(t_vadv=("U3", "C4"))):
        cfg = cfg_t.replace(**change)
        assert step3d_cuda.use_tracer(cfg)
        with pytest.raises(ValueError, match="advection schemes"):
            step3d_cuda._tracer_ints(cfg, "tracer_predictor")
    with pytest.raises(ValueError, match="unknown horizontal"):
        tadv.hadv_fluxes(cfg_t, "SPLINES", *[torch.zeros(2, 3, 3)] * 3)
    with pytest.raises(ValueError, match="unknown vertical"):
        tadv.vadv_flux("U3", *[torch.zeros(3, 3, 3)] * 3, "predictor")
    with pytest.raises(ValueError, match="outside"):
        step3d_cuda._tracer_ints(cfg_t.replace(ntracers=0, t_hadv=(),
                                               t_vadv=()), "tracer_corrector")
