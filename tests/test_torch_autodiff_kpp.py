"""The repairs that let torch.func differentiate the KPP step, on the CPU.

(a) vmix._alpha_beta's jvp equals roms_tpu's jax.jvp (jax.grad inside
    jax.jvp there, torch.func.grad here), and torch.autograd reaches T
    through alpha;
(b) on the small BENCHMARK (KPP, JM95, COARE), 2 steps in, torch.func.jvp
    of one step runs (it raised before the repair) and equals roms_tpu's
    jax.jvp (tests/data/torch_fourdvar_small.npz) at the bound
    scripts/torch_fourdvar_fixture.py states, and torch.func.vjp runs:
    where its adjoint is not finite, roms_tpu's is not either (ROADMAP
    queue 3).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from roms_tpu.ops import vmix as jvmix
from roms_tpu_torch import fourdvar
from roms_tpu_torch.models import benchmark
from roms_tpu_torch.ops import vmix
from roms_tpu_torch.state import TENSOR_FIELDS
from chip_smoke import _script

torch.set_num_threads(1)

fx = _script("torch_fourdvar_fixture")


@pytest.fixture(scope="module")
def ref():
    return np.load(fx.OUT)


@pytest.fixture(scope="module")
def small_benchmark(ref):
    return fx.port_benchmark(ref)


def test_alpha_beta_jvp_matches_roms_tpu():
    """_alpha_beta differentiates through T and S (the .detach() of the
    port before the repair dropped that), as roms_tpu's jax.grad inside
    jax.jvp does."""
    cfg = benchmark.make_config(Lm=8, Mm=6, N=4)
    rng = np.random.default_rng(21)
    T, S = rng.uniform(-1.0, 28.0, (3, 10, 12)), rng.uniform(32, 36,
                                                             (3, 10, 12))
    dT, dS = rng.standard_normal((2, 3, 10, 12))
    (a, b), (ta, tb) = torch.func.jvp(
        lambda x, y: vmix._alpha_beta(cfg, x, y),
        (torch.tensor(T), torch.tensor(S)),
        (torch.tensor(dT), torch.tensor(dS)))
    (ja, jb), (jta, jtb) = jax.jit(lambda *v: jax.jvp(
        lambda x, y: jvmix._alpha_beta(cfg, x, y), v[:2], v[2:]))(
        jnp.asarray(T), jnp.asarray(S), jnp.asarray(dT), jnp.asarray(dS))
    for got, want in ((a, ja), (b, jb), (ta, jta), (tb, jtb)):
        want = np.asarray(want)
        assert np.abs(got.numpy() - want).max() <= 1e-13 * np.abs(
            want).max()
    assert float(ta.abs().max()) > 0.0 and float(tb.abs().max()) > 0.0
    # and under torch.autograd: the gradient reaches T through alpha
    Tg = torch.tensor(T, requires_grad=True)
    alpha, _ = vmix._alpha_beta(cfg, Tg, torch.tensor(S))
    (g,) = torch.autograd.grad(alpha.sum(), Tg)
    assert float(g.abs().max()) > 0.0


def test_benchmark_tlm_matches_roms_tpu(ref):
    """torch.func.jvp of one small-BENCHMARK step (it raised before the
    _alpha_beta repair) equals roms_tpu's jax.jvp from the same state."""
    cfg, jdx = fx.port_benchmark_tlm(ref)
    errs = fx.benchmark_errors(cfg, jdx, ref)
    bad = {k: e for k, e in errs.items() if not e[0] <= e[1]}
    assert not bad, bad
    assert all(bool(torch.isfinite(v).all()) for v in jdx.values())


def test_benchmark_adjoint_runs(ref, small_benchmark):
    """torch.func.vjp of one small-BENCHMARK step runs.  Its adjoint is
    not finite on the surface temperature plane, as roms_tpu's is: the
    derivative of COARE's gustiness (Bf Zabl)^(1/3) on Bf <= 0
    (ops/bulk_flux.py, roms_tpu/ops/bulk_flux.py:196).  roms_tpu's is not
    finite in more places, a superset (ROADMAP queue 3): KPP's cube and
    square roots at 0 give 0 x inf in both, and JAX's maximum and minimum
    carry the NaN on through their transposes (a product with a 0/1 mask)
    where torch's backward stops it (a masked fill)."""
    cfg, grid, s, ffn = small_benchmark
    f, x = fourdvar.step_map(cfg, grid, s, ffn)
    y, vjp_fn = torch.func.vjp(f, x)
    shapes = fx.shapes_of(s, fx.PROGNOSTIC)
    dy = {k: torch.zeros_like(v) for k, v in y.items()}
    dy.update({k: torch.tensor(v) for k, v in fx.tangent(shapes, 4).items()})
    (adj,) = vjp_fn(dy)
    surface_temp = cfg.N - 1
    for k in TENSOR_FIELDS:
        got = fx.nonfinite_planes(adj[k])
        want = ref[f"benchmark/vjp_nonfinite/{k}"]
        assert (got <= want).all(), (k, got, want)
        if k == "t":
            plane = cfg.ny_tot * cfg.nx_tot
            assert got[surface_temp] == want[surface_temp] == plane
            assert got.sum() == plane
        else:
            assert not got.any(), (k, got)
