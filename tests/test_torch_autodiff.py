"""roms_tpu_torch's tangent-linear and adjoint step on the CPU (the analog
of tests/test_autodiff.py).

UPWELLING 12x16x6, ndtfast 8, 5 steps in (the fixture's state): torch.func
.jvp / vjp of one step through fourdvar.step_map pass the pert_roms.h
finite-difference check and the symmetry.h check <J dx, dy> = <dx, J^T dy>
at 1e-10, and equal roms_tpu's jax.jvp / jax.vjp
(tests/data/torch_fourdvar_small.npz, scripts/torch_fourdvar_fixture.py)
from the same state and seeded tangents at the bound that script states;
fourdvar.Linearization (the jvp built from two vjps that the drivers take)
gives the same numbers.  The repairs for the small BENCHMARK are in
tests/test_torch_autodiff_kpp.py, the kernels' refusal in
tests/test_torch_kernel_guard.py.
"""

import numpy as np
import pytest
import torch

from roms_tpu_torch import fourdvar
from roms_tpu_torch.state import TENSOR_FIELDS
from chip_smoke import _script

torch.set_num_threads(1)

fx = _script("torch_fourdvar_fixture")


@pytest.fixture(scope="module")
def ref():
    return np.load(fx.OUT)


@pytest.fixture(scope="module")
def tlm(ref):
    """The port's jvp and vjp of the autodiff part's step."""
    return fx.port_autodiff(ref)


def _dot(a, b):
    return sum(float(torch.vdot(a[k].reshape(-1), b[k].reshape(-1)))
               for k in a)


def test_tlm_finite_difference_convergence(ref, tlm):
    """pert_roms.h: |f(x+eps*dx) - f(x) - eps*J dx| = O(eps^2)."""
    cfg, s, dx, dy, jdx, _ = tlm
    _, grid, _, ffn = fx.port_autodiff_state(ref)
    f, x = fourdvar.step_map(cfg, grid, s, ffn)
    y0 = f(x)
    errs = []
    for eps in (1e-4, 1e-5):
        y1 = f({k: x[k] + eps * dx[k] for k in x})
        diff = {k: (y1[k] - y0[k]) / eps - jdx[k] for k in y0}
        errs.append(np.sqrt(_dot(diff, diff)) / np.sqrt(_dot(jdx, jdx)))
    assert errs[0] < 1e-2
    assert errs[1] < errs[0]


def test_adjoint_symmetry(tlm):
    """symmetry.h / dotproduct.F: <J dx, dy> == <dx, J^T dy>."""
    _, _, dx, dy, jdx, jtdy = tlm
    lhs, rhs = _dot(jdx, dy), _dot(dx, jtdy)
    assert abs(lhs - rhs) <= 1e-10 * max(abs(lhs), abs(rhs), 1e-30)


def test_tlm_adm_match_roms_tpu(ref, tlm):
    cfg, _, dx, dy, jdx, jtdy = tlm
    errs = fx.autodiff_errors(cfg, jdx, jtdy, ref)
    bad = {k: e for k, e in errs.items() if not e[0] <= e[1]}
    assert not bad, bad
    lhs, rhs = ref["autodiff/dots"]
    assert abs(_dot(jdx, dy) - lhs) <= 1e-10 * abs(lhs)
    assert abs(_dot(dx, jtdy) - rhs) <= 1e-10 * abs(rhs)


def test_linearization_matches_torch_func(ref, tlm):
    """The drivers' TLM and ADM (one recorded run, the jvp from two vjps)
    against torch.func.jvp / vjp of the same step."""
    cfg, s, dx, dy, jdx, jtdy = tlm
    _, grid, _, ffn = fx.port_autodiff_state(ref)
    f, x = fourdvar.step_map(cfg, grid, s, ffn)

    def flat(d):
        return torch.cat([d[k].reshape(-1) for k in TENSOR_FIELDS])

    lin = fourdvar.Linearization(lambda d: flat(f(d)), x)
    got = lin.jvp(dx)
    want = flat(jdx)
    assert float((got - want).abs().max()) <= 1e-12 * float(
        want.abs().max())
    adj = lin.vjp(flat(dy))
    for k in TENSOR_FIELDS:
        if jtdy[k].numel():
            assert float((adj[k] - jtdy[k]).abs().max()) <= 1e-12 * float(
                jtdy[k].abs().max()), k
    assert torch.equal(lin.hx, flat(f(x)))
