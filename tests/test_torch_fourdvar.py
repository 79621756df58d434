"""roms_tpu_torch.fourdvar on the CPU: the I4D-Var twin and the two dual
drivers (the analogs of tests/test_fourdvar.py:14-98).

Each driver runs from roms_tpu's observations (stored in
tests/data/torch_fourdvar_small.npz by scripts/torch_fourdvar_fixture.py),
so its Jo, CG residuals and analysis increment are held to roms_tpu's at
the bounds that script states.  Nothing here runs roms_tpu's 4D-Var.

(a) the I4D-Var twin (12x14x4, SST at step 2, n_inner 5): Jo falls below
    0.05 of the first, and the analysis SST is closer to the truth than
    the background's;
(b) RBL4D-Var and R4D-Var (n_inner 8) reduce Jo like the primal and reach
    its analysis increment within 0.05 of its scale.

The truth runs, the drivers' paths and the boundary control are in
tests/test_torch_fourdvar_runs.py, the wind-stress control in
tests/test_torch_fourdvar_controls.py.
"""

import numpy as np
import pytest
import torch

from chip_smoke import _script

torch.set_num_threads(1)

fx = _script("torch_fourdvar_fixture")


@pytest.fixture(scope="module")
def ref():
    return np.load(fx.OUT)


@pytest.fixture(scope="module")
def primal8(ref):
    return fx.port_driver("primal8", obs_values=fx.fixture_obs(ref,
                                                               "primal8"))


def _fixture_ok(part, run, ref):
    errs = fx.driver_errors(part, *run, ref)
    bad = {k: e for k, e in errs.items() if not e[0] <= e[1]}
    assert not bad, bad


def test_i4dvar_twin_experiment(ref):
    su, ana, diags = fx.port_driver("twin",
                                    obs_values=fx.fixture_obs(ref, "twin"))
    background, truth = su[2], su[6]
    assert diags["Jo"][-1] < 0.05 * diags["Jo"][0]
    err_b = float((background.t[0, -1] - truth.t[0, -1]).abs().max())
    err_a = float((ana.t[0, -1] - truth.t[0, -1]).abs().max())
    assert err_a < 0.5 * err_b
    assert len(diags["cg_residuals"]) == 5 and diags["control"] == {}
    _fixture_ok("twin", (su, ana, diags), ref)


def test_i4dvar_primal_matches_roms_tpu(ref, primal8):
    _fixture_ok("primal8", primal8, ref)


@pytest.mark.parametrize("part,driver", [("rbl8", "rbl4dvar"),
                                         ("r48", "r4dvar")])
def test_dual_matches_primal(ref, primal8, part, driver):
    """The dual (observation-space) solves reach the primal's analysis
    for the same B and enough iterations, and roms_tpu's numbers."""
    su, ana_d, dd = fx.port_driver(part, obs_values=fx.fixture_obs(ref,
                                                                   part))
    assert dd["Jo"][-1] < 0.05 * dd["Jo"][0]
    s0 = su[2]
    _, ana_p, _ = primal8
    da = (ana_d.t[0, -1] - s0.t[0, -1]).numpy()
    pa = (ana_p.t[0, -1] - s0.t[0, -1]).numpy()
    np.testing.assert_allclose(da, pa, atol=0.05 * np.abs(pa).max())
    _fixture_ok(part, (su, ana_d, dd), ref)
