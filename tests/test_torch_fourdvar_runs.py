"""roms_tpu_torch.fourdvar's runs on the CPU: the truth runs and
linearization point, which runs take the kernels, and the open-boundary
control.

(a) the port's own 5 UPWELLING steps reach the autodiff fixture's
    linearization point, and its own twin truth run reproduces roms_tpu's
    observations (tests/data/torch_fourdvar_small.npz);
(b) the drivers' linearized runs take the plain path and their nonlinear
    runs the caller's configuration;
(c) "bry:zeta_west" on KELVIN 24x16x4 through fourdvar._make_ops: the
    innovation of seeded zeta observations at step 2 and the adjoint of
    H M at it, the boundary line's entry included, equal roms_tpu's.
"""

import numpy as np
import pytest
import torch

from roms_tpu_torch import fourdvar, stepping
from roms_tpu_torch.models import upwelling
from chip_smoke import _script

torch.set_num_threads(1)

fx = _script("torch_fourdvar_fixture")


@pytest.fixture(scope="module")
def ref():
    return np.load(fx.OUT)


def test_spinup_matches_fixture(ref):
    """The port's own 5 steps reach the fixture's linearization point
    (roms_tpu's jitted steps) within 1e-9: roms_tpu's jitted step differs
    from its eager one by ~1e-9 of max|zeta| (ROADMAP, North star), and
    the port rounds as the eager one does."""
    cfg, grid, s, ffn = upwelling.build(
        upwelling.make_config(**fx.AUTODIFF), device="cpu")
    s = stepping.run(cfg, grid, s, fx.SPINUP, ffn)
    assert s.iic == int(ref["autodiff/iic"])
    for k in ("zeta", "u", "v", "t"):
        assert fx.rel_err(getattr(s, k).numpy(),
                          ref[f"autodiff/state/{k}"]) <= 1e-9, k


def test_twin_truth_run_matches_roms_tpu(ref):
    errs = fx.obs_errors("twin", fx.port_twin("twin"), ref)
    bad = {k: e for k, e in errs.items() if not e[0] <= e[1]}
    assert not bad, bad


def test_linearized_runs_take_the_plain_path(ref, monkeypatch):
    """Every step a driver differentiates runs with pallas2d=False, every
    step it runs without a derivative with the caller's cfg."""
    cfg, grid, s0, ffn, obs, nsteps, _ = fx.port_twin(
        "twin", obs_values=fx.fixture_obs(ref, "twin"))
    seen = []
    step = stepping.step

    def spy(c, g, s, f=None, **kw):
        seen.append((c.pallas2d, torch.is_grad_enabled()))
        return step(c, g, s, f, **kw)

    monkeypatch.setattr(stepping, "step", spy)
    fourdvar.r4dvar(cfg, grid, s0, obs, nsteps, ffn,
                    sigmas=fx.TWIN_SIGMAS, b_iters=2, n_inner=1)
    assert cfg.pallas2d
    # innovation, linearization, final innovation: nsteps steps each
    assert seen == [(True, False)] * nsteps + [(False, True)] * nsteps + \
        [(True, False)] * nsteps
    assert fourdvar.linear_config(cfg) == cfg.replace(pallas2d=False)


def test_bry_control_matches_roms_tpu(ref):
    cfg, d, adj = fx.port_bry()
    assert set(adj) == set(fx.BRY_CONTROLS)
    assert adj["bry:zeta_west"].shape == (cfg.ny_tot,)
    assert float(adj["bry:zeta_west"].abs().max()) > 0.0
    errs = fx.bry_errors(cfg, d, adj, ref)
    assert set(errs) == {"bry/innovation"} | {
        f"bry/adj/{k}" for k in fx.BRY_CONTROLS}
    bad = {k: e for k, e in errs.items() if not e[0] <= e[1]}
    assert not bad, bad

