"""roms_tpu_torch.fourdvar's surface-forcing control on the CPU (the analog
of tests/test_fourdvar.py:101-155; the open-boundary control is in
tests/test_torch_fourdvar.py).

The wind-stress control twin (ndtfast 30, vmix none, 3 steps, "sustr" in
the control vector, the IC sigmas zero): Jo falls by over three orders,
and the recovered stress anomaly correlates with the truth's above 0.95
at 0.8-1.2 of its amplitude; its Jo, CG residuals and control equal
roms_tpu's (tests/data/torch_fourdvar_small.npz,
scripts/torch_fourdvar_fixture.py) from roms_tpu's observations, and the
port's own truth run reproduces them.  It runs 4 CG iterations where
roms_tpu's test runs 8: its checks hold at 4 (Jo falls to 6.6e-5 of the
first) and each iteration costs ~3 s on one CPU thread.
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


def test_i4dvar_wind_stress_control_twin(ref):
    su, ana, diags = fx.port_driver("wind",
                                    obs_values=fx.fixture_obs(ref, "wind"))
    cfg, tau = su[0], su[6]
    assert diags["Jo"][-1] < 1e-3 * diags["Jo"][0]
    assert set(diags["control"]) == {"sustr"}
    H = cfg.halo
    ii = np.s_[H:H + cfg.Mm, H:H + cfg.Lm]
    a = diags["control"]["sustr"][ii].numpy().ravel()
    b = tau[ii].numpy().ravel()
    corr = float(np.dot(a - a.mean(), b - b.mean()) /
                 (np.linalg.norm(a - a.mean()) *
                  np.linalg.norm(b - b.mean()) + 1e-30))
    assert corr > 0.95, corr
    assert 0.8 < np.abs(a).max() / float(tau.max()) < 1.2
    errs = fx.driver_errors("wind", su, ana, diags, ref)
    bad = {k: e for k, e in errs.items() if not e[0] <= e[1]}
    assert not bad, bad


def test_wind_truth_run_matches_roms_tpu(ref):
    errs = fx.obs_errors("wind", fx.port_twin("wind"), ref)
    bad = {k: e for k, e in errs.items() if not e[0] <= e[1]}
    assert not bad, bad
