"""roms_tpu_torch.obs on the CPU: the s4dvar observation file and
stats_modobs, and the FracObs twin (the analogs of tests/test_obs.py:
60-128).

(a) the observation file round trip (roms_tpu reads the port's file as
    its own), and read_obs's values on the given device, the card by
    default;
(b) the FracObs twin of tests/test_obs.py:85-128: I4D-Var through the
    fractional-coordinate H beats the background in observation space,
    and its Jo, CG residuals, increment and stats_modobs of background
    and analysis equal tests/data/torch_fourdvar_small.npz (roms_tpu's,
    written by scripts/torch_fourdvar_fixture.py) at the bounds that
    script states, from roms_tpu's observations; the port's own truth run
    reproduces those observations.
"""

import numpy as np
import pytest
import torch

from roms_tpu import obs as jobs
from roms_tpu_torch import obs, stepping
from roms_tpu_torch.models import upwelling
from chip_smoke import _script

torch.set_num_threads(1)

fx = _script("torch_fourdvar_fixture")


@pytest.fixture(scope="module")
def ref():
    return np.load(fx.OUT)


@pytest.fixture(scope="module")
def cfg():
    return upwelling.make_config(Lm=16, Mm=18, N=4)


def test_obs_file_roundtrip(cfg, tmp_path):
    path = str(tmp_path / "obs.nc")
    olist = [
        obs.FracObs(step=4, var="temp", xg=np.array([6.25]),
                    yg=np.array([7.75]), zg=np.array([2.5]),
                    values=torch.tensor([18.0]), sigma=0.3),
        obs.FracObs(step=2, var="zeta", xg=np.array([3.5, 8.0]),
                    yg=np.array([4.0, 9.5]),
                    values=torch.tensor([0.1, -0.2]), sigma=0.05),
    ]
    obs.write_obs(path, cfg, olist)
    back = obs.read_obs(path, cfg, device="cpu")
    assert len(back) == 2
    bz = next(o for o in back if o.var == "zeta")
    bt = next(o for o in back if o.var == "temp")
    assert bz.step == 2 and bt.step == 4
    assert isinstance(bz.values, torch.Tensor) and \
        bz.values.device.type == "cpu" and bz.values.dtype == torch.float64
    np.testing.assert_allclose(bz.values.numpy(), [0.1, -0.2])
    np.testing.assert_allclose(bz.xg, [3.5, 8.0])
    assert bz.sigma == pytest.approx(0.05)
    assert bz.zg is None
    np.testing.assert_allclose(bt.zg, [2.5])
    # roms_tpu reads the port's file as its own
    jback = jobs.read_obs(path, cfg)
    assert [(o.step, o.var) for o in jback] == [(o.step, o.var)
                                                for o in back]
    for a, b in zip(jback, back):
        np.testing.assert_array_equal(np.asarray(a.values), b.values.numpy())
        assert a.sigma == b.sigma


def test_read_obs_defaults_to_the_card(cfg, tmp_path):
    path = str(tmp_path / "obs.nc")
    obs.write_obs(path, cfg, [obs.FracObs(step=1, var="zeta",
                                          xg=np.array([2.0]),
                                          yg=np.array([3.0]),
                                          values=torch.tensor([0.5]))])
    if torch.cuda.is_available():
        assert obs.read_obs(path, cfg)[0].values.is_cuda
    else:
        with pytest.raises((AssertionError, RuntimeError)):
            obs.read_obs(path, cfg)


def test_i4dvar_with_fracobs_twin(ref):
    """The FracObs twin from roms_tpu's observations: the analysis beats
    the background (Jo halves, stats_modobs's RMSE falls) and every number
    matches the fixture's."""
    su, ana, diags = fx.port_driver("fracobs",
                                    obs_values=fx.fixture_obs(ref, "fracobs"))
    cfg, grid, s0, ffn, olist, nsteps, _ = su
    assert diags["Jo"][-1] < 0.5 * diags["Jo"][0]
    errs = fx.driver_errors("fracobs", su, ana, diags, ref)
    bad = {k: e for k, e in errs.items() if not e[0] <= e[1]}
    assert not bad, bad

    sb, sa, states_b, states_a = s0, ana, {}, {}
    for n in range(1, nsteps + 1):
        sb = stepping.step(cfg, grid, sb, ffn)
        sa = stepping.step(cfg, grid, sa, ffn)
        states_b[n], states_a[n] = sb, sa
    stat_b = obs.stats_modobs(cfg, olist, states_b)
    stat_a = obs.stats_modobs(cfg, olist, states_a)
    assert stat_a["temp"]["rmse"] < stat_b["temp"]["rmse"]
    assert stat_b["temp"]["count"] == 12 * nsteps
    for tag, stat in (("b", stat_b), ("a", stat_a)):
        for k, want in zip(fx.STAT_KEYS, ref[f"fracobs/stats_{tag}"]):
            assert fx.rel_err([stat["temp"][k]], [want]) <= \
                fx.BOUNDS["driver"], (tag, k, stat["temp"][k], want)


def test_fracobs_truth_run_matches_roms_tpu(ref):
    errs = fx.obs_errors("fracobs", fx.port_twin("fracobs"), ref)
    bad = {k: e for k, e in errs.items() if not e[0] <= e[1]}
    assert not bad, bad

