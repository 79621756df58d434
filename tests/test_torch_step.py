"""roms_tpu_torch: the whole baroclinic step.

(a) three eager UPWELLING steps at 24x20x4 / ndtfast 8 through both
    packages' stepping.step agree on every State field;
(b) ten float64 steps of full-size UPWELLING reproduce the pinned anchor
    tests/data/upwelling_anchor.npz at the bounds of test_anchor.py, with
    no JAX run;
(c) a spatially constant tracer stays constant (the analog of
    test_step3d.py::test_tracer_constancy_*).
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from roms_tpu import stepping as jstepping
from roms_tpu.models import upwelling as jup
from roms_tpu_torch import convert, stepping
from roms_tpu_torch.models import upwelling as tup
from roms_tpu_torch.state import State, TENSOR_FIELDS

torch.set_num_threads(1)

_ANCHOR = os.path.join(os.path.dirname(__file__), "data",
                       "upwelling_anchor.npz")


def interior(cfg, a):
    H = cfg.halo
    return a[..., H:H + cfg.Mm, H:H + cfg.Lm]


def test_three_steps_match_jax():
    cfg_j, grid_j, s_j, ffn_j = jup.build(jup.make_config(Lm=24, Mm=20, N=4,
                                                          ndtfast=8))
    cfg, grid, s, ffn = tup.build(tup.make_config(Lm=24, Mm=20, N=4,
                                                  ndtfast=8))
    for _ in range(3):
        s_j = jstepping.step(cfg_j, grid_j, s_j, ffn_j)
        s = stepping.step(cfg, grid, s, ffn)
    assert (s.iic, s.time) == (int(s_j.iic), float(s_j.time))
    got = convert.state_to_numpy(s)
    assert set(TENSOR_FIELDS) == {f.name for f in dataclasses.fields(s_j)} \
        - {"time", "iic"}
    for name in TENSOR_FIELDS:
        ref = np.asarray(getattr(s_j, name))
        scale = max(np.abs(ref).max(), 1e-300) if ref.size else 1.0
        np.testing.assert_allclose(got[name], ref, rtol=0,
                                   atol=1e-12 * scale, err_msg=name)
    # the state converts back one to one
    back = convert.state_from_numpy(cfg, {f.name: np.asarray(
        getattr(s_j, f.name)) for f in dataclasses.fields(s_j)})
    assert isinstance(back, State) and back.iic == s.iic


def test_upwelling_10step_anchor():
    ref = np.load(_ANCHOR)
    cfg, grid, s, ffn = tup.build(tup.make_config())
    s = stepping.run(cfg, grid, s, 10, ffn)
    zeta = interior(cfg, s.zeta).numpy()
    u = interior(cfg, s.u).numpy()
    v = interior(cfg, s.v).numpy()
    t0 = interior(cfg, s.t).numpy()[0]
    np.testing.assert_allclose(zeta, ref["zeta"], rtol=0, atol=1e-12)
    np.testing.assert_allclose(u, ref["u_full"], rtol=0, atol=1e-13)
    np.testing.assert_allclose(v, ref["v_full"], rtol=0, atol=1e-13)
    np.testing.assert_allclose(t0, ref["temp_full"], rtol=0, atol=1e-10)
    np.testing.assert_allclose(u[:, ::8, ::8], ref["u_sub"], rtol=0,
                               atol=1e-13)
    np.testing.assert_allclose(v[:, ::8, ::8], ref["v_sub"], rtol=0,
                               atol=1e-13)
    np.testing.assert_allclose(t0[:, ::8, ::8], ref["temp_sub"], rtol=0,
                               atol=1e-10)
    assert abs(float(zeta.sum())) < 1e-10
    np.testing.assert_allclose(float(t0.sum()), float(ref["temp_sum"]),
                               rtol=1e-12)
    np.testing.assert_allclose(float(np.sqrt((u ** 2).mean())),
                               float(ref["u_rms"]), rtol=1e-10)


@pytest.fixture(scope="module")
def upw():
    return tup.build(tup.make_config(Lm=16, Mm=24, N=8, ndtfast=10))


def _constant_tracers(s0):
    tc = torch.stack([torch.full_like(s0.t[0], 14.0),
                      torch.full_like(s0.t[0], 35.0)])
    return s0.replace(t=tc, t_prev=tc.clone())


def _constancy_error(cfg, s):
    return max(float((interior(cfg, s.t[0]) - 14.0).abs().max()),
               float((interior(cfg, s.t[1]) - 35.0).abs().max()))


@pytest.mark.parametrize("change, feature", [
    (dict(wetdry=True), "general fast loop"),
    (dict(vmix="kpp"), "vertical mixing closure"),
    (dict(bulk_fluxes=True), "COARE bulk fluxes"),
])
def test_step_raises_for_unported_branches(upw, change, feature):
    cfg, grid, s0, ffn = upw
    with pytest.raises(NotImplementedError, match=feature):
        stepping.step(dataclasses.replace(cfg, **change), grid, s0, ffn)


def test_tracer_constancy_no_wind(upw):
    cfg, grid, s0, _ = upw
    s = stepping.run(cfg, grid, _constant_tracers(s0), 5)
    assert _constancy_error(cfg, s) < 1e-12


def test_tracer_constancy_with_wind(upw):
    """With wind-driven flow, 1e-12 holds over the first two steps.  After
    that the reference's own fast-filter first-corrector inconsistency
    (test_step3d.py:43-47) adds O(1e-9) per step (measured ~3e-9 per
    tracer unit at step 10 on this grid), so the longer run is held to
    test_step3d.py's bound."""
    cfg, grid, s0, ffn = upw
    s = stepping.run(cfg, grid, _constant_tracers(s0), 2, ffn)
    assert _constancy_error(cfg, s) < 1e-12
    s = stepping.run(cfg, grid, s, 8, ffn)
    assert _constancy_error(cfg, s) < 1e-7
    assert float(interior(cfg, s.u).abs().max()) > 1e-3   # real flow
    assert bool(torch.isfinite(s.u).all())
