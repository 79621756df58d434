"""roms_tpu_torch: the whole BENCHMARK step on the CPU.

(a) three float64 steps of the small BENCHMARK (64x32x12, ndtfast 10)
    reproduce tests/data/torch_benchmark_small.npz, written by
    scripts/torch_benchmark_fixture.py from roms_tpu's eager step, at the
    bounds that script states, with no JAX run here;
(b) twenty steps stay finite and bounded, and the zonal wind jet drives an
    eastward surface current (the analog of test_benchmark_case.py);
(c) a BENCHMARK grid and State carried over from numpy arrays of
    roms_tpu's (convert.py) equal the ones the port builds.
"""

import dataclasses
import os

import numpy as np
import torch

from roms_tpu_torch import convert, stepping
from roms_tpu_torch.grid import Grid
from roms_tpu_torch.models import benchmark as tbm
from roms_tpu_torch.state import State
from test_torch_benchmark_physics import _pair
from chip_smoke import fixture_script

torch.set_num_threads(1)

_FIXTURE = os.path.join(os.path.dirname(__file__), "data",
                        "torch_benchmark_small.npz")
fixture = fixture_script()


def interior(cfg, a):
    H = cfg.halo
    return a[..., H:H + cfg.Mm, H:H + cfg.Lm]


def test_small_benchmark_matches_fixture():
    """At the bounds scripts/torch_benchmark_fixture.py states, with the
    errors measured here beside them."""
    ref = np.load(_FIXTURE)
    cfg, grid, s0, ffn = tbm.build(tbm.make_config(**fixture.CASE),
                                   device="cpu")
    s = stepping.run(cfg, grid, s0, fixture.NSTEPS, ffn)
    assert (s.iic, s.time) == (int(ref["iic"]), float(ref["time"]))
    errors = fixture.errors(cfg, s0, s, ref)
    assert set(errors) == set(ref.files) - {"time", "iic"}
    bad = {k: e for k, e in errors.items() if not e[0] <= e[1]}
    assert not bad, bad


def test_benchmark_runs_stable_and_eastward():
    cfg, grid, s, ffn = tbm.build(tbm.make_config(Lm=32, Mm=16, N=8,
                                                  ndtfast=10), device="cpu")
    s = stepping.run(cfg, grid, s, 20, ffn)
    for name in ("zeta", "ubar", "vbar", "u", "v", "t", "Akv", "Akt",
                 "hsbl"):
        assert bool(torch.isfinite(getattr(s, name)).all()), name
    assert float(interior(cfg, s.u).abs().max()) < 2.0
    assert float(grid.f.max()) < 0.0
    # the eastward wind jet at 60S gives an eastward mean surface current
    assert float(interior(cfg, s.u[-1]).mean()) > 0.0
    # KPP has replaced the background diffusivities
    assert not torch.equal(s.Akt, tbm.build(cfg, device="cpu")[2].Akt)


def test_convert_benchmark_grid_and_state():
    cfg_j, grid_j, cfg_t, grid_t = _pair(Lm=16, Mm=8, N=4)
    arrays = {f.name: None if getattr(grid_j, f.name) is None
              else np.asarray(getattr(grid_j, f.name))
              for f in dataclasses.fields(Grid)}
    grid_c = convert.grid_from_numpy(cfg_t, arrays, device="cpu")
    for f in dataclasses.fields(Grid):
        a, b = getattr(grid_c, f.name), getattr(grid_t, f.name)
        assert (a is None and b is None) or torch.equal(a, b), f.name
    _, _, s, ffn = tbm.build(cfg_t, device="cpu")
    s = stepping.step(cfg_t, grid_t, s, ffn)
    back = convert.state_from_numpy(cfg_t, convert.state_to_numpy(s),
                                    device="cpu")
    assert isinstance(back, State) and (back.iic, back.time) == (1, cfg_t.dt)
    for name in ("hsbl", "hbbl", "Akv", "Akt", "t"):
        assert torch.equal(getattr(back, name), getattr(s, name)), name
