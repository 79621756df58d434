"""roms_tpu_torch: the ice shelf (ICESHELF) and mean-age tracers (AGE_MEAN)
on the CPU in float64.

(a) vgrid.set_depth with an ice draft against roms_tpu's under jax.jit at
    1e-15 x max|field|: the levels stretch over the water column h and the
    column sits |zice| lower;
(b) the surface fluxes under the ice (stepping._under_ice, then set_vbc):
    the top-layer ice-base drag in place of the wind stress and no surface
    tracer or shortwave flux, against the sustr, svstr, stflx and srflx
    that roms_tpu's eager step hands its tracer and momentum start from
    the same state, under quadratic and linear drag, as
    scripts/torch_cases2_fixture.py stores them in
    tests/data/torch_cases2_small.npz (no JAX run);
(c) AGE_MEAN on the fixture's small 4-tracer UPWELLING (the steps against
    roms_tpu's are in tests/test_torch_cases2.py): the analog of
    tests/test_step3d.py::test_mean_age_tracer_pair (a uniform tracer stays
    1 and its age is n dt after n steps), and the age update is exactly
    t[iage] + dt t[icons] after the tracer corrector.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from roms_tpu import vgrid as jvgrid
from roms_tpu_torch import stepping, vgrid as tvgrid
from roms_tpu_torch.grid import hc_of
from chip_smoke import cases2_fixture_script

torch.set_num_threads(1)

fx = cases2_fixture_script()


def _rel(a, b):
    b = np.asarray(b)
    return float(np.abs(a.numpy() - b).max() / max(np.abs(b).max(), 1e-300))


@pytest.fixture(scope="module")
def weddell():
    """The fixture's small WEDDELL (its cavity and ice front)."""
    return fx.build_port("weddell")[:2]


def test_set_depth_with_ice_draft(weddell):
    cfg, grid = weddell
    zeta = torch.tensor(0.1 * np.random.default_rng(2).standard_normal(
        tuple(grid.h.shape)))
    args = (grid.h, zeta, hc_of(cfg), grid.sc_r, grid.Cs_r, grid.sc_w,
            grid.Cs_w)
    got = tvgrid.set_depth(*args, cfg.vtransform, zice=grid.zice)
    ref = jax.jit(lambda *a: jvgrid.set_depth(*a[:-1], cfg.vtransform,
                                              zice=a[-1]))(
        *(jnp.asarray(a.numpy()) if isinstance(a, torch.Tensor) else a
          for a in args + (grid.zice,)))
    for name, a, b in zip(("z_r", "z_w", "Hz"), got, ref):
        assert _rel(a, b) <= 1e-15, name
    z_r, z_w, Hz = got
    open_ = tvgrid.set_depth(*args, cfg.vtransform)
    assert torch.equal(Hz, open_[2])
    dz = torch.abs(grid.zice)
    assert torch.equal(z_w[-1], zeta - dz)
    assert torch.equal(z_w[0], -grid.h - dz)
    assert float(dz.max()) == 340.0


@pytest.mark.parametrize("drag", fx.ICE_DRAGS)
def test_surface_fluxes_under_the_ice(drag):
    ref = np.load(fx.OUT)
    grid, a, got = fx.under_ice_port(drag)
    for name, x in got.items():
        assert _rel(x, ref[f"under_ice/{drag}/{name}"]) <= fx.ICE_BOUND, name
    # the ice branch did act: the drag replaced the wind under the ice,
    # and the open water kept its fluxes
    icy = grid.zice != 0.0
    assert bool(icy.any()) and bool((~icy).any())
    assert float((got["sustr"] - a["sustr"]).abs().max()) > 0.0
    assert bool((got["srflx"][icy] == 0.0).all())
    assert torch.equal(got["srflx"][~icy], a["srflx"][~icy])


@pytest.fixture(scope="module")
def upw4():
    """The fixture's small UPWELLING with a uniform third tracer (1) and
    its age (0), as roms_tpu's test sets them up."""
    return fx.build_port("upwelling_age")


def test_mean_age_tracer_pair(upw4):
    cfg, grid, s, ffn = upw4
    s = stepping.run(cfg, grid, s, 3, ffn)
    H = cfg.halo
    inner = (slice(None), slice(H, H + cfg.Mm), slice(H, H + cfg.Lm))
    C, A = s.t[2][inner].numpy(), s.t[3][inner].numpy()
    np.testing.assert_allclose(C, 1.0, atol=1e-9)       # constancy
    np.testing.assert_allclose(A / C, 3 * cfg.dt, rtol=1e-7)


def test_age_update_after_the_corrector(upw4):
    """One step with the pair against the same step without it: the age
    tracer is t[3] + dt t[2] of the corrector's result, every other
    field bitwise the same."""
    cfg, grid, s, ffn = upw4
    s = stepping.run(cfg, grid, s, 1, ffn)
    with_age = stepping.step(cfg, grid, s, ffn)
    without = stepping.step(dataclasses.replace(cfg, inert_age=()), grid, s,
                            ffn)
    t = without.t
    assert torch.equal(with_age.t[3], t[3] + cfg.dt * t[2])
    assert torch.equal(with_age.t[:3], t[:3])
    assert torch.equal(with_age.u, without.u)
