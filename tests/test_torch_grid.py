"""roms_tpu_torch: grid, s-coordinates, set_depth and fast-filter weights
against roms_tpu (analogs of test_vgrid.py and test_weights.py), on the
full-size UPWELLING grid."""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from roms_tpu import grid as jgrid, vgrid as jvgrid
from roms_tpu.models import upwelling as jup
from roms_tpu_torch import grid as tgrid, vgrid as tvgrid
from roms_tpu_torch.models import upwelling as tup

torch.set_num_threads(1)

TOL = 1e-14


def _close(a, b, name=""):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, name
    scale = max(np.abs(b).max(), 1.0) if b.size else 1.0
    np.testing.assert_allclose(a, b, rtol=0, atol=TOL * scale, err_msg=name)


@pytest.fixture(scope="module")
def full_size():
    cfg_j, grid_j, s_j, _ = jup.build(jup.make_config())
    cfg_t, grid_t, s_t, _ = tup.build(tup.make_config(), device="cpu")
    return cfg_j, grid_j, s_j, cfg_t, grid_t, s_t


def test_upwelling_grid_matches(full_size):
    cfg_j, grid_j, _, cfg_t, grid_t, _ = full_size
    assert (cfg_t.hmin, cfg_t.nfast) == (cfg_j.hmin, cfg_j.nfast)
    assert tgrid.hc_of(cfg_t) == jgrid.hc_of(cfg_j)
    for f in dataclasses.fields(tgrid.Grid):
        a = getattr(grid_t, f.name)
        if a is None:
            assert getattr(grid_j, f.name) is None
            continue
        assert a.dtype == torch.float64 and a.is_contiguous()
        _close(a.numpy(), getattr(grid_j, f.name), f.name)
    for prop in ("on_u", "om_u", "on_v", "om_v", "om_r", "on_r", "omn",
                 "fomn"):
        _close(getattr(grid_t, prop).numpy(), getattr(grid_j, prop), prop)


def test_upwelling_initial_state_matches(full_size):
    _, _, s_j, _, _, s_t = full_size
    for name in ("zeta", "u", "t", "t_prev", "Akv", "Akt", "tke", "gls",
                 "Akk", "rlength", "bed_mass"):
        _close(getattr(s_t, name).numpy(), getattr(s_j, name), name)
    assert (s_t.time, s_t.iic) == (float(s_j.time), int(s_j.iic))


@pytest.mark.parametrize("vs", [1, 2, 3, 4, 5])
def test_scoord_matches(vs):
    for theta_s, theta_b, N in ((3.0, 0.5, 16), (5.0, 0.0, 20)):
        for a, b in zip(tvgrid.scoord(vs, theta_s, theta_b, N),
                        jvgrid.scoord(vs, theta_s, theta_b, N)):
            _close(a, b)
    sc_r, Cs_r, sc_w, Cs_w = tvgrid.scoord(vs, 3.0, 0.5, 16)
    assert sc_w[0] == -1.0 and Cs_w[0] == -1.0
    assert np.all(np.diff(Cs_w) > 0)


@pytest.mark.parametrize("vtransform", [1, 2])
def test_set_depth_matches(vtransform):
    rng = np.random.default_rng(7)
    N = 16
    tables = jvgrid.scoord(4, 3.0, 0.0, N)
    h = 20.0 + 130.0 * rng.random((9, 11))
    zeta = 0.5 * rng.standard_normal((9, 11))
    hc = jvgrid.compute_hc(vtransform, 25.0, float(h.min()))
    assert tvgrid.compute_hc(vtransform, 25.0, float(h.min())) == hc
    ref = jvgrid.set_depth(jnp.asarray(h), jnp.asarray(zeta), hc, *tables,
                           vtransform)
    got = tvgrid.set_depth(torch.as_tensor(h), torch.as_tensor(zeta), hc,
                           *[torch.as_tensor(t) for t in tables],
                           vtransform)
    for a, b, name in zip(got, ref, ("z_r", "z_w", "Hz")):
        _close(a.numpy(), b, name)
    # total thickness equals h + zeta
    np.testing.assert_allclose(got[2].sum(0).numpy(), h + zeta, rtol=1e-12)


@pytest.mark.parametrize("ndtfast", [8, 10, 20, 30, 45, 60])
def test_build_weights_matches(ndtfast):
    w1, w2, nfast = tgrid.build_weights(ndtfast)
    r1, r2, rn = jgrid.build_weights(ndtfast)
    assert nfast == rn
    _close(w1, r1)
    _close(w2, r2)
    # set_weights.F invariants: both sums 1, primary centroid 1
    i = np.arange(1, len(w1) + 1)
    assert abs(w1.sum() - 1.0) < 1e-13 and abs(w2.sum() - 1.0) < 1e-13
    assert abs((w1 * i).sum() / ndtfast - 1.0) < 1e-12
    assert ndtfast < nfast <= 2 * ndtfast
