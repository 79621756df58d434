"""roms_tpu_torch's wetting-drying on the CPU (ops/wetdry.py and the
general fast loop with cfg.wetdry), against roms_tpu: the mask encodings,
the limiter's truth table, the lone pond, each function against roms_tpu's
under jax.jit on seeded fields, the fast loop with dry flats against
roms_tpu's step2d.fast_loop recorded in tests/data/torch_coastal_small.npz
(scripts/torch_coastal_fixture.py), and the all-wet loop equal to the loop
without wetting-drying."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from roms_tpu.ops import wetdry as jwetdry
from roms_tpu_torch.config import Config
from roms_tpu_torch.grid import build_grid
from roms_tpu_torch.ops import step2d, wetdry
from chip_smoke import coastal_fixture_script

torch.set_num_threads(1)

fx = coastal_fixture_script()
T = torch.tensor


def test_face_mask_encoding():
    # one row: wet wet dry dry wet; face i uses cells (i-1, i)
    wd = T([[1.0, 1.0, 0.0, 0.0, 1.0]] * 3, dtype=torch.float64)
    um, _ = wetdry.face_masks(wd)
    assert um[1, 1:].tolist() == [2.0, 1.0, 0.0, -1.0]
    _, vm = wetdry.face_masks(wd.T.contiguous())
    assert vm[1:, 1].tolist() == [2.0, 1.0, 0.0, -1.0]


@pytest.mark.parametrize("corners, want", [
    ((1, 1, 1, 1), 1.0), ((0, 1, 1, 1), 1.0), ((1, 1, 0, 0), 2.0),
    ((1, 0, 1, 0), 2.0), ((1, 0, 0, 1), 0.0), ((0, 1, 1, 0), 0.0),
    ((1, 0, 0, 0), 0.0), ((0, 0, 0, 0), 0.0)])
def test_psi_mask_encoding(corners, want):
    """corners (i-1,j-1), (i,j-1), (i-1,j), (i,j): three or four wet -> 1,
    an edge-adjacent pair -> 2, a diagonal pair or fewer -> 0."""
    a, b, c, d = corners
    wd = T([[a, b], [c, d]], dtype=torch.float64)
    assert float(wetdry.psi_wet(wd)[1, 1]) == want


def test_limiter_truth_table():
    """m = +1: flow toward the dry east cell passes, out of it is blocked;
    m = -1 the mirror; 2 and 0 pass and block; -0.0 counts as >= 0, as in
    roms_tpu (torch.sign would give 0 and a multiplier of 0.5)."""
    m = T([2.0, 0.0, 1.0, 1.0, -1.0, -1.0, 1.0, -1.0], dtype=torch.float64)
    x = T([5.0, 5.0, 1.0, -1.0, 1.0, -1.0, -0.0, -0.0], dtype=torch.float64)
    got = wetdry.limit(m, x)
    assert got.tolist() == [1.0, 0.0, 1.0, 0.0, 0.0, 1.0, 1.0, 0.0]
    ref = jax.jit(jwetdry.limit)(jnp.asarray(m.numpy()),
                                 jnp.asarray(x.numpy()))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_avg_face_mask_lone_pond():
    wd = T([[1.0, 1.0, 0.0]] * 2, dtype=torch.float64)
    flux = torch.zeros_like(wd)
    um, _ = wetdry.avg_face_masks(wd, flux, flux)
    assert float(um[0, 1]) == 1.0      # between two wet cells
    assert float(um[0, 2]) == 0.0      # zero flux next to a dry cell


@pytest.fixture(scope="module")
def inlet(tmp_path_factory):
    """The small inlet of the fixture, at rest below its flats."""
    tmp = str(tmp_path_factory.mktemp("inlet"))
    cfg, grid, _, _ = fx.build_port("inlet_test", tmp)
    return cfg, grid


def test_masks_match_jax(inlet):
    """rho_wet, face_masks, psi_wet, avg_face_masks and clamp_zeta on the
    fixture's inlet with seeded zeta and transports, bitwise roms_tpu's
    under jax.jit."""
    cfg, grid = inlet
    rng = np.random.default_rng(3)
    h = grid.h.numpy()
    zeta = np.maximum(-0.3, cfg.dcrit - h) + \
        0.05 * rng.random(h.shape) * (rng.random(h.shape) > 0.5)
    DU, DV = rng.standard_normal((2,) + h.shape) * (rng.random(h.shape) > 0.2)

    class G:
        pass
    gj = G()
    gj.h, gj.rmask = jnp.asarray(h), jnp.asarray(grid.rmask.numpy())

    def ref_fn(z, du, dv):
        wd = jwetdry.rho_wet(cfg, gj, z)
        um, vm = jwetdry.face_masks(wd)
        uma, vma = jwetdry.avg_face_masks(wd, du, dv)
        return (wd, um, vm, jwetdry.psi_wet(wd), uma, vma,
                jwetdry.clamp_zeta(cfg, gj, z))

    ref = jax.jit(ref_fn)(jnp.asarray(zeta), jnp.asarray(DU),
                          jnp.asarray(DV))
    wd = wetdry.rho_wet(cfg, grid, T(zeta))
    got = (wd, *wetdry.face_masks(wd), wetdry.psi_wet(wd),
           *wetdry.avg_face_masks(wd, T(DU), T(DV)),
           wetdry.clamp_zeta(cfg, grid, T(zeta)))
    assert 0.0 < float(wd.sum()) < float(grid.rmask.sum())
    for k, (a, b) in enumerate(zip(got, ref)):
        assert a.dtype == torch.float64
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=k)


def test_fast_loop_matches_fixture(inlet):
    """The general fast loop with wetting-drying from a state whose flats
    sit dry at the critical depth, against roms_tpu's fast_loop (the
    fixture's "wetdry/..."), every output and the averaged masks."""
    cfg, grid = inlet
    ref = np.load(fx.OUT)
    out = fx.port_wetdry_loop(step2d, cfg, grid)
    assert out[3] is not None and set(out[3]) == set(fx.WET)
    errors = fx.wetdry_errors(out, ref)
    bad = {k: e for k, e in errors.items() if not e[0] <= e[1]}
    assert not bad, bad
    # the masks are exact
    for k in fx.WET:
        assert np.array_equal(out[3][k].numpy(), ref[f"wetdry/{k}"]), k
    dry = (out[3]["rmask_wet"] == 0) & (grid.rmask == 1)
    assert bool(dry.any())


def test_all_wet_loop_equals_the_loop_without(inlet):
    """With 50 m of water everywhere the wet/dry machinery changes
    nothing: the loop with cfg.wetdry equals the loop without it bitwise
    (each multiplier is exactly 1), and its masks are all wet."""
    cfg = Config(name="chan", Lm=24, Mm=16, N=2, dt=300.0, ndtfast=10,
                 visc2=0.0, uv_vis2=False, bottom_drag=None)
    grid, cfg = build_grid(cfg, 100e3, 80e3, f0=1e-4, beta=0.0,
                           depth_fn=lambda x, y, i, j, c: 50.0 + 0 * x,
                           device="cpu")
    rng = np.random.default_rng(0)
    z = T(0.01 * rng.standard_normal(grid.h.shape))
    zero = torch.zeros_like(z)
    out = {}
    for on in (False, True):
        fs = step2d.Fast2DState(
            zeta_n=z, zeta_nm1=z, ubar_n=zero, ubar_nm1=zero, vbar_n=zero,
            vbar_nm1=zero, **{k: zero for k in fx.FS_FIELDS[6:]})
        out[on] = step2d.fast_loop(dataclasses.replace(cfg, wetdry=on),
                                   grid, fs, zero, zero, zero, zero, zero,
                                   zero, 0)
    for k in fx.FS_FIELDS:
        assert torch.equal(getattr(out[True][0], k),
                           getattr(out[False][0], k)), k
    assert torch.equal(out[True][1], out[False][1])
    assert out[False][3] is None
    for k in fx.WET:
        assert float(out[True][3][k].min()) == 1.0, k
