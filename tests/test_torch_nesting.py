"""roms_tpu_torch.nesting on the CPU: the analogs of tests/test_nesting.py's
grid construction, donor-boundary extraction, rest and constancy through
the nested cycle and a gravity wave across the contact, at its tolerances,
and the fine grid's geometry against roms_tpu's build_refined."""

import dataclasses

import numpy as np
import pytest
import torch

from roms_tpu import nesting as jnesting
from roms_tpu_torch import nesting
from roms_tpu_torch.ops import bc
from chip_smoke import nesting_fixture_script

torch.set_num_threads(1)

fx = nesting_fixture_script()
SPEC = nesting.RefineSpec(**fx.SPEC)


def _parent():
    return fx.nested_parent(fx.port())


def _t0(cfg):
    return torch.stack([torch.full((cfg.N, cfg.ny_tot, cfg.nx_tot), 17.0,
                                   dtype=torch.float64),
                        torch.full((cfg.N, cfg.ny_tot, cfg.nx_tot), 35.0,
                                   dtype=torch.float64)])


def test_build_refined_geometry():
    cfg_c, grid_c = _parent()
    cfg_f, grid_f = nesting.build_refined(cfg_c, grid_c, SPEC)
    assert cfg_f.Lm == 24 and cfg_f.Mm == 24
    assert cfg_f.dt == pytest.approx(cfg_c.dt / 3)
    assert {cfg_f.lbc_zeta.west, cfg_f.lbc_t.north} == {"Cla"}
    # fine spacing = parent/3; flat parent depth is preserved exactly
    torch.testing.assert_close(grid_f.pm, torch.full_like(
        grid_f.pm, 3.0 * float(grid_c.pm[3, 3])), rtol=1e-12, atol=0)
    torch.testing.assert_close(grid_f.h, torch.full_like(grid_f.h, 100.0),
                               rtol=1e-12, atol=0)
    # the same grid as roms_tpu's, field for field (on a sloped parent,
    # so the bilinear h is not trivial)
    P = fx.reference()
    jcfg_c, jgrid_c = fx.nested_parent(P)
    slope = lambda x, y, i, j, c: 50.0 + 2.0e-3 * x + 1.0e-3 * y
    jgrid_c, jcfg_c = P.build_grid(jcfg_c, Xsize=24.0e3, Esize=20.0e3,
                                   f0=1e-4, beta=2e-11, depth_fn=slope)
    grid_c, cfg_c = fx.port().build_grid(cfg_c, Xsize=24.0e3, Esize=20.0e3,
                                         f0=1e-4, beta=2e-11,
                                         depth_fn=slope)
    jcfg_f, jgrid_f = jnesting.build_refined(
        jcfg_c, jgrid_c, jnesting.RefineSpec(**fx.SPEC))
    cfg_f, grid_f = nesting.build_refined(cfg_c, grid_c, SPEC)
    assert (cfg_f.Lm, cfg_f.Mm, cfg_f.hmin, cfg_f.nfast) == \
        (jcfg_f.Lm, jcfg_f.Mm, jcfg_f.hmin, jcfg_f.nfast)
    for f in dataclasses.fields(grid_f):
        a = getattr(grid_f, f.name)
        if a is None:
            continue
        np.testing.assert_allclose(a.numpy(), np.asarray(getattr(jgrid_f,
                                                                 f.name)),
                                   rtol=1e-14, atol=1e-14, err_msg=f.name)


def test_extract_bry_linear_field_exact():
    # bilinear sampling reproduces a linear-in-x zeta exactly on every
    # boundary ring
    P = fx.port()
    cfg_c, grid_c = _parent()
    cfg_f, grid_f = nesting.build_refined(cfg_c, grid_c, SPEC)
    sc = P.initial_state(cfg_c, zeta=1.0e-3 * grid_c.xr)
    bry = nesting.extract_bry(cfg_c, grid_c, sc, SPEC, cfg_f)
    Hf = cfg_f.halo
    got = bry["zeta_west"].numpy()
    want = (1.0e-3 * grid_f.xr[:, Hf - 1]).numpy()
    np.testing.assert_allclose(got[2:-2], want[2:-2], rtol=1e-10)
    got_n = bry["zeta_north"].numpy()
    want_n = (1.0e-3 * grid_f.xr[Hf + cfg_f.Mm, :]).numpy()
    np.testing.assert_allclose(got_n[2:-2], want_n[2:-2], rtol=1e-10)


def test_nested_rest_and_constancy():
    # rest state + constant tracer survive the full nested cycle:
    # interpolation, 3 fine substeps, clamped contact BCs, two-way
    # feedback
    P = fx.port()
    cfg_c, grid_c = _parent()
    cfg_f, grid_f = nesting.build_refined(cfg_c, grid_c, SPEC)
    sc = P.initial_state(cfg_c, t=_t0(cfg_c))
    sf = nesting.init_refined(cfg_c, grid_c, sc, SPEC, cfg_f, grid_f)
    np.testing.assert_allclose(sf.t[0].numpy(), 17.0, rtol=1e-12)

    stepn = nesting.make_nested_stepper(cfg_c, grid_c, cfg_f, grid_f,
                                        SPEC)
    for _ in range(3):
        sc, sf = stepn(sc, sf)
    for s, cfg in ((sc, cfg_c), (sf, cfg_f)):
        H = cfg.halo
        itr = (slice(H, H + cfg.Mm), slice(H, H + cfg.Lm))
        np.testing.assert_allclose(s.t[0].numpy()[(slice(None),) + itr],
                                   17.0, atol=1e-9)
        np.testing.assert_allclose(s.u.numpy()[(slice(None),) + itr],
                                   0.0, atol=1e-12)
        np.testing.assert_allclose(s.zeta.numpy()[itr], 0.0, atol=1e-12)


def test_nested_gravity_wave_crosses_contact():
    # a zeta bump inside the refined region radiates out through the
    # clamped contact boundary; both grids stay finite and the coarse
    # two-way region tracks the fine average
    P = fx.port()
    cfg_c, grid_c = _parent()
    cfg_f, grid_f = nesting.build_refined(cfg_c, grid_c, SPEC)
    Hc = cfg_c.halo
    sc = fx.nested_state(P, cfg_c, grid_c)
    sf = nesting.init_refined(cfg_c, grid_c, sc, SPEC, cfg_f, grid_f)

    stepn = nesting.make_nested_stepper(cfg_c, grid_c, cfg_f, grid_f,
                                        SPEC)
    e0 = float(torch.sum(sc.zeta ** 2))
    for _ in range(8):
        sc, sf = stepn(sc, sf)
    assert torch.isfinite(sc.zeta).all() and torch.isfinite(sf.zeta).all()
    # wave amplitude decays as it radiates (no reflection blowup)
    assert float(torch.sum(sc.zeta ** 2)) < 2.0 * e0
    # two-way: covered coarse cells equal the fine block averages
    sc2 = nesting.fine2coarse(cfg_c, sc, cfg_f, sf, SPEC)
    r = SPEC.factor
    Hf = cfg_f.halo
    blk = sf.zeta[Hf + r:Hf + 2 * r, Hf + r:Hf + 2 * r].mean()
    np.testing.assert_allclose(
        float(sc2.zeta[Hc + SPEC.jstr, Hc + SPEC.istr]), float(blk),
        rtol=1e-12)
    assert bc.current_ctx() is None
