"""roms_tpu_torch.nesting on the CPU: the analogs of tests/test_nesting.py's
contact-flux conservation, volume conservation and transparent composite
contact, at its tolerances, and the nested and composite steps against
tests/data/torch_nesting_small.npz (roms_tpu's, written by
scripts/torch_nesting_fixture.py) at the bounds it states."""

import numpy as np
import torch

from roms_tpu_torch import nesting
from chip_smoke import nesting_fixture_script

torch.set_num_threads(1)

fx = nesting_fixture_script()
SPEC = nesting.RefineSpec(**fx.SPEC)


def test_contact_flux_conservation():
    """conserve_bry_flux (check_massflux analog): after the correction,
    the summed fine-face transports through every parent contact face
    equal the parent transport to round-off."""
    P = fx.port()
    cfg_c, grid_c = fx.nested_parent(P)
    cfg_f, grid_f = nesting.build_refined(cfg_c, grid_c, SPEC)
    Hc = cfg_c.halo
    y = (grid_c.yr - float(grid_c.yr[Hc + 10, Hc + 12])).numpy()
    sc = fx.nested_state(P, cfg_c, grid_c, width=3.0e3)
    sc = sc.replace(ubar=P.fill_halo(cfg_c, P.asarray(
        0.02 * np.cos(y / 4.0e3))))

    bry = nesting.extract_bry(cfg_c, grid_c, sc, SPEC, cfg_f)
    bry = nesting.conserve_bry_flux(cfg_c, grid_c, sc, SPEC,
                                    cfg_f, grid_f, bry)
    r = SPEC.factor
    Hf = cfg_f.halo
    # west face check
    iu_c = Hc + SPEC.istr - 1
    D_c = (sc.zeta + grid_c.h).numpy()
    Du_c = 0.5 * (D_c[:, iu_c - 1] + D_c[:, iu_c])
    Tc = (sc.ubar.numpy()[:, iu_c] * Du_c *
          grid_c.on_u.numpy()[:, iu_c])[Hc + SPEC.jstr - 1:Hc + SPEC.jend]
    h_f = grid_f.h.numpy()
    hu_f = 0.5 * (h_f[:, Hf - 1] + h_f[:, Hf])
    Tf = (bry["ubar_west"].numpy() * (hu_f + bry["zeta_west"].numpy()) *
          grid_f.on_u.numpy()[:, Hf])[Hf:Hf + cfg_f.Mm]
    np.testing.assert_allclose(Tf.reshape(-1, r).sum(-1), Tc, rtol=1e-12)


def test_nested_volume_conservation():
    """Two-way refined run with the flux correction: total volume over
    the composite domain is conserved and a constant tracer stays
    constant (the check_massflux 'done' criterion)."""
    P = fx.port()
    cfg_c, grid_c = fx.nested_parent(P)
    cfg_f, grid_f = nesting.build_refined(cfg_c, grid_c, SPEC)
    Hc = cfg_c.halo
    sc = fx.nested_state(P, cfg_c, grid_c)
    zeta0 = sc.zeta.numpy()
    sf = nesting.init_refined(cfg_c, grid_c, sc, SPEC, cfg_f, grid_f)

    stepn = nesting.make_nested_stepper(cfg_c, grid_c, cfg_f, grid_f,
                                        SPEC, flux_coupling=True)
    itr = (slice(Hc, Hc + cfg_c.Mm), slice(Hc, Hc + cfg_c.Lm))
    area = (1.0 / (grid_c.pm * grid_c.pn)).numpy()[itr]
    bump = float((np.abs(zeta0)[itr] * area).sum())
    # step 1 absorbs the one-time reconciliation of the bilinear initial
    # interpolation with the coarse cell values
    sc, sf = stepn(sc, sf)
    vol0 = float((sc.zeta.numpy()[itr] * area).sum())
    for _ in range(6):
        sc, sf = stepn(sc, sf)
    vol1 = float((sc.zeta.numpy()[itr] * area).sum())
    assert abs(vol1 - vol0) < 1.0e-3 * bump
    Hf = cfg_f.halo
    itf = (slice(Hf, Hf + cfg_f.Mm), slice(Hf, Hf + cfg_f.Lm))
    np.testing.assert_allclose(
        sc.t[0].numpy()[(slice(None),) + itr], 17.0, atol=2e-4)
    np.testing.assert_allclose(
        sf.t[0].numpy()[(slice(None),) + itf], 17.0, atol=2e-4)


def test_composite_grids_transparent_contact():
    """Composite (DOGBONE-class) grids: a gravity pulse crosses the
    contact between two abutted same-resolution grids and matches the
    monolithic single-grid solution to <0.1% of the pulse amplitude."""
    P = fx.port()
    olap, LA, LB = 4, 32, 32
    LT = LA + LB - olap
    cfg_t, grid_t = fx.composite_member(P, LT, "Clo", "Clo", "mono")
    s_t = fx.pulse(P, cfg_t, grid_t, 12e3)
    out = fx.run_composite(P, steps=120, la=LA, lb=LB)
    step_t = P.stepping.make_stepper(cfg_t, grid_t, None)
    for _ in range(120):          # the pulse fully crosses the contact
        s_t = step_t(s_t)

    H = cfg_t.halo
    zt = s_t.zeta.numpy()[H:-H, H:-H]
    za = out["a"][1].zeta.numpy()[H:-H, H:-H]
    zb = out["b"][1].zeta.numpy()[H:-H, H:-H]
    zc = np.concatenate([za[:, :LA - olap], zb], axis=1)
    amp = np.abs(zt).max()
    assert amp > 0.03                       # the pulse survived
    assert np.abs(zc - zt).max() < 1.0e-3   # <0.1% of the 0.1 m pulse
    # most of the signal is now in grid B (it crossed the contact)
    assert np.abs(zb).max() > 0.8 * amp


def test_steps_match_fixture():
    """The nested pair (two_way, conserve, flux_coupling) and the
    composite pair at the bounds scripts/torch_nesting_fixture.py
    states."""
    ref = np.load(fx.OUT)
    for part in ("nested", "composite"):
        states = fx.port_part(part)
        errors = fx.errors(part, states, ref)
        bad = {k: e for k, e in errors.items() if not e[0] <= e[1]}
        assert not bad, (part, bad)
        for cfg, s in states.values():
            assert torch.isfinite(s.zeta).all() and \
                torch.isfinite(s.t).all()
