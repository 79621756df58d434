"""roms_tpu_torch's coastal stages against roms_tpu's functions (under
jax.jit) on the CPU in float64, to 1e-12 x max|field| over the whole
padded array: the tidal boundary sum, the harmonic constituents and the
equilibrium tide, Brunt-Vaisala mixing, the true vertical velocity, the
three climatology nudging branches (the fast loop's rhs, rhs3d, the
tracer corrector), the curvilinear grid builder and the sponge layers."""

import dataclasses
import math

import jax
import numpy as np
import pytest
import torch

from roms_tpu import grid as jgrid
from roms_tpu.models import cases4 as jcases4
from roms_tpu.ops import omega as jomega, rhs3d as jrhs, step2d as jstep2d, \
    step3d_t as jst3t, tides as jtides, vmix as jvmix
from roms_tpu_torch import grid as tgrid
from roms_tpu_torch.models import cases4
from roms_tpu_torch.ops import omega as tomega, rhs3d as trhs, \
    step2d as tstep2d, step3d_t as tst3t, tides, vmix as tvmix
from test_torch_stages import J, T, _close, case  # noqa: F401  (fixture)
from test_torch_stages2 import _rhs_args

torch.set_num_threads(1)


def _jit(fn, *static):
    return jax.jit(lambda *a: fn(*static, *a))


def test_tidal_boundary_matches():
    rng = np.random.default_rng(1)
    nb = 12
    amp, pha, uamp, upha = rng.random((4, nb))
    cons = [("M2", True), ("K1", False), ("S2", True)]

    def build(mod, pack):
        return [mod.TidalConstituent(
            name, pack(amp), pack(pha),
            pack(uamp) if cur else None, pack(upha) if cur else None)
            for name, cur in cons]

    for side in ("west", "north"):
        t = 3.7e4
        got = tides.tidal_boundary(build(tides, T), t, side)
        ref = jax.jit(lambda tt: jtides.tidal_boundary(
            build(jtides, J), tt, side))(t)
        assert set(got) == set(ref)
        for k in ref:
            _close(got[k], ref[k], k)
    # after one M2 period the M2 part repeats
    TM2 = tides.PERIODS_H["M2"] * 3600.0
    one = tides.tidal_boundary(build(tides, T)[:1], TM2)["zeta_west"]
    np.testing.assert_allclose(one.numpy(), amp * np.cos(-pha), rtol=1e-9)


@pytest.mark.parametrize("lnodal", [True, False])
def test_harmonic_constituents_match(lnodal):
    """Host float64 arithmetic on the date number, as roms_tpu's: the
    nodal factors and phases agree to 1e-12."""
    for datenum in (2451545.0, 2459000.25, 2440000.5):
        got = tides.harmonic_constituents(datenum, lnodal)
        ref = jtides.harmonic_constituents(datenum, lnodal)
        assert list(got) == list(ref)
        for k in ref:
            for a, b in zip(got[k], ref[k]):
                assert abs(a - b) <= 1e-12 * max(abs(b), 1.0), (k, a, b)


def test_equilibrium_tide_matches():
    class G:
        pass
    lon = np.linspace(0.0, 360.0, 73)[None, :] * np.ones((37, 1))
    lat = np.linspace(-90.0, 90.0, 37)[:, None] * np.ones((1, 73))
    gt, gj = G(), G()
    gt.xr, gt.yr = T(lon), T(lat)
    gj.xr, gj.yr = J(lon), J(lat)
    hcon = tides.harmonic_constituents(2451545.0)
    for t in (0.0, 1.3e5):
        got = tides.equilibrium_tide(gt, t, hcon)
        ref = jax.jit(lambda tt: jtides.equilibrium_tide(gj, tt, hcon))(t)
        _close(got, ref, f"eq_tide t={t}")
    # semidiurnal and diurnal species vanish at the poles
    assert float(got[0].abs().max()) < 1e-12


def test_bvf_mix_matches(case):
    cfg_j, _, cfg_t, _, f = case
    rng = np.random.default_rng(2)
    bvf = 1e-4 * rng.standard_normal(f["Akv"].shape)
    bvf[1, :3] = 0.0
    cfg_j = dataclasses.replace(cfg_j, akt_bak=(1.0e-6, 2.0e-6))
    cfg_t = dataclasses.replace(cfg_t, akt_bak=(1.0e-6, 2.0e-6))
    ref = _jit(jvmix.bvf_mix, cfg_j)(J(bvf))
    got = tvmix.bvf_mix(cfg_t, T(bvf))
    _close(got[0], ref[0], "Akv")
    _close(got[1], ref[1], "Akt")


def test_wvelocity_matches(case):
    cfg_j, grid_j, cfg_t, grid_t, f = case
    rng = np.random.default_rng(4)
    DU, DV = 10.0 * rng.standard_normal((2,) + f["zeta"].shape)
    args = [f[k] for k in ("u", "v", "W", "z_r", "z_w")] + [DU, DV]
    ref = _jit(jomega.wvelocity, cfg_j, grid_j)(*map(J, args))
    got = tomega.wvelocity(cfg_t, grid_t, *map(T, args))
    _close(got, ref, "wvel")


@pytest.mark.parametrize("field", [False, True])
def test_fast_loop_rhs_nudging_matches(case, field):
    """The 2-D momentum nudging in the fast loop's rhs (m2nudg a scalar
    or a rho-point field), with the wet corner mask."""
    cfg_j, grid_j, cfg_t, grid_t, f = case
    rng = np.random.default_rng(6)
    s2 = f["zeta"].shape
    ubar, vbar = 0.1 * rng.standard_normal((2,) + s2)
    nud = 1e-4 * rng.random(s2) if field else 2.0e-5
    clm = {"ubarclm": 0.1 * rng.standard_normal(s2),
           "vbarclm": 0.1 * rng.standard_normal(s2), "m2nudg": nud}
    pw = (rng.random(s2) > 0.3).astype(np.float64)
    zeta = f["zeta"]

    def ref_fn(zeta, ubar, vbar, arrays, pw):
        # a scalar coefficient stays a Python float, as the caller's is
        Drhs, DUon, DVom = jstep2d.depth_fluxes(grid_j, zeta, ubar, vbar)
        return jstep2d._rhs_momentum(cfg_j, grid_j, zeta, ubar, vbar, Drhs,
                                     DUon, DVom, zeta, zeta * zeta, None,
                                     pmask_wet=pw, clm={**clm, **arrays})

    pack = lambda c, p: {k: p(v) for k, v in c.items()  # noqa: E731
                         if np.ndim(v)}
    ref = jax.jit(ref_fn)(J(zeta), J(ubar), J(vbar), pack(clm, J), J(pw))
    Drhs, DUon, DVom = tstep2d.depth_fluxes(grid_t, T(zeta), T(ubar),
                                            T(vbar))
    got = tstep2d._rhs_momentum(cfg_t, grid_t, T(ubar), T(vbar), Drhs,
                                DUon, DVom, T(zeta), T(zeta) * T(zeta),
                                pmask_wet=T(pw), clm={**clm,
                                                      **pack(clm, T)})
    _close(got[0], ref[0], "rhs_ubar")
    _close(got[1], ref[1], "rhs_vbar")


def test_rhs3d_nudging_matches(case):
    cfg_j, grid_j, cfg_t, grid_t, f = case
    rng = np.random.default_rng(7)
    s3 = f["u"].shape
    clm = {"uclm": 0.1 * rng.standard_normal(s3),
           "vclm": 0.1 * rng.standard_normal(s3), "m3nudg": 3.0e-5}

    def ref_fn(args, uclm, vclm):
        return jrhs.rhs3d_momentum(
            cfg_j, grid_j, *args,
            clm={"uclm": uclm, "vclm": vclm, "m3nudg": clm["m3nudg"]})

    ref = jax.jit(ref_fn)(_rhs_args(f, J), J(clm["uclm"]), J(clm["vclm"]))
    got = trhs.rhs3d_momentum(
        cfg_t, grid_t, *_rhs_args(f, T),
        clm={"uclm": T(clm["uclm"]), "vclm": T(clm["vclm"]),
             "m3nudg": clm["m3nudg"]})
    for a, b, name in zip(got, ref, ("ru", "rv", "rufrc", "rvfrc")):
        _close(a, b, name)


@pytest.mark.parametrize("per_tracer", [False, True])
def test_tracer_nudging_matches(case, per_tracer):
    """The tracer corrector's nudging and lateral BCs (_finalize_tracer),
    one coefficient for all tracers or one a tracer."""
    cfg_j, grid_j, cfg_t, grid_t, f = case
    tclm = f["t_prev"]
    tnudg = (1.0e-5, 4.0e-5) if per_tracer else 2.0e-5
    for itrc in range(2):
        tn = f["t"][itrc]
        ref = jax.jit(lambda tn, tclm: jst3t._finalize_tracer(
            cfg_j, grid_j, itrc, tn, None, None,
            {"tclm": tclm, "tnudg": tnudg}, cfg_j.dt))(J(tn), J(tclm))
        got = tst3t._finalize_tracer(cfg_t, grid_t, itrc, T(tn), None, None,
                                     {"tclm": T(tclm), "tnudg": tnudg},
                                     cfg_t.dt)
        _close(got, ref, f"t{itrc}")


def test_curvilinear_grid_and_sponge_match():
    """LAB_CANYON's polar grid from build_curvilinear_grid (the angle
    included) and a sponge on it, bitwise roms_tpu's."""
    kw = dict(Lm=12, Mm=16, N=4, ndtfast=10)
    cfg_j, grid_j, _, _ = jcases4.lab_canyon(**kw)
    cfg_t, grid_t, _, _ = cases4.lab_canyon(
        cases4.lab_canyon_config(**kw), device="cpu")
    assert (cfg_t.hmin, cfg_t.nfast) == (cfg_j.hmin, cfg_j.nfast)
    fields = [f.name for f in dataclasses.fields(tgrid.Grid)
              if f.name != "zice"]
    for k in fields:
        np.testing.assert_array_equal(getattr(grid_t, k).numpy(),
                                      np.asarray(getattr(grid_j, k)), k)
    assert float(grid_t.dndx.abs().max()) > 0.0
    # a sponge needs open (non-periodic) sides: east and west here
    sp_j = jgrid.add_sponge(grid_j, cfg_j, 3, 5.0)
    sp_t = tgrid.add_sponge(grid_t, cfg_t, 3, 5.0)
    for k in ("visc_factor", "diff_factor"):
        np.testing.assert_array_equal(getattr(sp_t, k).numpy(),
                                      np.asarray(getattr(sp_j, k)), k)
    assert float(sp_t.visc_factor.max()) == 5.0
    assert math.isclose(float(sp_t.visc_factor[8, 3 + 1]), 5.0 - 4.0 / 3.0)
