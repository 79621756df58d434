"""roms_tpu_torch stage parity, part 2: prsgrd32, rhs3d_momentum, the
harmonic mixing, the 2-D momentum pieces, the boundary conditions and the
two correctors against roms_tpu's functions (same inputs and tolerance as
test_torch_stages.py)."""

import dataclasses

import jax.numpy as jnp
import pytest
import torch

from roms_tpu.ops import bc as jbc, mix3d as jmix, prsgrd as jprs, \
    rhs3d as jrhs, step2d as jstep2d, step3d_t as jst3t, \
    step3d_uv as jst3uv
from roms_tpu_torch.ops import bc as tbc, mix3d as tmix, prsgrd as tprs, \
    prsgrd_cuda, rhs3d as trhs, step2d as tstep2d, step3d_cuda
from test_torch_stages import T, _close, case  # noqa: F401  (fixture)

torch.set_num_threads(1)

J = jnp.asarray


def _rho(f):
    return 1027.0 - 0.2 * (f["t"][0] - 14.0) - 1000.0


def test_prsgrd32_matches(case):
    cfg_j, grid_j, cfg_t, grid_t, f = case
    args = (_rho(f), f["z_r"], f["z_w"], f["Hz"])
    ref = jprs.prsgrd(cfg_j, grid_j, *[J(a) for a in args])
    got = prsgrd_cuda.prsgrd32_plain(cfg_t, grid_t, *[T(a) for a in args])
    _close(got[0], ref[0], "ru")
    _close(got[1], ref[1], "rv")
    # the other schemes go through the same dispatch (prsgrd40 here; all
    # four in test_torch_prsgrd_variants.py), an unknown one raises
    ref = jprs.prsgrd(dataclasses.replace(cfg_j, prsgrd_scheme="pj"), grid_j,
                      *[J(a) for a in args])
    got = tprs.prsgrd(dataclasses.replace(cfg_t, prsgrd_scheme="pj"), grid_t,
                      *[T(a) for a in args])
    _close(got[0], ref[0], "ru pj")
    _close(got[1], ref[1], "rv pj")
    with pytest.raises(ValueError, match="unknown prsgrd scheme"):
        tprs.prsgrd(dataclasses.replace(cfg_t, prsgrd_scheme="xx"), grid_t,
                    *[T(a) for a in args])


def _rhs_args(f, pack):
    ru, rv = f["hist"][0], f["hist"][1]
    return [pack(f[k]) for k in ("u", "v", "Huon", "Hvom", "W", "Hz")] + \
        [pack(ru), pack(rv)] + [pack(a) for a in f["stress"]]


@pytest.mark.parametrize("want_diags", [False, True])
def test_rhs3d_momentum_matches(case, want_diags):
    cfg_j, grid_j, cfg_t, grid_t, f = case
    ref = jrhs.rhs3d_momentum(cfg_j, grid_j, *_rhs_args(f, J),
                              want_diags=want_diags)
    got = trhs.rhs3d_momentum(cfg_t, grid_t, *_rhs_args(f, T),
                              want_diags=want_diags)
    for a, b, name in zip(got[:4], ref[:4], ("ru", "rv", "rufrc", "rvfrc")):
        _close(a, b, name)
    if want_diags:
        assert set(got[4]) == set(ref[4])
        for key, (tu, tv) in ref[4].items():
            _close(got[4][key][0], tu, key + "_u")
            _close(got[4][key][1], tv, key + "_v")
    # one direction, in pieces, equals the full call
    ru, rufrc = trhs.rhs3d_momentum(cfg_t, grid_t, *_rhs_args(f, T),
                                    parts="u")
    _close(ru, ref[0], "ru parts=u")
    _close(rufrc, ref[2], "rufrc parts=u")


def test_rhs3d_diags_guard(case):
    """The reference reaches a NameError here; the port raises ValueError."""
    _, _, cfg_t, grid_t, f = case
    with pytest.raises(ValueError, match="want_diags"):
        trhs.rhs3d_momentum(cfg_t, grid_t, *_rhs_args(f, T),
                            want_diags=True, pieces=("cor", "frc"))
    with pytest.raises(ValueError, match="want_diags"):
        trhs.rhs3d_momentum(cfg_t, grid_t, *_rhs_args(f, T),
                            want_diags=True, parts="u")


def test_uv3dmix2_and_t3dmix2_match(case):
    cfg_j, grid_j, cfg_t, grid_t, f = case
    h0, h1, h2, h3 = f["hist"]
    args = [f["u"], f["v"], f["Hz"], h0, h1, h2[0], h3[0]]
    ref = jmix.uv3dmix2(cfg_j, grid_j, *[J(a) for a in args], 300.0)
    got = tmix.uv3dmix2(cfg_t, grid_t, *[T(a) for a in args], 300.0)
    for a, b, name in zip(got, ref, ("u_nnew", "v_nnew", "rufrc", "rvfrc")):
        _close(a, b, name)
    cfg_j = dataclasses.replace(cfg_j, tnu2=(5.0, 2.0))
    cfg_t = dataclasses.replace(cfg_t, tnu2=(5.0, 2.0))
    t_nnew = f["t_prev"] * f["Hz"]
    _close(tmix.t3dmix2(cfg_t, grid_t, T(f["t"]), T(f["Hz"]), T(t_nnew),
                        300.0),
           jmix.t3dmix2(cfg_j, grid_j, J(f["t"]), J(f["Hz"]), J(t_nnew),
                        300.0), "t_nnew")


def test_2d_momentum_pieces_match(case):
    cfg_j, grid_j, cfg_t, grid_t, f = case
    zeta, ubar, vbar = f["zeta"], f["u"][0], f["v"][0]
    Drhs, DUon, DVom = jstep2d.depth_fluxes(grid_j, J(zeta), J(ubar),
                                            J(vbar))
    got = tstep2d.depth_fluxes(grid_t, T(zeta), T(ubar), T(vbar))
    for a, b in zip(got, (Drhs, DUon, DVom)):
        _close(a, b)
    zw = 0.9 * zeta
    ref = jstep2d._rhs_momentum(cfg_j, grid_j, J(zeta), J(ubar), J(vbar),
                                Drhs, DUon, DVom, J(zw), J(zw * zw), None)
    out = tstep2d._rhs_momentum(cfg_t, grid_t, T(ubar), T(vbar), *got,
                                T(zw), T(zw * zw))
    _close(out[0], ref[0], "rhs_ubar")
    _close(out[1], ref[1], "rhs_vbar")
    ref = jstep2d._step_momentum(cfg_j, grid_j, J(ubar), J(vbar), Drhs,
                                 Drhs + 0.01, 5.0 * ref[0], 5.0 * ref[1])
    out = tstep2d._step_momentum(cfg_t, grid_t, T(ubar), T(vbar), got[0],
                                 got[0] + 0.01, 5.0 * out[0], 5.0 * out[1])
    _close(out[0], ref[0], "ubar")
    _close(out[1], ref[1], "vbar")


def test_boundary_conditions_match(case):
    cfg_j, grid_j, cfg_t, grid_t, f = case
    a = f["u"]
    for lbc_name in ("lbc_zeta", "lbc_t"):
        lj, lt = getattr(cfg_j, lbc_name), getattr(cfg_t, lbc_name)
        _close(tbc.apply_bc_rho(cfg_t, lt, T(a), mask=grid_t.rmask),
               jbc.apply_bc_rho(cfg_j, lj, J(a), mask=grid_j.rmask))
    _close(tbc.apply_bc_u(cfg_t, cfg_t.lbc_u, T(a), cfg_t.gamma2,
                          mask=grid_t.umask),
           jbc.apply_bc_u(cfg_j, cfg_j.lbc_u, J(a), cfg_j.gamma2,
                          mask=grid_j.umask), "u")
    _close(tbc.apply_bc_v(cfg_t, cfg_t.lbc_v, T(a), cfg_t.gamma2,
                          mask=grid_t.vmask),
           jbc.apply_bc_v(cfg_j, cfg_j.lbc_v, J(a), cfg_j.gamma2,
                          mask=grid_j.vmask), "v")
    _close(tbc.fill_halo(cfg_t, T(a)), jbc.fill_halo(cfg_j, J(a)), "fill")
    for name in ("extrap_west", "extrap_east", "extrap_south",
                 "extrap_north"):
        _close(getattr(tbc, name)(cfg_t, T(a), 4),
               getattr(jbc, name)(cfg_j, J(a), 4), name)


@pytest.mark.parametrize("iic", [0, 1, 5])
def test_step3d_uv_matches(case, iic):
    cfg_j, grid_j, cfg_t, grid_t, f = case
    h0, h1, h2, h3 = f["hist"]
    Hz = f["Hz"]
    D2 = [h2[0] * 10.0, h2[1] * 10.0, h3[0] * 10.0, h3[1] * 10.0]
    args = [f["u"] * Hz, f["v"] * Hz, h0, h1, Hz, f["Akv"]] + D2 + \
        [f["Huon"], f["Hvom"]]
    ref = jst3uv.step3d_uv(cfg_j, grid_j, iic, *[J(a) for a in args])
    got = step3d_cuda.uv_corrector_plain(cfg_t, grid_t, iic,
                                         *[T(a) for a in args])
    for a, b, name in zip(got, ref, ("u", "v", "ubar", "vbar", "Huon",
                                     "Hvom")):
        _close(a, b, name)


@pytest.mark.parametrize("splines", [True, False])
def test_step3d_t_matches(case, splines):
    cfg_j, grid_j, cfg_t, grid_t, f = case
    cfg_j = dataclasses.replace(cfg_j, splines_vdiff=splines)
    cfg_t = dataclasses.replace(cfg_t, splines_vdiff=splines)
    t_nnew = f["t"] * f["Hz"]
    args = [t_nnew, f["t_prev"], f["Huon"], f["Hvom"], f["W"], f["Hz"],
            f["z_r"], f["Akt"]]
    ref = jst3t.step3d_t(cfg_j, grid_j, 3, *[J(a) for a in args])
    _close(step3d_cuda.tracer_corrector_plain(cfg_t, grid_t,
                                              *[T(a) for a in args]),
           ref, "t")
