"""roms_tpu_torch's wave-current bottom boundary layers (SSW, MB, SG) against
roms_tpu's, in float64 on the CPU, and analogs of tests/test_bbl.py.

(a) wave_number_kh, madsen94, ripple_geometry, the Kelvin functions of
    both branches, and the closures bblm (SSW), bblm_mb and bblm_sg on a
    7 x 9 patch of random inputs that spans their branches: depths from
    0.5 to 40 m (and a dry cell), waves from none to 3 m, periods of 3 to
    14 s, currents from rest to 1.2 m/s in every direction, a masked face,
    ripples and a previous stress on both sides of the motion threshold;
    each closure with its moveable bed on and off (MB also with a muddy
    bed and biogenic roughness), with the stress cap of a 60 s step and
    without it (cfg None);
(b) tests/test_bbl.py's checks on the port: the dispersion residual, the
    Madsen limits, the ripple regimes, the wave-enhanced stress on SED_TOY,
    the MB regimes and sheet flow, the Kelvin check values and the SG wave
    enhancement.

Tolerance: 1e-12 x max|field| (RTOL).  Each closure is a fixed count of
iterations of transcendental functions, which torch's CPU rounds
differently from XLA's (the SG closure's complex exp, sqrt and division
too); measured on these inputs at most 3.5e-14 x max|field| (SG's current
stress; the Kelvin functions' ker and kei 2.6e-14, SSW and MB below
1e-14).
"""

from types import SimpleNamespace

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from roms_tpu.ops import bbl as jbbl
from roms_tpu_torch import constants as C, vgrid
from roms_tpu_torch.grid import hc_of
from roms_tpu_torch.models import sed_toy
from roms_tpu_torch.ops import bbl as tbbl
from test_torch_obc import J, T, _close

torch.set_num_threads(1)
jax.config.update("jax_enable_x64", True)

NY, NX, N = 7, 9, 5


@pytest.fixture(scope="module")
def inputs():
    """The random patch, as numpy."""
    rng = np.random.default_rng(53)
    s2, s3 = (NY, NX), (N, NY, NX)
    h = 0.5 * (80.0 ** rng.random(s2))
    h[3, 4] = -0.2                               # a dry cell
    z_w = np.linspace(-1.0, 0.0, N + 1)[:, None, None] * \
        np.maximum(h, 0.05)[None]
    z_r = 0.5 * (z_w[1:] + z_w[:-1])
    speed = 1.2 * rng.random(s3) ** 2
    ang = 2.0 * np.pi * rng.random(s3)
    u, v = speed * np.cos(ang), speed * np.sin(ang)
    u[:, 2, 2] = v[:, 2, 2] = u[:, 2, 1] = v[:, 2, 3] = 0.0   # at rest
    umask = np.ones(s2)
    umask[5, 6] = 0.0
    Hwave = 3.0 * rng.random(s2) ** 2
    Hwave[0, :3] = 0.0                           # no waves
    return dict(
        h=h, umask=umask, vmask=np.ones(s2), angler=0.3 * rng.random(s2),
        z_w=z_w, z_r=z_r, u=u, v=v, rho=25.0 + rng.random(s2),
        Hwave=Hwave, Pwave=3.0 + 11.0 * rng.random(s2),
        Dwave=2.0 * np.pi * rng.random(s2),
        rheight=0.02 * rng.random(s2), rlength=0.05 + 0.3 * rng.random(s2),
        tau_prev=(0.05 / 1025.0) * 3.0 ** rng.standard_normal(s2))


def _grid(f, wrap):
    return SimpleNamespace(h=wrap(f["h"]), umask=wrap(f["umask"]),
                           vmask=wrap(f["vmask"]), angler=wrap(f["angler"]))


CFG = SimpleNamespace(dt=60.0)
_FLOW = ("u", "v", "z_r", "z_w")
_WAVES = ("Hwave", "Pwave", "Dwave")
_OUT = ("bustr", "bvstr", "tau_c", "tau_w", "tau_cwmax", "rheight",
        "rlength")


def test_wave_number_kh(inputs):
    h = np.maximum(inputs["h"], 0.01)
    w = 2.0 * np.pi / inputs["Pwave"]
    ref = jax.jit(jbbl.wave_number_kh)(J(h), J(w))
    got = tbbl.wave_number_kh(T(h), T(w))
    _close(got, ref, "kh")
    # the Pade fit against the exact kh tanh(kh) = w^2 h / g
    for hh, per in [(5.0, 6.0), (10.0, 8.0), (50.0, 10.0), (200.0, 12.0)]:
        ww = 2.0 * np.pi / per
        kh = float(tbbl.wave_number_kh(torch.tensor(hh), torch.tensor(ww)))
        np.testing.assert_allclose(kh * np.tanh(kh), ww * ww * hh / C.g,
                                   rtol=2e-3)


def test_madsen94(inputs):
    rng = np.random.default_rng(7)
    s2 = (NY, NX)
    args = (0.6 * rng.random(s2) + 1e-4, 0.3 + 2.0 * rng.random(s2),
            0.8 * rng.random(s2), 0.05 + 2.0 * rng.random(s2),
            2.0 * np.pi * rng.random(s2), 0.001 + 0.02 * rng.random(s2))
    ref = jax.jit(jbbl.madsen94)(*map(J, args))
    got = tbbl.madsen94(*map(T, args))
    for name, a, b in zip(("ustrc", "ustrwm", "ustrr", "zoa"), got, ref):
        _close(a, b, name)
    # tests/test_bbl.py: the log law under weak waves, wave enhancement
    zr, kN, ucr = 1.0, 0.005, 0.4
    one = lambda x: torch.tensor(float(x), dtype=torch.float64)  # noqa
    ustrc, ustrwm, _, _ = tbbl.madsen94(one(1e-3), one(1.0), one(ucr),
                                        one(zr), one(0.0), one(kN))
    loglaw = 0.41 * ucr / np.log(zr / (kN / 30.0))
    np.testing.assert_allclose(float(ustrc), loglaw, rtol=0.05)
    ustrc2, ustrwm2, ustrr2, zoa2 = tbbl.madsen94(
        one(0.5), one(2 * np.pi / 8.0), one(ucr), one(zr), one(0.0),
        one(kN))
    assert float(ustrr2) > float(ustrc2) and float(ustrr2) > float(ustrwm2)
    assert float(ustrc2) > loglaw and float(zoa2) > kN / 30.0
    assert float(ustrwm2) > float(ustrwm)


def test_ripple_geometry(inputs):
    rng = np.random.default_rng(9)
    s2 = (NY, NX)
    Ab = 0.02 * 400.0 ** rng.random(s2)
    tstar = 3.0 * rng.random(s2)
    p_j, p_t = jbbl.BBLParams(), tbbl.BBLParams()
    args = (Ab, tstar, inputs["rheight"], inputs["rlength"])
    ref = jax.jit(lambda *a: jbbl.ripple_geometry(p_j, *a))(*map(J, args))
    got = tbbl.ripple_geometry(p_t, *map(T, args))
    for name, a, b in zip(("rheight", "rlength"), got, ref):
        _close(a, b, name)
    # tests/test_bbl.py: relict below the threshold, sane steepness above,
    # washed out in sheet flow
    t = lambda x: torch.tensor([[x]], dtype=torch.float64)  # noqa: E731
    rh0, rl0 = t(0.011), t(0.33)
    rh, rl = tbbl.ripple_geometry(p_t, t(0.15), t(0.5), rh0, rl0)
    assert float(rh) == 0.011 and float(rl) == 0.33
    rh, rl = tbbl.ripple_geometry(p_t, t(0.15), t(2.0), rh0, rl0)
    assert 0.01 < float(rh / rl) < 0.25
    rh, rl = tbbl.ripple_geometry(p_t, t(2.0), t(50.0), rh0, rl0)
    assert float(rh) == 0.0


def _closure_args(f, wrap, kind):
    a = [wrap(f[k]) for k in _FLOW]
    if kind in ("mb", "sg"):
        a.append(wrap(f["rho"]))
    a += [wrap(f[k]) for k in _WAVES]
    if kind == "ssw":
        a += [wrap(f["rheight"]), wrap(f["rlength"]), wrap(f["tau_prev"])]
    elif kind == "mb":
        a += [wrap(f["rheight"]), wrap(f["rlength"])]
    return a


def _reference(kind, fn, args):
    """roms_tpu's closure fn on args: under jax.jit, but SG eagerly around a
    jitted _sg_phi (its Kelvin-function block, which the closure calls 130
    times; a jit of the whole unrolled closure takes over a minute to
    compile)."""
    if kind != "sg":
        return jax.jit(fn)(*args)
    real = jbbl._sg_phi
    jbbl._sg_phi = jax.jit(real)
    try:
        return fn(*args)
    finally:
        jbbl._sg_phi = real


_CLOSURES = {"ssw": ("bblm", "BBLParams"), "mb": ("bblm_mb", "MBBBLParams"),
             "sg": ("bblm_sg", "SGBBLParams")}
VARIANTS = [("ssw", {}, True), ("ssw", dict(calc_znot=False), False),
            ("mb", {}, True), ("mb", dict(z0bl=False, z0rip=False,
                                          z0bio=True, d50=0.00005), True),
            ("mb", dict(calc_znot=False), None),
            ("sg", {}, True), ("sg", dict(calc_znot=False), None)]


@pytest.mark.parametrize("kind, params, capped", VARIANTS, ids=[
    "ssw", "ssw-fixed-bed", "mb", "mb-muddy-bio", "mb-fixed-bed", "sg",
    "sg-fixed-bed"])
def test_closure(inputs, kind, params, capped):
    """capped: the stress cap of a 60 s step (True) or cfg None (False);
    None also without the cap."""
    fn, pcls = _CLOSURES[kind]
    cfg = CFG if capped else None
    p_j = getattr(jbbl, pcls)(**params)
    p_t = getattr(tbbl, pcls)(**params)
    g_j = _grid(inputs, J)
    ref = _reference(kind, lambda *a: getattr(jbbl, fn)(cfg, g_j, p_j, *a),
                     _closure_args(inputs, J, kind))
    got = getattr(tbbl, fn)(cfg, _grid(inputs, T), p_t,
                            *_closure_args(inputs, T, kind))
    for name, a, b in zip(_OUT, got, ref):
        assert bool(torch.isfinite(a).all()), name
        _close(a, b, name)


def test_kelvin_functions():
    x = torch.tensor([0.3, 1.0, 2.5, 5.0, 7.9, 8.0], dtype=torch.float64)
    xp = torch.tensor([8.0, 9.0, 12.0, 20.0, 40.0], dtype=torch.float64)
    for name, xs in (("_kelvin8m", x), ("_kelvin8p", xp)):
        ref = jax.jit(getattr(jbbl, name))(J(xs.numpy()))
        for i, (a, b) in enumerate(zip(getattr(tbbl, name)(xs), ref)):
            _close(a, b, f"{name}[{i}]")
    # tests/test_bbl.py: Abramowitz & Stegun 9.11 at x = 1 and the splice
    ber, bei, ker, kei, *_ = tbbl._kelvin8m(torch.tensor(1.0,
                                                         dtype=torch.float64))
    for got, want in ((ber, 0.98438), (bei, 0.24957), (ker, 0.28671),
                      (kei, -0.49499)):
        np.testing.assert_allclose(float(got), want, atol=2e-5)
    eight = torch.tensor(8.0, dtype=torch.float64)
    m, p = tbbl._kelvin8m(eight), tbbl._kelvin8p(eight)
    for a, b in zip(m[2:4], p[2:4]):
        np.testing.assert_allclose(float(a), float(b), rtol=2e-3, atol=1e-6)


# ---- tests/test_bbl.py's closure checks on the port ----

def _stub(Ny=6, Nx=8, depth=10.0, Nz=5):
    ones = torch.ones((Ny, Nx), dtype=torch.float64)
    g = SimpleNamespace(h=depth * ones, umask=ones, vmask=ones,
                        angler=0.0 * ones)
    z_w = torch.linspace(-depth, 0.0, Nz + 1,
                         dtype=torch.float64)[:, None, None] * ones
    return g, 0.5 * (z_w[1:] + z_w[:-1]), z_w


def test_bblm_waves_enhance_stress_field():
    cfg, grid, s, _ = sed_toy.build(sed_toy.make_config(Lm=8, Mm=10, N=8),
                                    device="cpu")
    z_r, z_w, _ = vgrid.set_depth(grid.h, s.zeta, hc_of(cfg), grid.sc_r,
                                  grid.Cs_r, grid.sc_w, grid.Cs_w,
                                  cfg.vtransform)
    u = torch.full_like(s.u, 0.2)
    zero = torch.zeros_like(grid.h)
    p = tbbl.BBLParams()
    out_nw = tbbl.bblm(cfg, grid, p, u, s.v, z_r, z_w, zero, zero + 8.0,
                       zero, s.rheight, s.rlength, s.tau_cwmax)
    out_w = tbbl.bblm(cfg, grid, p, u, s.v, z_r, z_w, zero + 2.0,
                      zero + 8.0, zero, s.rheight, s.rlength, s.tau_cwmax)
    H = cfg.halo
    jj, ii = slice(H, H + cfg.Mm), slice(H, H + cfg.Lm)
    tau_nw, tau_w = out_nw[4][jj, ii].numpy(), out_w[4][jj, ii].numpy()
    assert np.isfinite(tau_w).all() and (tau_w > tau_nw).all()
    np.testing.assert_allclose(tau_nw, out_nw[2][jj, ii].numpy(), rtol=1e-8)


def test_mb_bbl_regimes_and_sheet_flow():
    p = tbbl.MBBBLParams()
    g, z_r, z_w = _stub()
    shp = g.h.shape
    full = lambda x, s=shp: torch.full(s, x, dtype=torch.float64)  # noqa
    u, v, rho = full(0.3, (5,) + shp), full(0.0, (5,) + shp), full(25.0)
    rh0, rl0 = full(0.01), full(0.10)
    bustr0, _, taucw0, tauw0, taumax0, _, _ = tbbl.bblm_mb(
        None, g, p, u, v, z_r, z_w, rho, full(0.0), full(8.0), full(0.0),
        rh0, rl0)
    assert float(tauw0.max()) == 0.0 and float(bustr0.min()) > 0.0
    _, _, taucw1, tauw1, taumax1, rh1, _ = tbbl.bblm_mb(
        None, g, p, u, v, z_r, z_w, rho, full(2.0), full(8.0), full(0.0),
        rh0, rl0)
    assert float(tauw1.min()) > 0.0
    assert float(taumax1.min()) > float(taumax0.max())
    assert float(taucw1.min()) > float(taucw0.max())
    assert not np.allclose(rh1.numpy(), rh0.numpy())
    # huge waves on a 5 m bed: above the washout threshold, a plane bed
    g, z_r, z_w = _stub(depth=5.0)
    out = tbbl.bblm_mb(None, g, p, full(1.0, (5,) + shp), v, z_r, z_w, rho,
                       full(4.0), full(10.0), full(0.0), rh0, rl0)
    np.testing.assert_allclose(out[5].numpy(), 0.0, atol=1e-12)


def test_sg_bbl_wave_enhancement():
    p = tbbl.SGBBLParams()
    g, z_r, z_w = _stub()
    shp = g.h.shape
    full = lambda x, s=shp: torch.full(s, x, dtype=torch.float64)  # noqa
    u, v, rho = full(0.3, (5,) + shp), full(0.0, (5,) + shp), full(25.0)
    out0 = tbbl.bblm_sg(None, g, p, u, v, z_r, z_w, rho, full(0.0),
                        full(8.0), full(0.0))
    out1 = tbbl.bblm_sg(None, g, p, u, v, z_r, z_w, rho, full(2.0),
                        full(8.0), full(0.0))
    assert all(bool(torch.isfinite(o).all()) for o in out1)
    assert float(out1[4].min()) > float(out0[2].max())
    assert float(out1[3].min()) > 0.0 and float(out1[5].max()) > 0.0
