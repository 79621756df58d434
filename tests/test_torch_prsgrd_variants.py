"""roms_tpu_torch: the five pressure-gradient schemes (ops/prsgrd.py).

(a) each scheme through the dispatch against roms_tpu's prsgrd, on the
    small grids of test_torch_stages.py (UPWELLING, E-W periodic, and its
    closed variant) with a random density, and on a small SEAMOUNT with
    its stratification, in float64 to 1e-12 x max|field| over the whole
    padded array (roms_tpu under jax.jit, and eagerly at SEAMOUNT's
    ill-conditioned rest state);
(b) the dispatch's two errors: an unknown scheme, and the tide-generating
    force with any scheme but djs;
(c) the port's analogs of tests/test_prsgrd.py: a homogeneous ocean
    exerts no force over the shelf, a horizontally uniform stratification
    over a flat bottom none either, and over the shelf every scheme's
    error stays within ten times the default scheme's.
"""

import dataclasses

import jax
import jax.numpy as jnp
import pytest
import torch

from roms_tpu.models import cases as jcases
from roms_tpu.ops import prsgrd as jprs
from roms_tpu_torch import vgrid
from roms_tpu_torch.grid import hc_of
from roms_tpu_torch.models import cases as tcases, upwelling
from roms_tpu_torch.ops import eos, prsgrd as tprs, prsgrd_cuda
from test_torch_stages import T, _close, case  # noqa: F401  (fixture)

torch.set_num_threads(1)

J = jnp.asarray
SCHEMES = ["djs", "dj", "pj", "pjq2", "pjq4"]


def _jax_prsgrd(cfg_j, grid_j, args):
    return jax.jit(lambda *a: jprs.prsgrd(cfg_j, grid_j, *a))(
        *[J(a) for a in args])


@pytest.mark.parametrize("scheme", SCHEMES)
def test_scheme_matches(case, scheme):
    cfg_j, grid_j, cfg_t, grid_t, f = case
    cfg_j = dataclasses.replace(cfg_j, prsgrd_scheme=scheme)
    cfg_t = cfg_t.replace(prsgrd_scheme=scheme)
    rho = 1027.0 - 0.2 * (f["t"][0] - 14.0) - 1000.0
    args = (rho, f["z_r"], f["z_w"], f["Hz"])
    ref = _jax_prsgrd(cfg_j, grid_j, args)
    got = tprs.prsgrd(cfg_t, grid_t, *[T(a) for a in args])
    _close(got[0], ref[0], f"ru {scheme}")
    _close(got[1], ref[1], f"rv {scheme}")
    assert prsgrd_cuda.supported(cfg_t) == (scheme == "djs")


@pytest.fixture(scope="module")
def seamount():
    """SEAMOUNT at 12x12x6 in both packages, at rest in its
    stratification: (cfg_j, grid_j, cfg_t, grid_t, rho, z_r, z_w, Hz)."""
    sizes = dict(Lm=12, Mm=12, N=6, ndtfast=10)
    cfg_j, grid_j, _, _ = jcases.seamount(**sizes)
    cfg_t, grid_t, s0, _ = tcases.seamount(tcases.seamount_config(**sizes),
                                           device="cpu")
    z_r, z_w, Hz = vgrid.set_depth(grid_t.h, s0.zeta, hc_of(cfg_t),
                                   grid_t.sc_r, grid_t.Cs_r, grid_t.sc_w,
                                   grid_t.Cs_w, cfg_t.vtransform)
    rho = eos.rho_eos(cfg_t, s0.t, z_r)
    return cfg_j, grid_j, cfg_t, grid_t, rho, z_r, z_w, Hz


@pytest.mark.parametrize("scheme", SCHEMES)
def test_seamount_matches(seamount, scheme):
    """The pressure-gradient error at SEAMOUNT's rest state, which the
    SEAMOUNT test measures, as roms_tpu computes it.  That state is
    ill-conditioned: the force is a small difference of pressures of
    ~5e4 m2/s2, and roms_tpu itself moves by up to 3.3e-12 x max|field|
    between its eager and its jitted form (XLA's fusion), and by up to
    5.0e-12 when rho moves by one ulp.  So roms_tpu runs eagerly here,
    each operation as the port rounds it."""
    cfg_j, grid_j, cfg_t, grid_t, *args = seamount
    ref = jprs.prsgrd(dataclasses.replace(cfg_j, prsgrd_scheme=scheme),
                      grid_j, *[J(a.numpy()) for a in args])
    got = tprs.prsgrd(cfg_t.replace(prsgrd_scheme=scheme), grid_t, *args)
    _close(got[0], ref[0], f"ru {scheme}")
    _close(got[1], ref[1], f"rv {scheme}")
    assert float(got[0].abs().max()) > 0.0


def test_dispatch_errors(seamount):
    _, _, cfg, grid, *args = seamount
    with pytest.raises(ValueError, match="unknown prsgrd scheme"):
        tprs.prsgrd(cfg.replace(prsgrd_scheme="djs2"), grid, *args)
    eq_tide = torch.zeros_like(grid.h)
    for scheme in SCHEMES[1:]:
        with pytest.raises(ValueError, match="TIDE_GENERATING_FORCES"):
            tprs.prsgrd(cfg.replace(prsgrd_scheme=scheme), grid, *args,
                        eq_tide=eq_tide)
    ru, _ = tprs.prsgrd(cfg, grid, *args, eq_tide=eq_tide)
    assert torch.equal(ru, tprs.prsgrd(cfg, grid, *args)[0])


@pytest.fixture(scope="module")
def shelf():
    """The port's UPWELLING at 16x24x8 at rest: (cfg, grid, s0, z_r, z_w,
    Hz), as tests/test_prsgrd.py sets it up."""
    cfg, grid, s0, _ = upwelling.build(
        upwelling.make_config(Lm=16, Mm=24, N=8, ndtfast=10), device="cpu")
    z_r, z_w, Hz = vgrid.set_depth(grid.h, s0.zeta, hc_of(cfg), grid.sc_r,
                                   grid.Cs_r, grid.sc_w, grid.Cs_w,
                                   cfg.vtransform)
    return cfg, grid, s0, z_r, z_w, Hz


def _inner(cfg, a):
    H = cfg.halo
    return a[..., H:H + cfg.Mm - 1, H:H + cfg.Lm - 1].abs().max().item()


@pytest.mark.parametrize("scheme", SCHEMES)
def test_homogeneous_ocean_zero_force(shelf, scheme):
    cfg, grid, _, z_r, z_w, Hz = shelf
    ru, rv = tprs.prsgrd(cfg.replace(prsgrd_scheme=scheme), grid,
                         torch.zeros_like(z_r), z_r, z_w, Hz)
    assert _inner(cfg, ru) < 1e-9
    assert _inner(cfg, rv) < 1e-9


@pytest.mark.parametrize("scheme", SCHEMES)
def test_flat_bottom_stratification_exact(shelf, scheme):
    cfg, grid, s0, *_ = shelf
    cfg = cfg.replace(prsgrd_scheme=scheme)
    gridf = dataclasses.replace(grid, h=torch.full_like(grid.h, 150.0))
    z_r, z_w, Hz = vgrid.set_depth(gridf.h, s0.zeta, hc_of(cfg), grid.sc_r,
                                   grid.Cs_r, grid.sc_w, grid.Cs_w,
                                   cfg.vtransform)
    t = torch.stack([14.0 + 8.0 * torch.exp(z_r / 50.0),
                     torch.full_like(z_r, 35.0)])
    rho, _ = eos.rho_eos_pden(cfg, t, z_r)
    ru, rv = tprs.prsgrd(cfg, gridf, rho, z_r, z_w, Hz)
    assert _inner(cfg, ru) < 1e-7
    assert _inner(cfg, rv) < 1e-7


@pytest.mark.parametrize("scheme", SCHEMES[1:])
def test_slope_error_bounded(shelf, scheme):
    cfg, grid, s0, z_r, z_w, Hz = shelf
    rho, _ = eos.rho_eos_pden(cfg, s0.t, z_r)
    _, rv0 = tprs.prsgrd(cfg, grid, rho, z_r, z_w, Hz)
    _, rv = tprs.prsgrd(cfg.replace(prsgrd_scheme=scheme), grid, rho, z_r,
                        z_w, Hz)
    assert _inner(cfg, rv) < 10.0 * _inner(cfg, rv0)
    assert bool(torch.isfinite(rv).all())
