"""roms_tpu_torch: the diagnostic kernels' plain versions (grid_flux, eos,
omega; ops/diag_cuda.py) against roms_tpu's plain reference path
(stepping.py:147-154, 247, 512), over the whole padded array.  On CPU
tensors the wrappers take the plain versions and launch nothing."""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from roms_tpu import vgrid as jvgrid
from roms_tpu.config import LBC as JLBC
from roms_tpu.grid import hc_of
from roms_tpu.models import benchmark as jbench, upwelling as jup
from roms_tpu.ops import eos as jeos
from roms_tpu.ops.omega import omega as jomega, set_massflux as jmassflux
from roms_tpu_torch import convert
from roms_tpu_torch.ops import diag_cuda, eos as teos

torch.set_num_threads(1)

RTOL = 1e-12          # times max|field|


def _close(got, ref, name):
    got, ref = got.numpy(), np.asarray(ref)
    assert got.shape == ref.shape, name
    scale = max(np.abs(ref).max(), 1e-300)
    np.testing.assert_allclose(got, ref, rtol=0, atol=RTOL * scale,
                               err_msg=name)


def _case(kind):
    cfg = jup.make_config(Lm=14, Mm=12, N=6, ndtfast=6)
    if kind == "closed":
        cfg = dataclasses.replace(
            cfg, ew_periodic=False, lbc_zeta=JLBC(), lbc_ubar=JLBC(),
            lbc_vbar=JLBC(), lbc_u=JLBC(), lbc_v=JLBC(), lbc_t=JLBC())
    cfg_j, grid_j, _, _ = jup.build(cfg)
    cfg_t = convert.config_from_reference(cfg_j)
    grid_t = convert.grid_from_numpy(
        cfg_t, {f.name: getattr(grid_j, f.name)
                for f in dataclasses.fields(grid_j)})
    return cfg_j, grid_j, cfg_t, grid_t


def _fields(cfg, seed):
    rng = np.random.default_rng(seed)
    s2 = (cfg.ny_tot, cfg.nx_tot)
    s3 = (cfg.N,) + s2
    return (0.3 * rng.standard_normal(s2), 0.2 * rng.standard_normal(s3),
            0.2 * rng.standard_normal(s3))


@pytest.mark.parametrize("kind", ["upwelling", "closed"])
def test_grid_flux_and_omega_match(kind):
    cfg_j, grid_j, cfg_t, grid_t = _case(kind)
    zeta, u, v = _fields(cfg_j, 1)
    hc = hc_of(cfg_j)
    z_r, z_w, Hz = jvgrid.set_depth(grid_j.h, jnp.asarray(zeta), hc,
                                    grid_j.sc_r, grid_j.Cs_r, grid_j.sc_w,
                                    grid_j.Cs_w, cfg_j.vtransform)
    Huon, Hvom = jmassflux(cfg_j, grid_j, jnp.asarray(u), jnp.asarray(v), Hz)
    W = jomega(cfg_j, grid_j, Huon, Hvom, z_w)
    got = diag_cuda.grid_flux(cfg_t, grid_t, torch.as_tensor(zeta),
                              torch.as_tensor(u), torch.as_tensor(v), hc)
    for a, b, name in zip(got, (z_r, z_w, Hz, Huon, Hvom, W),
                          ("z_r", "z_w", "Hz", "Huon", "Hvom", "W")):
        _close(a, b, name)

    # omega of other fluxes (the W2 call)
    _, u2, v2 = _fields(cfg_j, 2)
    H2, V2 = jmassflux(cfg_j, grid_j, jnp.asarray(u2), jnp.asarray(v2), Hz)
    W2 = diag_cuda.omega(cfg_t, grid_t, torch.tensor(np.asarray(H2)),
                         torch.tensor(np.asarray(V2)), got[1])
    _close(W2, jomega(cfg_j, grid_j, H2, V2, z_w), "W2")
    assert diag_cuda.grid_flux.launches == 0
    assert diag_cuda.omega.launches == 0


def _tracers(cfg, rng, s3):
    temp = 2.0 + 18.0 * rng.random(s3)
    salt = 33.0 + 2.0 * rng.random(s3)
    return np.stack([temp, salt])


@pytest.mark.parametrize("eos_kind", ["linear", "jm95"])
@pytest.mark.parametrize("want_bvf", [False, True])
def test_eos_matches(eos_kind, want_bvf):
    if eos_kind == "jm95":
        cfg_j = jbench.make_config(Lm=24, Mm=16, N=8)
    else:
        cfg_j = dataclasses.replace(jup.make_config(Lm=24, Mm=16, N=8),
                                    Scoef=7.6e-4)
    cfg_t = convert.config_from_reference(cfg_j)
    rng = np.random.default_rng(3)
    s2 = (cfg_j.ny_tot, cfg_j.nx_tot)
    N = cfg_j.N
    h = 50.0 + 4000.0 * rng.random(s2)
    zeta = 0.5 * rng.standard_normal(s2)
    tables = jvgrid.scoord(cfg_j.vstretching, cfg_j.theta_s, cfg_j.theta_b,
                           N)
    z_r, z_w, _ = jvgrid.set_depth(jnp.asarray(h), jnp.asarray(zeta),
                                   cfg_j.tcline, *tables, cfg_j.vtransform)
    t = _tracers(cfg_j, rng, (N,) + s2)
    if want_bvf:
        ref = jeos.rho_eos_pden_bvf(cfg_j, jnp.asarray(t), z_r, z_w)
    else:
        ref = jeos.rho_eos_pden(cfg_j, jnp.asarray(t), z_r)
    got = diag_cuda.eos(cfg_t, torch.as_tensor(t),
                        torch.tensor(np.asarray(z_r)),
                        torch.tensor(np.asarray(z_w)), want_bvf)
    assert len(got) == len(ref)
    for a, b, name in zip(got, ref, ("rho", "pden", "bvf")):
        _close(a, b, name)
    assert diag_cuda.eos.launches == 0


def test_jm95_check_values():
    """rho_eos.F header check values: T=3C, S=35.5, Z=-5000 m."""
    T = torch.tensor([[3.0]], dtype=torch.float64)
    S = torch.tensor([[35.5]], dtype=torch.float64)
    Z = torch.tensor([[-5000.0]], dtype=torch.float64)
    den = teos.rho_jm95(T, S, Z) + 1000.0
    np.testing.assert_allclose(float(den[0, 0]), 1050.3639165364, rtol=1e-9)
    den1 = teos.rho_jm95(T, S, torch.zeros_like(Z)) + 1000.0
    np.testing.assert_allclose(float(den1[0, 0]), 1028.2845117925, rtol=1e-9)


def test_wrappers_reject_other_devices():
    cfg_j, grid_j, cfg_t, grid_t = _case("upwelling")
    zeta, u, v = (torch.as_tensor(a).to("meta") for a in _fields(cfg_j, 4))
    with pytest.raises(ValueError, match="device"):
        diag_cuda.grid_flux(cfg_t, grid_t, zeta, u, v, 25.0)
