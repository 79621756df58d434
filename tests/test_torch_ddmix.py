"""roms_tpu_torch: KPP double diffusion (LMD_DDMIX) against roms_tpu's, on
the CPU in float64.

lmd_vmix with cfg.lmd_ddmix on columns in the salt-fingering regime (warm
and salty over cold and fresh) and in the diffusive-convection regime
(cold and fresh over warm and salty), under JM95 (the thermal expansion and
saline contraction coefficients by autograd, as roms_tpu takes jax.grad)
and the linear EOS, against roms_tpu's lmd_vmix under jax.jit, each output
within 1e-12 x max|field| over the whole padded array; and the analog of
tests/test_cases3.py::test_ddmix_salt_fingering_enhances_salt_diffusivity
on the port alone, which also shows the heat and salt diffusivities get
their own terms (Akt_s starts as Akt_t and is built out of place).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from roms_tpu import vgrid as jvgrid
from roms_tpu.grid import hc_of
from roms_tpu.ops import eos as jeos, vmix as jvmix
from roms_tpu_torch import convert, vgrid as tvgrid
from roms_tpu_torch.models import upwelling as tup
from roms_tpu_torch.ops import eos as teos, vmix as tvmix
from test_torch_benchmark_physics import _pair

torch.set_num_threads(1)

RTOL = 1e-12          # times max|field|
J = jnp.asarray
_KPP_ARGS = ("u", "v", "t", "rho", "pden", "bvf", "Hz", "z_r", "z_w",
             "sustr", "svstr", "bustr", "bvstr", "stflx", "srflx", "hsbl")


def T(a):
    return torch.tensor(np.asarray(a))


def _close(got, ref, name):
    got, ref = got.numpy(), np.asarray(ref)
    assert got.shape == ref.shape, name
    scale = max(np.abs(ref).max(), 1e-300)
    np.testing.assert_allclose(got, ref, rtol=0, atol=RTOL * scale,
                               err_msg=name)


def _columns(cfg_j, grid_j, seed=5):
    """Stratified, wind-forced columns as numpy: even xi columns in the
    salt-fingering regime, odd ones in the diffusive-convection regime,
    the density ratio spread across (0, 2)."""
    rng = np.random.default_rng(seed)
    N = cfg_j.N
    s2 = np.asarray(grid_j.h).shape
    s3 = (N,) + s2
    z_r, z_w, Hz = jvgrid.set_depth(grid_j.h, J(0.1 * rng.standard_normal(
        s2)), hc_of(cfg_j), grid_j.sc_r, grid_j.Cs_r, grid_j.sc_w,
        grid_j.Cs_w, cfg_j.vtransform)
    zr = np.asarray(z_r)
    zeta = zr / np.abs(zr).max()                       # -1 at the bottom
    finger = np.broadcast_to(np.arange(s2[1]) % 2 == 0, s2)
    ratio = 0.2 + 1.6 * rng.random(s2)                 # dT / dS scale
    sgn = np.where(finger, -1.0, 1.0)
    # finger: T and S both rise toward the surface (zeta -> 0); diffusive:
    # both fall toward it
    temp = 8.0 - sgn * 4.0 * ratio * zeta + 1e-3 * rng.standard_normal(s3)
    salt = 34.5 - sgn * 0.9 * zeta + 1e-4 * rng.standard_normal(s3)
    t = np.stack([temp, salt])
    rho, pden, bvf = jax.jit(lambda t, z_r, z_w: (
        *jeos.rho_eos_pden(cfg_j, t, z_r),
        jeos.brunt_vaisala(cfg_j, t, z_r, z_w)))(J(t), z_r, z_w)
    srflx = 2e-6 * rng.random(s2)
    return dict(
        u=0.1 * np.exp(zr / 100.0) + 0.01 * rng.standard_normal(s3),
        v=0.01 * rng.standard_normal(s3),
        t=t, rho=np.asarray(rho), pden=np.asarray(pden),
        bvf=np.asarray(bvf), Hz=np.asarray(Hz), z_r=zr, z_w=np.asarray(z_w),
        sustr=1e-4 * rng.random(s2), svstr=3e-5 * rng.standard_normal(s2),
        bustr=1e-5 * rng.standard_normal(s2),
        bvstr=1e-5 * rng.standard_normal(s2),
        stflx=np.stack([srflx - 1e-5 * rng.random(s2),
                        1e-7 * rng.standard_normal(s2)]),
        srflx=srflx, hsbl=-20.0 - 10.0 * rng.random(s2),
        hbbl=np.zeros(s2), finger=finger)


@pytest.fixture(scope="module")
def pair():
    return _pair(Lm=12, Mm=8, N=12)


@pytest.mark.parametrize("eos, bottom", [("jm95", True), ("linear", False)])
def test_lmd_vmix_ddmix(pair, eos, bottom):
    """Both regimes, with and without the bottom layer, at 1e-12."""
    cfg_j, grid_j, cfg_t, grid_t = pair
    change = dict(lmd_ddmix=True, kpp_bottom=bottom, eos=eos,
                  Scoef=7.6e-4 if eos == "linear" else cfg_j.Scoef)
    cfg_j = dataclasses.replace(cfg_j, **change)
    cfg_t = dataclasses.replace(cfg_t, **change)
    assert convert.config_from_reference(cfg_j) == cfg_t
    f = _columns(cfg_j, grid_j)
    ref = jax.jit(lambda *a: jvmix.lmd_vmix(cfg_j, grid_j, *a[:-1],
                                            hbbl_prev=a[-1]))(
        *(J(f[k]) for k in _KPP_ARGS + ("hbbl",)))
    got = tvmix.lmd_vmix(cfg_t, grid_t, *(T(f[k]) for k in _KPP_ARGS),
                         hbbl_prev=T(f["hbbl"]))
    for name, a, b in zip(("Akv", "Akt", "hsbl", "hbbl", "ghats"), got,
                          ref):
        _close(a, b, name)
    # the columns reach both regimes: salt fingering (nu_dds = nu_ddt /
    # 0.7) in the even columns, diffusive convection (nu_ddt > nu_dds > 0)
    # in the odd ones
    nu_ddt, nu_dds = tvmix._ddmix(cfg_t, T(f["t"]))
    finger = torch.tensor(np.broadcast_to(f["finger"], nu_ddt.shape))
    salt_fingers = (nu_dds > nu_ddt) & (nu_ddt > 0.0)
    convection = (nu_ddt > nu_dds) & (nu_dds > 0.0)
    assert bool(salt_fingers[finger].any())
    assert bool(convection[~finger].any())


def test_ddmix_salt_fingering_enhances_salt_diffusivity():
    """The analog of roms_tpu's test on the same UPWELLING columns: warm
    and salty over cold and fresh (stable in T, unstable in S) gives nu_dds
    > nu_ddt > 0, and with DDMIX off the heat and salt diffusivities are
    the same, so each gets its own term only."""
    cfg = tup.make_config(Lm=8, Mm=8, N=12, ndtfast=6)
    cfg = dataclasses.replace(cfg, vmix="kpp", lmd_ddmix=True, eos="jm95",
                              tnu2=(0.0, 0.0), akt_bak=(1e-6, 1e-6))
    cfg, grid, s, _ = tup.build(cfg, device="cpu")
    z_r, z_w, Hz = tvgrid.set_depth(grid.h, s.zeta, hc_of(cfg), grid.sc_r,
                                    grid.Cs_r, grid.sc_w, grid.Cs_w,
                                    cfg.vtransform)
    tr = torch.stack([14.0 + 8.0 * z_r / 150.0, 35.0 + 1.5 * z_r / 150.0])
    rho, pden, bvf = teos.rho_eos_pden_bvf(cfg, tr, z_r, z_w)
    zero = torch.zeros_like(s.zeta)
    stflx = torch.zeros((2,) + tuple(s.zeta.shape), dtype=tr.dtype)
    args = (s.u, s.v, tr, rho, pden, bvf, Hz, z_r, z_w, zero, zero, zero,
            zero, stflx, zero, s.hsbl)
    _, Akt, *_ = tvmix.lmd_vmix(cfg, grid, *args)
    _, Akt0, *_ = tvmix.lmd_vmix(dataclasses.replace(cfg, lmd_ddmix=False),
                                 grid, *args)
    assert torch.equal(Akt0[0], Akt0[1])
    H = cfg.halo
    dS = (Akt[1] - Akt0[1])[3:-3, H + 2, H + 2]
    dT = (Akt[0] - Akt0[0])[3:-3, H + 2, H + 2]
    assert float(dS.max()) > 1.0e-5            # salt fingering adds ~1e-4
    assert float(dT.max()) > 1.0e-6
    assert float(dS.max()) > float(dT.max())   # nu_dds = nu_ddt / 0.7
