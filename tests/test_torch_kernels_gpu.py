"""roms_tpu_torch CUDA kernels against their plain PyTorch versions, on the
card, in float32 and float64; and the UPWELLING anchor with the kernels on.

Marked ``gpu``; each test skips without a CUDA device.  This file imports
no jax, so it also runs where jax is absent:

    python -m pytest tests/test_torch_kernels_gpu.py -m gpu --noconftest
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from roms_tpu_torch import stepping
from roms_tpu_torch.config import LBC, BC_CLOSED, BC_GRADIENT
from roms_tpu_torch.grid import hc_of
from roms_tpu_torch.models import upwelling
from roms_tpu_torch.ops import diag_cuda, step2d_cuda
from roms_tpu_torch.ops.step2d import FS_FIELDS, Fast2DState

pytestmark = pytest.mark.gpu

torch.set_num_threads(1)

RTOL = {torch.float64: 1e-12, torch.float32: 1e-5}
FAST_RTOL = {torch.float64: 1e-10, torch.float32: 1e-4}
_ANCHOR = os.path.join(os.path.dirname(__file__), "data",
                       "upwelling_anchor.npz")


@pytest.fixture(scope="module")
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda:0")


def _close(got, ref, rtol, name=""):
    for a, b in zip(got, ref):
        torch.cuda.synchronize()
        scale = max(b.abs().max().item(), 1e-30)
        err = (a - b).abs().max().item()
        assert err <= rtol * scale, f"{name}: {err:.3e} > {rtol}*{scale:.3e}"


def _config(kind, dtype):
    cfg = upwelling.make_config(Lm=20, Mm=16, N=6, ndtfast=8, dtype=dtype)
    if kind == "closed":
        cfg = dataclasses.replace(
            cfg, ew_periodic=False, gamma2=-1.0,
            lbc_zeta=LBC(BC_GRADIENT, BC_CLOSED, BC_CLOSED, BC_GRADIENT),
            lbc_ubar=LBC(BC_CLOSED, BC_GRADIENT, BC_CLOSED, BC_CLOSED),
            lbc_vbar=LBC(BC_GRADIENT, BC_CLOSED, BC_CLOSED, BC_GRADIENT),
            lbc_u=LBC(), lbc_v=LBC(), lbc_t=LBC())
    return cfg


@pytest.fixture(scope="module", params=[
    ("upwelling", "float64"), ("upwelling", "float32"),
    ("closed", "float64"), ("closed", "float32")])
def developed(request, device):
    """A case and its state after 3 plain steps, on the card."""
    kind, dtype = request.param
    cfg, grid, s0, ffn = upwelling.build(_config(kind, dtype), device=device)
    s = stepping.run(cfg.replace(pallas2d=False), grid, s0, 3, ffn)
    return cfg, grid, s


def test_grid_flux_and_omega_kernels(developed):
    cfg, grid, s = developed
    hc = hc_of(cfg)
    got = diag_cuda.grid_flux(cfg, grid, s.zeta, s.u, s.v, hc)
    ref = diag_cuda.grid_flux_plain(cfg, grid, s.zeta, s.u, s.v, hc)
    _close(got, ref, RTOL[s.u.dtype], "grid_flux")
    _close([diag_cuda.omega(cfg, grid, ref[3], ref[4], ref[1])],
           [diag_cuda.omega_plain(cfg, grid, ref[3], ref[4], ref[1])],
           RTOL[s.u.dtype], "omega")


@pytest.mark.parametrize("eos", ["linear", "jm95"])
@pytest.mark.parametrize("want_bvf", [False, True])
def test_eos_kernel(developed, eos, want_bvf):
    cfg, grid, s = developed
    cfg = cfg.replace(eos=eos, Scoef=7.6e-4)
    z_r, z_w, *_ = diag_cuda.grid_flux_plain(cfg, grid, s.zeta, s.u, s.v,
                                             hc_of(cfg))
    _close(diag_cuda.eos(cfg, s.t, z_r, z_w, want_bvf),
           diag_cuda.eos_plain(cfg, s.t, z_r, z_w, want_bvf),
           RTOL[s.u.dtype], "eos")


@pytest.mark.parametrize("iic", [0, 1, 5])
def test_fast_loop_kernel(developed, iic):
    cfg, grid, s = developed
    rng = np.random.default_rng(iic)
    fields = {k: getattr(s, src) for k, src in (
        ("zeta_n", "zeta"), ("zeta_nm1", "zeta"), ("ubar_n", "ubar"),
        ("ubar_nm1", "ubar"), ("vbar_n", "vbar"), ("vbar_nm1", "vbar"),
        ("rzeta_n", "rzeta"), ("rubar_n", "rubar"), ("rvbar_n", "rvbar"))}
    for k in FS_FIELDS:
        fields.setdefault(k, torch.zeros_like(s.zeta))
    frc = [1e-4 * torch.tensor(rng.standard_normal(s.zeta.shape),
                               dtype=s.zeta.dtype, device=s.zeta.device)
           for _ in range(6)]
    fresh = lambda: Fast2DState(**{k: a.clone() for k, a in fields.items()})
    before = step2d_cuda.fast_loop.launches
    fs_k, ruc_k, rvc_k = step2d_cuda.fast_loop(cfg, grid, fresh(), *frc, iic)
    assert step2d_cuda.fast_loop.launches == before + 1
    fs_p, ruc_p, rvc_p = step2d_cuda.fast_loop_plain(cfg, grid, fresh(),
                                                     *frc, iic)
    _close([getattr(fs_k, k) for k in FS_FIELDS] + [ruc_k, rvc_k],
           [getattr(fs_p, k) for k in FS_FIELDS] + [ruc_p, rvc_p],
           FAST_RTOL[s.u.dtype], "fast_loop")


def test_fast_loop_kernel_rejects_aliased_fields(developed):
    cfg, grid, s = developed
    fs = Fast2DState(**{k: s.zeta for k in FS_FIELDS})
    with pytest.raises(ValueError, match="alias"):
        step2d_cuda.fast_loop(cfg, grid, fs, *[s.zeta] * 6, 0)


def test_anchor_with_kernels(device):
    """10 float64 steps with the kernels on: every kernel launched once a
    step, and the anchor holds at 100x the bounds of test_anchor.py (the
    card sums columns in another order than the CPU)."""
    ref = np.load(_ANCHOR)
    cfg, grid, s, ffn = upwelling.build(upwelling.make_config(),
                                        device=device)
    wrappers = (diag_cuda.grid_flux, diag_cuda.eos, diag_cuda.omega,
                step2d_cuda.fast_loop)
    before = [w.launches for w in wrappers]
    s = stepping.run(cfg, grid, s, 10, ffn)
    assert [w.launches - b for w, b in zip(wrappers, before)] == [10] * 4
    H = cfg.halo
    inter = lambda a: a[..., H:H + cfg.Mm, H:H + cfg.Lm].cpu().numpy()
    np.testing.assert_allclose(inter(s.zeta), ref["zeta"], rtol=0,
                               atol=1e-10)
    np.testing.assert_allclose(inter(s.u), ref["u_full"], rtol=0, atol=1e-11)
    np.testing.assert_allclose(inter(s.v), ref["v_full"], rtol=0, atol=1e-11)
    np.testing.assert_allclose(inter(s.t)[0], ref["temp_full"], rtol=0,
                               atol=1e-8)
