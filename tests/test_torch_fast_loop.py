"""roms_tpu_torch: the plain fast barotropic loop (ops/step2d_cuda.py)
against roms_tpu's fused Pallas kernel run in interpreter mode
(step2d_pallas.fast_loop_fused(..., interpret=True)) and against the
general jnp loop it replaces (step2d.fast_loop), on the setup of
test_step2d_pallas.py (UPWELLING 24x20x4, ndtfast 8, a developed state
and structured slow forcing)."""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from roms_tpu.ops import step2d as jstep2d, step2d_pallas
from roms_tpu.ops.step2d import Fast2DState as JFast2DState
from roms_tpu.models import upwelling as jup
from roms_tpu_torch import convert, stepping
from roms_tpu_torch.models import upwelling as tup
from roms_tpu_torch.ops import step2d_cuda
from roms_tpu_torch.ops.step2d import FS_FIELDS, Fast2DState

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def setup():
    cfg_j, grid_j, _, _ = jup.build(jup.make_config(Lm=24, Mm=20, N=4,
                                                    ndtfast=8))
    cfg, grid, s0, ffn = tup.build(tup.make_config(Lm=24, Mm=20, N=4,
                                                   ndtfast=8))
    assert convert.config_from_reference(cfg_j) == cfg
    # two slow steps so the fast state and forcing history are nontrivial
    s = stepping.run(cfg, grid, s0, 2, ffn)
    st = convert.state_to_numpy(s)
    zero = np.zeros_like(st["zeta"])
    fs = dict(zeta_n=st["zeta"], zeta_nm1=st["zeta"], ubar_n=st["ubar"],
              ubar_nm1=st["ubar"], vbar_n=st["vbar"], vbar_nm1=st["vbar"],
              rzeta_n=st["rzeta"], rzeta_nm1=zero, rubar_n=st["rubar"],
              rubar_nm1=zero, rvbar_n=st["rvbar"], rvbar_nm1=zero,
              Zt_avg1=zero, DU_avg1=zero, DV_avg1=zero, DU_avg2=zero,
              DV_avg2=zero)
    rng = np.random.default_rng(0)
    rufrc = 1e-4 * rng.standard_normal(zero.shape)
    rvfrc = 1e-4 * rng.standard_normal(zero.shape)
    hist = [st[k] for k in ("rufrc0_prev", "rufrc0_prev2", "rvfrc0_prev",
                            "rvfrc0_prev2")]
    return cfg_j, grid_j, cfg, grid, fs, [rufrc, rvfrc] + hist, st["iic"]


def _port(cfg, grid, fs, frc, iic):
    fs_t = Fast2DState(**{k: torch.tensor(v) for k, v in fs.items()})
    out, ruc, rvc = step2d_cuda.fast_loop(
        cfg, grid, fs_t, *[torch.tensor(a) for a in frc], int(iic))
    return ({k: getattr(out, k).numpy() for k in FS_FIELDS},
            ruc.numpy(), rvc.numpy())


def _compare(ref, out, atol, rhs_rtol):
    """The tolerances of test_step2d_pallas.py: state fields to atol,
    rhs/average fields additionally to rhs_rtol relative."""
    fs_r, ruc_r, rvc_r = ref
    fs_o, ruc_o, rvc_o = out
    for name in FS_FIELDS:
        a, b = fs_o[name], np.asarray(getattr(fs_r, name))
        scale = max(np.abs(b).max(), 1.0)
        rt = rhs_rtol if name.startswith(("r", "DU", "DV")) else 0.0
        np.testing.assert_allclose(a, b, rtol=0, atol=atol + rt * scale,
                                   err_msg=name)
    for a, b in ((ruc_o, ruc_r), (rvc_o, rvc_r)):
        b = np.asarray(b)
        scale = max(np.abs(b).max(), 1.0)
        np.testing.assert_allclose(a, b, rtol=0,
                                   atol=atol + rhs_rtol * scale)


def test_fast_loop_matches_pallas_interpret(setup):
    cfg_j, grid_j, cfg, grid, fs, frc, iic = setup
    assert step2d_pallas.supported(cfg_j) and step2d_cuda.supported(cfg)
    fs_j = JFast2DState(**{k: jnp.asarray(v) for k, v in fs.items()})
    fs_r, ruc, rvc, wet = step2d_pallas.fast_loop_fused(
        cfg_j, grid_j, fs_j, *[jnp.asarray(a) for a in frc], int(iic),
        interpret=True)
    assert wet is None
    _compare((fs_r, ruc, rvc), _port(cfg, grid, fs, frc, iic),
             atol=1e-13, rhs_rtol=1e-9)
    assert step2d_cuda.fast_loop.launches == 0


@pytest.mark.parametrize("iic", [0, 1, 5])
def test_fast_loop_matches_reference_loop(setup, iic):
    """Against the general jnp loop (the reference path on CPU), for each
    branch of the AB3 start-up of the 2-D/3-D coupling."""
    cfg_j, grid_j, cfg, grid, fs, frc, _ = setup
    fs_j = JFast2DState(**{k: jnp.asarray(v) for k, v in fs.items()})
    fs_r, ruc, rvc, wet = jstep2d.fast_loop(
        cfg_j, grid_j, fs_j, rufrc=jnp.asarray(frc[0]),
        rvfrc=jnp.asarray(frc[1]), ru0_nm1=jnp.asarray(frc[2]),
        ru0_nm2=jnp.asarray(frc[3]), rv0_nm1=jnp.asarray(frc[4]),
        rv0_nm2=jnp.asarray(frc[5]), iic=iic)
    _compare((fs_r, ruc, rvc), _port(cfg, grid, fs, frc, iic),
             atol=1e-13, rhs_rtol=1e-9)


def test_fast_loop_gate():
    cfg = tup.make_config(Lm=24, Mm=20, N=4, ndtfast=8)
    cfg, *_ = tup.build(cfg)
    assert step2d_cuda.supported(cfg)
    assert not step2d_cuda.supported(dataclasses.replace(cfg, wetdry=True))
    assert not step2d_cuda.supported(cfg, sources=object())
    assert not step2d_cuda.supported(dataclasses.replace(cfg, nfast=1))
    with pytest.raises(NotImplementedError, match="fast loop"):
        step2d_cuda.fast_loop_plain(
            dataclasses.replace(cfg, wetdry=True), None, None, None, None,
            None, None, None, None, 0)
