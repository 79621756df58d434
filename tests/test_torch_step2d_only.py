"""roms_tpu_torch: the 2-D-only step (ops/step2d.step_2d_only, main2d) on
the CPU in float64.

(a) ten steps of a small SOLITON (24 x 8, the first one forward Euler)
    against roms_tpu's step_2d_only under jax.jit, from the same state
    carried across by convert.fast_state_to_numpy / _from_numpy; and the
    branches SOLITON does not take (closed walls, a Flather/clamped open
    boundary with its data, a surface stress, linear drag); every field of
    the Fast2DState within 1e-12 x max|field|;
(b) the analogs of tests/test_step2d.py: rest stays exactly at rest, and
    the volume is conserved within 1e-10 over 100 steps;
(c) the fused fast-loop kernel's gate refuses the 2-D-only mode, so no
    kernel runs it, as no Pallas kernel runs roms_tpu's.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from roms_tpu.grid import Grid as JGrid
from roms_tpu.ops import step2d as jstep2d, step2d_pallas
from roms_tpu_torch import convert
from roms_tpu_torch.config import LBC, BC_CLAMPED, BC_CLOSED, BC_FLATHER, \
    BC_CHAPMAN_EXPLICIT
from roms_tpu_torch.models import soliton as tsoliton
from roms_tpu_torch.ops import step2d, step2d_cuda
from test_torch_obc import jax_config

torch.set_num_threads(1)

RTOL = 1e-12          # times max|field|
NSTEPS = 10
SIZE = dict(Lm=24, Mm=8)


def _fs_numpy(fs):
    return {k: np.asarray(getattr(fs, k)) for k in step2d.FS_FIELDS}


def _run_port(cfg, grid, fs, n, forcing=None, bry=None):
    for i in range(n):
        fs = step2d.step_2d_only(cfg, grid, fs, i == 0, forcing=forcing,
                                 bry=bry)
    return fs


def _run_jax(cfg, grid, fs, n, forcing=None, bry=None):
    first = jax.jit(lambda s: jstep2d.step_2d_only(cfg, grid, s, True,
                                                   forcing=forcing, bry=bry))
    rest = jax.jit(lambda s: jstep2d.step_2d_only(cfg, grid, s, False,
                                                  forcing=forcing, bry=bry))
    fs = first(fs)
    for _ in range(n - 1):
        fs = rest(fs)
    return fs


def _pair(change=None):
    """SOLITON at SIZE with `change` to its configuration: the port's case
    and roms_tpu's configuration, grid and state made from it as numpy
    (roms_tpu's builder is held to the port's in tests/test_torch_cases2.py
    through the fixture)."""
    cfg_t = tsoliton.make_config(**SIZE)
    if change:
        cfg_t = dataclasses.replace(cfg_t, **change)
    cfg_t, grid_t, fs_t = tsoliton.build(cfg_t, device="cpu")
    cfg_j = jax_config(cfg_t)
    grid_j = JGrid(**{f.name: None if getattr(grid_t, f.name) is None else
                      jnp.asarray(getattr(grid_t, f.name).numpy())
                      for f in dataclasses.fields(grid_t)})
    fs_j = jstep2d.Fast2DState(**{k: jnp.asarray(v) for k, v in
                                  convert.fast_state_to_numpy(fs_t).items()})
    return cfg_j, grid_j, fs_j, cfg_t, grid_t, fs_t


def _close(got, ref):
    ref = _fs_numpy(ref)
    for k in step2d.FS_FIELDS:
        a = getattr(got, k).numpy()
        scale = max(np.abs(ref[k]).max(), 1e-300)
        np.testing.assert_allclose(a, ref[k], rtol=0, atol=RTOL * scale,
                                   err_msg=k)


def test_soliton_matches_jax():
    cfg_j, grid_j, fs_j, cfg_t, grid_t, fs_t = _pair()
    # the start carried back from roms_tpu's state as numpy
    fs_t = convert.fast_state_from_numpy(cfg_t, _fs_numpy(fs_j),
                                         device="cpu")
    _close(_run_port(cfg_t, grid_t, fs_t, NSTEPS),
           _run_jax(cfg_j, grid_j, fs_j, NSTEPS))


def test_open_boundary_forcing_and_drag_match_jax():
    """The branches SOLITON does not take: closed north and south walls, a
    Chapman/Flather west boundary fed by `bry` and a clamped east one, a
    surface stress through Forcing2D (which Flather's boundary sees too)
    and linear bottom drag."""
    clo = LBC(BC_CLOSED, BC_CLOSED, BC_CLOSED, BC_CLOSED)
    zb = LBC(BC_CHAPMAN_EXPLICIT, BC_CLOSED, BC_CHAPMAN_EXPLICIT, BC_CLOSED)
    ub = LBC(BC_FLATHER, BC_CLOSED, BC_CLAMPED, BC_CLOSED)
    change = dict(ew_periodic=False, lbc_zeta=zb, lbc_ubar=ub,
                  lbc_vbar=ub, lbc_u=clo, lbc_v=clo, lbc_t=clo,
                  bottom_drag="linear", rdrg=0.05)
    cfg_j, grid_j, fs_j, cfg_t, grid_t, fs_t = _pair(change)
    ny = cfg_t.ny_tot
    rng = np.random.default_rng(4)
    bry = {k: 0.05 * rng.standard_normal(ny) for k in (
        "zeta_west", "ubar_west", "vbar_west", "ubar_east", "vbar_east")}
    su, sv = (1e-3 * rng.standard_normal(grid_t.h.shape) for _ in "uv")
    _close(_run_port(cfg_t, grid_t, fs_t, NSTEPS,
                     step2d.Forcing2D(torch.tensor(su), torch.tensor(sv)),
                     {k: torch.tensor(v) for k, v in bry.items()}),
           _run_jax(cfg_j, grid_j, fs_j, NSTEPS,
                    jstep2d.Forcing2D(jnp.asarray(su), jnp.asarray(sv)),
                    {k: jnp.asarray(v) for k, v in bry.items()}))


@pytest.fixture(scope="module")
def soliton_cpu():
    return tsoliton.build(tsoliton.make_config(**SIZE), device="cpu")


def test_rest_state_stays_at_rest(soliton_cpu):
    cfg, grid, fs0 = soliton_cpu
    z = torch.zeros_like(fs0.zeta_n)
    fs = _run_port(cfg, grid, step2d.make_fast_state(cfg, z, z, z), 10)
    for k in step2d.FS_FIELDS:
        assert float(getattr(fs, k).abs().max()) == 0.0, k


def test_soliton_volume_conservation(soliton_cpu):
    cfg, grid, fs0 = soliton_cpu
    H = cfg.halo

    def volume(fs):
        inner = (slice(H, H + cfg.Mm), slice(H, H + cfg.Lm))
        return float((fs.zeta_n[inner] * grid.omn[inner]).sum())

    vol0 = volume(fs0)
    fs = _run_port(cfg, grid, fs0, 100)
    vol = volume(fs)
    assert np.isfinite(vol)
    assert abs(vol - vol0) < 1e-10 * max(1.0, abs(vol0))
    assert float(fs.zeta_n.abs().max()) > 0.5 * float(fs0.zeta_n.abs().max())


def test_no_kernel_takes_the_2d_mode(soliton_cpu):
    cfg = soliton_cpu[0]
    assert not step2d_cuda.supported(cfg)
    assert not step2d_pallas.supported(jax_config(cfg))
