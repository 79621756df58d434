"""roms_tpu_torch.obs on the CPU: the observation operators (the analogs
of tests/test_obs.py:21-57).

(a) bilinear and trilinear sampling reproduce linear fields exactly, and
    the u- and v-point stagger offsets land on the u and v indices;
(b) interp2d, interp3d and FracObs.sample equal roms_tpu's (jitted) at
    seeded fractional coordinates, out-of-range ones that hit the index
    clamps included, at 1e-14.

The observation file, stats_modobs and the FracObs twin are in
tests/test_torch_obs_files.py (each file keeps to four tests, so that
pytest-xdist's loadfile queue, longest files first, runs them after
roms_tpu's tests/test_fourdvar.py has started).
"""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from roms_tpu import obs as jobs
from roms_tpu_torch import obs
from roms_tpu_torch.models import upwelling

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def setup():
    cfg = upwelling.make_config(Lm=16, Mm=18, N=4)
    cfg, grid, s0, ffn = upwelling.build(cfg, device="cpu")
    return cfg, grid, s0, ffn


def test_interp2d_bilinear_exact(setup):
    cfg = setup[0]
    H = cfg.halo
    jj, ii = np.mgrid[0:cfg.ny_tot, 0:cfg.nx_tot].astype(float)
    f = 2.0 + 0.3 * (ii - H + 1) + 0.7 * (jj - H + 1)   # roms index units
    xg = np.array([3.25, 7.5, 10.75])
    yg = np.array([2.5, 9.0, 14.25])
    got = obs.interp2d(cfg, torch.tensor(f), xg, yg).numpy()
    np.testing.assert_allclose(got, 2.0 + 0.3 * xg + 0.7 * yg, rtol=1e-12)


def test_interp2d_stagger_offsets(setup):
    cfg = setup[0]
    H = cfg.halo
    jj, ii = np.mgrid[0:cfg.ny_tot, 0:cfg.nx_tot].astype(float)
    fu = torch.tensor(ii - H + 1)
    for iu in (3.0, 7.0):
        got = float(obs.interp2d(cfg, fu, np.array([iu - 0.5]),
                                 np.array([5.0]), var="u")[0])
        assert got == pytest.approx(iu, abs=1e-12)
    # a v-point field linear in the v index, sampled at Ygrid = jv - 0.5
    fv = torch.tensor(jj - H + 1)
    got = float(obs.interp2d(cfg, fv, np.array([4.0]), np.array([6.5]),
                             var="v")[0])
    assert got == pytest.approx(7.0, abs=1e-12)


def test_interp3d_trilinear_exact(setup):
    cfg = setup[0]
    H = cfg.halo
    kk, jj, ii = np.mgrid[0:cfg.N, 0:cfg.ny_tot, 0:cfg.nx_tot].astype(float)
    f = 1.0 + 0.2 * (ii - H + 1) + 0.4 * (jj - H + 1) + 1.5 * (kk + 1)
    xg = np.array([4.5, 8.25])
    yg = np.array([3.75, 12.0])
    zg = np.array([1.5, 3.25])
    got = obs.interp3d(cfg, torch.tensor(f), xg, yg, zg, var="temp").numpy()
    np.testing.assert_allclose(got, 1.0 + 0.2 * xg + 0.4 * yg + 1.5 * zg,
                               rtol=1e-12)


def _coords(cfg, n, seed):
    """Seeded coordinates over and past the grid (the clamps), levels
    past both ends."""
    rng = np.random.default_rng(seed)
    xg = rng.uniform(-3.0, cfg.Lm + 4.0, n)
    yg = rng.uniform(-3.0, cfg.Mm + 4.0, n)
    zg = rng.uniform(-1.0, cfg.N + 2.0, n)
    return xg, yg, zg


def test_sample_and_interp_match_roms_tpu(setup):
    """FracObs.sample of every observed variable (the surface level where
    no level is given), interp2d on a batch of levels and interp3d with
    one level for all, against roms_tpu's jitted functions at seeded
    coordinates past the grid and levels past both ends (the clamps), at
    1e-14 x max|value|."""
    cfg, grid, s0, _ = setup
    xg, yg, zg = _coords(cfg, 40, 11)
    assert (xg < 0).any() and (xg > cfg.Lm + 1).any() and \
        (zg < 1).any() and (zg > cfg.N).any()
    rng = np.random.default_rng(12)
    fields = {k: rng.standard_normal(tuple(getattr(s0, k).shape))
              for k in ("zeta", "ubar", "vbar", "u", "v", "t")}
    state_t = s0.replace(**{k: torch.tensor(v) for k, v in fields.items()})
    ns = {k: jnp.asarray(v) for k, v in fields.items()}

    def close(got, want, what):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=1e-14 * np.abs(want).max(),
                                   err_msg=what)

    for var in obs.OBS_TYPES:
        levels = [zg, None] if var in ("u", "v", "temp", "salt") else [None]
        for zz in levels:
            got = obs.FracObs(step=1, var=var, xg=xg, yg=yg, zg=zz,
                              values=torch.zeros(40)).sample(cfg, state_t)
            jref = jobs.FracObs(step=1, var=var, xg=xg, yg=yg, zg=zz,
                                values=jnp.zeros(40))
            close(got, jax.jit(lambda d: jref.sample(
                cfg, SimpleNamespace(**d)))(ns), f"{var}, zg {zz is None}")

    xg, yg, _ = _coords(cfg, 25, 13)
    f3 = np.random.default_rng(14).standard_normal(
        (cfg.N, cfg.ny_tot, cfg.nx_tot))
    close(obs.interp2d(cfg, torch.tensor(f3), xg, yg, "v"),
          jax.jit(lambda f: jobs.interp2d(cfg, f, xg, yg, "v"))(
              jnp.asarray(f3)), "interp2d")
    close(obs.interp3d(cfg, torch.tensor(f3), xg, yg, 2.5, "u"),
          jax.jit(lambda f: jobs.interp3d(cfg, f, xg, yg, 2.5, "u"))(
              jnp.asarray(f3)), "interp3d")
