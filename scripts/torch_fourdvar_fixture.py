"""Write tests/data/torch_fourdvar_small.npz: roms_tpu's tangent-linear
and adjoint steps and its 4D-Var drivers at the sizes of its own tests,
the reference that roms_tpu_torch's obs.py, fourdvar.py and the
linearized step are held to (tests/test_torch_obs_files.py,
tests/test_torch_autodiff*.py, tests/test_torch_fourdvar*.py,
chip_smoke.py phase 20):

  autodiff   UPWELLING 12 x 16 x 6, ndtfast 8, after 5 jitted steps
             (tests/test_autodiff.py): the state, and jax.jvp / jax.vjp of
             one step with a seeded tangent (every field but time, seed 1)
             and cotangent (seed 2);
  benchmark  the small BENCHMARK 16 x 12 x 6, ndtfast 6 (KPP, JM95, COARE)
             after BENCH_SPINUP = 2 jitted steps: the state, jax.jvp of
             one step (seeded tangent on zeta, ubar, vbar, u, v and t,
             seed 3), and where jax.vjp of that step is not finite (seed
             4's cotangent; ROADMAP queue 3).  From rest the TLM is not
             finite in either package, so the part starts 2 steps in;
  twin       the I4D-Var twin of tests/test_fourdvar.py:14-49 (12 x 14 x
             4, ndtfast 6, SST at step 2, n_inner 5);
  primal8, rbl8, r48
             the same twin under i4dvar, rbl4dvar and r4dvar with
             n_inner 8 (tests/test_fourdvar.py:73-98);
  wind       the wind-stress control twin (tests/test_fourdvar.py:
             101-155: ndtfast 30, vmix none, 3 steps, "sustr"), n_inner 4
             (DRIVERS);
  fracobs    the FracObs twin of tests/test_obs.py:85-128 (16 x 18 x 4)
             with stats_modobs of background and analysis;
  bry        KELVIN 24 x 16 x 4, ndtfast 20, 2 steps with "bry:zeta_west"
             in the control vector: the innovation of seeded zeta
             observations at step 2 and the adjoint of H M at it.

    JAX_PLATFORMS=cpu python scripts/torch_fourdvar_fixture.py \
        [--out PATH] [PART ...]     (~15 min for all parts)
    JAX_PLATFORMS=cpu python scripts/torch_fourdvar_fixture.py --report

Named PARTs are (re)written into an existing file and the others kept.
Each driver part stores its observation values from roms_tpu's truth run
("<part>/obs<i>", "<part>/nobs" of them), so a port run from the same observations is held to it
with identical inputs, and the port's own truth run is held to the values
apart.  Importing this file runs nothing and imports no jax: the sizes,
the seeded tangents, the port's side of every part (``port_*``) and
``BOUNDS`` are here for the tests and chip_smoke.py.  ``--report`` writes
nothing and prints what the bounds rest on: roms_tpu's own change when
the initial tracers move up by one ulp (autodiff, benchmark), and
roms_tpu_torch's CPU errors against the fixture (~3 min).
"""

from __future__ import annotations

import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, "tests", "data", "torch_fourdvar_small.npz")

AUTODIFF = dict(Lm=12, Mm=16, N=6, ndtfast=8)
SPINUP = 5
BENCH = dict(Lm=16, Mm=12, N=6, ndtfast=6)
BENCH_SPINUP = 2
TWIN = dict(Lm=12, Mm=14, N=4, ndtfast=6)
WIND = dict(Lm=12, Mm=14, N=4, ndtfast=30)
FRAC = dict(Lm=16, Mm=18, N=4)
KELVIN = dict(Lm=24, Mm=16, N=4, ndtfast=20)
TWIN_SIGMAS = {"zeta": 0.0, "u": 0.0, "v": 0.0, "t": 0.5}
WIND_SIGMAS = {"zeta": 0.0, "u": 0.0, "v": 0.0, "t": 0.0, "sustr": 1.0e-4}
WIND_CONTROLS = ("zeta", "u", "v", "t", "sustr")
BRY_CONTROLS = ("zeta", "u", "v", "t", "bry:zeta_west")
# the driver parts: (setup, driver, n_inner), roms_tpu's tests' n_inner
# but the wind twin's: its checks hold at 4 of roms_tpu's 8 (Jo falls to
# 6.6e-5 of the first against the 1e-3 asked, corr 0.99992, amplitude
# 0.991 in roms_tpu_torch on the CPU), and each iteration costs ~3 s there
DRIVERS = {"twin": ("twin", "i4dvar", 5), "primal8": ("twin", "i4dvar", 8),
           "rbl8": ("twin", "rbl4dvar", 8), "r48": ("twin", "r4dvar", 8),
           "wind": ("wind", "i4dvar", 4), "fracobs": ("fracobs", "i4dvar", 5)}
PARTS = ("autodiff", "benchmark") + tuple(DRIVERS) + ("bry",)
# the fields compared after one step of the autodiff part: what the step
# writes (its other fields pass the tangent through unchanged)
STEP_FIELDS = ("zeta", "ubar", "vbar", "u", "v", "t", "ru_prev", "rv_prev",
               "rufrc0_prev", "rvfrc0_prev", "rzeta", "rubar", "rvbar",
               "Akv", "Akt", "DU_avg1", "DV_avg1", "DU_avg2", "DV_avg2")
PROGNOSTIC = ("zeta", "ubar", "vbar", "u", "v", "t")
BENCH_FIELDS = PROGNOSTIC + ("Akv", "Akt", "hsbl")
# the stats_modobs entries the fracobs part stores, in order
STAT_KEYS = ("count", "bias", "rmse", "std", "corr", "model_mean",
             "obs_mean")

# Bounds on |port - fixture| on the CPU, relative to the fixture's
# max|.| (each field, tracer by tracer; a vector as a whole).  --report
# printed, for roms_tpu_torch on the CPU against the fixture, and for
# roms_tpu's own change when its initial tracers move up by one ulp:
#   autodiff   jvp / vjp of one step from identical inputs: the port
#              <= 3.0e-12 (vjp of Akt[1]; jvp <= 5.1e-13), roms_tpu's
#              spread <= 6.0e-14;
#   benchmark  the TLM of one step 2 steps in: the port <= 7.1e-11 (t[0];
#              the others <= 1.9e-12), roms_tpu's spread <= 3.7e-12: the
#              port's second derivatives of the JM95 EOS and the KPP
#              scales round otherwise than XLA's;
#   driver     Jo, cg_residuals, increments and controls from identical
#              observations: the port <= 3.2e-14;
#   obs        the port's own truth run against roms_tpu's jitted one:
#              <= 6.0e-13 (the wind twin's; its fast loop has 3 x 30
#              substeps);
#   bry        the innovation and the adjoint's entries: <= 1.9e-14.
BOUNDS = {"autodiff": 1e-10, "benchmark": 1e-9, "driver": 1e-10,
          "obs": 1e-10, "bry": 1e-10}


# ---------------------------------------------------------------------------
# shared: seeded tangents, interiors
# ---------------------------------------------------------------------------
def tangent(shapes: dict, seed: int) -> dict:
    """{field: standard normal array} over `shapes` ({field: shape}, in
    its order) from numpy's default_rng(seed)."""
    rng = np.random.default_rng(seed)
    return {k: rng.standard_normal(s) for k, s in shapes.items()}


def interior(cfg, a):
    H = cfg.halo
    a = a.detach().cpu().numpy() if hasattr(a, "detach") else np.asarray(a)
    return a[..., H:H + cfg.Mm, H:H + cfg.Lm]


def rel_err(got, want) -> float:
    """max|got - want| / max|want| (0 over 0 is 0; NaN where they
    differ in finiteness)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    if got.shape != want.shape:
        return float("inf")
    if not np.array_equal(np.isfinite(got), np.isfinite(want)):
        return float("nan")
    m = np.isfinite(want)
    scale = np.abs(want[m]).max() if m.any() else 0.0
    diff = np.abs(got[m] - want[m]).max() if m.any() else 0.0
    return float(diff / scale) if scale > 0 else float(diff)


def per_field_errors(cfg, got: dict, want_of, fields, prefix) -> dict:
    """{prefix/field[n]: rel_err} of each field's interior, each tracer
    (the leading axis of t and Akt) on its own."""
    out = {}
    for k in fields:
        g, w = interior(cfg, got[k]), want_of(f"{prefix}/{k}")
        if k in ("t", "Akt"):
            for n in range(len(w)):
                out[f"{prefix}/{k}[{n}]"] = rel_err(g[n], w[n])
        else:
            out[f"{prefix}/{k}"] = rel_err(g, w)
    return out


# ---------------------------------------------------------------------------
# roms_tpu_torch's side
# ---------------------------------------------------------------------------
def port_autodiff_state(ref, device="cpu"):
    """(cfg, grid, state, ffn) of the autodiff part: roms_tpu_torch's
    UPWELLING at AUTODIFF with the fixture's spun-up state."""
    return _port_state(ref, "autodiff", device)


def shapes_of(state, fields) -> dict:
    return {k: tuple(getattr(state, k).shape) for k in fields}


def port_twin(setup: str, device="cpu", obs_values=None):
    """(cfg, grid, background, ffn, obs, nsteps, truth) of a driver
    setup ("twin", "wind" or "fracobs") in roms_tpu_torch: the truth run
    gives the observations, or `obs_values` (a list, one array an Obs, as
    the fixture stores them) replace them.  truth: the truth's initial
    state (twin, fracobs) or the wind-stress anomaly (wind)."""
    import torch
    from roms_tpu_torch import fourdvar, obs as tobs, stepping
    from roms_tpu_torch.models import upwelling
    sizes = {"twin": TWIN, "wind": WIND, "fracobs": FRAC}[setup]
    cfg, grid, s0, ffn = upwelling.build(upwelling.make_config(**sizes),
                                         device=device)
    H = cfg.halo
    obs = []
    if setup == "twin":
        nsteps = 2
        pert = 0.5 * torch.exp(-(((grid.xr - 6e3) / 3e3) ** 2 +
                                 ((grid.yr - 7e3) / 3e3) ** 2))
        t_true = s0.t.clone()
        t_true[0] = t_true[0] + pert
        truth = s0.replace(t=t_true, t_prev=t_true)
        ii = np.s_[0, -1, H:H + cfg.Mm, H:H + cfg.Lm]
        if obs_values is None:
            s = stepping.run(cfg, grid, truth, 2, ffn)
            vals = [s.t[ii]]
        else:
            vals = [torch.as_tensor(obs_values[0], device=device)]
        obs = [fourdvar.Obs(step=2, field="t", idx=ii, values=vals[0],
                            sigma=0.1)]
        return cfg, grid, s0, ffn, obs, nsteps, truth
    if setup == "wind":
        cfg = cfg.replace(vmix="none")
        nsteps = 3
        tau = 2.0e-4 * torch.exp(-(((grid.xr - 6e3) / 4e3) ** 2 +
                                   ((grid.yr - 7e3) / 5e3) ** 2))

        def ffn_truth(c, g, t):
            frc = dict(ffn(c, g, t)) if ffn else {}
            frc["sustr"] = frc.get("sustr", 0.0) + tau
            return frc

        iu = np.s_[-1, H:H + cfg.Mm, H:H + cfg.Lm]
        s = s0
        for n in range(1, nsteps + 1):
            if obs_values is None:
                s = stepping.step(cfg, grid, s, ffn_truth)
            if n >= 2:
                v = s.u[iu] if obs_values is None else torch.as_tensor(
                    obs_values[n - 2], device=device)
                obs.append(fourdvar.Obs(step=n, field="u", idx=iu,
                                        values=v, sigma=1e-3))
        return cfg, grid, s0, ffn, obs, nsteps, tau
    # fracobs
    nsteps = 2
    jj = torch.arange(cfg.ny_tot, dtype=grid.h.dtype, device=device)
    ii_ = torch.arange(cfg.nx_tot, dtype=grid.h.dtype, device=device)
    pert = 0.5 * torch.exp(-(jj[:, None] - (H + 9)) ** 2 / 18.0
                           - (ii_[None, :] - (H + 8)) ** 2 / 18.0)
    t_true = s0.t.clone()
    t_true[0, -1] = t_true[0, -1] + pert
    truth = s0.replace(t=t_true)
    rng = np.random.default_rng(0)
    s = truth
    for n in range(1, nsteps + 1):
        if obs_values is None:
            s = stepping.step(cfg, grid, s, ffn)
        xg = rng.uniform(2, cfg.Lm - 1, 12)
        yg = rng.uniform(2, cfg.Mm - 1, 12)
        zg = np.full(12, float(cfg.N))
        o = tobs.FracObs(step=n, var="temp", xg=xg, yg=yg, zg=zg,
                         values=torch.zeros(12, dtype=grid.h.dtype,
                                            device=device), sigma=0.1)
        o.values = o.sample(cfg, s) if obs_values is None else \
            torch.as_tensor(obs_values[n - 1], device=device)
        obs.append(o)
    return cfg, grid, s0, ffn, obs, nsteps, truth


def port_driver(part: str, device="cpu", obs_values=None):
    """Run a driver part in roms_tpu_torch: (setup tuple, analysis,
    diags)."""
    from roms_tpu_torch import fourdvar
    setup, driver, n_inner = DRIVERS[part]
    su = port_twin(setup, device, obs_values)
    cfg, grid, s0, ffn, obs, nsteps, _ = su
    kw = dict(sigmas=TWIN_SIGMAS, b_iters=2, n_inner=n_inner)
    if setup == "wind":
        kw.update(sigmas=WIND_SIGMAS, controls=WIND_CONTROLS)
    if setup == "fracobs":
        kw = dict(n_inner=n_inner, sigmas=TWIN_SIGMAS)
    ana, diags = getattr(fourdvar, driver)(cfg, grid, s0, obs, nsteps, ffn,
                                           **kw)
    return su, ana, diags


def driver_outputs(part: str, su, ana, diags) -> dict:
    """The stored outputs of a driver part: Jo, cg_residuals, the
    analysis increment of the surface temperature (or the sustr
    control)."""
    cfg, _, s0, _, _, _, _ = su
    out = {"Jo": np.asarray(diags["Jo"], np.float64),
           "cg_residuals": np.asarray(diags["cg_residuals"], np.float64)}
    if DRIVERS[part][0] == "wind":
        out["control_sustr"] = interior(cfg, diags["control"]["sustr"])
    else:
        out["increment"] = interior(cfg, ana.t[0, -1]) - \
            interior(cfg, s0.t[0, -1])
    return out


def driver_errors(part: str, su, ana, diags, ref, factor=1.0) -> dict:
    """{name: (rel_err, bound)} of a port run of a driver part against the
    fixture."""
    got = driver_outputs(part, su, ana, diags)
    b = factor * BOUNDS["driver"]
    return {f"{part}/{k}": (rel_err(v, ref[f"{part}/{k}"]), b)
            for k, v in got.items()}


def fixture_obs(ref, part: str) -> list:
    """A driver part's observation values as stored."""
    n = int(ref[f"{part}/nobs"])
    return [ref[f"{part}/obs{i}"] for i in range(n)]


def port_bry(device="cpu"):
    """The bry part in roms_tpu_torch: (cfg, innovation d, {control:
    M^T H^T d}) through fourdvar._make_ops."""
    import torch
    from roms_tpu_torch import fourdvar
    from roms_tpu_torch.models import cases
    cfg, grid, s0, ffn = cases.kelvin(cases.kelvin_config(**KELVIN),
                                      device=device)
    obs = bry_obs(cfg, s0, device)
    traj_ctl, y, add_state, zeros_incr = fourdvar._make_ops(
        cfg, grid, s0, obs, 2, ffn, BRY_CONTROLS)
    with torch.no_grad():
        d = y - traj_ctl(s0, zeros_incr())
    lin = fourdvar.Linearization(
        lambda dx: traj_ctl(add_state(s0, dx), dx,
                            fourdvar.linear_config(cfg)), zeros_incr())
    return cfg, d, lin.vjp(d)


def bry_obs(cfg, s0, device="cpu"):
    """The bry part's observations: zeta over the interior at step 2,
    seeded values (seed 5, 0.05 m) and sigma 0.05."""
    import torch
    from roms_tpu_torch import fourdvar
    H = cfg.halo
    iz = np.s_[H:H + cfg.Mm, H:H + cfg.Lm]
    vals = 0.05 * np.random.default_rng(5).standard_normal((cfg.Mm, cfg.Lm))
    return [fourdvar.Obs(step=2, field="zeta", idx=iz,
                         values=torch.as_tensor(vals, dtype=s0.zeta.dtype,
                                                device=device),
                         sigma=0.05)]


def bry_outputs(cfg, d, adj) -> dict:
    out = {"innovation": np.asarray(d.detach().cpu().numpy())}
    for k, v in adj.items():
        a = v.detach().cpu().numpy()
        out["adj/" + k] = a if a.ndim == 1 else interior(cfg, a)
    return out


def port_benchmark(ref, device="cpu"):
    """(cfg, grid, state, ffn) of the benchmark part in roms_tpu_torch:
    the small BENCHMARK with the fixture's state BENCH_SPINUP steps in."""
    return _port_state(ref, "benchmark", device)


def _port_state(ref, part, device):
    from roms_tpu_torch import convert
    from roms_tpu_torch.models import benchmark, upwelling
    from roms_tpu_torch.state import TENSOR_FIELDS
    model, sizes = {"autodiff": (upwelling, AUTODIFF),
                    "benchmark": (benchmark, BENCH)}[part]
    cfg, grid, _, ffn = model.build(model.make_config(**sizes),
                                    device=device)
    arrays = {k: ref[f"{part}/state/{k}"] for k in TENSOR_FIELDS}
    arrays.update(time=ref[f"{part}/time"], iic=ref[f"{part}/iic"])
    return cfg, grid, convert.state_from_numpy(cfg, arrays, device), ffn


# ---------------------------------------------------------------------------
# roms_tpu's side (imports jax)
# ---------------------------------------------------------------------------
def _jnp_tangent(state, fields, seed):
    """A tangent pytree of roms_tpu's State: seeded normals on `fields`,
    zero on the other floating fields and time, float0 on iic."""
    import dataclasses
    import jax
    import jax.numpy as jnp
    shapes = {k: tuple(getattr(state, k).shape) for k in fields}
    vals = tangent(shapes, seed)
    kw = {}
    for f in dataclasses.fields(state):
        a = getattr(state, f.name)
        if f.name == "iic":
            kw[f.name] = np.zeros(np.shape(a), jax.dtypes.float0)
        elif f.name in vals:
            kw[f.name] = jnp.asarray(vals[f.name], a.dtype)
        else:
            kw[f.name] = jnp.zeros_like(a)
    return state.replace(**kw)


def ref_autodiff(out: dict, spread: bool = False):
    import jax
    import jax.numpy as jnp
    from roms_tpu import stepping
    from roms_tpu.models import upwelling
    from roms_tpu_torch.state import TENSOR_FIELDS
    cfg, grid, s, ffn = upwelling.build(upwelling.make_config(**AUTODIFF))
    stepf = stepping.make_stepper(cfg, grid, ffn, donate=False)
    for _ in range(SPINUP):
        s = stepf(s)
    if spread:
        up = jnp.asarray(np.nextafter(np.asarray(s.t), np.inf))
        s = s.replace(t=up)
    f = lambda st: stepping.step(cfg, grid, st, ffn)
    dx = _jnp_tangent(s, TENSOR_FIELDS, 1)
    dy = _jnp_tangent(s, TENSOR_FIELDS, 2)
    _, jdx = jax.jit(lambda a, b: jax.jvp(f, (a,), (b,)))(s, dx)
    (jtdy,) = jax.jit(lambda a, b: jax.vjp(f, a)[1](b))(s, dy)
    for k in TENSOR_FIELDS:
        out[f"autodiff/state/{k}"] = np.asarray(getattr(s, k))
    out["autodiff/time"] = np.asarray(float(s.time))
    out["autodiff/iic"] = np.asarray(int(s.iic))
    for k in STEP_FIELDS:
        out[f"autodiff/jvp/{k}"] = interior(cfg, getattr(jdx, k))
        out[f"autodiff/vjp/{k}"] = interior(cfg, getattr(jtdy, k))
    lhs = sum(float(jnp.vdot(getattr(jdx, k), getattr(dy, k)))
              for k in TENSOR_FIELDS)
    rhs = sum(float(jnp.vdot(getattr(dx, k), getattr(jtdy, k)))
              for k in TENSOR_FIELDS)
    out["autodiff/dots"] = np.asarray([lhs, rhs])


def ref_benchmark(out: dict, spread: bool = False):
    import jax
    import jax.numpy as jnp
    from roms_tpu import stepping
    from roms_tpu.models import benchmark
    from roms_tpu_torch.state import TENSOR_FIELDS
    cfg, grid, s, ffn = benchmark.build(benchmark.make_config(**BENCH))
    stepf = stepping.make_stepper(cfg, grid, ffn, donate=False)
    for _ in range(BENCH_SPINUP):
        s = stepf(s)
    if spread:
        up = jnp.asarray(np.nextafter(np.asarray(s.t), np.inf))
        s = s.replace(t=up)
    f = lambda st: stepping.step(cfg, grid, st, ffn)
    dx = _jnp_tangent(s, PROGNOSTIC, 3)
    _, jdx = jax.jit(lambda a, b: jax.jvp(f, (a,), (b,)))(s, dx)
    for k in BENCH_FIELDS:
        out[f"benchmark/jvp/{k}"] = interior(cfg, getattr(jdx, k))
    if spread:
        return
    for k in TENSOR_FIELDS:
        out[f"benchmark/state/{k}"] = np.asarray(getattr(s, k))
    out["benchmark/time"] = np.asarray(float(s.time))
    out["benchmark/iic"] = np.asarray(int(s.iic))
    # where roms_tpu's adjoint of this step is not finite: the count of
    # non-finite values in each (level) plane of each field
    dy = _jnp_tangent(s, PROGNOSTIC, 4)
    (jt,) = jax.jit(lambda a, b: jax.vjp(f, a)[1](b))(s, dy)
    for k in TENSOR_FIELDS:
        out[f"benchmark/vjp_nonfinite/{k}"] = nonfinite_planes(
            getattr(jt, k))


def nonfinite_planes(a) -> np.ndarray:
    """The count of non-finite values in each (Ny, Nx) plane of `a`."""
    a = a.detach().cpu().numpy() if hasattr(a, "detach") else np.asarray(a)
    return (~np.isfinite(a)).reshape((-1,) + a.shape[-2:]).sum(axis=(1, 2))


def _ref_twin(setup: str):
    """roms_tpu's (cfg, grid, background, ffn, obs, nsteps) of a setup,
    as its tests build them."""
    import jax
    import jax.numpy as jnp
    from roms_tpu import fourdvar, obs as robs, stepping
    from roms_tpu.models import upwelling
    sizes = {"twin": TWIN, "wind": WIND, "fracobs": FRAC}[setup]
    cfg, grid, s0, ffn = upwelling.build(upwelling.make_config(**sizes))
    H = cfg.halo
    obs = []
    if setup == "twin":
        nsteps = 2
        pert = 0.5 * jnp.exp(-(((grid.xr - 6e3) / 3e3) ** 2 +
                               ((grid.yr - 7e3) / 3e3) ** 2))
        t_true = s0.t.at[0].add(pert)
        s = s0.replace(t=t_true, t_prev=t_true)
        stepf = stepping.make_stepper(cfg, grid, ffn, donate=False)
        for n in range(1, nsteps + 1):
            s = stepf(s)
            if n == 2:
                ii = np.s_[0, -1, H:H + cfg.Mm, H:H + cfg.Lm]
                obs.append(fourdvar.Obs(step=n, field="t", idx=ii,
                                        values=s.t[ii], sigma=0.1))
        return cfg, grid, s0, ffn, obs, nsteps
    if setup == "wind":
        cfg = cfg.replace(vmix="none")
        nsteps = 3
        tau = 2.0e-4 * jnp.exp(-(((grid.xr - 6e3) / 4e3) ** 2 +
                                 ((grid.yr - 7e3) / 5e3) ** 2))

        def ffn_truth(c, g, t):
            frc = dict(ffn(c, g, t)) if ffn else {}
            frc["sustr"] = frc.get("sustr", 0.0) + tau
            return frc

        s = s0
        stepf = stepping.make_stepper(cfg, grid, ffn_truth, donate=False)
        for n in range(1, nsteps + 1):
            s = stepf(s)
            if n >= 2:
                iu = np.s_[-1, H:H + cfg.Mm, H:H + cfg.Lm]
                obs.append(fourdvar.Obs(step=n, field="u", idx=iu,
                                        values=s.u[iu], sigma=1e-3))
        return cfg, grid, s0, ffn, obs, nsteps
    nsteps = 2
    pert = 0.5 * jnp.exp(
        -(jnp.arange(cfg.ny_tot)[:, None] - (H + 9)) ** 2 / 18.0
        - (jnp.arange(cfg.nx_tot)[None, :] - (H + 8)) ** 2 / 18.0)
    truth = s0.replace(t=s0.t.at[0, -1].add(pert))
    run1 = jax.jit(lambda s: stepping.step(cfg, grid, s, ffn))
    rng = np.random.default_rng(0)
    for n in range(1, nsteps + 1):
        truth = run1(truth)
        xg = rng.uniform(2, cfg.Lm - 1, 12)
        yg = rng.uniform(2, cfg.Mm - 1, 12)
        zg = np.full(12, float(cfg.N))
        o = robs.FracObs(step=n, var="temp", xg=xg, yg=yg, zg=zg,
                         values=jnp.zeros(12), sigma=0.1)
        o.values = o.sample(cfg, truth)
        obs.append(o)
    return cfg, grid, s0, ffn, obs, nsteps


def ref_driver(out: dict, part: str):
    import jax
    from roms_tpu import fourdvar, obs as robs, stepping
    setup, driver, n_inner = DRIVERS[part]
    cfg, grid, s0, ffn, obs, nsteps = _ref_twin(setup)
    kw = dict(sigmas=TWIN_SIGMAS, b_iters=2, n_inner=n_inner)
    if setup == "wind":
        kw.update(sigmas=WIND_SIGMAS, controls=WIND_CONTROLS)
    if setup == "fracobs":
        kw = dict(n_inner=n_inner, sigmas=TWIN_SIGMAS)
    ana, diags = getattr(fourdvar, driver)(cfg, grid, s0, obs, nsteps, ffn,
                                           **kw)
    out[f"{part}/nobs"] = np.asarray(len(obs))
    for i, o in enumerate(obs):
        out[f"{part}/obs{i}"] = np.asarray(o.values)
    got = driver_outputs(part, (cfg, grid, s0, ffn, obs, nsteps, None),
                         ana, diags)
    for k, v in got.items():
        out[f"{part}/{k}"] = np.asarray(v)
    if setup == "fracobs":
        run1 = jax.jit(lambda s: stepping.step(cfg, grid, s, ffn))
        sb, sa, states_b, states_a = s0, ana, {}, {}
        for n in range(1, nsteps + 1):
            sb, sa = run1(sb), run1(sa)
            states_b[n], states_a[n] = sb, sa
        for tag, st in (("b", states_b), ("a", states_a)):
            stat = robs.stats_modobs(cfg, obs, st)["temp"]
            out[f"{part}/stats_{tag}"] = np.asarray(
                [stat[k] for k in STAT_KEYS], np.float64)



def ref_bry(out: dict):
    import jax
    import jax.numpy as jnp
    from roms_tpu import fourdvar
    from roms_tpu.models import cases
    cfg, grid, s0, ffn = cases.kelvin(**KELVIN)
    H = cfg.halo
    iz = np.s_[H:H + cfg.Mm, H:H + cfg.Lm]
    vals = 0.05 * np.random.default_rng(5).standard_normal(
        (cfg.Mm, cfg.Lm))
    obs = [fourdvar.Obs(step=2, field="zeta", idx=iz,
                        values=jnp.asarray(vals), sigma=0.05)]
    traj_ctl, _, y, add_state, zeros_incr = fourdvar._make_ops(
        cfg, grid, s0, obs, 2, ffn, BRY_CONTROLS)
    d = jax.jit(lambda s: y - traj_ctl(s, zeros_incr()))(s0)
    f = lambda dx: traj_ctl(add_state(s0, dx), dx)
    (adj,) = jax.jit(lambda dd: jax.vjp(f, zeros_incr())[1](dd))(d)
    out["bry/innovation"] = np.asarray(d)
    for k, v in adj.items():
        a = np.asarray(v)
        out["bry/adj/" + k] = a if a.ndim == 1 else interior(cfg, a)


# ---------------------------------------------------------------------------
# --report
# ---------------------------------------------------------------------------
def autodiff_errors(cfg, jvp_out: dict, vjp_out: dict, ref,
                    factor=1.0) -> dict:
    """{name: (rel_err, bound)} of the port's one-step jvp and vjp outputs
    ({field: tensor}) against the autodiff part."""
    b = factor * BOUNDS["autodiff"]
    e = per_field_errors(cfg, jvp_out, lambda k: ref[k], STEP_FIELDS,
                         "autodiff/jvp")
    e.update(per_field_errors(cfg, vjp_out, lambda k: ref[k], STEP_FIELDS,
                              "autodiff/vjp"))
    return {k: (v, b) for k, v in e.items()}


def port_autodiff(ref, device="cpu"):
    """The port's jvp and vjp of the autodiff part's step (torch.func over
    fourdvar.step_map): (cfg, state, dx, dy, jvp dict, vjp dict)."""
    import torch
    from roms_tpu_torch import fourdvar
    from roms_tpu_torch.state import TENSOR_FIELDS
    cfg, grid, s, ffn = port_autodiff_state(ref, device)
    f, x = fourdvar.step_map(cfg, grid, s, ffn)
    kw = dict(dtype=grid.h.dtype, device=device)
    shapes = shapes_of(s, TENSOR_FIELDS)
    dx = {k: torch.as_tensor(v, **kw)
          for k, v in tangent(shapes, 1).items()}
    dy = {k: torch.as_tensor(v, **kw)
          for k, v in tangent(shapes, 2).items()}
    _, jdx = torch.func.jvp(f, (x,), (dx,))
    _, vjp_fn = torch.func.vjp(f, x)
    (jtdy,) = vjp_fn(dy)
    return cfg, s, dx, dy, jdx, jtdy


def report() -> None:
    import torch
    torch.set_num_threads(1)
    ref = np.load(OUT)
    parts = [p for p in sys.argv[1:] if p in PARTS] or list(PARTS)
    if "autodiff" in parts:
        a, b = {}, {}
        ref_autodiff(a)
        ref_autodiff(b, spread=True)
        for k in STEP_FIELDS:
            for kind in ("jvp", "vjp"):
                key = f"autodiff/{kind}/{k}"
                print(f"roms_tpu, tracers one ulp up: {key:28s} "
                      f"{rel_err(b[key], a[key]):.3e}")
        cfg, s, dx, dy, jdx, jtdy = port_autodiff(ref)
        for k, (e, lim) in autodiff_errors(cfg, jdx, jtdy, ref).items():
            print(f"roms_tpu_torch (CPU): {k:28s} {e:.3e} (bound {lim:g})")
    if "benchmark" in parts:
        a, b = {}, {}
        ref_benchmark(a, spread=True)
        for k in BENCH_FIELDS:
            key = f"benchmark/jvp/{k}"
            print(f"roms_tpu, tracers one ulp up: {key:28s} "
                  f"{rel_err(a[key], ref[key]):.3e}")
        cfg, jdx = port_benchmark_tlm(ref)
        for k, (e, lim) in benchmark_errors(cfg, jdx, ref).items():
            print(f"roms_tpu_torch (CPU): {k:28s} {e:.3e} (bound {lim:g})")
    for part in DRIVERS:
        if part not in parts:
            continue
        su, ana, diags = port_driver(part, obs_values=fixture_obs(ref, part))
        for k, (e, lim) in driver_errors(part, su, ana, diags, ref).items():
            print(f"roms_tpu_torch (CPU): {k:28s} {e:.3e} (bound {lim:g})")
        su = port_twin(DRIVERS[part][0])
        for k, (e, lim) in obs_errors(part, su, ref).items():
            print(f"roms_tpu_torch (CPU): {k:28s} {e:.3e} (bound {lim:g})")
    if "bry" in parts:
        cfg, d, adj = port_bry()
        for k, (e, lim) in bry_errors(cfg, d, adj, ref).items():
            print(f"roms_tpu_torch (CPU): {k:28s} {e:.3e} (bound {lim:g})")


def port_benchmark_tlm(ref, device="cpu"):
    """torch.func.jvp of one step of the benchmark part, with the seeded
    tangent on PROGNOSTIC and zero on the other fields: (cfg, {field:
    tangent out}), BENCH_FIELDS read from it."""
    import torch
    from roms_tpu_torch import fourdvar
    cfg, grid, s, ffn = port_benchmark(ref, device)
    f, x = fourdvar.step_map(cfg, grid, s, ffn)
    kw = dict(dtype=grid.h.dtype, device=device)
    dx = {k: torch.zeros_like(v) for k, v in x.items()}
    dx.update({k: torch.as_tensor(v, **kw) for k, v in
               tangent(shapes_of(s, PROGNOSTIC), 3).items()})
    _, jdx = torch.func.jvp(f, (x,), (dx,))
    return cfg, jdx


def benchmark_errors(cfg, jdx, ref, factor=1.0) -> dict:
    """The port's TLM of one small-BENCHMARK step (port_benchmark_tlm)
    against the fixture: {name: (rel_err, bound)}."""
    e = per_field_errors(cfg, jdx, lambda k: ref[k], BENCH_FIELDS,
                         "benchmark/jvp")
    return {k: (v, factor * BOUNDS["benchmark"]) for k, v in e.items()}


def obs_errors(part: str, su, ref, factor=1.0) -> dict:
    """The port's own truth-run observations of a driver part against
    roms_tpu's."""
    obs = su[4]
    return {f"{part}/obs{i}": (rel_err(o.values.detach().cpu().numpy(),
                                       ref[f"{part}/obs{i}"]),
                               factor * BOUNDS["obs"])
            for i, o in enumerate(obs)}


def bry_errors(cfg, d, adj, ref, factor=1.0) -> dict:
    got = bry_outputs(cfg, d, adj)
    return {f"bry/{k}": (rel_err(v, ref[f"bry/{k}"]),
                         factor * BOUNDS["bry"]) for k, v in got.items()}


def main() -> int:
    sys.path.insert(0, ROOT)
    import jax
    jax.config.update("jax_enable_x64", True)
    if "--report" in sys.argv[1:]:
        report()
        return 0
    args = sys.argv[1:]
    path = OUT
    if "--out" in args:
        i = args.index("--out")
        path = args[i + 1]
        args = args[:i] + args[i + 2:]
    parts = [p for p in args if p in PARTS] or list(PARTS)
    out = {}
    if os.path.exists(path) and set(parts) != set(PARTS):
        old = np.load(path)
        out = {k: old[k] for k in old.files
               if k.split("/")[0] not in parts}
    for part in parts:
        if part == "autodiff":
            ref_autodiff(out)
        elif part == "benchmark":
            ref_benchmark(out)
        elif part == "bry":
            ref_bry(out)
        else:
            ref_driver(out, part)
        print(f"{part}: done", flush=True)
    np.savez_compressed(path, **out)
    print(f"wrote {path} ({os.path.getsize(path)} bytes)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
