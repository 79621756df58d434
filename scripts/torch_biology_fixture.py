"""Write tests/data/torch_biology_small.npz: roms_tpu's biology, the
reference that roms_tpu_torch's eight biology models and the biology slot
of its step are held to (tests/test_torch_bio_models.py,
tests/test_torch_bio_cases.py, chip_smoke.py):

  steps    three float64 steps of roms_tpu's eager step on
           bio_toy       BIO_TOY at 6 x 8 x 10 (tests/test_biology.py's
                         size), NPZD Powell under CONST_PAR;
           fennel        Fennel's 7 core compartments (9 tracers) on the
                         same grid (tests/test_bio_models.py:149);
           ecosim        the reduced EcoSim, 2 + 20 = 22 tracers, on the
                         same grid under 150 W/m2 (test_bio_models.py:446);
  models   the source terms of the models whose jitted roms_tpu function
           takes seconds to compile (Fennel with oxygen and carbon, with
           and without denitrification; NEMURO; EcoSim) on the seeded
           inputs of MODELS, eager.

    JAX_PLATFORMS=cpu python scripts/torch_biology_fixture.py [--report]

Importing this file runs nothing and imports no jax: ``STEP_CASES``,
``build_port``, ``run_port`` and ``errors`` hold a roms_tpu_torch run to
the fixture, ``MODELS``, ``model_inputs`` and ``call_model`` give a
model's seeded inputs and call it in either package, with the bounds
stated here.  ``--report`` writes nothing and prints the measurements the
bounds rest on: roms_tpu's own change when every initial tracer value
moves up by one ulp, and when its steps are jitted, and roms_tpu_torch's
CPU errors against the fixture.

Stored under "<case>/<key>": for a step case the repr of roms_tpu's
finished Config ("config"), the interior of the initial tracers
("t_initial") and of every field the step writes after the last step,
"time" and "iic"; for a model the full (NT,N,Ny,Nx) output ("out").
"""

from __future__ import annotations

import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, "tests", "data", "torch_biology_small.npz")
NSTEPS = 3
# the small grid of tests/test_biology.py and test_bio_models.py:149
SIZE = dict(Lm=6, Mm=8, N=10)
STEP_CASES = ("bio_toy", "fennel", "ecosim")
FIELDS = ("zeta", "ubar", "vbar", "u", "v", "t", "ru_prev", "rv_prev",
          "rufrc0_prev", "rvfrc0_prev", "rzeta", "rubar", "rvbar",
          "DU_avg1", "DV_avg1", "DU_avg2", "DV_avg2")
# Pointwise bound on |port - fixture| on the CPU, times max|field| (each
# tracer against its own), by case and field (BOUND when not listed);
# every number below is printed by --report.  roms_tpu_torch on the CPU
# measures at most 1.3e-14 (rzeta, the three cases alike), the tracers at
# most 3.2e-16; roms_tpu itself moves rzeta by 1.2e-9 and zeta by 1.4e-10
# when every initial tracer value moves up one ulp (the first steps from
# rest are ill-conditioned in zeta and its rhs), the tracers by at most
# 1.4e-15 (EcoSim's NO3).
BOUND = 1e-12
BOUND_OF: dict = {}
# A velocity-like field is measured against the larger of its own and its
# partner's max (a field at round-off would blow its own max up).
PARTNER = {"vbar": "ubar", "v": "u", "rv_prev": "ru_prev",
           "rvfrc0_prev": "rufrc0_prev", "rvbar": "rubar",
           "DV_avg1": "DU_avg1", "DV_avg2": "DU_avg2"}
PARTNER.update({b: a for a, b in PARTNER.items()})
FLOOR: dict = {}
# chip_smoke.py measures each tracer against its own max
PER_TRACER = True

# The model source terms, each on the seeded inputs of model_inputs: the
# model, its bio tracers' typical values (each drawn within 0.5-1.5x),
# its parameters, and whether the test reads roms_tpu's output from the
# fixture (True: its jitted function compiles for seconds) or jits it.
MODELS = {
    "npzd_powell": ("npzd_powell", (1.67, 0.08, 0.06, 0.04),
                    dict(wPhy=3.0), False),
    "npzd_franks": ("npzd_franks", (1.67, 0.08, 0.06, 0.04), {}, False),
    "npzd_iron": ("npzd_iron", (17.0, 1.0, 1.0, 1.0, 0.06, 0.01),
                  dict(iron_relax=True), False),
    "fennel": ("fennel", (10.0, 0.5, 0.1, 0.5, 0.3, 0.1, 0.1),
               dict(wPhy=5.0, wSDet=5.0, wLDet=20.0), False),
    "fennel_po4_denit": ("fennel", (10.0, 0.5, 0.1, 0.5, 0.3, 0.1, 0.1,
                                    1.0),
                         dict(po4=True, denitrification=True, wPhy=5.0,
                              wSDet=5.0, wLDet=20.0), False),
    "fennel_oxygen_carbon": ("fennel", (10.0, 1.0, 0.5, 1.0, 0.5, 0.5, 0.5,
                                        0.5, 0.5, 2300.0, 2300.0, 100.0),
                             dict(oxygen=True, carbon=True), True),
    "fennel_oxygen_carbon_denit": (
        "fennel", (10.0, 1.0, 0.5, 1.0, 0.5, 0.5, 0.5, 0.5, 0.5, 2300.0,
                   2300.0, 100.0),
        dict(oxygen=True, carbon=True, denitrification=True,
             talk_nonconserv=True), True),
    "hypoxia_srm": ("hypoxia_srm", (100.0,), {}, False),
    "nemuro": ("nemuro", (0.2, 0.2, 0.05, 0.05, 0.02, 5.0, 0.5, 0.1, 0.2,
                          10.0, 0.1), {}, True),
    "red_tide_winter": ("red_tide", (100.0,), dict(wDino=2.0), False),
    "red_tide_spring": ("red_tide", (100.0,), dict(wDino=2.0), False),
    "ecosim": ("ecosim", (8.0, 0.5, 0.6, 6.0, 2100.0, 1.0, 0.12, 0.008, 0.3,
                          1.0, 0.12, 0.008, 0.15, 0.3, 0.5, 10.0, 1.0, 2.0,
                          0.5, 0.06), {}, True),
}
# the year-days of the red-tide cases: one after mid-December (the
# December-January wrap) and one inside the monthly table
YDAY = {"red_tide_winter": 359.0, "red_tide_spring": 100.0}
MODEL_SHAPE = (10, 5, 6)      # N, Ny, Nx of the model inputs
MODEL_DT = 3600.0
# |port - roms_tpu| of a model's output on the CPU, times max|output| of
# each tracer (--report prints the measurements)
MODEL_BOUND = 1e-12
PARAMS = {"npzd_powell": "NPZDParams", "npzd_franks": "FranksParams",
          "npzd_iron": "IronParams", "fennel": "FennelParams",
          "hypoxia_srm": "HypoxiaParams", "nemuro": "NemuroParams",
          "red_tide": "RedTideParams", "ecosim": "EcosimParams"}


def model_inputs(name: str) -> dict:
    """The seeded numpy inputs of model `name`: t (NT,N,Ny,Nx) with
    temperature, salinity and the bio tracers (a few negative values for
    the positive-definite fill), Hz, z_w, z_r of uneven layers, srflx
    (kinematic, night in two columns), the 10 m winds, the respiration
    rate, the cyst map, the DIN climatology, the bathymetry and yday."""
    model, ini, _, _ = MODELS[name]
    rng = np.random.default_rng(sorted(MODELS).index(name) + 11)
    N, Ny, Nx = MODEL_SHAPE
    hz = rng.uniform(1.0, 8.0, (N, Ny, Nx))
    z_w = np.concatenate([-hz.sum(0)[None],
                          -hz.sum(0)[None] + np.cumsum(hz, 0)])
    t = np.empty((2 + len(ini), N, Ny, Nx))
    t[0] = rng.uniform(5.0, 25.0, (N, Ny, Nx))
    t[1] = rng.uniform(30.0, 36.0, (N, Ny, Nx))
    for i, v in enumerate(ini):
        t[2 + i] = v * rng.uniform(0.5, 1.5, (N, Ny, Nx))
    if model in ("npzd_powell", "ecosim"):
        t[2, :2, 0, 0] = -0.01          # a deficit to draw from the rest
    srflx = rng.uniform(0.0, 400.0, (Ny, Nx)) / (1025.0 * 3985.0)
    srflx[0, :2] = 0.0
    return dict(t=t, Hz=z_w[1:] - z_w[:-1], z_w=z_w,
                z_r=0.5 * (z_w[1:] + z_w[:-1]), srflx=srflx,
                uwind=rng.uniform(2.0, 10.0, (Ny, Nx)),
                vwind=rng.uniform(-3.0, 3.0, (Ny, Nx)),
                respiration=rng.uniform(1.0, 20.0, (N, Ny, Nx)),
                cysts=rng.uniform(100.0, 2000.0, (Ny, Nx)),
                din=rng.uniform(0.0, 20.0, (N, Ny, Nx)),
                h=rng.uniform(50.0, 400.0, (Ny, Nx)),
                yday=YDAY.get(name, 0.0))


class _Grid:
    """The grid fields a model reads: h (IRON_RELAX), no land mask."""
    rmask = None

    def __init__(self, h):
        self.h = h


def model_config(name: str, bio_toy):
    """The configuration of model `name` from either package's
    models/bio_toy (its biology parameters aside): BIO_TOY's with 2 + the
    model's bio tracers, DT MODEL_DT."""
    model, ini, _, _ = MODELS[name]
    nt = 2 + len(ini)
    cfg = bio_toy.make_config(Lm=MODEL_SHAPE[2], Mm=MODEL_SHAPE[1],
                              N=MODEL_SHAPE[0])
    return cfg.replace(ntracers=nt, ibio=tuple(range(2, nt)),
                       t_hadv=nt * ("U3",), t_vadv=nt * ("C4",),
                       tnu2=nt * (0.0,), dt=MODEL_DT, biology=model)


def call_model(name: str, biology, bio_models, bio_toy, arr, yday):
    """Model `name`'s source term in either package (its ops.biology,
    ops.bio_models and models.bio_toy modules) on the inputs `arr`
    ({key: array in that package}) at year-day `yday` (that package's
    form); returns the new tracer stack."""
    model, _, kw, _ = MODELS[name]
    mod = biology if model == "npzd_powell" else bio_models
    p = getattr(mod, PARAMS[model])(**kw)
    cfg = model_config(name, bio_toy).replace(bio_params=p)
    t, Hz, z_w, z_r, srf = (arr[k] for k in ("t", "Hz", "z_w", "z_r",
                                               "srflx"))
    g = _Grid(arr["h"])
    if model == "npzd_powell":
        return mod.npzd_powell(cfg, p, t, t, Hz, z_w, srf)
    if model == "npzd_franks":
        return mod.npzd_franks(cfg, p, t, t, Hz, z_w, z_r, srf)
    if model == "npzd_iron":
        return mod.npzd_iron(cfg, p, g, t, t, Hz, z_w, srf)
    if model == "fennel":
        return mod.fennel(cfg, p, g, t, t, Hz, z_w, srf,
                          uwind=arr["uwind"], vwind=arr["vwind"])
    if model == "hypoxia_srm":
        return mod.hypoxia_srm(cfg, p, g, t, t, Hz, z_w, srf,
                               uwind=arr["uwind"], vwind=arr["vwind"],
                               respiration=arr["respiration"])
    if model == "nemuro":
        return mod.nemuro(cfg, p, t, t, Hz, z_w, srf)
    if model == "red_tide":
        return mod.red_tide(cfg, p, t, t, Hz, z_w, z_r, srf, yday,
                            cyst_ini=arr["cysts"], din_obs=arr["din"])
    return mod.ecosim(cfg, p, t, t, Hz, z_w, srf)


def port_model(name: str, device="cpu"):
    """roms_tpu_torch's output of model `name` on its inputs (float64, on
    `device`), as a numpy array."""
    import torch
    from roms_tpu_torch.models import bio_toy
    from roms_tpu_torch.ops import bio_models, biology
    arr = {k: torch.tensor(v, device=device) if isinstance(v, np.ndarray)
           else v for k, v in model_inputs(name).items()}
    return call_model(name, biology, bio_models, bio_toy, arr,
                      arr["yday"]).cpu().numpy()


def reference_model(name: str, jit: bool = False):
    """roms_tpu's output of model `name` (imports jax)."""
    import jax
    import jax.numpy as jnp
    from roms_tpu.models import bio_toy
    from roms_tpu.ops import bio_models, biology
    inp = model_inputs(name)
    yday = jnp.asarray(inp.pop("yday"))

    def run(arr):
        return call_model(name, biology, bio_models, bio_toy, arr, yday)
    arr = {k: jnp.asarray(v) for k, v in inp.items()}
    return np.asarray(jax.jit(run)(arr) if jit else run(arr))


def model_errors(name: str, got, want) -> np.ndarray:
    """|got - want| / max|want| of each tracer of a model's output."""
    scale = np.abs(want).reshape(len(want), -1).max(1)
    err = np.abs(got - want).reshape(len(want), -1).max(1)
    return err / np.maximum(scale, 1e-300)


# ---------------------------------------------------------------------
# the step cases
# ---------------------------------------------------------------------

def build_port(case: str, device="cpu", dtype="float64"):
    """roms_tpu_torch's (cfg, grid, state0, forcing_fn) of `case`."""
    from roms_tpu_torch.models import bio_toy
    if case == "bio_toy":
        return bio_toy.build(bio_toy.make_config(dtype=dtype, **SIZE),
                             device=device)
    return bio_toy.build_model(case, bio_toy.model_config(
        case, dtype=dtype, **SIZE), device=device)


def run_port(case: str, cfg, grid, s0, ffn):
    from roms_tpu_torch import stepping
    return stepping.run(cfg, grid, s0, NSTEPS, ffn)


def build_reference(case: str):
    """roms_tpu's case (imports jax): BIO_TOY from its builder; Fennel and
    EcoSim as roms_tpu_torch's models/bio_toy.build_model sets them up on
    UPWELLING, from roms_tpu's configuration and builder."""
    import jax.numpy as jnp
    from roms_tpu.constants import Cp, rho0_default
    from roms_tpu.models import bio_toy, upwelling
    from roms_tpu.ops import bio_models
    from roms_tpu.state import initial_state
    if case == "bio_toy":
        return bio_toy.build(bio_toy.make_config(**SIZE))
    if case == "fennel":
        p, ini, par = bio_models.FennelParams(const_par=158.075), \
            (10.0, 0.5, 0.1, 0.5, 0.3, 0.1, 0.1), None
    else:
        p, ini, par = bio_models.EcosimParams(), \
            (8.0, 0.5, 0.6, 6.0, 2100.0, 1.0, 0.12, 0.008, 0.3, 1.0, 0.12,
             0.008, 0.15, 0.3, 0.5, 10.0, 1.0, 2.0, 0.5, 0.06), 150.0
    nt = 2 + len(ini)
    cfg_uw, grid, s_uw, ffn0 = upwelling.build(upwelling.make_config(**SIZE))
    cfg = cfg_uw.replace(
        name=case, ntracers=nt, t_hadv=nt * ("U3",), t_vadv=nt * ("C4",),
        tnu2=nt * (0.0,), akt_bak=(1e-6, 1e-6), biology=case,
        ibio=tuple(range(2, nt)), bio_params=p)
    bio = jnp.stack([jnp.full_like(s_uw.t[0], v) for v in ini])
    s0 = initial_state(cfg, zeta=s_uw.zeta,
                       t=jnp.concatenate([s_uw.t, bio], axis=0))

    def ffn(cfg_, grid_, time):
        frc = dict(ffn0(cfg_, grid_, time))
        if par is not None:
            frc["srflx"] = par / (rho0_default * Cp) * jnp.ones_like(
                grid_.h)
        return frc
    return cfg, grid, s0, ffn


def run_reference(case: str, cfg, grid, s, ffn):
    """roms_tpu's eager steps from s."""
    from roms_tpu import stepping
    for _ in range(NSTEPS):
        s = stepping.step(cfg, grid, s, ffn)
    return s


def _interior(cfg, a):
    H = cfg.halo
    return np.asarray(a)[..., H:H + cfg.Mm, H:H + cfg.Lm]


def fields_of(case: str) -> tuple:
    """The fields the fixture holds for `case`."""
    return FIELDS


def errors(case: str, cfg, s0, s, ref, factor: float = 1.0) -> dict:
    """{field: (|port - fixture| / max|fixture field|, bound)} of a
    roms_tpu_torch run of `case` from s0 to s against the loaded fixture
    `ref`, every bound times `factor`; the tracers each against their own
    max ("t[<n>]")."""
    def interior(a):
        return _interior(cfg, a.cpu().numpy())

    out = {}
    for name in ("t_initial",) + fields_of(case):
        got = interior(s0.t if name == "t_initial" else getattr(s, name))
        want = ref[f"{case}/{name}"]
        bound = factor * BOUND_OF.get((case, name), BOUND)
        if name in ("t", "t_initial"):
            for n in range(len(want)):
                scale = max(np.abs(want[n]).max(), 1e-300)
                out[f"{name}[{n}]"] = (
                    float(np.abs(got[n] - want[n]).max() / scale), bound)
            continue
        scale = np.abs(want).max()
        if name in PARTNER:
            scale = max(scale, np.abs(ref[f"{case}/{PARTNER[name]}"]).max())
        scale = max(scale, FLOOR.get((case, name), 0.0))
        out[name] = (float(np.abs(got - want).max() / max(scale, 1e-300)),
                     bound)
    return out


def _rel_change(cfg, a, b) -> dict:
    """{field: max|a - b| / max|a|}, the tracers each against their own
    max, a velocity-like field against its partner's max too."""
    out = {}
    for name in FIELDS:
        x = _interior(cfg, getattr(a, name))
        y = _interior(cfg, getattr(b, name))
        if name == "t":
            for n in range(len(x)):
                out[f"t[{n}]"] = float(np.abs(x[n] - y[n]).max() /
                                       max(np.abs(x[n]).max(), 1e-300))
            continue
        scale = np.abs(x).max()
        if name in PARTNER:
            scale = max(scale, np.abs(_interior(
                cfg, getattr(a, PARTNER[name]))).max())
        out[name] = float(np.abs(x - y).max() / max(scale, 1e-300))
    return out


def _spread(case: str) -> dict:
    """roms_tpu's change after the steps when every initial tracer value
    moves up by one ulp."""
    import jax.numpy as jnp
    cfg, grid, s0, ffn = build_reference(case)
    up = jnp.asarray(np.nextafter(np.asarray(s0.t), np.inf))
    a = run_reference(case, cfg, grid, s0, ffn)
    b = run_reference(case, cfg, grid, s0.replace(t=up, t_prev=up), ffn)
    return _rel_change(cfg, a, b)


def _jit_spread(case: str) -> dict:
    """roms_tpu's jitted steps against its eager ones."""
    import jax
    from roms_tpu import stepping
    cfg, grid, s0, ffn = build_reference(case)
    a = run_reference(case, cfg, grid, s0, ffn)
    step = jax.jit(lambda s: stepping.step(cfg, grid, s, ffn))
    b = s0
    for _ in range(NSTEPS):
        b = step(b)
    return _rel_change(cfg, a, b)


def _model_spread(name: str) -> np.ndarray:
    """roms_tpu's change of model `name`'s output when every input tracer
    moves up by one ulp, per tracer against its max."""
    import jax.numpy as jnp
    from roms_tpu.models import bio_toy
    from roms_tpu.ops import bio_models, biology
    inp = model_inputs(name)
    yday = jnp.asarray(inp.pop("yday"))
    arr = {k: jnp.asarray(v) for k, v in inp.items()}
    a = np.asarray(call_model(name, biology, bio_models, bio_toy, arr, yday))
    arr["t"] = jnp.asarray(np.nextafter(inp["t"], np.inf))
    b = np.asarray(call_model(name, biology, bio_models, bio_toy, arr, yday))
    return model_errors(name, b, a)


def report() -> None:
    """Print the measurements the bounds of this file rest on."""
    import torch
    ref = np.load(OUT)
    torch.set_num_threads(1)
    for name in MODELS:
        got = port_model(name)
        want = ref[f"{name}/out"] if MODELS[name][3] else \
            reference_model(name, jit=True)
        print(f"model {name}: roms_tpu, inputs one ulp up: worst "
              f"{_model_spread(name).max():.3e}; roms_tpu_torch (CPU) "
              f"against roms_tpu{'' if MODELS[name][3] else ' (jitted)'}: "
              f"worst {model_errors(name, got, want).max():.3e} x "
              f"max|tracer| (bound {MODEL_BOUND:g})", flush=True)
    cases = [c for c in sys.argv[1:] if c in STEP_CASES] or list(STEP_CASES)
    for case in cases:
        for key, e in _spread(case).items():
            print(f"{case}: roms_tpu, initial values one ulp up: "
                  f"{key:12s} {e:.3e} x max|field|")
        for key, e in _jit_spread(case).items():
            print(f"{case}: roms_tpu, jitted against eager: "
                  f"{key:12s} {e:.3e} x max|field|")
        tcfg, tgrid, t0, tffn = build_port(case)
        t = run_port(case, tcfg, tgrid, t0, tffn)
        for key, (err, lim) in errors(case, tcfg, t0, t, ref).items():
            print(f"{case}: roms_tpu_torch (CPU) against the fixture: "
                  f"{key:12s} {err:.3e} x max|field| (bound {lim:g})")


def main() -> int:
    sys.path.insert(0, ROOT)
    import jax
    jax.config.update("jax_enable_x64", True)

    if "--report" in sys.argv[1:]:
        report()
        return 0
    out = {}
    for name, (_, _, _, stored) in MODELS.items():
        if stored:
            out[f"{name}/out"] = reference_model(name)
    for case in STEP_CASES:
        cfg, grid, s, ffn = build_reference(case)
        out[f"{case}/config"] = np.asarray(repr(cfg))
        out[f"{case}/t_initial"] = _interior(cfg, s.t)
        s = run_reference(case, cfg, grid, s, ffn)
        for name in FIELDS:
            out[f"{case}/{name}"] = _interior(cfg, getattr(s, name))
        out[f"{case}/time"] = np.asarray(float(s.time))
        out[f"{case}/iic"] = np.asarray(int(s.iic))
        print(f"{case}: done", flush=True)
    np.savez_compressed(OUT, **out)
    print(f"wrote {OUT} ({os.path.getsize(OUT)} bytes)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
