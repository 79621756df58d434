"""roms_tpu_torch: whole steps of the regional cases on the CPU.

(a) three float64 steps of a small KELVIN, ESTUARY_TEST and RIVERPLUME1
    reproduce tests/data/torch_regional_small.npz, written by
    scripts/torch_regional_fixture.py from roms_tpu's eager step, at the
    bounds that script states (no JAX run here), and leave the caller's
    state and boundary data unchanged;
(b) the step's dispatch on each case takes each kernel wrapper exactly
    where roms_tpu's step takes its Pallas kernel (the JAX gates asked with
    the case's bry/sources, as under ROMS_PALLAS_INTERPRET), and the
    general plain stages everywhere else;
(c) the branches still missing raise NotImplementedError naming them.
"""

import dataclasses

import numpy as np
import pytest
import torch

from roms_tpu.ops import diag_pallas, mix3d_pallas, prsgrd_pallas, \
    rhs3d_pallas, step2d_pallas, step3d_pallas
from roms_tpu_torch import stepping
from roms_tpu_torch.models import cases as tcases
from roms_tpu_torch.ops import diag_cuda, mix3d_cuda, prsgrd_cuda, \
    rhs3d_cuda, step2d, step2d_cuda, step3d_cuda
from chip_smoke import regional_fixture_script
from test_torch_obc import jax_config

torch.set_num_threads(1)

fixture = regional_fixture_script()
CASES = tuple(fixture.CASES)


def _build(case, **change):
    kw = dict(fixture.CASES[case], **change)
    return getattr(tcases, case)(getattr(tcases, case + "_config")(**kw),
                                 device="cpu")


@pytest.mark.parametrize("case", CASES)
def test_small_case_matches_fixture(case):
    """At the bounds scripts/torch_regional_fixture.py states."""
    ref = np.load(fixture.OUT)
    cfg, grid, s0, ffn = _build(case)
    keep = {k: v.clone() for k, v in vars(s0).items()
            if isinstance(v, torch.Tensor)}
    frc0 = ffn(cfg, grid, s0.time)
    bry_keep = {k: v.clone() for k, v in frc0.get("bry", {}).items()}
    s = stepping.run(cfg, grid, s0, fixture.NSTEPS, ffn)
    assert (s.iic, s.time) == (int(ref[f"{case}/iic"]),
                               float(ref[f"{case}/time"]))
    errors = fixture.errors(case, cfg, s0, s, ref)
    bad = {k: e for k, e in errors.items() if not e[0] <= e[1]}
    assert not bad, bad
    for k, v in keep.items():
        assert torch.equal(getattr(s0, k), v), k
    for k, v in frc0.get("bry", {}).items():
        assert torch.equal(v, bry_keep[k]), k


# which of the eleven kernel functions each case's step takes (all gates
# true on UPWELLING and BENCHMARK1)
EXPECTED = {
    "kelvin": {"grid_flux", "eos", "omega", "momentum_rhs"},
    "estuary": {"grid_flux", "eos", "omega", "momentum_rhs"},
    "riverplume": {"grid_flux", "eos", "omega", "momentum_rhs",
                   "t3dmix2_geo"},
}


@pytest.mark.parametrize("case", CASES)
def test_dispatch_mirrors_jax_gates(case, monkeypatch):
    cfg, grid, s0, ffn = _build(case)
    frc = ffn(cfg, grid, s0.time)
    bry, sources = frc.get("bry"), frc.get("sources")
    monkeypatch.setenv("ROMS_PALLAS_INTERPRET", "1")
    cfg_j = jax_config(cfg)
    jbry = {} if bry is not None else None
    jsrc = () if sources is not None else None
    port = {
        "grid_flux": cfg.pallas2d and diag_cuda.supported(cfg, grid),
        "momentum_rhs": rhs3d_cuda.use_kernels(cfg),
        "prsgrd32": prsgrd_cuda.supported(cfg),
        "mix": mix3d_cuda.use_kernels(cfg),
        "tracer": step3d_cuda.use_tracer(cfg, bry=bry, sources=sources),
        "uv": step3d_cuda.use_uv(cfg, bry=bry, sources=sources),
        "fast_loop": cfg.pallas2d and step2d_cuda.supported(cfg, bry,
                                                            sources),
    }
    ref = {
        "grid_flux": diag_pallas.use_pallas(cfg_j),
        "momentum_rhs": rhs3d_pallas.use_pallas(cfg_j),
        "prsgrd32": prsgrd_pallas.use_pallas(cfg_j),
        "mix": mix3d_pallas.use_pallas(cfg_j),
        "tracer": step3d_pallas.use_tracer_pallas(cfg_j, bry=jbry,
                                                  sources=jsrc),
        "uv": step3d_pallas.use_uv_pallas(cfg_j, bry=jbry, sources=jsrc),
        "fast_loop": step2d_pallas.use_pallas(cfg_j, jbry, jsrc),
    }
    assert port == ref
    assert not (port["tracer"] or port["uv"] or port["fast_loop"])

    # the calls one step makes: the kernel wrappers of the table, the
    # plain stages of the rest
    calls = []
    sites = [(diag_cuda, "grid_flux"), (diag_cuda, "eos"),
             (diag_cuda, "omega"), (rhs3d_cuda, "momentum_rhs"),
             (mix3d_cuda, "t3dmix2_geo"), (step2d_cuda, "fast_loop"),
             (step2d, "fast_loop"), (step3d_cuda, "tracer_predictor"),
             (step3d_cuda, "tracer_predictor_plain"),
             (step3d_cuda, "uv_corrector"),
             (step3d_cuda, "uv_corrector_plain"),
             (step3d_cuda, "tracer_corrector"),
             (step3d_cuda, "tracer_corrector_plain")]
    for mod, attr in sites:
        fn = getattr(mod, attr)

        def rec(*a, _fn=fn, _name=f"{mod.__name__.split('.')[-1]}.{attr}",
                **k):
            calls.append(_name)
            return _fn(*a, **k)
        monkeypatch.setattr(mod, attr, rec)
    stepping.step(cfg, grid, s0, ffn)
    kernels = {c.split(".")[1] for c in calls if c.startswith(("diag_cuda",
                                                               "rhs3d_cuda",
                                                               "mix3d_cuda"))}
    assert kernels == EXPECTED[case]
    assert sorted(c for c in calls if not c.startswith(
        ("diag_cuda", "rhs3d_cuda", "mix3d_cuda"))) == sorted([
            "step2d.fast_loop", "step3d_cuda.tracer_predictor_plain",
            "step3d_cuda.uv_corrector_plain",
            "step3d_cuda.tracer_corrector_plain"])


@pytest.mark.parametrize("change, frc, feature", [
    (dict(bodyforce=True), {}, "BODYFORCE"),
    (dict(nearshore="mellor05"), {}, "nearshore radiation stress"),
    ({}, {"Uwind": 0.0}, "forcing fields"),
    (dict(biology="npzd_powell"), {}, "biology"),
])
def test_unported_branches_raise(change, frc, feature):
    cfg, grid, s0, ffn = _build("kelvin")
    cfg = dataclasses.replace(cfg, **change)

    def forcing(cfg_, grid_, time):
        return {**ffn(cfg_, grid_, time), **frc}

    with pytest.raises(NotImplementedError, match=feature):
        stepping.step(cfg, grid, s0, forcing)
