"""roms_tpu_torch: whole steps of the coastal path on the CPU.

(a) three float64 steps of a small LAB_CANYON (polar annulus, north-south
    periodic), INLET_TEST and TEST_HEAD (wetting-drying and an
    open-boundary tide on grid files that scripts/torch_coastal_fixture.py
    writes) and BENCHMARK with the tide-generating force reproduce
    tests/data/torch_coastal_small.npz, written by that script from
    roms_tpu's eager step, at the bounds it states (no JAX run here);
(b) the step's dispatch on each case takes each kernel wrapper exactly
    where roms_tpu's step takes its Pallas kernel (the JAX gates asked as
    under ROMS_PALLAS_INTERPRET), and the general plain stages elsewhere;
(c) LAB_CANYON's physics and BENCHMARK's tidal response, as
    tests/test_cases4.py and tests/test_tides_avg.py check roms_tpu;
(d) the branches still missing raise NotImplementedError naming them.
"""

import dataclasses

import numpy as np
import pytest
import torch

from roms_tpu.ops import diag_pallas, mix3d_pallas, prsgrd_pallas, \
    rhs3d_pallas, step2d_pallas, step3d_pallas
from roms_tpu_torch import stepping
from roms_tpu_torch.models import cases4
from roms_tpu_torch.ops import bc, diag_cuda, mix3d_cuda, prsgrd_cuda, \
    rhs3d_cuda, step2d, step2d_cuda, step3d_cuda
from chip_smoke import coastal_fixture_script
from test_torch_obc import jax_config

torch.set_num_threads(1)

fx = coastal_fixture_script()
CASES = tuple(fx.CASES)


@pytest.fixture(scope="module")
def tmp(tmp_path_factory):
    return str(tmp_path_factory.mktemp("coastal"))


@pytest.mark.parametrize("case", CASES)
def test_small_case_matches_fixture(case, tmp):
    """At the bounds scripts/torch_coastal_fixture.py states; the caller's
    state is left unchanged."""
    ref = np.load(fx.OUT)
    cfg, grid, s0, ffn = fx.build_port(case, tmp)
    keep = {k: v.clone() for k, v in vars(s0).items()
            if isinstance(v, torch.Tensor)}
    s = stepping.run(cfg, grid, s0, fx.NSTEPS, ffn)
    assert (s.iic, s.time) == (int(ref[f"{case}/iic"]),
                               float(ref[f"{case}/time"]))
    errors = fx.errors(case, cfg, s0, s, ref)
    bad = {k: e for k, e in errors.items() if not e[0] <= e[1]}
    assert not bad, bad
    for k, v in keep.items():
        assert torch.equal(getattr(s0, k), v), k


# the kernel wrappers each case's step takes, and the plain general stages
_ALL = {"grid_flux", "eos", "omega", "momentum_rhs", "tracer_predictor",
        "tracer_corrector", "uv_corrector", "fast_loop"}
_FILE = ({"grid_flux", "eos", "omega", "prsgrd32", "uv3dmix2"},
         {"step2d.fast_loop", "step3d_cuda.tracer_predictor_plain",
          "step3d_cuda.uv_corrector_plain",
          "step3d_cuda.tracer_corrector_plain"})
EXPECTED = {"lab_canyon": (_ALL, set()), "tide": (_ALL, set()),
            "inlet_test": _FILE, "test_head": _FILE}


@pytest.mark.parametrize("case", CASES)
def test_dispatch_mirrors_jax_gates(case, tmp, monkeypatch):
    cfg, grid, s0, ffn = fx.build_port(case, tmp)
    bry = (ffn(cfg, grid, s0.time) if ffn else {}).get("bry")
    monkeypatch.setenv("ROMS_PALLAS_INTERPRET", "1")
    cfg_j = jax_config(cfg)
    jbry = {} if bry is not None else None
    port = {
        "grid_flux": cfg.pallas2d and diag_cuda.supported(cfg, grid),
        "momentum_rhs": rhs3d_cuda.use_kernels(cfg),
        "prsgrd32": prsgrd_cuda.supported(cfg),
        "mix": mix3d_cuda.use_kernels(cfg),
        "tracer": step3d_cuda.use_tracer(cfg, bry=bry),
        "uv": step3d_cuda.use_uv(cfg, bry=bry),
        "fast_loop": cfg.pallas2d and step2d_cuda.supported(cfg, bry),
    }
    ref = {
        "grid_flux": diag_pallas.use_pallas(cfg_j),
        "momentum_rhs": rhs3d_pallas.use_pallas(cfg_j),
        "prsgrd32": prsgrd_pallas.use_pallas(cfg_j),
        "mix": mix3d_pallas.use_pallas(cfg_j),
        "tracer": step3d_pallas.use_tracer_pallas(cfg_j, bry=jbry),
        "uv": step3d_pallas.use_uv_pallas(cfg_j, bry=jbry),
        "fast_loop": step2d_pallas.use_pallas(cfg_j, jbry),
    }
    assert port == ref
    # wetting-drying refuses the fused loop and its masks the uv kernel,
    # as in roms_tpu; the tracer kernels do not look at cfg.wetdry
    if cfg.wetdry:
        nobry = dataclasses.replace(cfg, lbc_zeta=cfg.lbc_u,
                                    lbc_ubar=cfg.lbc_u, lbc_vbar=cfg.lbc_u,
                                    lbc_t=cfg.lbc_u.__class__())
        assert not step2d_cuda.supported(nobry)
        assert step2d_cuda.supported(dataclasses.replace(nobry,
                                                         wetdry=False))
        assert not step3d_cuda.use_uv(nobry, wet={})
        assert step3d_cuda.use_tracer(nobry) == \
            step3d_pallas.use_tracer_pallas(jax_config(nobry))

    # the calls the step makes itself (a wrapper on CPU tensors calls its
    # plain version in turn, which is not recorded)
    calls, depth = [], [0]
    sites = [(diag_cuda, "grid_flux"), (diag_cuda, "eos"),
             (diag_cuda, "omega"), (rhs3d_cuda, "momentum_rhs"),
             (prsgrd_cuda, "prsgrd32"), (mix3d_cuda, "uv3dmix2"),
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
            if not depth[0]:
                calls.append(_name)
            depth[0] += 1
            try:
                return _fn(*a, **k)
            finally:
                depth[0] -= 1
        monkeypatch.setattr(mod, attr, rec)
    stepping.step(cfg, grid, s0, ffn)
    kernels, plain = EXPECTED[case]
    assert {c.split(".")[1] for c in calls if "cuda." in c and
            not c.endswith("_plain")} == kernels
    assert {c for c in calls if "cuda." not in c or
            c.endswith("_plain")} == plain
    assert len(calls) == len(kernels) + len(plain)


def test_lab_canyon_physics():
    """tests/test_cases4.py's LAB_CANYON checks on the same 24x48x6 grid:
    the stratified rest state stays nearly at rest for 20 steps (|u|, |v|
    < 2e-3 m/s), angler spans (-3, 3), and a constant tracer under a
    free-surface bump stays within 2e-5 of its value for 10 steps."""
    cfg, grid, s0, ffn = cases4.lab_canyon(
        cases4.lab_canyon_config(Lm=24, Mm=48, N=6, ndtfast=10),
        device="cpu")
    s = stepping.run(cfg, grid, s0, 20, ffn)
    assert bool(torch.isfinite(s.zeta).all())
    assert float(s.u.abs().max()) < 2.0e-3
    assert float(s.v.abs().max()) < 2.0e-3
    assert float(grid.angler.min()) < -3.0 < 3.0 < float(grid.angler.max())
    t3 = torch.full_like(s0.t, 3.0)
    s2 = s0.replace(t=t3, t_prev=t3.clone(), zeta=bc.fill_halo(
        cfg, 5.0e-4 * torch.cos(3.0 * grid.angler)))
    s2 = stepping.run(cfg, grid, s2, 10, None)
    assert float((s2.t - 3.0).abs().max()) < 2e-5


def test_tide_generating_force_moves_benchmark(tmp):
    """tests/test_tides_avg.py's check: from rest, five steps with the
    equilibrium-tide force give a current of tidal size (0 < |u| < 0.5)."""
    cfg, grid, s0, _ = fx.build_port("tide", tmp)
    s = stepping.run(cfg, grid, s0, 5, None)
    umax = float(s.u.abs().max())
    assert bool(torch.isfinite(s.u).all()) and 0.0 < umax < 0.5
    off = stepping.run(cfg.replace(tide_gen_forces=False), grid, s0, 5, None)
    assert float(off.u.abs().max()) < 0.1 * umax


@pytest.mark.parametrize("change, kw, feature", [
    (dict(biology="npzd_powell"), {}, "biology"),
    (dict(bodyforce=True), {}, "BODYFORCE"),
    ({}, dict(collect_diags=True), "budget diagnostics"),
    (dict(nearshore="mellor05"), {}, "nearshore radiation stress"),
    ({}, dict(stokes=True), "Stokes drift"),
])
def test_unported_branches_raise(change, kw, feature, tmp):
    """The step (with `kw`), or with stokes the general fast loop handed a
    Stokes transport, raises naming the branch."""
    cfg, grid, s0, ffn = fx.build_port("lab_canyon", tmp)
    cfg = dataclasses.replace(cfg, **change)
    with pytest.raises(NotImplementedError, match=feature):
        if kw.get("stokes"):
            zero = torch.zeros_like(s0.zeta)
            step2d.fast_loop(cfg, grid, step2d.make_fast_state(
                cfg, s0.zeta, s0.ubar, s0.vbar), us2d=(zero, zero))
        else:
            stepping.step(cfg, grid, s0, ffn, **kw)
