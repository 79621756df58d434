"""roms_tpu_torch: CHANNEL, LMD_TEST, MIXED_LAYER, TEST_CHAN, RIVERPLUME2,
WEDDELL, BL_TEST, SOLITON and mean age (AGE_MEAN, on a 4-tracer UPWELLING)
on the CPU.

(a) each builder against roms_tpu's at a small size, as the fixture holds
    it: the configuration, every grid field (WEDDELL's ice draft too) and
    the forcing 12 h in (the open-boundary data, the wall and river
    sources, the wind and the shortwave); the initial state in (b);
(b) the steps of each small case of scripts/torch_cases2_fixture.py (three
    float64 3-D steps, SOLITON's ten 2-D steps; the uniform tracer and its
    age each against its own max) reproduce
    tests/data/torch_cases2_small.npz, written by that script from
    roms_tpu's eager steps, at the bounds it states (no JAX run here), and
    leave the caller's state unchanged (no JAX run in (a) or (b));
(c) the step's dispatch on each 3-D case takes each kernel wrapper exactly
    where roms_tpu's step takes its Pallas kernel (the JAX gates asked as
    under ROMS_PALLAS_INTERPRET, with the case's bry/sources), the general
    plain stages everywhere else;
(d) the registry has roms_tpu's 30 cases, and a
    2-D-only case builds in the "2d" mode.
"""

import contextlib
import dataclasses
import io

import numpy as np
import pytest
import torch

from roms_tpu.ops import diag_pallas, mix3d_pallas, prsgrd_pallas, \
    rhs3d_pallas, step2d_pallas, step3d_pallas
from roms_tpu_torch import stepping
from roms_tpu_torch.__main__ import main as cli
from roms_tpu_torch.ops import diag_cuda, mix3d, mix3d_cuda, prsgrd_cuda, \
    rhs3d_cuda, step2d, step2d_cuda, step3d_cuda
from roms_tpu_torch.utils.yamlcfg import CASES as REGISTRY, build_from_dict
from chip_smoke import cases2_fixture_script
from test_torch_obc import jax_config

torch.set_num_threads(1)

fx = cases2_fixture_script()
FIXTURE_CASES = tuple(fx.CASES)
CASES3D = tuple(c for c in FIXTURE_CASES if c != "soliton")
# the registry's cases among them
REGISTERED = tuple(c for c in FIXTURE_CASES if c != "upwelling_age")


def _rel(a, b):
    b = np.asarray(b)
    return float(np.abs(a.numpy() - b).max() / max(np.abs(b).max(), 1e-300))


@pytest.mark.parametrize("case", FIXTURE_CASES)
def test_builder_matches(case):
    """Against roms_tpu's builder as the fixture holds it: the finished
    configuration, every grid array (WEDDELL's ice draft too), and the
    forcing at FORCING_TIME, when the ramps, the wind burst, the tide and
    the shortwave are under way (the open-boundary data, the wall and
    river sources, the wind and the shortwave)."""
    ref = np.load(fx.OUT)
    cfg, grid, _, ffn = fx.build_port(case)
    assert repr(jax_config(cfg)) == str(ref[f"{case}/config"])
    names = {f.name for f in dataclasses.fields(grid)
             if getattr(grid, f.name) is not None}
    assert names == {k.split("/")[2] for k in ref.files
                     if k.startswith(f"{case}/grid/")}
    assert ("zice" in names) == (case == "weddell")
    for name in names:
        assert _rel(getattr(grid, name), ref[f"{case}/grid/{name}"]) \
            <= 1e-15, name
    want = {k[len(case) + 1:] for k in ref.files
            if k.startswith(f"{case}/forcing/")}
    if ffn is None:
        assert not want
        return
    got = fx.forcing_arrays(ffn(cfg, grid, fx.FORCING_TIME))
    assert set(got) == want
    for k, a in got.items():
        assert a.dtype in (grid.h.dtype, torch.int64), k
        assert _rel(a, ref[f"{case}/{k}"]) <= 1e-15, k


@pytest.mark.parametrize("case", FIXTURE_CASES)
def test_small_case_matches_fixture(case):
    """At the bounds scripts/torch_cases2_fixture.py states."""
    ref = np.load(fx.OUT)
    cfg, grid, s0, ffn = fx.build_port(case)
    keep = {k: v.clone() for k, v in vars(s0).items()
            if isinstance(v, torch.Tensor)}
    s = fx.run_port(case, cfg, grid, s0, ffn)
    if case != "soliton":
        assert (s.iic, s.time) == (int(ref[f"{case}/iic"]),
                                   float(ref[f"{case}/time"]))
    errors = fx.errors(case, cfg, s0, s, ref)
    bad = {k: e for k, e in errors.items() if not e[0] <= e[1]}
    assert not bad, bad
    for k, v in keep.items():
        assert torch.equal(getattr(s0, k), v), k


# the kernel wrappers each case's step takes and the plain stages it calls
_DIAG = {"diag_cuda.grid_flux", "diag_cuda.eos", "diag_cuda.omega"}
_COLUMNS = {"step3d_cuda.tracer_predictor", "step3d_cuda.tracer_corrector",
            "step3d_cuda.uv_corrector", "step2d_cuda.fast_loop"}
_PLAIN = {"step3d_cuda.tracer_predictor_plain",
          "step3d_cuda.tracer_corrector_plain",
          "step3d_cuda.uv_corrector_plain", "step2d.fast_loop"}
_MOMENTUM = {"rhs3d_cuda.momentum_rhs"}
EXPECTED = {
    "channel": (_DIAG | _COLUMNS | _MOMENTUM, {"mix3d.t3dmix2"}),
    "lmd_test": (_DIAG | _COLUMNS | _MOMENTUM, set()),
    "mixed_layer": (_DIAG | _COLUMNS | _MOMENTUM, set()),
    "test_chan": (_DIAG | _MOMENTUM, _PLAIN),
    "riverplume2": (_DIAG | _MOMENTUM, _PLAIN),
    "weddell": ({"diag_cuda.omega"} | _MOMENTUM,
                _PLAIN | {"diag_cuda.grid_flux_plain", "diag_cuda.eos_plain",
                          "mix3d.t3dmix2"}),
    "bl_test": (_DIAG | _MOMENTUM, _PLAIN),
    "upwelling_age": (_DIAG | _COLUMNS | _MOMENTUM, set()),
}
_KERNEL_SITES = [(diag_cuda, "grid_flux"), (diag_cuda, "eos"),
                 (diag_cuda, "omega"), (rhs3d_cuda, "momentum_rhs"),
                 (prsgrd_cuda, "prsgrd32"), (mix3d_cuda, "uv3dmix2"),
                 (mix3d_cuda, "t3dmix2_geo"), (step2d_cuda, "fast_loop"),
                 (step3d_cuda, "tracer_predictor"),
                 (step3d_cuda, "uv_corrector"),
                 (step3d_cuda, "tracer_corrector")]
_PLAIN_SITES = [(mix3d, "t3dmix2"), (diag_cuda, "grid_flux_plain"),
                (diag_cuda, "eos_plain"), (mix3d_cuda, "t3dmix2_geo_plain"),
                (mix3d_cuda, "uv3dmix2_plain"),
                (step3d_cuda, "tracer_predictor_plain"),
                (step3d_cuda, "uv_corrector_plain"),
                (step3d_cuda, "tracer_corrector_plain"),
                (step2d, "fast_loop")]


@pytest.mark.parametrize("case", CASES3D)
def test_dispatch_mirrors_jax_gates(case, monkeypatch):
    cfg, grid, s0, ffn = fx.build_port(case)
    frc = ffn(cfg, grid, s0.time) if ffn is not None else {}
    bry, sources = frc.get("bry"), frc.get("sources")
    monkeypatch.setenv("ROMS_PALLAS_INTERPRET", "1")
    cfg_j = jax_config(cfg)
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
        # roms_tpu's step takes the fused diag kernels only without zice
        "grid_flux": diag_pallas.use_pallas(cfg_j) and grid.zice is None,
        "momentum_rhs": rhs3d_pallas.use_pallas(cfg_j),
        "prsgrd32": prsgrd_pallas.use_pallas(cfg_j),
        "mix": mix3d_pallas.use_pallas(cfg_j),
        "tracer": step3d_pallas.use_tracer_pallas(cfg_j, bry=bry,
                                                  sources=sources),
        "uv": step3d_pallas.use_uv_pallas(cfg_j, bry=bry, sources=sources),
        "fast_loop": step2d_pallas.use_pallas(cfg_j, bry, sources),
    }
    assert port == ref

    # the calls the step makes itself (a wrapper on CPU tensors calls its
    # plain version in turn, which is not recorded)
    calls, depth = [], [0]
    for mod, attr in _KERNEL_SITES + _PLAIN_SITES:
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
    assert sorted(calls) == sorted(kernels | plain)


def test_registry_and_cli_list_the_cases():
    assert len(REGISTRY) == 30
    assert set(REGISTERED) <= set(REGISTRY)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert cli(["cases"]) == 0
    assert set(REGISTERED) <= set(out.getvalue().split())
    cfg, grid, fs, ffn, opts = build_from_dict(
        {"case": "soliton", "config": {"Lm": 12, "Mm": 6}}, device="cpu")
    assert opts["mode"] == "2d" and ffn is None
    assert isinstance(fs, step2d.Fast2DState) and not cfg.solve3d
    assert (cfg.Lm, cfg.Mm, cfg.nfast) == (12, 6, 1)
    assert build_from_dict({"case": "weddell", "config": dict(
        Lm=24, Mm=4, N=4)}, device="cpu")[4]["mode"] == "3d"
