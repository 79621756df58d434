"""roms_tpu_torch: SED_TOY, LAKE_SIGNELL and SED_TEST1, and SED_TOY under
each bottom boundary layer, Soulsby's bedload and SED_MORPH, on the CPU.

(a) each builder against roms_tpu's at a small size, as the fixture holds
    it: the configuration (the sediment and BBL parameters too), every grid
    field, and the forcing 17.5 h in (the wind and wave ramps, the open
    flume's boundary data); the initial state in (b);
(b) three float64 steps of each small case of
    scripts/torch_sediment_fixture.py reproduce
    tests/data/torch_sediment_small.npz, written by that script from
    roms_tpu's eager steps, at the bounds it states (no JAX run here), and
    leave the caller's state unchanged;
(c) the step's dispatch on each case takes each kernel wrapper exactly
    where roms_tpu's step takes its Pallas kernel (MPDATA keeps
    LAKE_SIGNELL's tracer kernels off, SED_TEST1's open ends keep rows
    8-11 off), the general plain stages everywhere else;
(d) the registry and the CLI have the three cases, and `run --case
    sed_toy` runs.
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
from roms_tpu_torch.ops import diag_cuda, mix3d_cuda, prsgrd_cuda, \
    rhs3d_cuda, step2d, step2d_cuda, step3d_cuda
from roms_tpu_torch.utils.yamlcfg import CASES as REGISTRY
from chip_smoke import sediment_fixture_script
from test_torch_obc import jax_config

torch.set_num_threads(1)

fx = sediment_fixture_script()
FIXTURE_CASES = tuple(fx.BASE)


def _rel(a, b):
    b = np.asarray(b)
    return float(np.abs(a.numpy() - b).max() / max(np.abs(b).max(), 1e-300))


@pytest.mark.parametrize("case", FIXTURE_CASES)
def test_builder_matches(case):
    """The finished configuration of every case; for the three builders
    every grid array and the forcing at FORCING_TIME."""
    ref = np.load(fx.OUT)
    cfg, grid, _, ffn = fx.build_port(case)
    assert repr(jax_config(cfg)) == str(ref[f"{case}/config"])
    if case not in fx.BUILDERS:
        return
    names = {f.name for f in dataclasses.fields(grid)
             if getattr(grid, f.name) is not None}
    assert names == {k.split("/")[2] for k in ref.files
                     if k.startswith(f"{case}/grid/")}
    for name in names:
        assert _rel(getattr(grid, name), ref[f"{case}/grid/{name}"]) \
            <= 1e-15, name
    want = {k[len(case) + 1:] for k in ref.files
            if k.startswith(f"{case}/forcing/")}
    got = fx.forcing_arrays(ffn(cfg, grid, fx.FORCING_TIME))
    assert set(got) == want
    for k, a in got.items():
        assert a.dtype == grid.h.dtype, k
        assert _rel(a, ref[f"{case}/{k}"]) <= 1e-15, k


@pytest.mark.parametrize("case", FIXTURE_CASES)
def test_small_case_matches_fixture(case):
    """At the bounds scripts/torch_sediment_fixture.py states."""
    ref = np.load(fx.OUT)
    cfg, grid, s0, ffn = fx.build_port(case)
    keep = {k: v.clone() for k, v in vars(s0).items()
            if isinstance(v, torch.Tensor)}
    s = fx.run_port(case, cfg, grid, s0, ffn)
    assert (s.iic, s.time) == (int(ref[f"{case}/iic"]),
                               float(ref[f"{case}/time"]))
    errors = fx.errors(case, cfg, s0, s, ref)
    bad = {k: e for k, e in errors.items() if not e[0] <= e[1]}
    assert not bad, bad
    for k, v in keep.items():
        assert torch.equal(getattr(s0, k), v), k


_DIAG = {"diag_cuda.grid_flux", "diag_cuda.eos", "diag_cuda.omega"}
_COLUMNS = {"step3d_cuda.tracer_predictor", "step3d_cuda.tracer_corrector",
            "step3d_cuda.uv_corrector", "step2d_cuda.fast_loop"}
_MOMENTUM = {"rhs3d_cuda.momentum_rhs"}
_TRACER_PLAIN = {"step3d_cuda.tracer_predictor_plain",
                 "step3d_cuda.tracer_corrector_plain"}
EXPECTED = {
    "sed_toy": _DIAG | _COLUMNS | _MOMENTUM,
    "lake_signell": (_DIAG | _COLUMNS | _MOMENTUM | _TRACER_PLAIN) -
    {"step3d_cuda.tracer_predictor", "step3d_cuda.tracer_corrector"},
    "sed_test1": _DIAG | _MOMENTUM | _TRACER_PLAIN |
    {"step3d_cuda.uv_corrector_plain", "step2d.fast_loop"},
}
_KERNEL_SITES = [(diag_cuda, "grid_flux"), (diag_cuda, "eos"),
                 (diag_cuda, "omega"), (rhs3d_cuda, "momentum_rhs"),
                 (prsgrd_cuda, "prsgrd32"), (mix3d_cuda, "uv3dmix2"),
                 (mix3d_cuda, "t3dmix2_geo"), (step2d_cuda, "fast_loop"),
                 (step3d_cuda, "tracer_predictor"),
                 (step3d_cuda, "uv_corrector"),
                 (step3d_cuda, "tracer_corrector")]
_PLAIN_SITES = [(diag_cuda, "grid_flux_plain"), (diag_cuda, "eos_plain"),
                (mix3d_cuda, "t3dmix2_geo_plain"),
                (mix3d_cuda, "uv3dmix2_plain"),
                (step3d_cuda, "tracer_predictor_plain"),
                (step3d_cuda, "uv_corrector_plain"),
                (step3d_cuda, "tracer_corrector_plain"),
                (step2d, "fast_loop")]


@pytest.mark.parametrize("case", ["sed_toy", "sed_toy_sg", "lake_signell",
                                  "sed_test1"])
def test_dispatch_mirrors_jax_gates(case, monkeypatch):
    cfg, grid, s0, ffn = fx.build_port(case)
    frc = ffn(cfg, grid, s0.time)
    bry = frc.get("bry")
    monkeypatch.setenv("ROMS_PALLAS_INTERPRET", "1")
    cfg_j = jax_config(cfg)
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
        "grid_flux": diag_pallas.use_pallas(cfg_j) and grid.zice is None,
        "momentum_rhs": rhs3d_pallas.use_pallas(cfg_j),
        "prsgrd32": prsgrd_pallas.use_pallas(cfg_j),
        "mix": mix3d_pallas.use_pallas(cfg_j),
        "tracer": step3d_pallas.use_tracer_pallas(cfg_j, bry=bry),
        "uv": step3d_pallas.use_uv_pallas(cfg_j, bry=bry),
        "fast_loop": step2d_pallas.use_pallas(cfg_j, bry),
    }
    assert port == ref

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
    assert sorted(calls) == sorted(EXPECTED[fx.BASE[case]])


def test_registry_and_cli_run_the_cases(capsys):
    assert len(REGISTRY) == 30
    assert {"sed_toy", "lake_signell", "sed_test1"} <= set(REGISTRY)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert cli(["cases"]) == 0
    assert {"sed_toy", "lake_signell", "sed_test1"} <= \
        set(out.getvalue().split())
    assert cli(["run", "--case", "sed_toy", "--nsteps", "2", "--ninfo",
                "1", "--device", "cpu"]) == 0
    assert capsys.readouterr().out.count("KE=") == 2


def test_restart_carries_bed_and_bbl(tmp_path):
    """A restart of SED_TOY under waves with the SSW layer holds the bed
    (non-empty) and the BBL memory, and continues bitwise."""
    from roms_tpu_torch.driver import restart
    from roms_tpu_torch.io import checkpoint
    from roms_tpu_torch.state import TENSOR_FIELDS
    cfg, grid, s0, ffn = fx.build_port("sed_toy_ssw")
    half = stepping.run(cfg, grid, s0, 2, ffn)
    path = str(tmp_path / "rst.pt")
    checkpoint.save(path, half)
    resumed = stepping.run(cfg, grid, restart(cfg, path, s0), 2, ffn)
    straight = stepping.run(cfg, grid, s0, 4, ffn)
    assert half.bed_mass.numel() > 0
    for k in ("bed_mass", "rheight", "tau_cwmax"):
        assert not torch.equal(getattr(half, k), getattr(s0, k)), k
    for k in TENSOR_FIELDS:
        assert torch.equal(getattr(resumed, k), getattr(straight, k)), k
    assert (resumed.iic, resumed.time) == (straight.iic, straight.time)
