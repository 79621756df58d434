"""roms_tpu_torch: the biology slot of the step and BIO_TOY, on the CPU.

(a) BIO_TOY, Fennel's core (9 tracers) and EcoSim (22 tracers) on the
    6 x 8 x 10 UPWELLING grid: the finished configuration against
    roms_tpu's, and three float64 steps against
    tests/data/torch_biology_small.npz (roms_tpu's eager steps, written by
    scripts/torch_biology_fixture.py) at the bounds it states (no JAX run
    here), the caller's state unchanged;
(b) the step's dispatch on BIO_TOY and 22-tracer EcoSim takes each kernel
    wrapper exactly where roms_tpu's step takes its Pallas kernel (all but
    row 5, whose tnu2 = 0), the plain stages nowhere;
(c) the registry and the CLI have bio_toy: `cases` lists it, the committed
    examples/bio_toy.yaml runs two steps in a temporary directory and its
    history file holds the NPZD tracers under their names; a restart of
    BIO_TOY continues bitwise;
(d) config_from_reference carries each of the eight parameter classes, an
    unknown cfg.biology raises ValueError as roms_tpu's apply_biology
    does, and the step admits a model's own forcing fields under that
    model only;
(e) the tracer kernels' limits: the scheme codes of rows 8 and 9 and the
    mixed tracers of row 5 take 22 and 64 tracers and raise past
    MAX_TRACERS, which is csrc/column.cuh's kMaxTr.
"""

import contextlib
import dataclasses
import io
import os
import shutil

import numpy as np
import pytest
import torch

from roms_tpu.ops import bio_models as jbm, biology as jbio, diag_pallas, \
    mix3d_pallas, prsgrd_pallas, rhs3d_pallas, step2d_pallas, step3d_pallas
from roms_tpu_torch import convert, stepping
from roms_tpu_torch.__main__ import main as cli
from roms_tpu_torch.ops import biology, diag_cuda, mix3d_cuda, \
    prsgrd_cuda, rhs3d_cuda, step2d, step2d_cuda, step3d_cuda
from roms_tpu_torch.ops._kernels import CSRC, MAX_TRACERS
from roms_tpu_torch.utils.yamlcfg import CASES as REGISTRY
from chip_smoke import ROOT, biology_fixture_script
from test_torch_obc import jax_config

torch.set_num_threads(1)

fx = biology_fixture_script()


@pytest.mark.parametrize("case", fx.STEP_CASES)
def test_config_matches(case):
    ref = np.load(fx.OUT)
    cfg = fx.build_port(case)[0]
    assert repr(jax_config(cfg)) == str(ref[f"{case}/config"])


@pytest.mark.parametrize("case", fx.STEP_CASES)
def test_small_case_matches_fixture(case):
    """At the bounds scripts/torch_biology_fixture.py states."""
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
# rows 1-3, 8-11 and the momentum phase (rows 6, 7, 4) on both
EXPECTED = {"diag_cuda.grid_flux", "diag_cuda.eos", "diag_cuda.omega",
            "rhs3d_cuda.momentum_rhs", "step3d_cuda.tracer_predictor",
            "step3d_cuda.tracer_corrector", "step3d_cuda.uv_corrector",
            "step2d_cuda.fast_loop"}


@pytest.mark.parametrize("case", ["bio_toy", "ecosim"])
def test_dispatch_mirrors_jax_gates(case, monkeypatch):
    cfg, grid, s0, ffn = fx.build_port(case)
    frc = ffn(cfg, grid, s0.time)
    monkeypatch.setenv("ROMS_PALLAS_INTERPRET", "1")
    cfg_j = jax_config(cfg)
    port = {
        "grid_flux": cfg.pallas2d and diag_cuda.supported(cfg, grid),
        "momentum_rhs": rhs3d_cuda.use_kernels(cfg),
        "prsgrd32": prsgrd_cuda.supported(cfg),
        "mix": mix3d_cuda.use_kernels(cfg),
        "t3dmix2": any(x != 0.0 for x in cfg.tnu2),
        "tracer": step3d_cuda.use_tracer(cfg, bry=frc.get("bry")),
        "uv": step3d_cuda.use_uv(cfg, bry=frc.get("bry")),
        "fast_loop": cfg.pallas2d and step2d_cuda.supported(cfg, None),
    }
    ref = {
        "grid_flux": diag_pallas.use_pallas(cfg_j) and grid.zice is None,
        "momentum_rhs": rhs3d_pallas.use_pallas(cfg_j),
        "prsgrd32": prsgrd_pallas.use_pallas(cfg_j),
        "mix": mix3d_pallas.use_pallas(cfg_j),
        "t3dmix2": any(x != 0.0 for x in cfg_j.tnu2),
        "tracer": step3d_pallas.use_tracer_pallas(cfg_j, bry=None),
        "uv": step3d_pallas.use_uv_pallas(cfg_j, bry=None),
        "fast_loop": step2d_pallas.use_pallas(cfg_j, None),
    }
    assert port == ref
    assert port["tracer"] and not port["t3dmix2"]
    assert cfg.ntracers == {"bio_toy": 6, "ecosim": 22}[case]

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
    assert sorted(calls) == sorted(EXPECTED)


def test_registry_cli_and_example(tmp_path, monkeypatch, capsys):
    from roms_tpu_torch.io.netcdf import read_history
    assert len(REGISTRY) == 30 and "bio_toy" in REGISTRY
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert cli(["cases"]) == 0
    assert "bio_toy" in out.getvalue().split()
    # the committed example writes bio_his.nc where it runs (a record
    # every 48 steps: none in two)
    shutil.copy(os.path.join(ROOT, "examples", "bio_toy.yaml"), tmp_path)
    monkeypatch.chdir(tmp_path)
    assert cli(["run", "bio_toy.yaml", "--nsteps", "2", "--device",
                "cpu"]) == 0
    names = ("NO3", "phytoplankton", "zooplankton", "detritus")
    assert set(names) <= set(read_history(str(tmp_path / "bio_his.nc")))
    his = str(tmp_path / "his.nc")
    assert cli(["run", "--case", "bio_toy", "--nsteps", "2", "--his", his,
                "--nhis", "1", "--device", "cpu"]) == 0
    h = read_history(his)
    for name in names:
        assert h[name].shape[0] == 2 and np.isfinite(h[name]).all(), name
    assert float(h["phytoplankton"][-1].max()) > 0.0


def test_restart_continues_bitwise(tmp_path):
    from roms_tpu_torch.driver import restart
    from roms_tpu_torch.io import checkpoint
    from roms_tpu_torch.state import TENSOR_FIELDS
    cfg, grid, s0, ffn = fx.build_port("bio_toy")
    half = stepping.run(cfg, grid, s0, 2, ffn)
    path = str(tmp_path / "rst.pt")
    checkpoint.save(path, half)
    resumed = stepping.run(cfg, grid, restart(cfg, path, s0), 2, ffn)
    straight = stepping.run(cfg, grid, s0, 4, ffn)
    for k in TENSOR_FIELDS:
        assert torch.equal(getattr(resumed, k), getattr(straight, k)), k
    assert (resumed.iic, resumed.time) == (straight.iic, straight.time)


_PARAM_CLASSES = [(jbio, "NPZDParams", dict(wDet=3.0, const_par=100.0)),
                  (jbm, "FranksParams", dict(K_ext=0.05)),
                  (jbm, "IronParams", dict(iron_relax=True)),
                  (jbm, "FennelParams", dict(oxygen=True, carbon=True)),
                  (jbm, "HypoxiaParams", dict(ResRate=2.0)),
                  (jbm, "NemuroParams", dict(setVPON=10.0)),
                  (jbm, "RedTideParams", dict(wDino=3.0)),
                  (jbm, "EcosimParams", dict(WS=(0.0, 1.0)))]


@pytest.mark.parametrize("home, cls, kw", _PARAM_CLASSES,
                         ids=[c for _, c, _ in _PARAM_CLASSES])
def test_config_from_reference_carries_bio_params(home, cls, kw):
    from roms_tpu.config import Config as JConfig
    ref = JConfig(biology="fennel", bio_params=getattr(home, cls)(**kw))
    got = convert.config_from_reference(ref).bio_params
    assert type(got).__name__ == cls
    assert type(got).__module__.startswith("roms_tpu_torch.")
    assert dataclasses.asdict(got) == dataclasses.asdict(ref.bio_params)


def test_unknown_biology_raises():
    cfg, grid, s0, ffn = fx.build_port("bio_toy")
    with pytest.raises(ValueError, match="unknown biology model"):
        biology.apply_biology(cfg.replace(biology="npzd_typo"), grid, s0.t,
                              s0.t, None, None, None)
    with pytest.raises(ValueError, match="unknown biology model"):
        stepping.step(cfg.replace(biology="npzd_typo"), grid, s0, ffn)


@pytest.mark.parametrize("field, model, admitted", [
    ("respiration", "hypoxia_srm", True), ("respiration", "fennel", False),
    ("CystIni", "red_tide", True), ("DIN_obs", "npzd_powell", False)])
def test_model_forcing_fields(field, model, admitted):
    """A model's own forcing field passes the step's check under that
    model only."""
    cfg, grid, s0, ffn = fx.build_port("bio_toy")
    cfg = cfg.replace(biology=model)
    frc = {**ffn(cfg, grid, 0.0), field: torch.zeros_like(grid.h)}
    if admitted:
        stepping._check_slice(cfg, frc)
    else:
        with pytest.raises(NotImplementedError, match="forcing fields"):
            stepping._check_slice(cfg, frc)


def _with_tracers(nt):
    """BIO_TOY's configuration with nt tracers, each diffused."""
    cfg = fx.build_port("bio_toy")[0]
    return cfg.replace(ntracers=nt, t_hadv=nt * ("U3",),
                       t_vadv=nt * ("C4",), tnu2=nt * (5.0,))


def test_kernel_limit_is_the_header():
    header = (CSRC / "column.cuh").read_text()
    assert f"constexpr int kMaxTr = {MAX_TRACERS};" in header
    assert MAX_TRACERS >= 64
    assert step3d_cuda.MAX_TRACERS == mix3d_cuda.MAX_TRACERS == MAX_TRACERS


@pytest.mark.parametrize("nt", [22, 64, "past"])
def test_tracer_kernels_take_many_tracers(nt):
    """Rows 8 and 9's scheme codes and row 5's mixed tracers at 22 and 64
    tracers, and the ValueError one past MAX_TRACERS."""
    n = MAX_TRACERS + 1 if nt == "past" else nt
    cfg = _with_tracers(n)
    if nt == "past":
        for name in ("tracer_predictor", "tracer_corrector"):
            with pytest.raises(ValueError, match="tracers outside"):
                step3d_cuda._tracer_ints(cfg, name)
        with pytest.raises(ValueError, match="mixed tracers"):
            mix3d_cuda.geo_tracers(cfg)
        return
    assert step3d_cuda._tracer_ints(cfg, "tracer_predictor") == \
        [0] * n + [0] * n
    assert step3d_cuda._tracer_ints(
        cfg.replace(t_hadv=n * ("C2",), t_vadv=n * ("A4",)),
        "tracer_corrector") == [2] * n + [4] * n
    assert mix3d_cuda.geo_tracers(cfg) == list(range(n))
    plan = step3d_cuda.tracer_plan("tracer_corrector", torch.float64, 64, n,
                                   86, 47)
    assert plan["tile"] >= 1 and plan["smem_bytes"] <= 232448
