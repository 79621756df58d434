"""roms_tpu_torch: the operator cases (BASIN, DOUBLE_GYRE, GRAV_ADJ,
SEAMOUNT, CANYON3D, OVERFLOW, WINDBASIN, CHANNEL_NECK) on the CPU.

(a) each builder against roms_tpu's at a small size: the configuration,
    every grid field, the initial state and the forcing at two times;
(b) three float64 steps of each small case of
    scripts/torch_operators_fixture.py (the eight cases, SEAMOUNT under
    each pressure-gradient scheme, UPWELLING with each option no case
    uses) reproduce tests/data/torch_operators_small.npz, written by that
    script from roms_tpu's eager step, at the bounds it states (no JAX run
    here), and leave the caller's state unchanged;
(c) the step's dispatch on each case takes each kernel wrapper exactly
    where roms_tpu's step takes its Pallas kernel (the JAX gates asked as
    under ROMS_PALLAS_INTERPRET);
(d) the registry and the command line list the cases.
"""

import contextlib
import dataclasses
import io

import numpy as np
import pytest
import torch

from roms_tpu.models import cases as jcases, cases4 as jcases4
from roms_tpu.ops import diag_pallas, mix3d_pallas, prsgrd_pallas, \
    rhs3d_pallas, step2d_pallas, step3d_pallas
from roms_tpu_torch import convert, stepping
from roms_tpu_torch.__main__ import main as cli
from roms_tpu_torch.models import cases as tcases, cases4 as tcases4
from roms_tpu_torch.ops import diag_cuda, mix3d, mix3d_cuda, prsgrd, \
    prsgrd_cuda, rhs3d_cuda, step2d, step2d_cuda, step3d_cuda
from roms_tpu_torch.utils.yamlcfg import CASES as REGISTRY
from chip_smoke import operators_fixture_script
from test_torch_obc import jax_config

torch.set_num_threads(1)

fx = operators_fixture_script()
FIXTURE_CASES = tuple(fx.CASES)
BUILDERS = ("basin", "double_gyre", "grav_adj", "seamount", "canyon3d",
            "overflow", "windbasin", "channel_neck")
# the builders' small sizes: one shape for all but the two narrow cases,
# so that roms_tpu's eager operations compile once for most of them
_SHAPE = dict(Lm=12, Mm=10, N=5)
SMALL = {**dict.fromkeys(BUILDERS, _SHAPE),
         "grav_adj": dict(Lm=12, Mm=4, N=5), "overflow": dict(Lm=4, Mm=10,
                                                              N=5)}


def _rel(a, b):
    b = np.asarray(b)
    return float(np.abs(a.numpy() - b).max() / max(np.abs(b).max(), 1e-300))


@pytest.mark.parametrize("case", BUILDERS)
def test_builder_matches(case):
    jm, tm = (jcases4, tcases4) if case == "channel_neck" else \
        (jcases, tcases)
    cfg_j, grid_j, s_j, f_j = getattr(jm, case)(**SMALL[case])
    cfg_t, grid_t, s_t, f_t = getattr(tm, case)(
        getattr(tm, case + "_config")(**SMALL[case]), device="cpu")
    assert convert.config_from_reference(cfg_j) == cfg_t
    for f in dataclasses.fields(grid_t):
        a = getattr(grid_t, f.name)
        if isinstance(a, torch.Tensor) and a.numel():
            assert _rel(a, getattr(grid_j, f.name)) <= 1e-15, f.name
    for k, a in vars(s_t).items():
        if isinstance(a, torch.Tensor) and a.numel():
            assert _rel(a, getattr(s_j, k)) <= 1e-15, k
    assert (f_j is None) == (f_t is None)
    if f_t is not None:
        for time in (0.0, 5.0 * 86400.0):
            got, ref = f_t(cfg_t, grid_t, time), f_j(cfg_j, grid_j, time)
            assert set(got) == set(ref)
            for k in ref:
                assert got[k].dtype == grid_t.h.dtype
                assert _rel(got[k], ref[k]) <= 1e-15, (k, time)


@pytest.mark.parametrize("case", FIXTURE_CASES)
def test_small_case_matches_fixture(case):
    """At the bounds scripts/torch_operators_fixture.py states."""
    ref = np.load(fx.OUT)
    cfg, grid, s0, ffn = fx.build_port(case)
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


# the kernel wrappers each case's step takes (rows 1-3 and 8-11 on all of
# them), and the plain operators it calls
_ROWS = {"grid_flux", "eos", "omega", "tracer_predictor", "tracer_corrector",
         "uv_corrector", "fast_loop"}
_FUSED = _ROWS | {"momentum_rhs"}
_STAGED = _ROWS | {"prsgrd32", "rhs3d_momentum"}
EXPECTED = {
    "basin": (_STAGED, {"uv3dmix4", "t3dmix4"}),
    "double_gyre": (_FUSED, {"t3dmix2"}),
    "grav_adj": (_STAGED | {"uv3dmix2"}, set()),
    "canyon3d": (_FUSED, {"t3dmix2"}),
    "overflow": (_STAGED | {"uv3dmix2"}, {"t3dmix2_iso"}),
    "windbasin": (_STAGED, set()),
    "channel_neck": (_STAGED, {"uv3dmix2_geo"}),
    "seamount_djs": (_FUSED, set()),
    **{f"seamount_{s}": (_ROWS | {"rhs3d_momentum"}, {"prsgrd"})
       for s in ("dj", "pj", "pjq2", "pjq4")},
    "upw_smagorinsky": (_STAGED, {"uv3dmix2_plain"}),
    "upw_t4_geo": (_FUSED, {"t3dmix4_geo"}),
    "upw_t4_iso": (_FUSED, {"t3dmix4_iso"}),
    "upw_uv4_geo": (_STAGED, {"uv3dmix2_geo", "uv3dmix4_geo"}),
}
_KERNEL_SITES = [(diag_cuda, "grid_flux"), (diag_cuda, "eos"),
                 (diag_cuda, "omega"), (rhs3d_cuda, "momentum_rhs"),
                 (prsgrd_cuda, "prsgrd32"), (mix3d_cuda, "uv3dmix2"),
                 (mix3d_cuda, "t3dmix2_geo"), (step2d_cuda, "fast_loop"),
                 (step3d_cuda, "tracer_predictor"),
                 (step3d_cuda, "uv_corrector"),
                 (step3d_cuda, "tracer_corrector"),
                 (stepping, "rhs3d_momentum")]
_PLAIN_SITES = [(mix3d, n) for n in (
    "t3dmix2", "t3dmix4", "t3dmix2_iso", "t3dmix4_iso", "t3dmix4_geo",
    "uv3dmix2_geo", "uv3dmix4", "uv3dmix4_geo")] + \
    [(prsgrd, "prsgrd"), (mix3d_cuda, "uv3dmix2_plain"),
     (mix3d_cuda, "t3dmix2_geo_plain"), (step2d, "fast_loop"),
     (step3d_cuda, "tracer_predictor_plain"),
     (step3d_cuda, "uv_corrector_plain"),
     (step3d_cuda, "tracer_corrector_plain")]


@pytest.mark.parametrize("case", FIXTURE_CASES)
def test_dispatch_mirrors_jax_gates(case, monkeypatch):
    cfg, grid, s0, ffn = fx.build_port(case)
    monkeypatch.setenv("ROMS_PALLAS_INTERPRET", "1")
    cfg_j = jax_config(cfg)
    port = {
        "grid_flux": cfg.pallas2d and diag_cuda.supported(cfg, grid),
        "momentum_rhs": rhs3d_cuda.use_kernels(cfg),
        "prsgrd32": prsgrd_cuda.supported(cfg),
        "mix": mix3d_cuda.use_kernels(cfg),
        "tracer": step3d_cuda.use_tracer(cfg),
        "uv": step3d_cuda.use_uv(cfg),
        "fast_loop": cfg.pallas2d and step2d_cuda.supported(cfg),
    }
    ref = {
        "grid_flux": diag_pallas.use_pallas(cfg_j),
        "momentum_rhs": rhs3d_pallas.use_pallas(cfg_j),
        "prsgrd32": prsgrd_pallas.use_pallas(cfg_j),
        "mix": mix3d_pallas.use_pallas(cfg_j),
        "tracer": step3d_pallas.use_tracer_pallas(cfg_j),
        "uv": step3d_pallas.use_uv_pallas(cfg_j),
        "fast_loop": step2d_pallas.use_pallas(cfg_j),
    }
    assert port == ref

    # the calls the step makes itself (a wrapper on CPU tensors calls its
    # plain version in turn, which is not recorded)
    calls, depth = [], [0]
    for mod, attr in _KERNEL_SITES + _PLAIN_SITES:
        fn = getattr(mod, attr)

        def rec(*a, _fn=fn, _name=attr, **k):
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
    kernel_names = {attr for _, attr in _KERNEL_SITES}
    assert {c for c in calls if c in kernel_names} == kernels
    assert {c for c in calls if c not in kernel_names} == plain
    assert len(calls) == len(kernels) + len(plain)


def test_registry_and_cli_list_the_cases():
    assert set(BUILDERS) <= set(REGISTRY)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert cli(["cases"]) == 0
    listed = out.getvalue().split()
    assert all(name in listed for name in BUILDERS)
