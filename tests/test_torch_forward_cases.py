"""roms_tpu_torch: the last branches of the forward model (BODYFORCE,
floats, the nearshore radiation stress with the Stokes drift, the budget
diagnostics) and FLT_TEST and SHOREFACE, on the CPU.

(a) FLT_TEST at 14x12x4 with its floats, SHOREFACE at 20x4x8 under
    Mellor05 and Mellor08, and UPWELLING's budget dict at 10x12x10: the
    finished configuration against roms_tpu's, and the steps against
    tests/data/torch_forward_small.npz (roms_tpu's eager steps, written by
    scripts/torch_forward_fixture.py) at the bounds it states, every key
    of the budget dict included (no JAX run here); the caller's state
    unchanged;
(b) the budgets' identities of tests/test_diags.py: rate is the sum of
    the momentum terms, the tracer terms integrate to zero over the
    closed channel, and the diagnostics leave the state bitwise as it is
    without them;
(c) the step's dispatch on FLT_TEST, SHOREFACE and UPWELLING with the
    budgets takes each kernel wrapper exactly where roms_tpu's step takes
    its Pallas kernel (the JAX gates asked as under
    ROMS_PALLAS_INTERPRET, ns_active included), the plain stages
    elsewhere;
(d) the registry and the command line have all 30 of roms_tpu's cases,
    and Simulation's DIA stream writes the records roms_tpu's DiagWriter
    writes for the same sums;
(e) row 7's wrapper under BODYFORCE: the plain rhs3d_momentum and
    momentum_init against roms_tpu's, the level-range sums in k order,
    and the launch's flag, level ranges and shared memory.
"""

import contextlib
import dataclasses
import io
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from roms_tpu.io.netcdf import DiagWriter as JDiagWriter
from roms_tpu.ops import diag_pallas, mix3d_pallas, pre_step3d as jpre, \
    prsgrd_pallas, rhs3d as jrhs3d, rhs3d_pallas, step2d_pallas, \
    step3d_pallas
from roms_tpu.utils.yamlcfg import CASES as JCASES
from roms_tpu_torch import stepping
from roms_tpu_torch.__main__ import main as cli
from roms_tpu_torch.driver import Simulation
from roms_tpu_torch.io.netcdf import read_history
from roms_tpu_torch.models import upwelling
from roms_tpu_torch.ops import diag_cuda, mix3d_cuda, pre_step3d, \
    prsgrd_cuda, rhs3d, rhs3d_cuda, step2d, step2d_cuda, step3d_cuda
from roms_tpu_torch.state import TENSOR_FIELDS
from roms_tpu_torch.utils.yamlcfg import CASES as REGISTRY
from chip_smoke import forward_fixture_script
from test_torch_obc import jax_config

torch.set_num_threads(1)

fx = forward_fixture_script()
TERMS = ("prestep", "hvisc", "prsgrd", "cor", "xadv", "yadv", "vadv",
         "vvisc")


@pytest.mark.parametrize("case", list(fx.CASES))
def test_config_matches(case):
    ref = np.load(fx.OUT)
    cfg = fx.build_port(case)[0]
    assert repr(jax_config(cfg)) == str(ref[f"{case}/config"])


@pytest.mark.parametrize("case", list(fx.CASES))
def test_small_case_matches_fixture(case):
    """At the bounds scripts/torch_forward_fixture.py states."""
    ref = np.load(fx.OUT)
    cfg, grid, s0, ffn = fx.build_port(case)
    keep = {k: v.clone() for k, v in vars(s0).items()
            if isinstance(v, torch.Tensor)}
    s, outs = fx.run_port(case, cfg, grid, s0, ffn)
    assert (s.iic, s.time) == (int(ref[f"{case}/iic"]),
                               float(ref[f"{case}/time"]))
    assert set(outs) == {k.split("/", 1)[1] for k in ref.files
                         if k.startswith(case + "/")} - {
        "config", "t_initial", "time", "iic"}
    errors = fx.errors(case, cfg, s0, outs, ref)
    bad = {k: e for k, e in errors.items() if not e[0] <= e[1]}
    assert not bad, bad
    for k, v in keep.items():
        assert torch.equal(getattr(s0, k), v), k


@pytest.fixture(scope="module")
def dia_case():
    return fx.build_port("upwelling_dia")


def test_budgets_close(dia_case):
    """tests/test_diags.py's identities on three steps: rate is the total
    change and the sum of the momentum terms; each tracer term
    integrates to zero over the channel (flux form, closed walls)."""
    cfg, grid, s, ffn = dia_case
    for _ in range(3):
        prev = s
        s, dia = stepping.step(cfg, grid, s, ffn, collect_diags=True)
    for c in ("u", "v"):
        total = sum(dia[f"{c}_{k}"] for k in TERMS)
        torch.testing.assert_close(total, dia[f"{c}_rate"], rtol=0,
                                   atol=1e-16)
        assert torch.equal(dia[f"{c}_rate"], getattr(s, c) -
                           getattr(prev, c))
    assert torch.equal(dia["rate"], s.t - prev.t)
    H = cfg.halo
    jj, ii = slice(H, H + cfg.Mm), slice(H, H + cfg.Lm)
    from roms_tpu_torch import vgrid
    from roms_tpu_torch.grid import hc_of
    _, _, Hz = vgrid.set_depth(grid.h, s.zeta, hc_of(cfg), grid.sc_r,
                               grid.Cs_r, grid.sc_w, grid.Cs_w,
                               cfg.vtransform)
    vol = Hz[:, jj, ii] * grid.omn[jj, ii]
    for term in ("xadv", "yadv", "vadv", "vdiff", "hdiff"):
        net = float((dia[term][0][:, jj, ii] * vol).sum())
        gross = float((dia[term][0][:, jj, ii].abs() * vol).sum())
        assert abs(net) <= 1e-9 * gross + 1e-20, (term, net, gross)
        assert gross > 0.0, term
    for key in ("u_prsgrd", "v_cor", "u_vvisc", "v_hvisc", "u_prestep",
                "u_xadv"):
        assert float(dia[key].abs().max()) > 0.0, key


@pytest.mark.parametrize("case", ["upwelling_dia", "flt_test"])
def test_diagnostics_leave_the_state_unchanged(case):
    cfg, grid, s0, ffn = fx.build_port(case)
    plain = stepping.run(cfg, grid, s0, 2, ffn)
    s = s0
    for _ in range(2):
        s, _ = stepping.step(cfg, grid, s, ffn, collect_diags=True)
    for k in TENSOR_FIELDS:
        assert torch.equal(getattr(s, k), getattr(plain, k)), k


_KERNEL_SITES = [(diag_cuda, "grid_flux"), (diag_cuda, "eos"),
                 (diag_cuda, "omega"), (rhs3d_cuda, "momentum_rhs"),
                 (prsgrd_cuda, "prsgrd32"), (mix3d_cuda, "uv3dmix2"),
                 (step2d_cuda, "fast_loop"),
                 (step3d_cuda, "tracer_predictor"),
                 (step3d_cuda, "uv_corrector"),
                 (step3d_cuda, "tracer_corrector")]
_PLAIN_SITES = [(diag_cuda, "grid_flux_plain"), (diag_cuda, "eos_plain"),
                (diag_cuda, "omega_plain"),
                (step3d_cuda, "tracer_predictor_plain"),
                (step3d_cuda, "uv_corrector_plain"),
                (step3d_cuda, "tracer_corrector_plain"),
                (step2d, "fast_loop")]
_ROWS = {"diag_cuda.grid_flux", "diag_cuda.eos", "diag_cuda.omega",
         "step2d_cuda.fast_loop", "step3d_cuda.uv_corrector"}
EXPECTED = {
    # BODYFORCE in row 7: every row but 4 and 5 (visc2 = tnu2 = 0)
    "flt_test": _ROWS | {"rhs3d_cuda.momentum_rhs",
                         "step3d_cuda.tracer_predictor",
                         "step3d_cuda.tracer_corrector"},
    # ns_active keeps rows 1 and 3 plain, omega at time n from the Stokes
    # fluxes plain; bry and wet/dry keep rows 8-11 plain
    "shoreface05": {"diag_cuda.omega", "rhs3d_cuda.momentum_rhs",
                    "diag_cuda.eos_plain", "diag_cuda.omega_plain",
                    "step3d_cuda.tracer_predictor_plain",
                    "step3d_cuda.uv_corrector_plain",
                    "step3d_cuda.tracer_corrector_plain",
                    "step2d.fast_loop"},
    # the budgets keep rows 7-9 off: the momentum phase staged, with rows
    # 6 and 4 standalone
    "upwelling_dia": _ROWS | {"prsgrd_cuda.prsgrd32",
                              "mix3d_cuda.uv3dmix2",
                              "step3d_cuda.tracer_predictor_plain",
                              "step3d_cuda.tracer_corrector_plain"},
}


@pytest.mark.parametrize("case", list(EXPECTED))
def test_dispatch_mirrors_jax_gates(case, monkeypatch):
    cfg, grid, s0, ffn = fx.build_port(case)
    diags = case == "upwelling_dia"
    frc = ffn(cfg, grid, s0.time)
    bry = frc.get("bry")
    ns_active = cfg.nearshore is not None and "Hwave" in frc
    monkeypatch.setenv("ROMS_PALLAS_INTERPRET", "1")
    cfg_j = jax_config(cfg)
    port = {
        "grid_flux": cfg.pallas2d and diag_cuda.supported(cfg, grid)
        and not ns_active,
        "momentum_rhs": rhs3d_cuda.use_kernels(cfg, want_diags=diags),
        "prsgrd32": prsgrd_cuda.supported(cfg),
        "mix": mix3d_cuda.use_kernels(cfg),
        "tracer": step3d_cuda.use_tracer(cfg, bry=bry, want_diags=diags),
        "uv": step3d_cuda.use_uv(cfg, bry=bry, wet={} if cfg.wetdry
                                 else None),
        "fast_loop": cfg.pallas2d and step2d_cuda.supported(cfg, bry),
    }
    ref = {
        "grid_flux": diag_pallas.use_pallas(cfg_j) and grid.zice is None
        and not ns_active,
        "momentum_rhs": rhs3d_pallas.use_pallas(cfg_j, want_diags=diags),
        "prsgrd32": prsgrd_pallas.use_pallas(cfg_j),
        "mix": mix3d_pallas.use_pallas(cfg_j),
        "tracer": step3d_pallas.use_tracer_pallas(cfg_j, bry=bry,
                                                  want_diags=diags),
        "uv": step3d_pallas.use_uv_pallas(cfg_j, bry=bry,
                                          wet={} if cfg.wetdry else None),
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
    stepping.step(cfg, grid, s0, ffn, collect_diags=diags)
    assert set(calls) == EXPECTED[case]


def test_registry_and_cli_list_all_of_roms_tpu():
    assert set(REGISTRY) == set(JCASES) and len(REGISTRY) == 30
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert cli(["cases"]) == 0
    assert set(JCASES) <= set(out.getvalue().split())


def test_dia_stream_matches_roms_tpu_writer(dia_case, tmp_path):
    """Four steps with ndia = 2: two records, each the mean of two steps'
    budget dicts, as roms_tpu's DiagWriter writes the same sums."""
    cfg, grid, s0, ffn = dia_case
    path = str(tmp_path / "dia.nc")
    sim = Simulation(cfg, grid, s0, ffn, dia_file=path, ndia=2, ninfo=0,
                     log=lambda *a: None)
    sim.run(4)
    sim.finalize()
    got = read_history(path)
    want_path = str(tmp_path / "dia_ref.nc")
    w = JDiagWriter(want_path, jax_config(cfg))
    s = s0
    for rec in range(2):
        sums = None
        for _ in range(2):
            s, dia = stepping.step(cfg, grid, s, ffn, collect_diags=True)
            sums = dia if sums is None else {k: sums[k] + v
                                             for k, v in dia.items()}
        w.write({k: v.numpy() for k, v in sums.items()},
                time=float(s.time) - cfg.dt, scale=0.5)
    w.close()
    want = read_history(want_path)
    assert set(got) == set(want) and len(got["ocean_time"]) == 2
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    total = sum(got[f"u_{k}"] for k in TERMS)
    np.testing.assert_allclose(got["u_rate"], total, rtol=0, atol=1e-15)


# ---------------------------------------------------------------------------
# (e) row 7 under BODYFORCE
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def rhs_inputs():
    """Seeded rhs3d arguments on UPWELLING's 10x12x10 grid in both
    packages, uneven layers."""
    cfg, grid, _, _ = upwelling.build(upwelling.make_config(
        Lm=10, Mm=12, N=10), device="cpu")
    rng = np.random.default_rng(17)
    N, ny, nx = cfg.N, cfg.ny_tot, cfg.nx_tot
    a = dict(u=0.1 * rng.standard_normal((N, ny, nx)),
             v=0.1 * rng.standard_normal((N, ny, nx)),
             Huon=rng.standard_normal((N, ny, nx)),
             Hvom=rng.standard_normal((N, ny, nx)),
             W=rng.standard_normal((N + 1, ny, nx)),
             Hz=rng.uniform(1.0, 9.0, (N, ny, nx)),
             ru=rng.standard_normal((N, ny, nx)),
             rv=rng.standard_normal((N, ny, nx)))
    for k in ("sustr", "svstr", "bustr", "bvstr"):
        a[k] = 1e-4 * rng.standard_normal((ny, nx))
    return cfg, grid, a


@pytest.mark.parametrize("levs", [(1, 10), (4, 3), (10, 1)])
def test_rhs3d_bodyforce_matches_jax(rhs_inputs, levs):
    cfg, grid, a = rhs_inputs
    cfg = cfg.replace(bodyforce=True, levsfrc=levs[0], levbfrc=levs[1])
    cfg_j = jax_config(cfg)
    g_j = SimpleNamespace(**{k: jnp.asarray(getattr(grid, k).numpy())
                             for k in ("pm", "pn", "fomn", "dndx", "dmde",
                                       "om_u", "on_u", "om_v", "on_v")})
    t = {k: torch.tensor(v) for k, v in a.items()}
    j = {k: jnp.asarray(v) for k, v in a.items()}
    names = ("u", "v", "Huon", "Hvom", "W", "Hz", "ru", "rv", "sustr",
             "svstr", "bustr", "bvstr")
    got = rhs3d.rhs3d_momentum(cfg, grid, *(t[k] for k in names))
    ref = jrhs3d.rhs3d_momentum(cfg_j, g_j, *(j[k] for k in names))
    for x, y, name in zip(got, ref, ("ru", "rv", "rufrc", "rvfrc")):
        scale = float(np.abs(np.asarray(y)).max())
        np.testing.assert_allclose(x.numpy(), np.asarray(y), rtol=0,
                                   atol=1e-12 * scale, err_msg=name)
    # the stresses moved from the boundary fluxes into ru/rv
    off = rhs3d.rhs3d_momentum(cfg.replace(bodyforce=False), grid,
                               *(t[k] for k in names))
    assert float((got[0] - off[0]).abs().max()) > 0.0
    a1, a2 = pre_step3d.ab3_start_coefs(5)
    zero = torch.zeros_like(t["ru"])
    got = pre_step3d.momentum_init(cfg, grid.pm, grid.pn, a1, a2, t["u"],
                                   t["v"], t["Hz"], zero, zero, zero, zero,
                                   t["sustr"], t["svstr"], t["bustr"],
                                   t["bvstr"])
    ja1, ja2 = jpre.ab3_start_coefs(5, jnp.float64)
    zj = jnp.zeros_like(j["ru"])
    ref = jpre.momentum_init(cfg_j, g_j.pm, g_j.pn, ja1, ja2, j["u"],
                             j["v"], j["Hz"], zj, zj, zj, zj, j["sustr"],
                             j["svstr"], j["bustr"], j["bvstr"])
    for x, y in zip(got, ref):
        np.testing.assert_allclose(x.numpy(), np.asarray(y), rtol=0,
                                   atol=1e-12 * float(np.abs(y).max()))


def test_level_sums_in_k_order(rhs_inputs):
    _, _, a = rhs_inputs
    Hz = torch.tensor(a["Hz"])
    s = torch.zeros_like(Hz[0])
    for k in range(3, Hz.shape[0]):
        s = s + Hz[k]
    assert torch.equal(rhs3d.level_sum(Hz, 3, Hz.shape[0]), s)
    assert torch.equal(rhs3d.level_sum(Hz, -2, 1), Hz[0] + 0.0)
    assert float(rhs3d.level_sum(Hz, 4, 4).abs().max()) == 0.0


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_row7_launch_under_bodyforce(rhs_inputs, monkeypatch, dtype):
    """The wrapper hands the kernel the flag, levsfrc - 1 and levbfrc, and
    the plan of four more shared words a tile point; without BODYFORCE the
    plan is the one it was."""
    cfg, grid, a = rhs_inputs
    cfg = cfg.replace(bodyforce=True, levsfrc=4, levbfrc=3)
    seen = []
    monkeypatch.setattr(rhs3d_cuda, "on_card", lambda x: True)
    monkeypatch.setattr(rhs3d_cuda, "launch",
                        lambda name, f64, tensors, ints, dbl, stream:
                        seen.append((name, f64, ints, dbl)))
    monkeypatch.setattr(torch.cuda, "current_stream", lambda d=None: None)
    g = dataclasses.replace(grid, **{k: getattr(grid, k).to(dtype) for k in
                                     ("pm", "pn", "f")})
    t = {k: torch.tensor(v, dtype=dtype) for k, v in a.items()}
    rhs3d_cuda.rhs3d(cfg, g, t["u"], t["v"], t["Huon"], t["Hvom"], t["W"],
                     t["Hz"], t["ru"], t["rv"], t["sustr"], t["svstr"],
                     t["bustr"], t["bvstr"],
                     start=(0.0, 0.5, t["ru"], t["ru"], t["rv"], t["rv"]))
    (name, f64, ints, dbl), = seen
    plan = rhs3d_cuda.rhs3d_plan(dtype, cfg.N, cfg.ny_tot, cfg.nx_tot,
                                 bodyforce=True)
    base = rhs3d_cuda.rhs3d_plan(dtype, cfg.N, cfg.ny_tot, cfg.nx_tot)
    word = 8 if dtype == torch.float64 else 4
    npts = plan["tile"][0] * plan["tile"][1]
    assert name == "roms_rhs3d" and f64 == (dtype == torch.float64)
    assert ints[-12:] == [1, 1, 0, 1, 1, 3, 3, *plan["tile"],
                          plan["levels"], plan["threads"],
                          plan["smem_bytes"]]
    assert (plan["tile"], plan["levels"]) == (base["tile"], base["levels"])
    assert plan["smem_bytes"] == base["smem_bytes"] + 4 * npts * word
    assert dbl == [cfg.dt, 0.0, 0.5]


# ---------------------------------------------------------------------------
# the branches that once raised, on the other test files' cases
# ---------------------------------------------------------------------------
def branch_forcing(ffn, cfg):
    """`ffn` with what the branch of `cfg` acts on: under the nearshore
    radiation stress a wave field shoaling toward +y (tests/test_nearshore.py
    ffn_waves), its height a fifth of the depth and its length ten times
    the depth; under BODYFORCE an eastward wind stress of 1e-4 m2/s2."""
    def forcing(cfg_, grid_, time):
        out = dict(ffn(cfg_, grid_, time)) if ffn else {}
        if cfg.bodyforce:
            out["sustr"] = out.get("sustr", 0.0) + \
                torch.full_like(grid_.h, 1e-4)
        if cfg.nearshore is not None:
            yy = torch.arange(grid_.h.shape[-2], dtype=grid_.h.dtype,
                              device=grid_.h.device)[:, None]
            decay = torch.clamp(1.0 - 0.04 * (yy - cfg_.halo), min=0.2)
            depth = torch.clamp(grid_.h, min=0.0)
            out["Hwave"] = 0.2 * depth * decay
            out["Dwave"] = torch.full_like(grid_.h, torch.pi)
            out["Lwave"] = torch.clamp(10.0 * depth, min=1.0)
        return out
    return forcing


def run_branch(cfg, grid, s0, ffn, change: dict, kw: dict):
    """One CPU step of a branch the step once refused: `change` to the
    configuration (BODYFORCE, a nearshore kernel, with shoaling waves
    added to the forcing), kw collect_diags (the budgets, which must
    close), or kw stokes (the general fast loop carrying a Stokes
    transport, which with a zero transport is the loop without one).
    Asserts the result finite and moved by the branch."""
    cfg = dataclasses.replace(cfg, **change)
    if kw.get("stokes"):
        fs0 = step2d.make_fast_state(cfg, s0.zeta, s0.ubar, s0.vbar)
        zero = torch.zeros_like(s0.zeta)
        none = step2d.fast_loop(cfg, grid, fs0)
        flat = step2d.fast_loop(cfg, grid, fs0, us2d=(zero, zero))
        ramp = torch.linspace(0.0, 1.0, s0.zeta.shape[-1],
                              dtype=s0.zeta.dtype)
        ts = 1e-3 * ramp * grid.on_u * grid.umask     # convergent
        moved = step2d.fast_loop(cfg, grid, fs0, us2d=(ts, zero))
        for name in step2d.FS_FIELDS:
            assert torch.equal(getattr(flat[0], name),
                               getattr(none[0], name)), name
            assert bool(torch.isfinite(getattr(moved[0], name)).all())
        assert not torch.equal(moved[0].zeta_n, none[0].zeta_n)
        return
    ffn = branch_forcing(ffn, cfg)
    out = stepping.step(cfg, grid, s0, ffn, **kw)
    s = out[0] if kw.get("collect_diags") else out
    base = stepping.step(dataclasses.replace(cfg, bodyforce=False,
                                             nearshore=None), grid, s0,
                         lambda c, g, t: {k: v for k, v in
                                          ffn(c, g, t).items()
                                          if k not in ("Hwave", "Dwave",
                                                       "Lwave")})
    for k in ("zeta", "u", "v", "t", "ubar", "vbar"):
        assert bool(torch.isfinite(getattr(s, k)).all()), k
    if kw.get("collect_diags"):
        dia = out[1]
        for c in ("u", "v"):
            torch.testing.assert_close(sum(dia[f"{c}_{k}"] for k in TERMS),
                                       dia[f"{c}_rate"], rtol=0, atol=1e-15)
        assert all(torch.equal(getattr(s, k), getattr(base, k))
                   for k in TENSOR_FIELDS)
    else:
        assert not torch.equal(s.u, base.u)


def test_nearshore_without_waves_is_calm(monkeypatch):
    """cfg.nearshore with no Hwave in the forcing: roms_tpu's ns_active is
    false, so grid_flux and eos stay on their kernels, no stress or
    Stokes transport enters, and only the fused fast loop stays off (its
    gate reads cfg.nearshore): the step equals the step without
    nearshore."""
    cfg, grid, s0, ffn = upwelling.build(upwelling.make_config(
        Lm=8, Mm=10, N=6, ndtfast=6), device="cpu")
    calls = []
    for mod, attr in ((diag_cuda, "grid_flux"), (diag_cuda, "eos"),
                      (step2d, "fast_loop")):
        fn = getattr(mod, attr)

        def rec(*a, _fn=fn, _name=attr, **k):
            calls.append(_name)
            return _fn(*a, **k)
        monkeypatch.setattr(mod, attr, rec)
    s = stepping.step(cfg.replace(nearshore="mellor05"), grid, s0, ffn)
    assert calls == ["grid_flux", "eos", "fast_loop"]
    monkeypatch.undo()
    ref = stepping.step(cfg, grid, s0, ffn)
    for k in TENSOR_FIELDS:
        assert torch.equal(getattr(s, k), getattr(ref, k)), k
