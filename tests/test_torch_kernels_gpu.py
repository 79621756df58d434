"""roms_tpu_torch CUDA kernels against their plain PyTorch versions, on the
card, in float32 and float64, on UPWELLING and on closed, gradient and
masked (an island) variants of it (the momentum kernels also on a
curvilinear one), the geopotential tracer diffusion on a small BENCHMARK,
the tracer kernels, prsgrd32 and eos bitwise, rhs3d, uv3dmix2 and
grid_flux bitwise but for their column sums, uv_corrector and omega within
RTOL (their outputs all pass through column sums) and every kernel's second
launch bitwise equal to its first, also on the small BENCHMARK (1-3
tracers; closed and masked variants for the momentum and uv kernels;
uv3dmix2 on 2, 4 and 8 level slots), on a grid smaller than one tile and
at their largest shared-memory plans;
the UPWELLING anchor with ten kernels on, the small-BENCHMARK fixture
(tests/data/torch_benchmark_small.npz) with all eleven on, the run
driver's restarts across the card and the CPU, and on KELVIN, ESTUARY_TEST
and RIVERPLUME1 at their published sizes the kernels each step launches
against their plain versions on its arguments, the steps with kernels on
against off, and the small regional fixture
(tests/data/torch_regional_small.npz); the same on LAB_CANYON, INLET_TEST
and BENCHMARK1 with tides (tests/data/torch_coastal_small.npz), and every
kernel of the step on north-south periodic grids; the tracer kernels under
C2, U1 and A4 advection, a small case of each operator family with
kernels on against off, and the small operator fixture
(tests/data/torch_operators_small.npz).

Marked ``gpu``; each test skips without a CUDA device.  This file imports
no jax, so it also runs where jax is absent:

    python -m pytest tests/test_torch_kernels_gpu.py -m gpu --noconftest
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

import chip_smoke
from chip_smoke import BITWISE, CARD_FACTOR, fixture_script
from roms_tpu_torch import stepping
from roms_tpu_torch.config import LBC, BC_CLOSED, BC_GRADIENT, BC_PERIODIC
from roms_tpu_torch.grid import hc_of
from roms_tpu_torch.models import benchmark, upwelling
from roms_tpu_torch.ops import diag_cuda, mix3d_cuda, prsgrd_cuda, \
    rhs3d_cuda, step2d_cuda, step3d_cuda
from roms_tpu_torch.ops.pre_step3d import ab3_start_coefs, momentum_init
from roms_tpu_torch.ops.step2d import FS_FIELDS, Fast2DState
from roms_tpu_torch.ops.vbc import set_vbc

pytestmark = pytest.mark.gpu

torch.set_num_threads(1)

RTOL = {torch.float64: 1e-12, torch.float32: 1e-5}
FAST_RTOL = {torch.float64: 1e-10, torch.float32: 1e-4}
_ANCHOR = os.path.join(os.path.dirname(__file__), "data",
                       "upwelling_anchor.npz")
_BENCH_FIXTURE = os.path.join(os.path.dirname(__file__), "data",
                              "torch_benchmark_small.npz")


@pytest.fixture(scope="module")
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda:0")


def _close(got, ref, rtol, name=""):
    for a, b in zip(got, ref):
        torch.cuda.synchronize()
        scale = max(b.abs().max().item(), 1e-30)
        err = (a - b).abs().max().item()
        assert err <= rtol * scale, f"{name}: {err:.3e} > {rtol}*{scale:.3e}"


def _config(kind, dtype, N=6):
    cfg = upwelling.make_config(Lm=20, Mm=16, N=N, ndtfast=8, dtype=dtype)
    if kind in ("closed", "masked"):
        cfg = dataclasses.replace(
            cfg, ew_periodic=False, gamma2=-1.0,
            lbc_zeta=LBC(BC_GRADIENT, BC_CLOSED, BC_CLOSED, BC_GRADIENT),
            lbc_ubar=LBC(BC_CLOSED, BC_GRADIENT, BC_CLOSED, BC_CLOSED),
            lbc_vbar=LBC(BC_GRADIENT, BC_CLOSED, BC_CLOSED, BC_GRADIENT),
            lbc_u=LBC(), lbc_v=LBC(), lbc_t=LBC())
    if kind == "gradient":
        grad = LBC(BC_GRADIENT, BC_GRADIENT, BC_GRADIENT, BC_GRADIENT)
        cfg = dataclasses.replace(cfg, ew_periodic=False, lbc_zeta=grad,
                                  lbc_ubar=grad, lbc_vbar=grad, lbc_u=grad,
                                  lbc_v=grad, lbc_t=grad)
    return cfg


def _island(grid):
    """The grid with a land block inside its interior."""
    m = grid.rmask.clone()
    m[8:11, 7:12] = 0.0
    umask = m * torch.roll(m, 1, -1)
    vmask = m * torch.roll(m, 1, -2)
    return dataclasses.replace(grid, rmask=m, umask=umask, vmask=vmask,
                               pmask=umask * torch.roll(umask, 1, -2))


@pytest.fixture(scope="module", params=[
    (kind, dtype) for kind in ("upwelling", "closed", "gradient", "masked")
    for dtype in ("float64", "float32")])
def developed(request, device):
    """A case and its state after 3 plain steps, on the card."""
    kind, dtype = request.param
    cfg, grid, s0, ffn = upwelling.build(_config(kind, dtype), device=device)
    if kind == "masked":
        grid = _island(grid)
    s = stepping.run(cfg.replace(pallas2d=False), grid, s0, 3, ffn)
    return cfg, grid, s


def _stage_inputs(cfg, grid, s):
    """Time-n depths, fluxes, density and boundary fluxes from state s,
    through the plain versions, with random surface/bottom tracer fluxes."""
    rng = np.random.default_rng(17)
    R = lambda shape, scale: scale * torch.tensor(  # noqa: E731
        rng.standard_normal(shape), dtype=s.u.dtype, device=s.u.device)
    z_r, z_w, Hz, Huon, Hvom, W = diag_cuda.grid_flux_plain(
        cfg, grid, s.zeta, s.u, s.v, hc_of(cfg))
    rho, _ = diag_cuda.eos_plain(cfg, s.t, z_r, z_w, False)
    stflux = R(s.t.shape[:1] + s.zeta.shape, 1e-5)
    btflux = R(s.t.shape[:1] + s.zeta.shape, 1e-6)
    bustr, bvstr, stflx, btflx = set_vbc(cfg, grid, s.u, s.v, s.t, stflux,
                                         btflux)
    return dict(z_r=z_r, z_w=z_w, Hz=Hz, Huon=Huon, Hvom=Hvom, W=W, rho=rho,
                bustr=bustr, bvstr=bvstr, stflx=stflx, btflx=btflx, R=R)


def _check_grid_flux(cfg, grid, s):
    """grid_flux in one launch: z_r, z_w, Hz, Huon and Hvom bitwise equal
    to its plain version, W within RTOL (torch's cumsum adds in another
    order), a second launch bitwise equal to the first; returns the plain
    version's outputs."""
    args = (cfg, grid, s.zeta, s.u, s.v, hc_of(cfg))
    before = diag_cuda.grid_flux.launches
    got = diag_cuda.grid_flux(*args)
    assert diag_cuda.grid_flux.launches == before + 1
    ref = diag_cuda.grid_flux_plain(*args)
    _equal(got[:5], ref[:5], "grid_flux")
    _close(got[5:], ref[5:], RTOL[s.u.dtype], "grid_flux W")
    _equal(diag_cuda.grid_flux(*args), got, "grid_flux, second launch")
    return ref


def _check_omega(cfg, grid, Huon, Hvom, z_w):
    """omega in one launch within RTOL of its plain version (torch's cumsum
    adds in another order), a second launch bitwise equal to the first."""
    args = (cfg, grid, Huon, Hvom, z_w)
    before = diag_cuda.omega.launches
    got = diag_cuda.omega(*args)
    assert diag_cuda.omega.launches == before + 1
    _close([got], [diag_cuda.omega_plain(*args)], RTOL[Huon.dtype], "omega")
    _equal([diag_cuda.omega(*args)], [got], "omega, second launch")


def _check_eos(cfg, t, z_r, z_w, want_bvf):
    """eos within RTOL of its plain version, bitwise for the outputs
    chip_smoke.BITWISE names, a second launch bitwise equal to the
    first."""
    args = (cfg, t, z_r, z_w, want_bvf)
    before = diag_cuda.eos.launches
    got = diag_cuda.eos(*args)
    assert diag_cuda.eos.launches == before + 1
    ref = diag_cuda.eos_plain(*args)
    _close(got, ref, RTOL[t.dtype], f"eos {cfg.eos} bvf={want_bvf}")
    exact = [n for n in BITWISE["eos"] if n < len(ref)]
    _equal([got[n] for n in exact], [ref[n] for n in exact],
           f"eos {cfg.eos} bvf={want_bvf}")
    _equal(diag_cuda.eos(*args), got, "eos, second launch")


def test_grid_flux_and_omega_kernels(developed):
    cfg, grid, s = developed
    ref = _check_grid_flux(cfg, grid, s)
    _check_omega(cfg, grid, ref[3], ref[4], ref[1])


@pytest.mark.parametrize("eos", ["linear", "jm95"])
@pytest.mark.parametrize("want_bvf", [False, True])
def test_eos_kernel(developed, eos, want_bvf):
    cfg, grid, s = developed
    cfg = cfg.replace(eos=eos, Scoef=7.6e-4)
    z_r, z_w, *_ = diag_cuda.grid_flux_plain(cfg, grid, s.zeta, s.u, s.v,
                                             hc_of(cfg))
    _check_eos(cfg, s.t, z_r, z_w, want_bvf)


def _fast_loop_inputs(s, iic):
    """Fast-state fields from state s, and random slow forcing."""
    rng = np.random.default_rng(iic)
    fields = {k: getattr(s, src) for k, src in (
        ("zeta_n", "zeta"), ("zeta_nm1", "zeta"), ("ubar_n", "ubar"),
        ("ubar_nm1", "ubar"), ("vbar_n", "vbar"), ("vbar_nm1", "vbar"),
        ("rzeta_n", "rzeta"), ("rubar_n", "rubar"), ("rvbar_n", "rvbar"))}
    for k in FS_FIELDS:
        fields.setdefault(k, torch.zeros_like(s.zeta))
    frc = [1e-4 * torch.tensor(rng.standard_normal(s.zeta.shape),
                               dtype=s.zeta.dtype, device=s.zeta.device)
           for _ in range(6)]
    return fields, frc


def _check_fast_loop(cfg, grid, s, iic):
    """The kernel against its plain version, and a second launch on a copy
    of the same input bitwise equal to the first (a race between blocks
    would show as a difference)."""
    fields, frc = _fast_loop_inputs(s, iic)
    fresh = lambda: Fast2DState(**{k: a.clone() for k, a in fields.items()})
    before = step2d_cuda.fast_loop.launches
    fs_k, ruc_k, rvc_k = step2d_cuda.fast_loop(cfg, grid, fresh(), *frc, iic)
    assert step2d_cuda.fast_loop.launches == before + 1
    fs_p, ruc_p, rvc_p = step2d_cuda.fast_loop_plain(cfg, grid, fresh(),
                                                     *frc, iic)
    got = [getattr(fs_k, k) for k in FS_FIELDS] + [ruc_k, rvc_k]
    _close(got, [getattr(fs_p, k) for k in FS_FIELDS] + [ruc_p, rvc_p],
           FAST_RTOL[s.u.dtype], "fast_loop")
    fs_2, ruc_2, rvc_2 = step2d_cuda.fast_loop(cfg, grid, fresh(), *frc, iic)
    again = [getattr(fs_2, k) for k in FS_FIELDS] + [ruc_2, rvc_2]
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.parametrize("iic", [0, 1, 5])
def test_fast_loop_kernel(developed, iic):
    cfg, grid, s = developed
    _check_fast_loop(cfg, grid, s, iic)


@pytest.fixture(scope="module", params=["float64", "float32"])
def fixture_case(request, device):
    """The small BENCHMARK of the fixture (70x38 padded points, spherical:
    curvilinear terms and a varying f) after 3 plain steps, on the card."""
    cfg, grid, s0, ffn = benchmark.build(benchmark.make_config(
        **fixture_script().CASE, dtype=request.param), device=device)
    s = stepping.run(cfg.replace(pallas2d=False), grid, s0, 3, ffn)
    return cfg, grid, s


@pytest.mark.parametrize("iic", [0, 5])
def test_fast_loop_kernel_on_many_blocks(fixture_case, iic):
    """A grid of several blocks whose last is ragged (the padded points are
    not a multiple of the block)."""
    cfg, grid, s = fixture_case
    points = cfg.ny_tot * cfg.nx_tot
    plan = step2d_cuda.launch_plan(s.u.dtype, points)
    assert plan["blocks"] > 1 and points % plan["threads"] != 0, plan
    _check_fast_loop(cfg, grid, s, iic)


def test_fast_loop_kernel_rejects_aliased_fields(developed):
    cfg, grid, s = developed
    fs = Fast2DState(**{k: s.zeta for k in FS_FIELDS})
    with pytest.raises(ValueError, match="alias"):
        step2d_cuda.fast_loop(cfg, grid, fs, *[s.zeta] * 6, 0)


def _equal(got, ref, name):
    torch.cuda.synchronize()
    for a, b in zip(got, ref):
        assert torch.equal(a, b), \
            f"{name}: differs by {(a - b).abs().max().item():.3e}"


def _check_prsgrd32(cfg, grid, f, tide):
    """prsgrd32 on stage inputs f, bitwise equal to its plain version, as
    is a second launch; `tide` adds an equilibrium tide."""
    kw = dict(eq_tide=f["R"](f["Hz"].shape[1:], 0.05)) if tide else {}
    args = (cfg, grid, f["rho"], f["z_r"], f["z_w"], f["Hz"])
    before = prsgrd_cuda.prsgrd32.launches
    got = prsgrd_cuda.prsgrd32(*args, **kw)
    assert prsgrd_cuda.prsgrd32.launches == before + 1
    _equal(got, prsgrd_cuda.prsgrd32_plain(*args, **kw), "prsgrd32")
    _equal(prsgrd_cuda.prsgrd32(*args, **kw), got,
           "prsgrd32, second launch")


@pytest.mark.parametrize("tide", [False, True])
def test_prsgrd32_kernel(developed, tide):
    cfg, grid, s = developed
    _check_prsgrd32(cfg, grid, _stage_inputs(cfg, grid, s), tide)


def _with_tracers(cfg, s, nt):
    """The case with nt tracers: the first nt of the state's, and random
    passive ones beyond two (C4 and U3 horizontal, SPLINES and C4 vertical
    advection in turn)."""
    t, t_prev = s.t[:nt], s.t_prev[:nt]
    if nt > t.shape[0]:
        rng = np.random.default_rng(29)
        extra = torch.tensor(
            rng.standard_normal((nt - t.shape[0],) + t.shape[1:]),
            dtype=t.dtype, device=t.device)
        t, t_prev = torch.cat([t, extra]), torch.cat([t_prev, 0.9 * extra])
    hadv = cfg.t_hadv[:2] + ("C4", "U3") * nt
    vadv = cfg.t_vadv[:2] + ("SPLINES", "C4") * nt
    cfg = cfg.replace(ntracers=nt, t_hadv=hadv[:nt], t_vadv=vadv[:nt])
    return cfg, s.replace(t=t.contiguous(), t_prev=t_prev.contiguous())


def _check_predictor(cfg, grid, s, f, iic, extra):
    """tracer_predictor on state s and stage inputs f, bitwise equal to its
    plain version, as is a second launch; `extra` adds the KPP nonlocal
    flux and the penetrating shortwave terms.  Returns (t3, t_nnew)."""
    kw = {}
    if extra:
        sw = f["W"].shape
        kw = dict(ghats=f["R"]((min(cfg.ntracers, 2),) + sw, 1e-3),
                  srflx=f["R"](s.zeta.shape, 1e-4).abs(),
                  swdk_w=torch.rand(sw, dtype=s.u.dtype, device=s.u.device))
    args = (cfg, grid, iic, s.t, s.t_prev, f["Hz"], f["Huon"], f["Hvom"],
            f["W"], s.Akt + 1e-3, f["stflx"], f["btflx"])
    before = step3d_cuda.tracer_predictor.launches
    got = step3d_cuda.tracer_predictor(*args, **kw)
    assert step3d_cuda.tracer_predictor.launches == before + 1
    ref = step3d_cuda.tracer_predictor_plain(*args, **kw)
    _equal(got, ref, "tracer_predictor")
    _equal(step3d_cuda.tracer_predictor(*args, **kw), got,
           "tracer_predictor, second launch")
    return ref


def _check_corrector(cfg, grid, s, f, t3, t_nnew):
    """tracer_corrector (spline or Thomas vertical diffusion, as cfg says)
    from (t3, t_nnew), bitwise equal to its plain version, as is a second
    launch."""
    args = (cfg, grid, t_nnew, t3, f["Huon"], f["Hvom"], f["W"],
            f["Hz"] * 1.001, f["z_r"] + 0.01, s.Akt + 1e-3)
    before = step3d_cuda.tracer_corrector.launches
    got = step3d_cuda.tracer_corrector(*args)
    assert step3d_cuda.tracer_corrector.launches == before + 1
    _equal([got], [step3d_cuda.tracer_corrector_plain(*args)],
           "tracer_corrector")
    _equal([step3d_cuda.tracer_corrector(*args)], [got],
           "tracer_corrector, second launch")


def _ragged_tiles(cfg, dtype):
    """Whether both tracer kernels run on several tiles, the last ragged,
    with tiles that straddle rows of the padded grid."""
    points = cfg.ny_tot * cfg.nx_tot
    plans = [step3d_cuda.tracer_plan(name, dtype, cfg.N, cfg.ntracers,
                                     cfg.ny_tot, cfg.nx_tot)
             for name in ("tracer_predictor", "tracer_corrector")]
    return all(p["blocks"] > 1 and points % p["tile"] != 0 and
               cfg.nx_tot % p["tile"] != 0 for p in plans)


@pytest.mark.parametrize("vadv", ["C4", "SPLINES"])
@pytest.mark.parametrize("iic,extra", [(0, False), (1, False), (5, False),
                                       (5, True)])
def test_tracer_predictor_kernel(developed, iic, extra, vadv):
    """Each rung of the AB3 start-up; `extra` adds the KPP nonlocal flux
    and the penetrating shortwave terms; `vadv` is the vertical tracer
    advection of both tracers.  On ragged tiles."""
    cfg, grid, s = developed
    cfg = cfg.replace(t_vadv=(vadv, vadv))
    assert _ragged_tiles(cfg, s.u.dtype)
    _check_predictor(cfg, grid, s, _stage_inputs(cfg, grid, s), iic, extra)


@pytest.mark.parametrize("vadv", ["C4", "SPLINES"])
@pytest.mark.parametrize("splines", [True, False])
def test_tracer_corrector_kernel(developed, splines, vadv):
    """On ragged tiles."""
    cfg, grid, s = developed
    cfg = cfg.replace(splines_vdiff=splines, t_vadv=(vadv, vadv))
    assert _ragged_tiles(cfg, s.u.dtype)
    f = _stage_inputs(cfg, grid, s)
    t3, t_nnew = step3d_cuda.tracer_predictor_plain(
        cfg, grid, 3, s.t, s.t_prev, f["Hz"], f["Huon"], f["Hvom"], f["W"],
        s.Akt + 1e-3, f["stflx"], f["btflx"])
    _check_corrector(cfg, grid, s, f, t3, t_nnew)


@pytest.mark.parametrize("splines", [True, False])
@pytest.mark.parametrize("nt", [1, 2, 3])
def test_tracer_kernels_on_ragged_tiles(fixture_case, nt, splines):
    """The small BENCHMARK (spherical, E-W periodic, 70 x 38 padded points:
    several tiles, the last ragged, tiles straddling rows) with 1, 2 or 3
    tracers, the KPP and shortwave terms on."""
    cfg, grid, s = fixture_case
    cfg, s = _with_tracers(cfg.replace(splines_vdiff=splines), s, nt)
    assert _ragged_tiles(cfg, s.u.dtype)
    f = _stage_inputs(cfg, grid, s)
    _check_corrector(cfg, grid, s, f,
                     *_check_predictor(cfg, grid, s, f, 5, True))


@pytest.mark.parametrize("nt", [2, 16])
def test_tracer_kernels_at_the_largest_plan(device, nt):
    """N = 64 in float64 on a small gradient-walled plane: the largest
    columns the kernels take, so the fewest a tile (8, and 2 with 16
    tracers), in more than 48 KB of shared memory a block."""
    cfg, grid, s0, ffn = upwelling.build(
        _config("gradient", "float64", N=64), device=device)
    s = stepping.run(cfg.replace(pallas2d=False), grid, s0, 1, ffn)
    cfg, s = _with_tracers(cfg, s, nt)
    for name in ("tracer_predictor", "tracer_corrector"):
        plan = step3d_cuda.tracer_plan(name, torch.float64, 64, nt,
                                       cfg.ny_tot, cfg.nx_tot)
        assert plan["tile"] <= 8 and plan["smem_bytes"] > 48 * 1024, plan
    f = _stage_inputs(cfg, grid, s)
    _check_corrector(cfg, grid, s, f,
                     *_check_predictor(cfg, grid, s, f, 5, True))


def _check_uv_corrector(cfg, grid, s, f, iic):
    """uv_corrector from the AB3 start of state s, with random right-hand
    sides and barotropic transports: within RTOL of its plain version (its
    outputs all pass through column sums), and a second launch bitwise
    equal to the first."""
    a1, a2 = ab3_start_coefs(iic)
    zero = torch.zeros_like(s.zeta)
    u_nnew, v_nnew = momentum_init(
        cfg, grid.pm, grid.pn, a1, a2, s.u, s.v, f["Hz"], s.ru_prev,
        s.ru_prev2, s.rv_prev, s.rv_prev2, zero, zero, f["bustr"],
        f["bvstr"])
    R = f["R"]
    args = (cfg, grid, iic, u_nnew, v_nnew, R(s.u.shape, 1e-2),
            R(s.v.shape, 1e-2), f["Hz"] * 1.001, s.Akv + 1e-3,
            R(s.zeta.shape, 10.0), R(s.zeta.shape, 10.0),
            R(s.zeta.shape, 10.0), R(s.zeta.shape, 10.0), f["Huon"],
            f["Hvom"])
    before = step3d_cuda.uv_corrector.launches
    got = step3d_cuda.uv_corrector(*args)
    assert step3d_cuda.uv_corrector.launches == before + 1
    _close(got, step3d_cuda.uv_corrector_plain(*args), RTOL[s.u.dtype],
           "uv_corrector")
    _equal(step3d_cuda.uv_corrector(*args), got,
           "uv_corrector, second launch")


def _check_uv3dmix2(cfg, grid, s, f):
    """uv3dmix2 on fresh copies of the fields it updates in place: u_nnew
    and v_nnew bitwise equal to its plain version, rufrc and rvfrc (column
    sums) within RTOL, and a second launch bitwise equal to the first."""
    R = f["R"]
    ins = (s.u, s.v, f["Hz"])
    upd = (s.u * f["Hz"], s.v * f["Hz"], R(s.zeta.shape, 1.0),
           R(s.zeta.shape, 1.0))
    before = mix3d_cuda.uv3dmix2.launches
    got = mix3d_cuda.uv3dmix2(cfg, grid, *ins, *[a.clone() for a in upd],
                              cfg.dt)
    assert mix3d_cuda.uv3dmix2.launches == before + 1
    ref = mix3d_cuda.uv3dmix2_plain(cfg, grid, *ins, *upd, cfg.dt)
    _equal(got[:2], ref[:2], "uv3dmix2")
    _close(got[2:], ref[2:], RTOL[s.u.dtype], "uv3dmix2 column sums")
    _equal(mix3d_cuda.uv3dmix2(cfg, grid, *ins, *[a.clone() for a in upd],
                               cfg.dt), got, "uv3dmix2, second launch")


def _uv_plans(cfg, dtype):
    """The uv_corrector and uv3dmix2 plans of a case."""
    shape = (cfg.N, cfg.ny_tot, cfg.nx_tot)
    return (step3d_cuda.uv_plan(dtype, *shape),
            mix3d_cuda.uv3dmix2_plan(dtype, *shape))


@pytest.mark.parametrize("iic", [0, 1, 5])
def test_uv_corrector_kernel(developed, iic):
    """Each rung of the AB3 start-up, on tiles that straddle rows of the
    padded grid, the last ragged."""
    cfg, grid, s = developed
    plan = _uv_plans(cfg, s.u.dtype)[0]
    points = cfg.ny_tot * cfg.nx_tot
    assert plan["blocks"] > 1 and points % plan["tile"] != 0 and \
        cfg.nx_tot % plan["tile"] != 0, plan
    _check_uv_corrector(cfg, grid, s, _stage_inputs(cfg, grid, s), iic)


def _curvilinear(cfg, grid, curv):
    """With `curv`, the case with the curvilinear metric terms on and
    random dndx/dmde."""
    if not curv:
        return cfg, grid
    rng = np.random.default_rng(23)
    d = {k: torch.tensor(50.0 * rng.standard_normal(grid.h.shape),
                         dtype=grid.h.dtype, device=grid.h.device)
         for k in ("dndx", "dmde")}
    return cfg.replace(curvgrid=True), dataclasses.replace(grid, **d)


def _momentum_inputs(s, f):
    """rhs3d's arguments after (cfg, grid): random pressure gradients and
    surface stresses, the rest from state s and the stage inputs f."""
    R = f["R"]
    return (s.u, s.v, f["Huon"], f["Hvom"], f["W"], f["Hz"],
            R(s.u.shape, 1e-2), R(s.v.shape, 1e-2), R(s.zeta.shape, 1e-4),
            R(s.zeta.shape, 1e-4), f["bustr"], f["bvstr"])


@pytest.mark.parametrize("curv", [False, True])
@pytest.mark.parametrize("iic", [None, 0, 1, 5])
def test_rhs3d_kernel(developed, iic, curv):
    """Without the start (iic None), and with it at each rung of the AB3
    start-up; `curv` adds the curvilinear terms."""
    cfg, grid, s = developed
    cfg, grid = _curvilinear(cfg, grid, curv)
    f = _stage_inputs(cfg, grid, s)
    args = (cfg, grid) + _momentum_inputs(s, f)
    kw = {}
    if iic is not None:
        a1, a2 = ab3_start_coefs(iic)
        kw = dict(start=(a1, a2, s.ru_prev, s.ru_prev2, s.rv_prev,
                         s.rv_prev2))
    _check_rhs3d(args, kw)


@pytest.mark.parametrize("levels", [(1, 16), (12, 4)])
@pytest.mark.parametrize("iic", [None, 5])
def test_rhs3d_kernel_bodyforce(developed, iic, levels):
    """BODYFORCE: the stresses as body forces over the levels k >=
    levsfrc and k <= levbfrc, the momentum start without its stress
    fluxes; ru, rv, u_nnew and v_nnew still bitwise the plain version's
    (the level-range sums of Hz run in k order in both)."""
    cfg, grid, s = developed
    cfg = cfg.replace(bodyforce=True, levsfrc=levels[0], levbfrc=levels[1])
    f = _stage_inputs(cfg, grid, s)
    args = (cfg, grid) + _momentum_inputs(s, f)
    kw = {}
    if iic is not None:
        a1, a2 = ab3_start_coefs(iic)
        kw = dict(start=(a1, a2, s.ru_prev, s.ru_prev2, s.rv_prev,
                         s.rv_prev2))
    _check_rhs3d(args, kw)


def _check_rhs3d(args, kw):
    """rhs3d: ru, rv (and u_nnew, v_nnew with the start) bitwise equal to
    the plain version, rufrc and rvfrc, the column sums, within RTOL; a
    second launch bitwise equal to the first."""
    before = rhs3d_cuda.rhs3d.launches
    got = rhs3d_cuda.rhs3d(*args, **kw)
    assert rhs3d_cuda.rhs3d.launches == before + 1
    ref = rhs3d_cuda.rhs3d_plain(*args, **kw)
    assert len(got) == len(ref) == (6 if kw.get("start") else 4)
    _equal(got[:2] + got[4:], ref[:2] + ref[4:], "rhs3d")
    _close(got[2:4], ref[2:4], RTOL[got[0].dtype], "rhs3d column sums")
    _equal(rhs3d_cuda.rhs3d(*args, **kw), got, "rhs3d, second launch")


def test_uv3dmix2_kernel(developed):
    """The kernel updates its last four arguments in place: each launch
    gets fresh copies.  On more than one tile."""
    cfg, grid, s = developed
    assert _uv_plans(cfg, s.u.dtype)[1]["blocks"] > 1
    _check_uv3dmix2(cfg, grid, s, _stage_inputs(cfg, grid, s))


@pytest.mark.parametrize("rows", [1, 2, 4])
def test_uv3dmix2_kernel_on_level_slots(fixture_case, rows, monkeypatch):
    """The small BENCHMARK on tiles of 32 x `rows` points, so 8, 4 or 2
    level slots a block (the plans of UPWELLING and BENCHMARK1; the
    small cases alone take one slot): each slot walks its own levels and
    one slot's threads add each direction's column in k order."""
    cfg, grid, s = fixture_case
    monkeypatch.setattr(mix3d_cuda, "tile_plan", lambda make: make(32, rows))
    plan = _uv_plans(cfg, s.u.dtype)[1]
    assert plan["tile"] == (32, rows) and plan["levels"] == 8 // rows, plan
    _check_uv3dmix2(cfg, grid, s, _stage_inputs(cfg, grid, s))


@pytest.mark.parametrize("iic,tide", [(0, False), (5, True)])
def test_momentum_rhs_kernels(developed, iic, tide):
    """The momentum phase on the card (prsgrd32, rhs3d with the start,
    uv3dmix2: one launch each) against its plain chain."""
    cfg, grid, s = developed
    f = _stage_inputs(cfg, grid, s)
    u, v, Huon, Hvom, W, Hz, _, _, sustr, svstr, bustr, bvstr = \
        _momentum_inputs(s, f)
    args = (cfg, grid, iic, u, v, Hz, f["z_r"], f["z_w"], f["rho"], Huon,
            Hvom, W, s.ru_prev, s.ru_prev2, s.rv_prev, s.rv_prev2, sustr,
            svstr, bustr, bvstr)
    kw = dict(eq_tide=f["R"](s.zeta.shape, 0.05)) if tide else {}
    wrappers = (prsgrd_cuda.prsgrd32, rhs3d_cuda.rhs3d, mix3d_cuda.uv3dmix2)
    before = [w.launches for w in wrappers]
    got = rhs3d_cuda.momentum_rhs(*args, **kw)
    assert [w.launches - b for w, b in zip(wrappers, before)] == [1, 1, 1]
    ref = rhs3d_cuda.momentum_rhs_plain(*args, **kw)
    # u_nnew, v_nnew, ru, rv bitwise; rufrc, rvfrc (column sums) at RTOL
    _equal(got[:4], ref[:4], "momentum_rhs")
    _close(got[4:], ref[4:], RTOL[s.u.dtype], "momentum_rhs column sums")
    _equal(rhs3d_cuda.momentum_rhs(*args, **kw), got,
           "momentum_rhs, second launch")


def _momentum_plans(cfg, dtype):
    """The prsgrd32 and rhs3d plans of a case."""
    shape = (cfg.N, cfg.ny_tot, cfg.nx_tot)
    return (prsgrd_cuda.prsgrd_plan(dtype, *shape),
            rhs3d_cuda.rhs3d_plan(dtype, *shape))


def _check_momentum_kernels(cfg, grid, s):
    """prsgrd32, and rhs3d without and with the start, on state s."""
    f = _stage_inputs(cfg, grid, s)
    _check_prsgrd32(cfg, grid, f, True)
    args = (cfg, grid) + _momentum_inputs(s, f)
    _check_rhs3d(args, {})
    a1, a2 = ab3_start_coefs(5)
    _check_rhs3d(args, dict(start=(a1, a2, s.ru_prev, s.ru_prev2,
                                   s.rv_prev, s.rv_prev2)))


def _check_uv_kernels(cfg, grid, s):
    """uv_corrector (spline and no vertical viscosity, at the first step
    and in the steady AB3) and uv3dmix2, on state s."""
    f = _stage_inputs(cfg, grid, s)
    for splines in (True, False):
        for iic in (0, 5):
            _check_uv_corrector(cfg.replace(splines_vvisc=splines), grid, s,
                                f, iic)
    _check_uv3dmix2(cfg, grid, s, f)


def _case_variant(cfg, grid, variant):
    """The small BENCHMARK as it is ("spherical"), with closed E-W walls
    ("closed") or with an island ("masked")."""
    if variant == "closed":
        closed = LBC()
        cfg = cfg.replace(ew_periodic=False, gamma2=-1.0, lbc_zeta=closed,
                          lbc_ubar=closed, lbc_vbar=closed, lbc_u=closed,
                          lbc_v=closed, lbc_t=closed)
    if variant == "masked":
        grid = _island(grid)
    return cfg, grid


@pytest.mark.parametrize("variant", ["spherical", "closed", "masked"])
def test_momentum_kernels_on_ragged_tiles(fixture_case, variant):
    """The small BENCHMARK (spherical: curvilinear terms and a varying f;
    70 x 38 padded points) as it is, with closed E-W walls, and with an
    island: several tiles along both axes, the last of each ragged."""
    cfg, grid, s = fixture_case
    cfg, grid = _case_variant(cfg, grid, variant)
    for plan in _momentum_plans(cfg, s.u.dtype):
        tx, ty = plan["tile"]
        assert cfg.nx_tot > tx and cfg.nx_tot % tx != 0, plan
        assert cfg.ny_tot > ty and cfg.ny_tot % ty != 0, plan
    _check_momentum_kernels(cfg, grid, s)


@pytest.mark.parametrize("variant", ["spherical", "closed", "masked"])
def test_uv_kernels_on_ragged_tiles(fixture_case, variant):
    """uv_corrector and uv3dmix2 on the small BENCHMARK (70 x 38 padded
    points) as it is, with closed E-W walls, and with an island: several
    tiles, the last ragged (uv_corrector's straddle rows; uv3dmix2's
    along both axes)."""
    cfg, grid, s = fixture_case
    cfg, grid = _case_variant(cfg, grid, variant)
    uv, mix = _uv_plans(cfg, s.u.dtype)
    points = cfg.ny_tot * cfg.nx_tot
    assert uv["blocks"] > 1 and points % uv["tile"] != 0 and \
        cfg.nx_tot % uv["tile"] != 0, uv
    tx, ty = mix["tile"]
    assert cfg.nx_tot > tx and cfg.nx_tot % tx != 0, mix
    assert cfg.ny_tot > ty and cfg.ny_tot % ty != 0, mix
    _check_uv_kernels(cfg, grid, s)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_momentum_kernels_on_a_grid_smaller_than_a_tile(device, dtype):
    """A 20 x 2 plane (26 x 8 padded points): narrower than a tile, and in
    float32 smaller than one (in float64 rhs3d's tiles have 4 rows)."""
    cfg, grid, s0, ffn = upwelling.build(
        upwelling.make_config(Lm=20, Mm=2, N=6, ndtfast=8, dtype=dtype),
        device=device)
    s = stepping.run(cfg.replace(pallas2d=False), grid, s0, 3, ffn)
    for plan in _momentum_plans(cfg, s.u.dtype):
        tx, ty = plan["tile"]
        assert cfg.nx_tot < tx and \
            plan["blocks"] == -(-cfg.ny_tot // ty), plan
        if dtype == "float32":
            assert plan["blocks"] == 1, plan
    _check_momentum_kernels(cfg, grid, s)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_uv_kernels_on_a_grid_smaller_than_a_tile(device, dtype):
    """A 20 x 2 plane (26 x 8 padded points): narrower than a uv3dmix2
    tile and smaller than one (one block), and a few uv_corrector tiles
    that straddle its rows."""
    cfg, grid, s0, ffn = upwelling.build(
        upwelling.make_config(Lm=20, Mm=2, N=6, ndtfast=8, dtype=dtype),
        device=device)
    s = stepping.run(cfg.replace(pallas2d=False), grid, s0, 3, ffn)
    uv, mix = _uv_plans(cfg, s.u.dtype)
    assert cfg.nx_tot < mix["tile"][0] and mix["blocks"] == 1, mix
    assert uv["blocks"] > 1 and cfg.nx_tot % uv["tile"] != 0, uv
    _check_uv_kernels(cfg, grid, s)


def test_momentum_kernels_at_the_largest_plan(device):
    """N = 64 in float64 on a small gradient-walled plane: prsgrd32's
    largest columns (16 x 1 tiles) and rhs3d's float64 tile (32 x 4), each
    in more than 48 KB of shared memory a block."""
    cfg, grid, s0, ffn = upwelling.build(
        _config("gradient", "float64", N=64), device=device)
    s = stepping.run(cfg.replace(pallas2d=False), grid, s0, 1, ffn)
    prs, rhs = _momentum_plans(cfg, torch.float64)
    assert prs["tile"] == (16, 1) and rhs["tile"] == (32, 4), (prs, rhs)
    assert min(prs["smem_bytes"], rhs["smem_bytes"]) > 48 * 1024
    _check_momentum_kernels(cfg, grid, s)


def test_uv_kernels_at_the_largest_plan(device):
    """N = 64 in float64 on a small gradient-walled plane: uv_corrector's
    largest columns (8 a tile) and uv3dmix2's per-level planes, each in
    more than 48 KB of shared memory a block, on more than one tile."""
    cfg, grid, s0, ffn = upwelling.build(
        _config("gradient", "float64", N=64), device=device)
    s = stepping.run(cfg.replace(pallas2d=False), grid, s0, 1, ffn)
    uv, mix = _uv_plans(cfg, torch.float64)
    assert uv["tile"] == 8 and mix["tile"] == (32, 8), (uv, mix)
    assert min(uv["smem_bytes"], mix["smem_bytes"]) > 48 * 1024
    assert min(uv["blocks"], mix["blocks"]) > 1, (uv, mix)
    _check_uv_kernels(cfg, grid, s)


@pytest.mark.parametrize("nt", [2, 1])
def test_diag_kernels_on_the_small_benchmark(fixture_case, nt):
    """The small BENCHMARK (spherical, E-W periodic, 70 x 38 padded points:
    grid_flux on several tiles along both axes, the last of each ragged,
    the halo columns' fluxes and W from the far end of the row; omega of
    its fluxes), JM95 with bvf as on its path, with 2 tracers or
    temperature alone (no salt), and the linear EOS with and without
    bvf."""
    cfg, grid, s = fixture_case
    cfg, s = _with_tracers(cfg, s, nt)
    plan = diag_cuda.grid_flux_plan(s.u.dtype, cfg.N, cfg.ny_tot,
                                    cfg.nx_tot)
    tx, ty = plan["tile"]
    assert cfg.nx_tot % tx != 0 and cfg.ny_tot % ty != 0, plan
    assert plan["blocks"] > 4, plan
    z_r, z_w, _, Huon, Hvom, _ = _check_grid_flux(cfg, grid, s)
    _check_omega(cfg, grid, Huon, Hvom, z_w)
    assert cfg.eos == "jm95"
    eos = diag_cuda.eos_plan(s.u.dtype, cfg.N, cfg.ny_tot, cfg.nx_tot,
                             True, True)
    assert eos["tile"] and eos["blocks"] > 1, eos
    _check_eos(cfg, s.t, z_r, z_w, True)
    lin = cfg.replace(eos="linear", Scoef=7.6e-4)
    for want_bvf in (False, True):
        _check_eos(lin, s.t, z_r, z_w, want_bvf)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_diag_kernels_on_a_grid_smaller_than_a_tile(device, dtype):
    """A 20 x 2 plane (26 x 8 padded points): grid_flux's one tile is wider
    and, in float32, taller than the grid, and the wall columns' W comes
    from inside it, with Vtransform 2 and 1; omega of its fluxes; eos with
    JM95 and bvf on runs that straddle its rows."""
    cfg, grid, s0, ffn = upwelling.build(
        upwelling.make_config(Lm=20, Mm=2, N=6, ndtfast=8, dtype=dtype),
        device=device)
    s = stepping.run(cfg.replace(pallas2d=False), grid, s0, 3, ffn)
    plan = diag_cuda.grid_flux_plan(s.u.dtype, cfg.N, cfg.ny_tot,
                                    cfg.nx_tot)
    assert cfg.nx_tot < plan["tile"][0], plan
    if dtype == "float32":
        assert plan["blocks"] == 1 and cfg.ny_tot <= plan["tile"][1], plan
    z_r, z_w, _, Huon, Hvom, _ = _check_grid_flux(cfg, grid, s)
    _check_omega(cfg, grid, Huon, Hvom, z_w)
    _check_grid_flux(cfg.replace(vtransform=1), grid, s)
    _check_eos(cfg.replace(eos="jm95"), s.t, z_r, z_w, True)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_diag_kernels_at_the_largest_plan(device, dtype):
    """N = 64 on a small gradient-walled plane: grid_flux on 16 x 2 tiles
    in float64 and 32 x 2 in float32, in more than 48 KB of shared memory
    a block, omega of its fluxes, eos on runs of 16 (32) points in 48 KB;
    JM95 with bvf, with 2 tracers and with temperature alone."""
    cfg, grid, s0, ffn = upwelling.build(
        _config("gradient", dtype, N=64), device=device)
    s = stepping.run(cfg.replace(pallas2d=False), grid, s0, 1, ffn)
    gf = diag_cuda.grid_flux_plan(s.u.dtype, 64, cfg.ny_tot, cfg.nx_tot)
    eos = diag_cuda.eos_plan(s.u.dtype, 64, cfg.ny_tot, cfg.nx_tot, True,
                             True)
    f64 = dtype == "float64"
    assert gf["tile"] == ((16, 2) if f64 else (32, 2)), gf
    assert eos["tile"] == (16 if f64 else 32), eos
    assert gf["smem_bytes"] > 48 * 1024, gf
    assert eos["smem_bytes"] == 48 * 1024, eos
    z_r, z_w, _, Huon, Hvom, _ = _check_grid_flux(cfg, grid, s)
    _check_omega(cfg, grid, Huon, Hvom, z_w)
    for nt in (2, 1):
        c, st = _with_tracers(cfg.replace(eos="jm95"), s, nt)
        _check_eos(c, st.t, z_r, z_w, True)


def test_wrappers_raise_on_foreign_tensors(developed):
    """No fallback on the card: a tensor of another dtype raises."""
    cfg, grid, s = developed
    f = _stage_inputs(cfg, grid, s)
    other = torch.float32 if s.u.dtype == torch.float64 else torch.float64
    with pytest.raises(ValueError, match="expected"):
        prsgrd_cuda.prsgrd32(cfg, grid, f["rho"].to(other), f["z_r"],
                             f["z_w"], f["Hz"])
    with pytest.raises(ValueError, match="expected"):
        rhs3d_cuda.rhs3d(cfg, grid, *[a.to(other) if a is s.u else a
                                      for a in _momentum_inputs(s, f)])
    with pytest.raises(ValueError, match="supported"):
        rhs3d_cuda.momentum_rhs(
            cfg.replace(prsgrd_scheme="pj"), grid, 3, s.u, s.v, f["Hz"],
            f["z_r"], f["z_w"], f["rho"], f["Huon"], f["Hvom"], f["W"],
            s.ru_prev, s.ru_prev2, s.rv_prev, s.rv_prev2, *[s.zeta] * 4)
    un = s.u.clone()
    with pytest.raises(ValueError, match="alias"):
        mix3d_cuda.uv3dmix2(cfg, grid, s.u, s.v, f["Hz"], un, un,
                            s.zeta.clone(), s.zeta.clone(), cfg.dt)


def test_anchor_with_kernels(device):
    """10 float64 steps with the kernels on: every kernel launched once a
    step, and the anchor holds at 100x the bounds of test_anchor.py (the
    card sums columns in another order than the CPU)."""
    ref = np.load(_ANCHOR)
    cfg, grid, s, ffn = upwelling.build(upwelling.make_config(),
                                        device=device)
    wrappers = (diag_cuda.grid_flux, diag_cuda.eos, diag_cuda.omega,
                step2d_cuda.fast_loop, prsgrd_cuda.prsgrd32,
                rhs3d_cuda.rhs3d, mix3d_cuda.uv3dmix2,
                step3d_cuda.tracer_predictor, step3d_cuda.uv_corrector,
                step3d_cuda.tracer_corrector)
    before = [w.launches for w in wrappers]
    s = stepping.run(cfg, grid, s, 10, ffn)
    assert [w.launches - b for w, b in zip(wrappers, before)] == \
        [10] * len(wrappers)
    H = cfg.halo
    inter = lambda a: a[..., H:H + cfg.Mm, H:H + cfg.Lm].cpu().numpy()
    np.testing.assert_allclose(inter(s.zeta), ref["zeta"], rtol=0,
                               atol=1e-10)
    np.testing.assert_allclose(inter(s.u), ref["u_full"], rtol=0, atol=1e-11)
    np.testing.assert_allclose(inter(s.v), ref["v_full"], rtol=0, atol=1e-11)
    np.testing.assert_allclose(inter(s.t)[0], ref["temp_full"], rtol=0,
                               atol=1e-8)


# small BENCHMARK cases of the geopotential mixing: smaller than one tile
# of the kernel along xi; the same with closed E-W walls; several tiles
# along both axes, the last of each ragged (76 x 27 padded points)
GEO_CASES = {"one tile": dict(Lm=24, Mm=16),
             "closed E-W": dict(Lm=24, Mm=16),
             "ragged tiles": dict(Lm=70, Mm=21)}


@pytest.fixture(scope="module", params=[
    (kind, dtype) for kind in GEO_CASES for dtype in ("float64", "float32")])
def bench_developed(request, device):
    """A small BENCHMARK and its state after 3 plain steps, on the card."""
    kind, dtype = request.param
    cfg = benchmark.make_config(N=8, ndtfast=10, dtype=dtype,
                                **GEO_CASES[kind])
    if kind == "closed E-W":
        closed = LBC()
        cfg = cfg.replace(ew_periodic=False, lbc_zeta=closed,
                          lbc_ubar=closed, lbc_vbar=closed, lbc_u=closed,
                          lbc_v=closed, lbc_t=closed)
    cfg, grid, s0, ffn = benchmark.build(cfg, device=device)
    s = stepping.run(cfg.replace(pallas2d=False), grid, s0, 3, ffn)
    return cfg, grid, s


@pytest.mark.parametrize("tnu2", [(500.0, 500.0), (500.0, 0.0),
                                  (0.0, 300.0)])
def test_t3dmix2_geo_kernel(bench_developed, tnu2):
    """Against its plain version; a tracer with tnu2 = 0 is not touched; a
    second launch on a copy of the same input is bitwise equal."""
    cfg, grid, s = bench_developed
    cfg = cfg.replace(tnu2=tnu2)
    z_r, _, Hz, *_ = diag_cuda.grid_flux_plain(cfg, grid, s.zeta, s.u, s.v,
                                               hc_of(cfg))
    t_nnew = s.t * Hz[None]
    before = mix3d_cuda.t3dmix2_geo.launches
    got = mix3d_cuda.t3dmix2_geo(cfg, grid, s.t, Hz, z_r, t_nnew.clone(),
                                 cfg.dt)
    assert mix3d_cuda.t3dmix2_geo.launches == before + 1
    ref = mix3d_cuda.t3dmix2_geo_plain(cfg, grid, s.t, Hz, z_r,
                                       t_nnew.clone(), cfg.dt)
    _close([got], [ref], RTOL[s.u.dtype], "t3dmix2_geo")
    for k, d in enumerate(tnu2):
        if d == 0.0:
            assert torch.equal(got[k], t_nnew[k]), k
    again = mix3d_cuda.t3dmix2_geo(cfg, grid, s.t, Hz, z_r, t_nnew.clone(),
                                   cfg.dt)
    assert torch.equal(got, again)


def test_t3dmix2_geo_kernel_refuses_aliased_t_nnew(bench_developed):
    cfg, grid, s = bench_developed
    z_r, _, Hz, *_ = diag_cuda.grid_flux_plain(cfg, grid, s.zeta, s.u, s.v,
                                               hc_of(cfg))
    t = s.t.clone()
    with pytest.raises(ValueError, match="alias"):
        mix3d_cuda.t3dmix2_geo(cfg, grid, t, Hz, z_r, t, cfg.dt)


def test_benchmark_fixture_with_kernels(device):
    """3 float64 steps of the small BENCHMARK with all eleven kernels on
    (one launch a step each) hold tests/data/torch_benchmark_small.npz at
    100x the CPU test's bounds."""
    fixture = fixture_script()
    ref = np.load(_BENCH_FIXTURE)
    cfg, grid, s0, ffn = benchmark.build(
        benchmark.make_config(**fixture.CASE), device=device)
    wrappers = (diag_cuda.grid_flux, diag_cuda.eos, diag_cuda.omega,
                step2d_cuda.fast_loop, prsgrd_cuda.prsgrd32,
                rhs3d_cuda.rhs3d, mix3d_cuda.uv3dmix2,
                mix3d_cuda.t3dmix2_geo, step3d_cuda.tracer_predictor,
                step3d_cuda.uv_corrector, step3d_cuda.tracer_corrector)
    before = [w.launches for w in wrappers]
    s = stepping.run(cfg, grid, s0, fixture.NSTEPS, ffn)
    assert [w.launches - b for w, b in zip(wrappers, before)] == \
        [fixture.NSTEPS] * len(wrappers)
    errors = fixture.errors(cfg, s0, s, ref, factor=CARD_FACTOR)
    bad = {k: e for k, e in errors.items() if not e[0] <= e[1]}
    assert not bad, bad


@pytest.mark.parametrize("saved_on", ["cuda", "cpu"])
def test_restart_across_devices(device, tmp_path, saved_on):
    """A restart the driver writes from the card restores on the CPU, and
    one written from the CPU restores on the card, bitwise; one written
    and restored on the card continues bitwise as the straight run."""
    from roms_tpu_torch.driver import Simulation, restart
    from roms_tpu_torch.state import TENSOR_FIELDS
    devices = {"cuda": device, "cpu": torch.device("cpu")}
    other = "cpu" if saved_on == "cuda" else "cuda"
    cfg = upwelling.make_config(Lm=20, Mm=16, N=6, ndtfast=8)
    cfg, grid, s0, ffn = upwelling.build(cfg, device=devices[saved_on])
    s0_o = upwelling.build(cfg, device=devices[other])[2]
    sim = Simulation(cfg, grid, s0, ffn, rst_file=str(tmp_path / "rst"),
                     nrst=3, ninfo=0, log=lambda *a: None)
    sim.run(3)
    r = restart(cfg, sim.rst_paths[0], s0_o)
    assert (r.time, r.iic) == (sim.state.time, sim.state.iic)
    for k in TENSOR_FIELDS:
        a = getattr(r, k)
        assert a.device.type == other and a.dtype == torch.float64, k
        assert torch.equal(a.cpu(), getattr(sim.state, k).cpu()), k
    if saved_on == "cuda":
        card = restart(cfg, sim.rst_paths[0], s0)
        straight = stepping.run(cfg, grid, s0, 5, ffn)
        resumed = stepping.run(cfg, grid, card, 2, ffn)
        for k in TENSOR_FIELDS:
            assert torch.equal(getattr(resumed, k), getattr(straight, k)), k


@pytest.fixture(scope="module", params=chip_smoke.REGIONAL)
def regional(request, device):
    """A regional case at its published sizes, float64, three plain steps
    from rest."""
    name = request.param
    cfg, grid, s0, ffn = chip_smoke.regional_case(name, device)
    s = stepping.run(cfg.replace(pallas2d=False), grid, s0, 3, ffn)
    return name, cfg, grid, s, ffn


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_regional_kernels_on_case_arguments(regional, dtype):
    """Each kernel the case's step launches, and only those of
    chip_smoke.REGIONAL_KERNELS, against its plain version on the step's
    arguments (chip_smoke phase 13 (a))."""
    from roms_tpu_torch.state import TENSOR_FIELDS
    name, _, _, s, _ = regional
    cfg, grid, _, ffn = chip_smoke.regional_case(name, s.zeta.device, dtype)
    state = s.replace(**{k: getattr(s, k).to(grid.h.dtype)
                         for k in TENSOR_FIELDS})
    calls = chip_smoke.captured_calls(cfg, grid, state, ffn)
    assert set(calls) == set(chip_smoke.REGIONAL_KERNELS[name])
    chip_smoke.check_variants(
        "regional", grid, [(f"{name}:{k}", k, *calls[k]) for k in calls],
        dtype, {}, timed=False)


def test_regional_kernels_on_against_off(regional):
    """Three float64 steps with the kernels on against cfg.pallas2d=False,
    each field within 1e-9 x max|field|, one launch a step of each kernel
    of the case (chip_smoke phase 13 (b))."""
    name, cfg, grid, s, ffn = regional
    launches = chip_smoke.regional_equivalence(s.zeta.device, name, cfg,
                                               grid, s, ffn)
    assert launches == dict.fromkeys(chip_smoke.REGIONAL_KERNELS[name], 1.0)


def test_regional_fixture_with_kernels(device):
    """The small KELVIN, ESTUARY_TEST and RIVERPLUME1 with the kernels on
    hold tests/data/torch_regional_small.npz at 100x the CPU test's
    bounds (chip_smoke phase 13 (c))."""
    chip_smoke.regional_fixture(device)


def _ns_periodic_case(kind, dtype, device):
    """A north-south periodic case: a 24 x 48 x 6 LAB_CANYON ("ns", closed
    east-west; UPWELLING's own shelf blows up with closed east-west walls
    in both packages) or UPWELLING at 20 x 16 x 6 periodic both ways
    ("both")."""
    if kind == "ns":
        from roms_tpu_torch.models import cases4
        return cases4.lab_canyon(cases4.lab_canyon_config(
            Lm=24, Mm=48, N=6, ndtfast=10, dtype=dtype), device=device)
    per = LBC(BC_PERIODIC, BC_PERIODIC, BC_PERIODIC, BC_PERIODIC)
    cfg = upwelling.make_config(Lm=20, Mm=16, N=6, ndtfast=8, dtype=dtype)
    return upwelling.build(dataclasses.replace(
        cfg, ns_periodic=True, lbc_zeta=per, lbc_ubar=per, lbc_vbar=per,
        lbc_u=per, lbc_v=per, lbc_t=per), device=device)


@pytest.mark.parametrize("kind", ["ns", "both"])
@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_kernels_on_ns_periodic_grids(device, kind, dtype):
    """Every kernel of the step on a north-south periodic grid (the wrap
    the halo gathers, the fast loop's neighbour exchange and the closed
    axis's last tile had seen only east-west) against its plain version on
    the step's arguments, then three steps with the kernels on against
    off within 1e-9 x max|field| (float64), one launch a step each."""
    import types
    cfg, grid, s0, ffn = _ns_periodic_case(kind, dtype, device)
    s = stepping.run(cfg.replace(pallas2d=False), grid, s0, 3, ffn)
    calls = chip_smoke.captured_calls(cfg, grid, s, ffn)
    kernels = chip_smoke.COASTAL_KERNELS["lab_canyon"]
    assert set(calls) == set(kernels)
    chip_smoke.check_variants(
        "ns-periodic", grid, [(f"{kind}:{k}", k, *calls[k]) for k in calls],
        dtype, {}, timed=False)
    if dtype == "float64":
        fx = chip_smoke.coastal_fixture_script()
        fields = types.SimpleNamespace(fields_of=lambda name: fx.FIELDS,
                                       PARTNER=fx.PARTNER)
        launches = chip_smoke.kernels_on_off(
            "ns-periodic", kind, cfg, grid, s, ffn, kernels, fields, 3)
        assert launches == dict.fromkeys(kernels, 1.0)


@pytest.fixture(scope="module", params=chip_smoke.COASTAL)
def coastal(request, device, tmp_path_factory):
    """A phase-14 case at full size, float64, three plain steps from
    rest."""
    tmp = str(tmp_path_factory.mktemp(request.param))
    cfg, grid, s0, ffn = chip_smoke.coastal_case(request.param, device, tmp)
    s = stepping.run(cfg.replace(pallas2d=False), grid, s0, 3, ffn)
    return request.param, tmp, cfg, grid, s, ffn


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_coastal_kernels_on_case_arguments(coastal, dtype):
    """Each kernel the case's step launches, and only those of
    chip_smoke.COASTAL_KERNELS, against its plain version on the step's
    arguments (chip_smoke phase 14 (a))."""
    from roms_tpu_torch.state import TENSOR_FIELDS
    name, tmp, _, _, s, _ = coastal
    cfg, grid, _, ffn = chip_smoke.coastal_case(name, s.zeta.device, tmp,
                                                dtype)
    state = s.replace(**{k: getattr(s, k).to(grid.h.dtype)
                         for k in TENSOR_FIELDS})
    calls = chip_smoke.captured_calls(cfg, grid, state, ffn)
    assert set(calls) == set(chip_smoke.COASTAL_KERNELS[name])
    chip_smoke.check_variants(
        "coastal", grid, [(f"{name}:{k}", k, *calls[k]) for k in calls],
        dtype, {}, timed=False)


def test_coastal_kernels_on_against_off(coastal):
    """Three float64 steps with the kernels on against cfg.pallas2d=False,
    each field within 1e-9 x max|field|, one launch a step of each kernel
    of the case (chip_smoke phase 14 (a'))."""
    name, _, cfg, grid, s, ffn = coastal
    launches = chip_smoke.kernels_on_off(
        "coastal-equiv", name, cfg, grid, s, ffn,
        chip_smoke.COASTAL_KERNELS[name], chip_smoke.coastal_fixture_script(),
        3)
    assert launches == dict.fromkeys(chip_smoke.COASTAL_KERNELS[name], 1.0)


def test_coastal_fixture_with_kernels(device, tmp_path):
    """The small LAB_CANYON, INLET_TEST, TEST_HEAD, BENCHMARK with tides
    and the wet/dry fast loop with the kernels on hold
    tests/data/torch_coastal_small.npz at 100x the CPU test's bounds
    (chip_smoke phase 14 (f))."""
    chip_smoke.coastal_fixture(device, str(tmp_path))


def _operator_small(name, device, dtype="float64"):
    """A small case of scripts/torch_operators_fixture.py on the card, and
    its state after three plain steps."""
    fx = chip_smoke.operators_fixture_script()
    cfg, grid, s0, ffn = fx.build_port(name, device=device, dtype=dtype)
    s = stepping.run(cfg.replace(pallas2d=False), grid, s0, 3, ffn)
    return cfg, grid, s, ffn


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("pair", chip_smoke.SCHEME_PAIRS,
                         ids=lambda p: "/".join(p))
def test_tracer_kernels_other_schemes(device, dtype, pair):
    """Rows 8 and 9 under C2, U1 and A4 advection (chip_smoke.SCHEME_PAIRS,
    every tracer) on the small UPWELLING's step arguments, bitwise their
    plain versions and a second launch bitwise the first (chip_smoke phase
    15 (c))."""
    cfg, grid, s, ffn = _operator_small("upw_smagorinsky", device, dtype)
    cfg = cfg.replace(uv_smagorinsky=False)
    calls = chip_smoke.captured_calls(cfg, grid, s, ffn)
    h, v = pair
    nt = cfg.ntracers
    cases = []
    for name in ("tracer_predictor", "tracer_corrector"):
        args, kw = calls[name]
        c = args[0].replace(t_hadv=(h,) * nt, t_vadv=(v,) * nt)
        cases.append((f"{name}[{h}/{v}]", name, (c,) + args[1:], kw))
    chip_smoke.check_variants("schemes", grid, cases, dtype, {},
                              timed=False)


@pytest.mark.parametrize("name", ["basin", "overflow", "channel_neck",
                                  "seamount_pjq4", "upw_smagorinsky",
                                  "upw_t4_iso", "upw_uv4_geo"])
def test_operator_families_on_against_off(device, name):
    """One small case of each new family (biharmonic, isopycnal and rotated
    mixing, a pressure-gradient scheme without a kernel, Smagorinsky
    viscosity): three float64 steps with the kernels on against
    cfg.pallas2d=False within 1e-9 x max|field|, one launch a step of each
    kernel chip_smoke.OPERATOR_KERNELS names."""
    cfg, grid, s, ffn = _operator_small(name, device)
    kernels = chip_smoke.OPERATOR_KERNELS[name]
    launches = chip_smoke.kernels_on_off(
        "operators", name, cfg, grid, s, ffn, kernels,
        chip_smoke.operators_fixture_script(), 3)
    assert launches == dict.fromkeys(kernels, 1.0)


def test_operator_fixture_with_kernels(device):
    """The small operator cases with the kernels on hold
    tests/data/torch_operators_small.npz at 100x the CPU test's bounds
    (chip_smoke phase 15 (e))."""
    chip_smoke.operator_fixture(device)
