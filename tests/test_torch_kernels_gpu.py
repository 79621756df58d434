"""roms_tpu_torch CUDA kernels against their plain PyTorch versions, on the
card, in float32 and float64, on UPWELLING and on closed, gradient and
masked (an island) variants of it (the momentum kernels also on a
curvilinear one); and the UPWELLING anchor with all ten kernels on.

Marked ``gpu``; each test skips without a CUDA device.  This file imports
no jax, so it also runs where jax is absent:

    python -m pytest tests/test_torch_kernels_gpu.py -m gpu --noconftest
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from roms_tpu_torch import stepping
from roms_tpu_torch.config import LBC, BC_CLOSED, BC_GRADIENT
from roms_tpu_torch.grid import hc_of
from roms_tpu_torch.models import upwelling
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


def _config(kind, dtype):
    cfg = upwelling.make_config(Lm=20, Mm=16, N=6, ndtfast=8, dtype=dtype)
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


def test_grid_flux_and_omega_kernels(developed):
    cfg, grid, s = developed
    hc = hc_of(cfg)
    got = diag_cuda.grid_flux(cfg, grid, s.zeta, s.u, s.v, hc)
    ref = diag_cuda.grid_flux_plain(cfg, grid, s.zeta, s.u, s.v, hc)
    _close(got, ref, RTOL[s.u.dtype], "grid_flux")
    _close([diag_cuda.omega(cfg, grid, ref[3], ref[4], ref[1])],
           [diag_cuda.omega_plain(cfg, grid, ref[3], ref[4], ref[1])],
           RTOL[s.u.dtype], "omega")


@pytest.mark.parametrize("eos", ["linear", "jm95"])
@pytest.mark.parametrize("want_bvf", [False, True])
def test_eos_kernel(developed, eos, want_bvf):
    cfg, grid, s = developed
    cfg = cfg.replace(eos=eos, Scoef=7.6e-4)
    z_r, z_w, *_ = diag_cuda.grid_flux_plain(cfg, grid, s.zeta, s.u, s.v,
                                             hc_of(cfg))
    _close(diag_cuda.eos(cfg, s.t, z_r, z_w, want_bvf),
           diag_cuda.eos_plain(cfg, s.t, z_r, z_w, want_bvf),
           RTOL[s.u.dtype], "eos")


@pytest.mark.parametrize("iic", [0, 1, 5])
def test_fast_loop_kernel(developed, iic):
    cfg, grid, s = developed
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
    fresh = lambda: Fast2DState(**{k: a.clone() for k, a in fields.items()})
    before = step2d_cuda.fast_loop.launches
    fs_k, ruc_k, rvc_k = step2d_cuda.fast_loop(cfg, grid, fresh(), *frc, iic)
    assert step2d_cuda.fast_loop.launches == before + 1
    fs_p, ruc_p, rvc_p = step2d_cuda.fast_loop_plain(cfg, grid, fresh(),
                                                     *frc, iic)
    _close([getattr(fs_k, k) for k in FS_FIELDS] + [ruc_k, rvc_k],
           [getattr(fs_p, k) for k in FS_FIELDS] + [ruc_p, rvc_p],
           FAST_RTOL[s.u.dtype], "fast_loop")


def test_fast_loop_kernel_rejects_aliased_fields(developed):
    cfg, grid, s = developed
    fs = Fast2DState(**{k: s.zeta for k in FS_FIELDS})
    with pytest.raises(ValueError, match="alias"):
        step2d_cuda.fast_loop(cfg, grid, fs, *[s.zeta] * 6, 0)


@pytest.mark.parametrize("tide", [False, True])
def test_prsgrd32_kernel(developed, tide):
    cfg, grid, s = developed
    f = _stage_inputs(cfg, grid, s)
    kw = dict(eq_tide=f["R"](s.zeta.shape, 0.05)) if tide else {}
    args = (cfg, grid, f["rho"], f["z_r"], f["z_w"], f["Hz"])
    before = prsgrd_cuda.prsgrd32.launches
    got = prsgrd_cuda.prsgrd32(*args, **kw)
    assert prsgrd_cuda.prsgrd32.launches == before + 1
    _close(got, prsgrd_cuda.prsgrd32_plain(*args, **kw), RTOL[s.u.dtype],
           "prsgrd32")


@pytest.mark.parametrize("vadv", ["C4", "SPLINES"])
@pytest.mark.parametrize("iic,extra", [(0, False), (1, False), (5, False),
                                       (5, True)])
def test_tracer_predictor_kernel(developed, iic, extra, vadv):
    """Each rung of the AB3 start-up; `extra` adds the KPP nonlocal flux
    and the penetrating shortwave terms; `vadv` is the vertical tracer
    advection of both tracers."""
    cfg, grid, s = developed
    cfg = cfg.replace(t_vadv=(vadv, vadv))
    f = _stage_inputs(cfg, grid, s)
    kw = {}
    if extra:
        sw = f["W"].shape
        kw = dict(ghats=f["R"]((2,) + sw, 1e-3),
                  srflx=f["R"](s.zeta.shape, 1e-4).abs(),
                  swdk_w=torch.rand(sw, dtype=s.u.dtype, device=s.u.device))
    args = (cfg, grid, iic, s.t, s.t_prev, f["Hz"], f["Huon"], f["Hvom"],
            f["W"], s.Akt + 1e-3, f["stflx"], f["btflx"])
    before = step3d_cuda.tracer_predictor.launches
    got = step3d_cuda.tracer_predictor(*args, **kw)
    assert step3d_cuda.tracer_predictor.launches == before + 1
    _close(got, step3d_cuda.tracer_predictor_plain(*args, **kw),
           RTOL[s.u.dtype], "tracer_predictor")


@pytest.mark.parametrize("vadv", ["C4", "SPLINES"])
@pytest.mark.parametrize("splines", [True, False])
def test_tracer_corrector_kernel(developed, splines, vadv):
    cfg, grid, s = developed
    cfg = cfg.replace(splines_vdiff=splines, t_vadv=(vadv, vadv))
    f = _stage_inputs(cfg, grid, s)
    Akt = s.Akt + 1e-3
    t3, t_nnew = step3d_cuda.tracer_predictor_plain(
        cfg, grid, 3, s.t, s.t_prev, f["Hz"], f["Huon"], f["Hvom"], f["W"],
        Akt, f["stflx"], f["btflx"])
    args = (cfg, grid, t_nnew, t3, f["Huon"], f["Hvom"], f["W"],
            f["Hz"] * 1.001, f["z_r"] + 0.01, Akt)
    before = step3d_cuda.tracer_corrector.launches
    got = step3d_cuda.tracer_corrector(*args)
    assert step3d_cuda.tracer_corrector.launches == before + 1
    _close([got], [step3d_cuda.tracer_corrector_plain(*args)],
           RTOL[s.u.dtype], "tracer_corrector")


@pytest.mark.parametrize("iic", [0, 1, 5])
def test_uv_corrector_kernel(developed, iic):
    cfg, grid, s = developed
    f = _stage_inputs(cfg, grid, s)
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
    before = rhs3d_cuda.rhs3d.launches
    got = rhs3d_cuda.rhs3d(*args, **kw)
    assert rhs3d_cuda.rhs3d.launches == before + 1
    ref = rhs3d_cuda.rhs3d_plain(*args, **kw)
    assert len(got) == len(ref) == (4 if iic is None else 6)
    _close(got, ref, RTOL[s.u.dtype], "rhs3d")


def test_uv3dmix2_kernel(developed):
    """The kernel updates its last four arguments in place: it gets
    copies."""
    cfg, grid, s = developed
    f = _stage_inputs(cfg, grid, s)
    R = f["R"]
    ins = (s.u, s.v, f["Hz"])
    upd = (s.u * f["Hz"], s.v * f["Hz"], R(s.zeta.shape, 1.0),
           R(s.zeta.shape, 1.0))
    before = mix3d_cuda.uv3dmix2.launches
    got = mix3d_cuda.uv3dmix2(cfg, grid, *ins, *[a.clone() for a in upd],
                              cfg.dt)
    assert mix3d_cuda.uv3dmix2.launches == before + 1
    _close(got, mix3d_cuda.uv3dmix2_plain(cfg, grid, *ins, *upd, cfg.dt),
           RTOL[s.u.dtype], "uv3dmix2")


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
    _close(got, rhs3d_cuda.momentum_rhs_plain(*args, **kw), RTOL[s.u.dtype],
           "momentum_rhs")


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
