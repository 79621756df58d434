"""roms_tpu_torch: the momentum phase of the rhs3d step (ops/rhs3d_cuda.py,
ops/mix3d_cuda.py) against the TPU kernels it replaces,
rhs3d_pallas.{momentum_rhs_fused, rhs3d_fused} and
mix3d_pallas.uv3dmix2_fused, run in Pallas interpret mode on the CPU; the
gates against the JAX gates; and the step's dispatch through
``momentum_rhs``.

The same inputs, made with numpy from a seed on UPWELLING at 12x10x4, go
to the JAX chain and to the port's, whose wrappers on CPU tensors take
their plain versions and launch nothing.  One interpret run of
momentum_rhs_fused a case: the rhs3d_fused and uv3dmix2_fused calls inside
it are recorded (inputs and outputs) and the port's rhs3d and uv3dmix2 are
held against them, so the three share the JAX set-up.  The cases are
periodic E-W, closed E-W, masked (land points and pmask) and curvilinear
(nonzero dndx/dmde), which between them take iic at the first step and a
later one, with and without eq_tide.  Held to 1e-12 x max|field| in float64
over the whole padded array.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from roms_tpu.config import LBC as JLBC
from roms_tpu.models import upwelling as jup
from roms_tpu.ops import mix3d_pallas, pre_step3d as jpre, rhs3d_pallas
from roms_tpu_torch import convert, stepping
from roms_tpu_torch.grid import hc_of
from roms_tpu_torch.models import upwelling as tup
from roms_tpu_torch.ops import diag_cuda, mix3d_cuda, prsgrd_cuda, \
    rhs3d_cuda
from roms_tpu_torch.state import TENSOR_FIELDS
from test_torch_stages import build_pair
from test_torch_step3d_kernels import T, _close as _close_pairs, _closed_ew

torch.set_num_threads(1)

J = jnp.asarray
# case -> (iic, with eq_tide): the four cases cover both rungs of the AB3
# start-up (iic 0 is the first step) with and without the tide
CASES = {"periodic": (0, False), "closed_ew": (3, True),
         "masked": (0, True), "curvgrid": (3, False)}
_MOM = ("u", "v", "Hz", "z_r", "z_w", "rho", "Huon", "Hvom", "W",
        "ru_prev", "ru_prev2", "rv_prev", "rv_prev2", "sustr", "svstr",
        "bustr", "bvstr")


def _close(got, ref, name):
    assert len(got) == len(ref), name
    _close_pairs(got, ref, name)


def _masked(grid, ns):
    """grid with a land block inside its interior (rho, u, v, psi masks);
    ``ns`` is the namespace the masks are made in (np or torch)."""
    m = np.array(grid.rmask)
    m[6:9, 5:9] = 0.0
    um = m * np.roll(m, 1, -1)
    vm = m * np.roll(m, 1, -2)
    masks = dict(rmask=m, umask=um, vmask=vm, pmask=um * np.roll(um, 1, -2))
    return dataclasses.replace(grid, **{k: ns(a) for k, a in masks.items()})


def _build(kind):
    """(cfg_j, grid_j, cfg_t, grid_t) of a case."""
    cfg = jup.make_config(Lm=12, Mm=10, N=4, ndtfast=6)
    if kind == "closed_ew":
        cfg = _closed_ew(cfg)
    if kind == "curvgrid":
        cfg = dataclasses.replace(cfg, curvgrid=True)
    cfg_j, grid_j, cfg_t, grid_t = build_pair(cfg)
    if kind == "masked":
        grid_j, grid_t = _masked(grid_j, J), _masked(grid_t, T)
    if kind == "curvgrid":
        rng = np.random.default_rng(5)
        d = {k: 50.0 * rng.standard_normal(grid_t.h.shape)
             for k in ("dndx", "dmde")}
        grid_j = dataclasses.replace(grid_j, **{k: J(a) for k, a in d.items()})
        grid_t = dataclasses.replace(grid_t, **{k: T(a) for k, a in d.items()})
    return cfg_j, grid_j, cfg_t, grid_t


def _fields(cfg_t, grid_t, with_tide):
    """Consistent random inputs of the momentum phase, as numpy: depths and
    fluxes from the port's plain grid_flux."""
    rng = np.random.default_rng(2025)
    N = cfg_t.N
    s2 = (cfg_t.ny_tot, cfg_t.nx_tot)
    s3 = (N,) + s2
    zeta = 0.3 * rng.standard_normal(s2)
    u = 0.2 * rng.standard_normal(s3)
    v = 0.2 * rng.standard_normal(s3)
    z_r, z_w, Hz, Huon, Hvom, W = diag_cuda.grid_flux_plain(
        cfg_t, grid_t, T(zeta), T(u), T(v), hc_of(cfg_t))
    f = {k: a.numpy() for k, a in dict(
        z_r=z_r, z_w=z_w, Hz=Hz, Huon=Huon, Hvom=Hvom, W=W).items()}
    f.update(u=u, v=v, rho=0.5 * rng.standard_normal(s3) - 0.1 * f["z_r"])
    for k in ("ru_prev", "ru_prev2", "rv_prev", "rv_prev2"):
        f[k] = 1e-2 * rng.standard_normal(s3)
    for k in ("sustr", "svstr", "bustr", "bvstr"):
        f[k] = 1e-4 * rng.standard_normal(s2)
    f["eq_tide"] = 0.05 * rng.standard_normal(s2) if with_tide else None
    return f


def _recorded(fn, calls, name):
    """fn, recording the numpy copies of its arguments and results."""
    def call(*args, **kw):
        ins = [np.array(a) if hasattr(a, "shape") else a for a in args]
        out = fn(*args, **kw)
        calls[name] = (ins, [np.array(o) for o in out])
        return out
    return call


@pytest.fixture(scope="module")
def runs():
    """case -> (cfg_t, grid_t, iic, f, {"momentum_rhs" | "rhs3d" |
    "uv3dmix2": (args, outputs)}), each from one interpret run of
    momentum_rhs_fused, made on first use."""
    memo = {}

    def get(kind):
        if kind not in memo:
            iic, tide = CASES[kind]
            cfg_j, grid_j, cfg_t, grid_t = _build(kind)
            f = _fields(cfg_t, grid_t, tide)
            calls = {}
            with pytest.MonkeyPatch.context() as mp:
                mp.setattr(rhs3d_pallas, "rhs3d_fused", _recorded(
                    rhs3d_pallas.rhs3d_fused, calls, "rhs3d"))
                mp.setattr(mix3d_pallas, "uv3dmix2_fused", _recorded(
                    mix3d_pallas.uv3dmix2_fused, calls, "uv3dmix2"))
                out = rhs3d_pallas.momentum_rhs_fused(
                    cfg_j, grid_j, iic, *[J(f[k]) for k in _MOM],
                    eq_tide=None if f["eq_tide"] is None
                    else J(f["eq_tide"]), interpret=True)
            calls["momentum_rhs"] = (None, [np.array(o) for o in out])
            assert set(calls) == {"momentum_rhs", "rhs3d", "uv3dmix2"}
            memo[kind] = (cfg_t, grid_t, iic, f, calls)
        return memo[kind]
    return get


def _launches():
    return (prsgrd_cuda.prsgrd32.launches, rhs3d_cuda.rhs3d.launches,
            mix3d_cuda.uv3dmix2.launches)


@pytest.mark.parametrize("kind", CASES)
def test_momentum_rhs_matches_pallas(runs, kind):
    cfg_t, grid_t, iic, f, calls = runs(kind)
    tide = None if f["eq_tide"] is None else T(f["eq_tide"])
    args = [T(f[k]) for k in _MOM]
    ref = calls["momentum_rhs"][1]
    names = f"u_nnew v_nnew ru rv rufrc rvfrc ({kind})"
    _close(rhs3d_cuda.momentum_rhs_plain(cfg_t, grid_t, iic, *args,
                                         eq_tide=tide), ref, names)
    before = _launches()
    _close(rhs3d_cuda.momentum_rhs(cfg_t, grid_t, iic, *args, eq_tide=tide),
           ref, names)
    assert _launches() == before


@pytest.mark.parametrize("kind", CASES)
def test_rhs3d_matches_pallas(runs, kind):
    """rhs3d on rhs3d_fused's recorded arguments (u, v, Huon, Hvom, W, Hz,
    ru from prsgrd32, ...); with the start, its u_nnew/v_nnew against
    roms_tpu's momentum_init on the same inputs."""
    cfg_t, grid_t, iic, f, calls = runs(kind)
    ins, ref = calls["rhs3d"]
    assert ins[0] is not None and len(ins) == 14
    args = [T(a) for a in ins[2:]]
    _close(rhs3d_cuda.rhs3d_plain(cfg_t, grid_t, *args), ref,
           f"ru rv rufrc rvfrc ({kind})")
    a1, a2 = jpre.ab3_start_coefs(iic, jnp.float64)
    hist = [f[k] for k in ("ru_prev", "ru_prev2", "rv_prev", "rv_prev2")]
    start_ref = jpre.momentum_init(
        ins[0], ins[1].pm, ins[1].pn, a1, a2,
        J(f["u"]), J(f["v"]), J(f["Hz"]), *[J(a) for a in hist],
        *[J(f[k]) for k in ("sustr", "svstr", "bustr", "bvstr")])
    before = _launches()
    got = rhs3d_cuda.rhs3d(cfg_t, grid_t, *args, start=(
        float(a1), float(a2), *[T(a) for a in hist]))
    assert _launches() == before
    _close(got, list(ref) + list(start_ref),
           f"ru rv rufrc rvfrc u_nnew v_nnew ({kind})")


@pytest.mark.parametrize("kind", CASES)
def test_uv3dmix2_matches_pallas(runs, kind):
    cfg_t, grid_t, _, _, calls = runs(kind)
    ins, ref = calls["uv3dmix2"]
    args = [T(a) for a in ins[2:9]]
    _close(mix3d_cuda.uv3dmix2_plain(cfg_t, grid_t, *args, ins[9]), ref,
           f"u_nnew v_nnew rufrc rvfrc ({kind})")
    before = _launches()
    _close(mix3d_cuda.uv3dmix2(cfg_t, grid_t, *args, ins[9]), ref,
           f"u_nnew v_nnew rufrc rvfrc ({kind})")
    assert _launches() == before


@pytest.mark.parametrize("change", [
    {}, dict(pallas2d=False), dict(prsgrd_scheme="pj"),
    dict(use_sponge=True), dict(uv_smagorinsky=True),
    dict(uv_mix_geo=True), dict(uv_vis4=True, visc4=1e8),
    dict(uv_vis4=True), dict(uv_cor=False), dict(uv_adv=False)])
def test_gates_mirror_pallas(monkeypatch, change):
    """rhs3d_cuda.use_kernels and mix3d_cuda.use_kernels decide as the
    JAX gates do when its kernels are on (ROMS_PALLAS_INTERPRET on the
    CPU), climatology and budget diagnostics included."""
    monkeypatch.setenv("ROMS_PALLAS_INTERPRET", "1")
    cfg_j = dataclasses.replace(jup.make_config(Lm=12, Mm=10, N=4,
                                                ndtfast=6), **change)
    cfg_t = convert.config_from_reference(cfg_j)
    assert rhs3d_cuda.use_kernels(cfg_t) == rhs3d_pallas.use_pallas(cfg_j)
    assert mix3d_cuda.use_kernels(cfg_t) == mix3d_pallas.use_pallas(cfg_j)
    for kw in (dict(clm={}), dict(want_diags=True)):
        assert rhs3d_cuda.use_kernels(cfg_t, **kw) == \
            rhs3d_pallas.use_pallas(cfg_j, **kw)


def test_wrappers_raise_off_the_cpu_and_card(runs):
    """A tensor on neither the CPU nor a CUDA card finds no path."""
    cfg_t, grid_t, _, _, calls = runs("periodic")
    ins, _ = calls["uv3dmix2"]
    meta = [T(a).to("meta") for a in ins[2:9]]
    with pytest.raises(ValueError, match="no kernel or plain path"):
        mix3d_cuda.uv3dmix2(cfg_t, grid_t, *meta, ins[9])
    with pytest.raises(ValueError, match="no kernel or plain path"):
        rhs3d_cuda.rhs3d(cfg_t, grid_t, *[T(a).to("meta")
                                          for a in calls["rhs3d"][0][2:]])


def test_step_dispatch_through_momentum_rhs():
    """With cfg.pallas2d the step takes momentum_rhs (its plain chain on
    the CPU); without, the stages one by one.  Two steps agree at
    round-off on every State field."""
    cfg, grid, s0, ffn = tup.build(tup.make_config(Lm=16, Mm=12, N=4,
                                                   ndtfast=8), device="cpu")
    assert rhs3d_cuda.use_kernels(cfg)
    calls = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(rhs3d_cuda, "momentum_rhs", _counted(
            rhs3d_cuda.momentum_rhs, calls))
        on = stepping.run(cfg, grid, s0, 2, ffn)
    assert len(calls) == 2
    off = stepping.run(cfg.replace(pallas2d=False), grid, s0, 2, ffn)
    assert (on.iic, on.time) == (off.iic, off.time)
    for name in TENSOR_FIELDS:
        a, b = getattr(on, name), getattr(off, name)
        if b.numel():
            scale = max(float(b.abs().max()), 1e-300)
            assert float((a - b).abs().max()) <= 1e-12 * scale, name


def _counted(fn, calls):
    def call(*args, **kw):
        calls.append(1)
        return fn(*args, **kw)
    return call
