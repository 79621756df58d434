"""Smoke run of roms_tpu_torch on one CUDA card: builds the kernels, checks
each against its plain PyTorch version, drives the UPWELLING step through
them, and checks the result.

    python3 chip_smoke.py

Phases, one or more lines each; any failure exits non-zero:
  1. device: card name and power limit (nvidia-smi), torch and CUDA versions;
  2. kernel build (nvcc, sm_90a, one process per source) and its time;
  3. each kernel against its plain version on the arguments the main path
     gives it (one step of full-size UPWELLING from a developed state), in
     float64 and float32, plus the branches the main path does not take
     (eq_tide, KPP/solar terms, the Thomas solve, SPLINES vertical tracer
     advection, JM95 + bvf, closed E-W walls, land points, the curvilinear
     terms, the first step's momentum start): max abs
     error, tolerance, the time a call of kernel and plain version (CUDA
     events around 10 calls back to back, median of 5 such batches), and
     the kernel's bound (bytes and operations);
  4. the main path: 10 float64 steps of full-size UPWELLING through
     stepping.step, with every kernel's launch count (one a step each),
     checked against the pinned anchor (tests/data/upwelling_anchor.npz)
     and against the same steps with the kernels off (cfg.pallas2d=False);
  5. the 5-model-day UPWELLING run: 1440 float32 steps, finite fields,
     volume conservation, the upwelling signature, ms/step;
  6. torch.profiler over 10 float32 steps: launches a step, device busy and
     idle share, device time by kernel, host time by stage.
The last two lines are a JSON object of per-kernel results and a JSON
object {"ok": true, "device": {...}}.  Without CUDA it exits non-zero and
prints no result.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
ANCHOR = os.path.join(ROOT, "tests", "data", "upwelling_anchor.npz")

# tests/test_anchor.py:47-66 bounds; the card runs them at 100x (nvcc's
# operation order is kept with --fmad=false, but the card's column sums
# and cumsums run in another order than the CPU's)
ANCHOR_ATOL = {"zeta": 1e-12, "u": 1e-13, "v": 1e-13, "temp": 1e-10}
CARD_FACTOR = 100.0
# kernel against plain version, relative to max|field|: one pass of
# round-off, except the fast loop, which compounds it over nfast substeps
KERNEL_RTOL = {"float64": 1e-12, "float32": 1e-5}
FAST_RTOL = {"float64": 1e-10, "float32": 1e-4}
NRUNS, NBATCH = 10, 5
# H100 SXM peaks (NVIDIA's data sheet, 700 W): HBM3 bandwidth, and the
# non-tensor-core rate of each type (the kernels use no tensor cores)
PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"float64": 34e12, "float32": 67e12}


def _reads_all(*fields):
    """Reads every tensor among its arguments, and these grid fields."""
    return lambda g, a, kw: tensors_of(list(a) + list(kw.values())) + \
        [getattr(g, f) for f in fields]


def _reads_eos(g, a, kw):
    """eos(cfg, t, z_r, z_w, want_bvf): salinity where the density takes
    it, z_r for JM95 or bvf, z_w for JM95 with bvf."""
    cfg, t, z_r, z_w = a[:4]
    bvf, jm95 = kw.get("want_bvf", False), cfg.eos == "jm95"
    salt = cfg.ntracers >= 2 and (jm95 or cfg.Scoef != 0.0)
    return [t[:2] if salt else t[0]] + ([z_r] if jm95 or bvf else []) + \
        ([z_w] if jm95 and bvf else [])


def _reads_prsgrd32(g, a, kw):
    """prsgrd32(cfg, grid, rho, z_r, z_w, Hz, eq_tide): z_w's surface plane
    only."""
    rho, z_r, z_w, Hz = a[2:6]
    tide = kw.get("eq_tide")
    return [rho, z_r, z_w[-1], Hz, g.pm, g.pn] + \
        ([tide] if tide is not None else [])


def _reads_tracer_predictor(g, a, kw):
    """tracer_predictor(cfg, grid, iic, t, t_prev, Hz, Huon, Hvom, W, Akt,
    stflx, btflx, srflx=, ghats=, swdk_w=): Akt and ghats for the KPP
    nonlocal flux only, srflx and swdk_w for shortwave only, each at the
    interior w levels."""
    t, t_prev, Hz, Huon, Hvom, W, Akt, stflx, btflx = a[3:12]
    out = [t, t_prev, Hz, Huon, Hvom, W, stflx, btflx, g.pm, g.pn]
    ghats = kw.get("ghats")
    if ghats is not None:
        out += [Akt[:, 1:-1], ghats[:, 1:-1]]
    if kw.get("srflx") is not None and kw.get("swdk_w") is not None:
        out += [kw["srflx"], kw["swdk_w"][1:-1]]
    return out


def _reads_tracer_corrector(g, a, kw):
    """tracer_corrector(cfg, grid, t_nnew, t3, Huon, Hvom, W, Hz_new,
    z_r_new, Akt): z_r_new for the Thomas solve only."""
    cfg, _, t_nnew, t3, Huon, Hvom, W, Hz_new, z_r_new, Akt = a[:10]
    return [t_nnew, t3, Huon, Hvom, W, Hz_new, Akt, g.pm, g.pn] + \
        ([] if cfg.splines_vdiff else [z_r_new])


def _reads_rhs3d(g, a, kw):
    """rhs3d(cfg, grid, u, v, Huon, Hvom, W, Hz, ru, rv, sustr, svstr,
    bustr, bvstr, start=): the mass fluxes and W's interior levels with
    advection, f with Coriolis, dndx and dmde with the curvilinear terms,
    and the AB3 history with the start."""
    cfg = a[0]
    u, v, Huon, Hvom, W, Hz, ru, rv = a[2:10]
    out = [u, v, Hz, ru, rv, *a[10:14], g.pm, g.pn]
    if cfg.uv_adv:
        out += [Huon, Hvom, W[1:-1]]
    if cfg.uv_cor:
        out.append(g.f)
    if cfg.curvgrid and cfg.uv_adv:
        out += [g.dndx, g.dmde]
    if kw.get("start") is not None:
        out += list(kw["start"][2:])
    return out


def _reads_uv_corrector(g, a, kw):
    """uv_corrector(cfg, grid, iic, u_nnew, v_nnew, ru, rv, Hz_new, Akv,
    DU_avg1, DV_avg1, DU_avg2, DV_avg2, Huon_old, Hvom_old): Akv for the
    spline vertical viscosity only."""
    cfg = a[0]
    ins = list(a[3:15])
    if not cfg.splines_vvisc:
        del ins[5]
    return ins + [g.pm, g.pn, g.umask, g.vmask]


# kernel -> (source, TPU kernel it replaces, reads(grid, args, kwargs):
# the inputs, or parts of them, that its call on these arguments must read)
KERNELS = {
    "grid_flux": ("roms_tpu_torch/csrc/diag.cu",
                  "roms_tpu/ops/diag_pallas.py:53",
                  _reads_all("h", "pm", "pn", "sc_r", "Cs_r", "sc_w",
                             "Cs_w")),
    "eos": ("roms_tpu_torch/csrc/diag.cu", "roms_tpu/ops/diag_pallas.py:108",
            _reads_eos),
    "omega": ("roms_tpu_torch/csrc/diag.cu",
              "roms_tpu/ops/diag_pallas.py:144", _reads_all()),
    "fast_loop": ("roms_tpu_torch/csrc/fast_loop.cu",
                  "roms_tpu/ops/step2d_pallas.py:260",
                  _reads_all("h", "f", "pm", "pn", "dndx", "dmde", "rmask",
                             "umask", "vmask", "pmask")),
    "prsgrd32": ("roms_tpu_torch/csrc/prsgrd.cu",
                 "roms_tpu/ops/prsgrd_pallas.py:63", _reads_prsgrd32),
    "rhs3d": ("roms_tpu_torch/csrc/rhs3d.cu",
              "roms_tpu/ops/rhs3d_pallas.py:60", _reads_rhs3d),
    "uv3dmix2": ("roms_tpu_torch/csrc/mix3d.cu",
                 "roms_tpu/ops/mix3d_pallas.py:114",
                 _reads_all("pm", "pn", "pmask")),
    "tracer_predictor": ("roms_tpu_torch/csrc/step3d.cu",
                         "roms_tpu/ops/step3d_pallas.py:116",
                         _reads_tracer_predictor),
    "uv_corrector": ("roms_tpu_torch/csrc/step3d.cu",
                     "roms_tpu/ops/step3d_pallas.py:220",
                     _reads_uv_corrector),
    "tracer_corrector": ("roms_tpu_torch/csrc/step3d.cu",
                         "roms_tpu/ops/step3d_pallas.py:301",
                         _reads_tracer_corrector),
}


class SmokeFailure(Exception):
    pass


def check(cond: bool, msg: str):
    if not cond:
        raise SmokeFailure(msg)


def nvidia_smi() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(res.returncode == 0, f"nvidia-smi failed: {res.stderr.strip()}")
    return res.stdout.strip().splitlines()[0]


def wrappers():
    """{kernel name: (module, wrapper attribute, plain version)}."""
    from roms_tpu_torch.ops import diag_cuda, mix3d_cuda, prsgrd_cuda, \
        rhs3d_cuda, step2d_cuda, step3d_cuda
    return {
        "grid_flux": (diag_cuda, "grid_flux", diag_cuda.grid_flux_plain),
        "eos": (diag_cuda, "eos", diag_cuda.eos_plain),
        "omega": (diag_cuda, "omega", diag_cuda.omega_plain),
        "fast_loop": (step2d_cuda, "fast_loop", step2d_cuda.fast_loop_plain),
        "prsgrd32": (prsgrd_cuda, "prsgrd32", prsgrd_cuda.prsgrd32_plain),
        "rhs3d": (rhs3d_cuda, "rhs3d", rhs3d_cuda.rhs3d_plain),
        "uv3dmix2": (mix3d_cuda, "uv3dmix2", mix3d_cuda.uv3dmix2_plain),
        "tracer_predictor": (step3d_cuda, "tracer_predictor",
                             step3d_cuda.tracer_predictor_plain),
        "uv_corrector": (step3d_cuda, "uv_corrector",
                         step3d_cuda.uv_corrector_plain),
        "tracer_corrector": (step3d_cuda, "tracer_corrector",
                             step3d_cuda.tracer_corrector_plain),
    }


@contextlib.contextmanager
def patched(sites, wrap):
    """Replace each (module, attribute) of `sites` by wrap(name, original)
    for the duration; restore them after."""
    saved = [(mod, attr, getattr(mod, attr)) for mod, attr in sites]
    try:
        for mod, attr, fn in saved:
            # wraps() copies `launches`, which a wrapper increments through
            # its module's name for it
            setattr(mod, attr, functools.wraps(fn)(wrap(attr, fn)))
        yield
    finally:
        for mod, attr, fn in saved:
            setattr(mod, attr, fn)


def fresh(args):
    """`args` with every tensor among them cloned, a Fast2DState field by
    field (the fast-loop and uv3dmix2 kernels update their fields in
    place); a tensor passed twice stays one tensor."""
    import torch
    from roms_tpu_torch.ops.step2d import Fast2DState
    memo = {}

    def copy(a):
        if isinstance(a, torch.Tensor):
            return memo.setdefault(id(a), a.clone())
        if isinstance(a, Fast2DState):
            return dataclasses.replace(a, **{
                f.name: copy(getattr(a, f.name))
                for f in dataclasses.fields(a)})
        return a
    return tuple(copy(a) for a in args)


def captured_calls(cfg, grid, state, ffn):
    """The arguments each kernel wrapper receives in one kernels-on step
    from `state`: {name: (args, kwargs)}."""
    from roms_tpu_torch import stepping
    calls = {}

    def record(name, fn):
        def call(*args, **kw):
            calls[name] = (fresh(args), kw)
            return fn(*args, **kw)
        return call

    sites = [(mod, attr) for mod, attr, _ in wrappers().values()]
    with patched(sites, record):
        stepping.step(cfg, grid, state, ffn)
    return calls


_ARITH = {"add", "sub", "rsub", "mul", "div", "neg", "reciprocal", "sqrt",
          "rsqrt", "exp", "log", "pow", "abs", "maximum", "minimum", "clamp",
          "clamp_min", "clamp_max", "where", "gt", "lt", "ge", "le", "eq",
          "ne", "sin", "cos", "tanh", "sign", "addcmul", "addcdiv", "floor"}
_REDUCE = {"sum", "cumsum", "mean", "amax", "amin"}


def count_ops(fn, args, kw) -> int:
    """Arithmetic operations the plain version performs on these inputs:
    the elements of every arithmetic aten op's output (of its input for a
    reduction), counted under a TorchDispatchMode."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_leaves

    class Counter(TorchDispatchMode):
        ops = 0

        def __torch_dispatch__(self, func, types, a=(), k=None):
            out = func(*a, **(k or {}))
            name = func._overloadpacket.__name__.rstrip("_")
            if name in _REDUCE:
                Counter.ops += a[0].numel()
            elif name in _ARITH:
                Counter.ops += max((t.numel() for t in tree_leaves(out)
                                    if isinstance(t, torch.Tensor)),
                                   default=0)
            return out

    with Counter():
        fn(*fresh(args), **kw)
    return Counter.ops


def tensors_of(x):
    """The tensors in an argument or result (Fast2DState fields, tuple
    items), for the byte count."""
    import torch
    from roms_tpu_torch.ops.step2d import Fast2DState
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, Fast2DState):
        return [getattr(x, f.name) for f in dataclasses.fields(x)]
    if isinstance(x, (tuple, list)):
        return [t for a in x for t in tensors_of(a)]
    return []


def bound(name, grid, args, kw, outs, ops, dtype):
    """(bound_ms, bound_by): the larger of the bytes the kernel must move
    (each input read once, each output written once) over the card's
    bandwidth, and its operations over the card's peak rate.  The inputs
    are the parts that KERNELS says this call reads, each counted once."""
    ins = KERNELS[name][2](grid, args, kw)
    unique = {(t.data_ptr(), t.shape): t for t in ins}
    nbytes = sum(t.numel() * t.element_size() for t in unique.values())
    nbytes += sum(t.numel() * t.element_size() for t in tensors_of(outs))
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def device_ms(fn, args, kw) -> float:
    """fn's time a call on the card: CUDA events around NRUNS calls back
    to back, after two warm-up calls; the median over NBATCH such batches,
    so that a stall of the shared host in one batch does not count.  A
    fast loop runs again on the state it updated, which is the same
    work."""
    import torch
    a = fresh(args)
    for _ in range(2):
        fn(*a, **kw)
    batches = []
    for _ in range(NBATCH):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(NRUNS):
            fn(*a, **kw)
        end.record()
        torch.cuda.synchronize()
        batches.append(start.elapsed_time(end) / NRUNS)
    return sorted(batches)[NBATCH // 2]


def max_err(outs_k, outs_p, rtol):
    """(max abs error, worst error/tolerance) over paired outputs, each
    held to rtol * max|plain field|."""
    worst_abs, worst_ratio = 0.0, 0.0
    for a, b in zip(tensors_of(outs_k), tensors_of(outs_p)):
        err = (a - b).abs().max().item()
        tol = rtol * max(b.abs().max().item(), 1e-30)
        worst_abs = max(worst_abs, err)
        worst_ratio = max(worst_ratio, err / tol)
    return worst_abs, worst_ratio


def variants(cfg, grid, calls):
    """Cases beyond the main path's arguments: (label, kernel, args, kw)."""
    import numpy as np
    import torch
    from roms_tpu_torch.config import LBC
    rng = np.random.default_rng(7)
    like = dict(dtype=grid.h.dtype, device=grid.h.device)
    s2 = tuple(grid.h.shape)
    sw = (cfg.N + 1,) + s2

    def rand(shape, scale):
        return torch.tensor(scale * rng.standard_normal(shape), **like)

    out = [(name, name, args, kw) for name, (args, kw) in calls.items()]
    args, kw = calls["eos"]
    out.append(("eos[jm95+bvf]", "eos",
                (args[0].replace(eos="jm95"),) + args[1:],
                dict(kw, want_bvf=True)))
    args, kw = calls["prsgrd32"]
    out.append(("prsgrd32[eq_tide]", "prsgrd32", args,
                dict(kw, eq_tide=rand(s2, 0.05))))
    args, kw = calls["tracer_predictor"]
    out.append(("tracer_predictor[ghats+solar]", "tracer_predictor", args,
                dict(kw, ghats=rand((2,) + sw, 1e-3),
                     srflx=torch.tensor(1e-4 * rng.random(s2), **like),
                     swdk_w=torch.tensor(rng.random(sw), **like))))
    args, kw = calls["tracer_corrector"]
    out.append(("tracer_corrector[thomas]", "tracer_corrector",
                (args[0].replace(splines_vdiff=False),) + args[1:], kw))
    for name in ("tracer_predictor", "tracer_corrector"):
        args, kw = calls[name]
        vadv = ("SPLINES",) * args[0].ntracers
        out.append((f"{name}[splines vadv]", name,
                    (args[0].replace(t_vadv=vadv),) + args[1:], kw))
    closed = LBC()
    for name in ("rhs3d", "uv3dmix2"):
        args, kw = calls[name]
        out.append((f"{name}[closed E-W]", name, (args[0].replace(
            ew_periodic=False, gamma2=-1.0, lbc_zeta=closed, lbc_ubar=closed,
            lbc_vbar=closed, lbc_u=closed, lbc_v=closed, lbc_t=closed),)
            + args[1:], kw))
    args, kw = calls["rhs3d"]
    curv = dataclasses.replace(grid, dndx=rand(s2, 50.0),
                               dmde=rand(s2, 50.0))
    out.append(("rhs3d[curvgrid]", "rhs3d",
                (args[0].replace(curvgrid=True), curv) + args[2:], kw))
    out.append(("rhs3d[first step]", "rhs3d", args,
                dict(kw, start=(0.0, 0.0) + kw["start"][2:])))
    args, kw = calls["uv3dmix2"]
    out.append(("uv3dmix2[masked]", "uv3dmix2",
                (args[0], island(grid)) + args[2:], kw))
    return out


def island(grid):
    """The grid with a block of land points inside its interior."""
    import torch
    m = grid.rmask.clone()
    m[30:40, 15:25] = 0.0
    umask = m * torch.roll(m, 1, -1)
    vmask = m * torch.roll(m, 1, -2)
    return dataclasses.replace(grid, rmask=m, umask=umask, vmask=vmask,
                               pmask=umask * torch.roll(umask, 1, -2))


def kernel_checks(results, device):
    """Phase 3: every kernel against its plain version, f64 and f32."""
    import torch
    from roms_tpu_torch import stepping
    from roms_tpu_torch.models import upwelling
    from roms_tpu_torch.state import TENSOR_FIELDS

    table = wrappers()
    # a developed state: 3 plain float64 steps from rest
    cfg64, grid64, s, ffn = upwelling.build(upwelling.make_config(),
                                           device=device)
    s = stepping.run(cfg64.replace(pallas2d=False), grid64, s, 3, ffn)
    for dtype in ("float64", "float32"):
        cfg, grid, _, ffn = upwelling.build(
            upwelling.make_config(dtype=dtype), device=device)
        state = s.replace(**{k: getattr(s, k).to(grid.h.dtype)
                             for k in TENSOR_FIELDS})
        calls = captured_calls(cfg, grid, state, ffn)
        check(set(calls) == set(table),
              f"the main path called {sorted(calls)}, not every kernel")
        for label, name, args, kw in variants(cfg, grid, calls):
            mod, attr, plain = table[name]
            kern = getattr(mod, attr)
            rtol = FAST_RTOL if name == "fast_loop" else KERNEL_RTOL
            out_k = kern(*fresh(args), **kw)
            torch.cuda.synchronize()
            out_p = plain(*fresh(args), **kw)
            finite = all(bool(torch.isfinite(a).all())
                         for a in tensors_of(out_k))
            err, ratio = max_err(out_k, out_p, rtol[dtype])
            ms = device_ms(kern, args, kw)
            plain_ms = device_ms(plain, args, kw)
            ops = count_ops(plain, args, kw)
            b_ms, b_by = bound(name, grid, args, kw, out_k, ops, dtype)
            ok = finite and ratio <= 1.0
            print(f"[kernel] {label:30s} {dtype}: max_abs_err={err:.3e} "
                  f"tol={rtol[dtype]:g}*max|field| (worst err/tol "
                  f"{ratio:.3e}) finite={finite} kernel {ms:.4f} ms, plain "
                  f"{plain_ms:.4f} ms, bound {b_ms:.5f} ms by {b_by} "
                  f"({ops:.4e} ops)  {'OK' if ok else 'FAIL'}", flush=True)
            check(ok, f"{label} {dtype}: kernel disagrees with its plain "
                      "version")
            results.setdefault(label, {})[dtype] = dict(
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by)


def interior(cfg, a):
    H = cfg.halo
    return a[..., H:H + cfg.Mm, H:H + cfg.Lm]


def main_path(device):
    """Phase 4: 10 float64 steps through stepping.step; returns the
    launch counts of that run."""
    import numpy as np
    import torch
    from roms_tpu_torch import stepping
    from roms_tpu_torch.models import upwelling

    table = {k: getattr(mod, attr) for k, (mod, attr, _) in
             wrappers().items()}
    cfg, grid, s0, ffn = upwelling.build(upwelling.make_config(),
                                         device=device)
    nsteps = 10
    for w in table.values():
        w.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    s = stepping.run(cfg, grid, s0, nsteps, ffn)
    torch.cuda.synchronize()
    ms_step = (time.perf_counter() - t0) * 1e3 / nsteps
    launches = {k: w.launches for k, w in table.items()}
    print(f"[main] {nsteps} float64 UPWELLING steps, kernels on: "
          f"{ms_step:.2f} ms/step (host clock incl. first-call set-up); "
          f"launches {launches}", flush=True)
    check(all(n == nsteps for n in launches.values()),
          f"a kernel of the main path did not launch once a step: "
          f"{launches}")

    s_plain = stepping.run(cfg.replace(pallas2d=False), grid, s0, nsteps,
                           ffn)
    fields = {"zeta": s.zeta, "u": s.u, "v": s.v, "temp": s.t[0]}
    plain = {"zeta": s_plain.zeta, "u": s_plain.u, "v": s_plain.v,
             "temp": s_plain.t[0]}
    check(all(bool(torch.isfinite(a).all()) for a in fields.values()),
          "non-finite fields after 10 steps")
    ref = np.load(ANCHOR)
    ref_of = {"zeta": ref["zeta"], "u": ref["u_full"], "v": ref["v_full"],
              "temp": ref["temp_full"]}
    for name, a in fields.items():
        lim = CARD_FACTOR * ANCHOR_ATOL[name]
        got = interior(cfg, a).cpu().numpy()
        e_anchor = float(np.abs(got - ref_of[name]).max())
        e_plain = float((interior(cfg, a) -
                         interior(cfg, plain[name])).abs().max())
        ok = e_anchor <= lim and e_plain <= lim
        print(f"[main] {name:5s}: |kernels - anchor| = {e_anchor:.3e}, "
              f"|kernels - kernels off| = {e_plain:.3e}, bound {lim:g} "
              f"{'OK' if ok else 'FAIL'}", flush=True)
        check(ok, f"{name} misses the anchor bound")
    zsum = float(interior(cfg, s.zeta).sum())
    print(f"[main] sum(zeta) over the interior = {zsum:.3e}")
    check(abs(zsum) < CARD_FACTOR * 1e-10, "free-surface volume drifted")
    return launches


def upwelling_signature(cfg, grid, s0, s):
    """(mean zeta over the cell area in m, change of surface temperature
    at the wall that cools most in degC) between states s0 and s."""
    area = interior(cfg, 1.0 / (grid.pm * grid.pn))
    zeta = interior(cfg, s.zeta)
    mean_zeta = float((zeta * area).sum() / area.sum())
    sst0 = interior(cfg, s0.t[0, -1])
    sst = interior(cfg, s.t[0, -1])
    dsst_south = float((sst[0] - sst0[0]).mean())
    dsst_north = float((sst[-1] - sst0[-1]).mean())
    return mean_zeta, min(dsst_south, dsst_north)


def long_run(device, name):
    """Phase 5: 1440 float32 steps (5 model days)."""
    import torch
    from roms_tpu_torch import stepping
    from roms_tpu_torch.models import upwelling

    cfg, grid, s0, ffn = upwelling.build(
        upwelling.make_config(dtype="float32"), device=device)
    s = stepping.run(cfg, grid, s0, 2, ffn)       # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    s = stepping.run(cfg, grid, s, 1438, ffn)
    torch.cuda.synchronize()
    ms_step = (time.perf_counter() - t0) * 1000.0 / 1438
    finite = all(bool(torch.isfinite(getattr(s, k)).all())
                 for k in ("zeta", "ubar", "vbar", "u", "v", "t"))
    mean_zeta, dsst = upwelling_signature(cfg, grid, s0, s)
    pts = cfg.Lm * cfg.Mm * cfg.N
    print(f"[run] 1440 float32 UPWELLING steps (5 days): {ms_step:.3f} "
          f"ms/step on {name}, {pts / ms_step * 1e3:.4e} grid-points/s; "
          f"finite={finite} mean zeta {mean_zeta:.3e} m, SST change at "
          f"the upwelling wall {dsst:.3f} degC", flush=True)
    check(finite, "non-finite fields in the 5-day run")
    check(abs(mean_zeta) < 1e-6, "free-surface volume drifted")
    check(dsst < -1.0, "no upwelling: the surface did not cool at a wall")
    return ms_step


def profile(device):
    """Phase 6: torch.profiler over 10 float32 steps with a
    record_function span around every stage call of stepping.step."""
    import torch
    from torch.profiler import ProfilerActivity, record_function
    from roms_tpu_torch import stepping, vgrid
    from roms_tpu_torch.models import upwelling
    from roms_tpu_torch.ops import rhs3d_cuda

    sites = [(mod, attr) for mod, attr, _ in wrappers().values()]
    sites += [(stepping, n) for n in ("set_vbc", "t3dmix2")]
    sites.append((rhs3d_cuda, "momentum_rhs"))
    sites.append((vgrid, "set_depth"))

    def span(name, fn):
        def call(*args, **kw):
            with record_function("stage:" + name):
                return fn(*args, **kw)
        return call

    cfg, grid, s, ffn = upwelling.build(
        upwelling.make_config(dtype="float32"), device=device)
    s = stepping.run(cfg, grid, s, 3, ffn)        # warm-up
    nsteps = 10
    torch.cuda.synchronize()
    with patched(sites, span), torch.profiler.profile(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        s = stepping.run(cfg, grid, s, nsteps, ffn)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / nsteps
    check(bool(torch.isfinite(s.u).all()), "non-finite u in the profile")
    kernels = {}
    for e in prof.events():
        # device events, less the device-side copies of the stage spans
        if str(getattr(e, "device_type", "")).endswith("CUDA") and \
                not e.name.startswith("stage:"):
            ms = e.time_range.elapsed_us() / 1e3
            n, tot = kernels.get(e.name, (0, 0.0))
            kernels[e.name] = (n + 1, tot + ms)
    launches = sum(n for n, _ in kernels.values()) / nsteps
    busy = sum(t for _, t in kernels.values()) / nsteps
    check(launches > 0, "the profiler saw no device activity")
    print(f"[profile] 10 float32 steps under torch.profiler: "
          f"{wall_ms:.3f} ms/step (profiler on), {launches:.1f} device "
          f"launches a step, device busy {busy:.3f} ms a step, idle "
          f"{100.0 * (1.0 - busy / wall_ms):.1f}%", flush=True)
    ranked = sorted(kernels.items(), key=lambda kv: -kv[1][1])
    # the eight largest, and every kernel of the port's own library
    shown = [kv for i, kv in enumerate(ranked)
             if i < 8 or "at::native" not in kv[0]]
    for kname, (n, tot) in shown:
        print(f"[profile] device {tot / nsteps:8.4f} ms/step "
              f"{n / nsteps:7.1f} launches/step  {kname[:90]}")
    stages = [(e.key, e.cpu_time_total / 1e3 / nsteps)
              for e in prof.key_averages()
              if e.key.startswith("stage:") and e.cpu_time_total > 0]
    for key, ms in sorted(stages, key=lambda kv: -kv[1]):
        print(f"[profile] host {ms:8.3f} ms/step  {key[6:]}")


def main() -> int:
    try:
        import torch
    except ImportError as exc:
        print(f"chip_smoke: torch is not importable ({exc})",
              file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke run needs the card",
              file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    try:
        import roms_tpu_torch  # noqa: F401
        from roms_tpu_torch.ops import _kernels
    except ImportError as exc:
        print(f"chip_smoke: roms_tpu_torch is not importable beside this "
              f"script ({exc})", file=sys.stderr)
        return 2
    if not os.path.exists(ANCHOR):
        print(f"chip_smoke: missing {ANCHOR}", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda:0")
    name = torch.cuda.get_device_name(0)
    try:
        smi = nvidia_smi()
        print(f"[device] {name}; torch {torch.__version__}, CUDA "
              f"{torch.version.cuda}, {torch.cuda.device_count()} device(s)",
              flush=True)

        t0 = time.perf_counter()
        info = _kernels.build()
        _kernels.library()
        print(f"[build] nvcc {' '.join(_kernels.NVCC_FLAGS)}: "
              f"{time.perf_counter() - t0:.1f} s -> {info['path'].name}",
              flush=True)
        for line in info["log"].splitlines():
            if any(w in line for w in ("entry function", "registers",
                                       "spill")):
                print(f"[build] {line.strip()}")

        results = {}
        kernel_checks(results, device)
        launches = main_path(device)
        long_run(device, name)
        profile(device)
    except SmokeFailure as exc:
        print(f"chip_smoke: FAILED: {exc}", file=sys.stderr)
        return 1
    kernels = []
    for k, (src, rep, _) in KERNELS.items():
        r = results[k]["float64"]
        kernels.append({"name": k, "route": "cuda", "source": src,
                        "replaces": rep, "launches": launches[k],
                        "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                        "bound_by": r["bound_by"], "library_ms": None})
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
