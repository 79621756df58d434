"""Build and load the port's CUDA kernels (``roms_tpu_torch/csrc``).

The kernels are compiled by ``nvcc`` for ``sm_90a`` into one shared library
with a plain C interface, loaded with ctypes.  The build runs at first use,
from the repository's sources only, into ``build/kernels/`` at the root of
the checkout, keyed by a hash of the sources: a changed source builds anew.
Each ``csrc/*.cu`` compiles in its own ``nvcc`` process, all started
together, and one more links the objects.  Nothing here runs at import
time, so the package imports on a machine with no CUDA toolkit.

``--fmad=false`` keeps nvcc from contracting a*b+c into fused multiply-adds,
so that a kernel rounds like its plain PyTorch version operation for
operation; the remaining differences come from summation order.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch
import torch.autograd.forward_ad as fwAD

from ..config import BC_PERIODIC, BC_CLOSED, BC_GRADIENT

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
_ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = _ARCH + ("-std=c++17", "-O3", "--fmad=false", "-Xptxas", "-v",
                      "-Xcompiler", "-fPIC")
_ENTRY_POINTS = ("roms_grid_flux", "roms_omega", "roms_eos",
                 "roms_fast_loop", "roms_prsgrd32", "roms_tracer_predictor",
                 "roms_tracer_corrector", "roms_uv_corrector", "roms_rhs3d",
                 "roms_uv3dmix2", "roms_t3dmix2_geo")


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (nvcc on PATH or /usr/local/cuda)")


def _sources():
    return sorted(CSRC.glob("*.cu")), sorted(CSRC.glob("*.cuh"))


def _source_key() -> str:
    cu, cuh = _sources()
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in cu + cuh:
        digest.update(path.name.encode())
        digest.update(path.read_bytes())
    return digest.hexdigest()[:16]


@functools.cache
def build() -> dict:
    """Compile the library if this source hash has no build yet.  Returns
    {"path", "seconds", "log"}: the library, the build's wall time (0 when
    an earlier build was reused) and nvcc's output (-Xptxas -v register and
    spill counts)."""
    so = BUILD_DIR / f"libroms_kernels_{_source_key()}.so"
    if so.exists():
        return {"path": so, "seconds": 0.0, "log": ""}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cu, _ = _sources()
    tag = f"{so.stem}.{os.getpid()}"
    objs = [BUILD_DIR / f"{tag}.{src.stem}.o" for src in cu]
    tmp = so.with_name(f"{tag}.tmp")
    t0 = time.perf_counter()
    jobs = [[_nvcc(), *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
            for src, obj in zip(cu, objs)]
    log = _run_all(jobs)
    log += _run_all([[_nvcc(), *_ARCH, "-shared", "-o", str(tmp),
                      *map(str, objs)]])
    seconds = time.perf_counter() - t0
    for obj in objs:
        obj.unlink()
    os.replace(tmp, so)       # atomic: concurrent builders agree
    return {"path": so, "seconds": seconds, "log": log}


def _run_all(cmds) -> str:
    """Run the commands side by side; return their joined output, or raise
    with the output of the first that failed."""
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for cmd in cmds]
    outs = [proc.communicate()[0] for proc in procs]
    for cmd, proc, out in zip(cmds, procs, outs):
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                               f"{' '.join(cmd)}\n{out}")
    return "".join(outs)


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    lib = ctypes.CDLL(str(build()["path"]))
    for name in _ENTRY_POINTS:
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_void_p),
                       ctypes.POINTER(ctypes.c_int),
                       ctypes.POINTER(ctypes.c_double), ctypes.c_void_p]
        fn.restype = ctypes.c_int
    lib.roms_fast_loop_scratch_planes.argtypes = []
    lib.roms_fast_loop_scratch_planes.restype = ctypes.c_int
    lib.roms_fast_loop_plan.argtypes = [ctypes.c_int] * 3 + [
        ctypes.POINTER(ctypes.c_int)]
    lib.roms_fast_loop_plan.restype = ctypes.c_int
    lib.roms_grid_barriers.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p]
    lib.roms_grid_barriers.restype = ctypes.c_int
    lib.roms_t3dmix2_geo_layout.argtypes = [ctypes.c_int,
                                            ctypes.POINTER(ctypes.c_int)]
    lib.roms_t3dmix2_geo_layout.restype = ctypes.c_int
    for name in ("roms_tracer_layout", "roms_rhs3d_layout"):
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_int, ctypes.c_int,
                       ctypes.POINTER(ctypes.c_int)]
        fn.restype = ctypes.c_int
    for name in ("roms_prsgrd32_layout", "roms_uv_corrector_layout",
                 "roms_uv3dmix2_layout", "roms_grid_flux_layout",
                 "roms_omega_layout", "roms_eos_layout"):
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
        fn.restype = ctypes.c_int
    return lib


def kernel_layout(name: str, dtype, *args) -> dict:
    """The kernel of layout entry point `name` (roms_<kernel>_layout, with
    any `args` after the dtype flag) on the current card: {"registers": a
    thread, "stack_bytes": its local memory (stack frame) a thread}."""
    out = (ctypes.c_int * 2)()
    err = getattr(library(), name)(int(dtype == torch.float64), *args, out)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err}")
    return dict(registers=out[0], stack_bytes=out[1])


SMEM_MAX = 232448   # shared memory a block can take on the H100
SMS = 132           # streaming multiprocessors of an H100 SXM


def tile_plan(make) -> dict:
    """The launch of a kernel on 2-D tiles of padded points.  make(tx, ty)
    gives the plan of a tile tx points along xi by ty along eta (a dict
    with "blocks" and "smem_bytes").  The tiles are 32 points along xi
    (16, 8, ... where no 32-point tile fits) by 8, 4, 2 or 1 rows, those
    whose shared memory leaves room for three blocks an SM; of these, the
    one with the most rows that gives at least two blocks an SM, else one,
    else the one with the most rows: a grid that small is one wave
    whatever the tile."""
    for tx in (32, 16, 8, 4, 2, 1):
        plans = [p for p in (make(tx, ty) for ty in (8, 4, 2, 1))
                 if p["smem_bytes"] <= SMEM_MAX // 3]
        if plans:
            break
    else:
        raise ValueError("no tile fits the shared memory")
    for least in (2 * SMS, SMS):
        for plan in plans:
            if plan["blocks"] >= least:
                return plan
    return plans[0]


def on_card(t) -> bool:
    """False for a CPU tensor (the wrappers then take the plain version),
    True for a CUDA tensor (the wrappers launch the kernel); any other
    device raises."""
    if t.device.type == "cpu":
        return False
    if t.device.type == "cuda":
        return True
    raise ValueError(f"no kernel or plain path for device {t.device}")


def refuse_autodiff(name: str, tensors) -> None:
    """Raise a RuntimeError if any tensor carries a derivative: one under a
    torch.func transform (jvp, vjp, grad, vmap), one that requires grad
    while grad mode is on, or a forward-AD dual.  A kernel reads raw
    device pointers, so its outputs would carry no derivative; no kernel
    has one, in this package or in roms_tpu, whose tangent-linear and
    adjoint runs take its plain path.  Every wrapper calls this through
    check_tensors() before it reads a pointer or launches; it never falls
    back.  The three states are asked once a call, so that a launch
    outside them pays ~0.1 us a tensor."""
    transformed = torch._C._functorch.peek_interpreter_stack() is not None
    grad = torch.is_grad_enabled()
    dual = fwAD._current_level >= 0       # inside a forward-AD dual_level
    for t in tensors:
        if t is None:
            continue
        if transformed and torch._C._functorch.is_functorch_wrapped_tensor(t):
            why = "a tensor under a torch.func transform"
        elif grad and t.requires_grad:
            why = "a tensor that requires grad"
        elif dual and fwAD.unpack_dual(t).tangent is not None:
            why = "a forward-AD dual tensor"
        else:
            continue
        raise RuntimeError(
            f"{name} kernel was handed {why}: the kernels have no "
            f"derivative; run the linearized step with pallas2d=False "
            f"(fourdvar.linear_config)")


def check_tensors(name: str, tensors: dict, shapes: dict, dtype,
                  device) -> bool:
    """Raise if a tensor carries a derivative (refuse_autodiff), and unless
    every tensor is contiguous, of `dtype` on `device`, of its expected
    shape, and `dtype` is one the kernels take.  `name` is the kernel's
    entry point.  Returns whether `dtype` is float64 (the kernels' dtype
    flag)."""
    refuse_autodiff(name, tensors.values())
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"the kernels take float32 and float64, not {dtype}")
    for arg, t in tensors.items():
        if t.device != device or t.dtype != dtype:
            raise ValueError(f"{name}: {arg}: {t.dtype} on {t.device}, "
                             f"expected {dtype} on {device}")
        if tuple(t.shape) != tuple(shapes[arg]):
            raise ValueError(f"{name}: {arg} has shape {tuple(t.shape)}, "
                             f"expected {tuple(shapes[arg])}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {arg} is not contiguous")
    return dtype == torch.float64


BC_CODE = {BC_PERIODIC: 0, BC_CLOSED: 1, BC_GRADIENT: 2}   # bc.cuh BcKind


def bc_kinds(lbc) -> list:
    """The kind codes of an LBC's west, south, east and north sides; raise
    for a kind the kernels do not take (the open boundaries)."""
    kinds = [getattr(lbc, s) for s in ("west", "south", "east", "north")]
    if any(k not in BC_CODE for k in kinds):
        raise ValueError(f"the kernels take periodic, closed and gradient "
                         f"lateral BCs, not {kinds}")
    return [BC_CODE[k] for k in kinds]


def geometry(cfg) -> list:
    """The padded-grid geometry ints every kernel takes first (csrc/bc.cuh
    Geom): Ny Nx H Lm Mm ew_periodic ns_periodic."""
    return [cfg.ny_tot, cfg.nx_tot, cfg.halo, cfg.Lm, cfg.Mm,
            int(cfg.ew_periodic), int(cfg.ns_periodic)]


MAX_N = 64      # most levels the column kernels' plans are tested for


def header_int(header: str, name: str) -> int:
    """The value of `constexpr int <name> = <value>;` in csrc/<header>."""
    import re
    text = (CSRC / header).read_text()
    found = re.search(rf"constexpr\s+int\s+{name}\s*=\s*(\d+)\s*;", text)
    if found is None:
        raise RuntimeError(f"csrc/{header} defines no constexpr int {name}")
    return int(found.group(1))


# most tracers a tracer kernel takes (csrc/column.cuh kMaxTr)
MAX_TRACERS = header_int("column.cuh", "kMaxTr")


def column_ints(cfg, name: str) -> list:
    """N and the geometry ints of a column kernel (csrc/column.cuh); raise
    for a depth outside the kernels' plans."""
    if not 3 <= cfg.N <= MAX_N:
        raise ValueError(f"{name} kernel: N={cfg.N} outside 3..{MAX_N}")
    return [cfg.N] + geometry(cfg)


def launch(name: str, f64: bool, tensors, ints, doubles, stream) -> None:
    """Call entry point `name` with device pointers of `tensors` (None for
    a null pointer), host int/double parameter arrays and the CUDA stream;
    raise if the launch reports an error."""
    ptrs = (ctypes.c_void_p * len(tensors))(
        *[None if t is None else t.data_ptr() for t in tensors])
    ip = (ctypes.c_int * max(len(ints), 1))(*ints)
    dp = (ctypes.c_double * max(len(doubles), 1))(*doubles)
    err = getattr(library(), name)(int(f64), ptrs, ip, dp,
                                   ctypes.c_void_p(stream.cuda_stream))
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")
