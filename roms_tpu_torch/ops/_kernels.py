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

from ..config import BC_PERIODIC, BC_CLOSED, BC_GRADIENT

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
_ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = _ARCH + ("-std=c++17", "-O3", "--fmad=false", "-Xptxas", "-v",
                      "-Xcompiler", "-fPIC")
_ENTRY_POINTS = ("roms_grid_flux", "roms_omega", "roms_eos",
                 "roms_fast_loop", "roms_prsgrd32", "roms_tracer_predictor",
                 "roms_tracer_corrector", "roms_uv_corrector", "roms_rhs3d",
                 "roms_uv3dmix2")


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
    return lib


def on_card(t) -> bool:
    """False for a CPU tensor (the wrappers then take the plain version),
    True for a CUDA tensor (the wrappers launch the kernel); any other
    device raises."""
    if t.device.type == "cpu":
        return False
    if t.device.type == "cuda":
        return True
    raise ValueError(f"no kernel or plain path for device {t.device}")


def check_tensors(tensors: dict, shapes: dict, dtype, device) -> bool:
    """Raise unless every tensor is contiguous, of `dtype` on `device`, of
    its expected shape, and `dtype` is one the kernels take.  Returns
    whether `dtype` is float64 (the kernels' dtype flag)."""
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"the kernels take float32 and float64, not {dtype}")
    for name, t in tensors.items():
        if t.device != device or t.dtype != dtype:
            raise ValueError(f"{name}: {t.dtype} on {t.device}, expected "
                             f"{dtype} on {device}")
        if tuple(t.shape) != tuple(shapes[name]):
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                             f"{tuple(shapes[name])}")
        if not t.is_contiguous():
            raise ValueError(f"{name} is not contiguous")
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


MAX_N = 64      # csrc/column.cuh kMaxN: levels a column kernel's thread holds


def column_ints(cfg, name: str) -> list:
    """N and the geometry ints of a column kernel (csrc/column.cuh); raise
    for a depth its thread-local columns cannot hold."""
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
