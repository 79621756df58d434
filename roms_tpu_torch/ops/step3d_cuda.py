"""The 3-D predictor/corrector stages: their CUDA kernels and plain versions.

tracer_predictor - the tracer loop of pre_step3d: (t, t_prev, ...) ->
                   (t3, t_nnew).  Replaces the TPU kernel
                   roms_tpu/ops/step3d_pallas.py::tracer_predictor_fused.
uv_corrector     - step3d_uv -> (u, v, ubar, vbar, Huon, Hvom).  Replaces
                   step3d_pallas.uv_corrector_fused.
tracer_corrector - step3d_t -> the new tracers.  Replaces
                   step3d_pallas.tracer_corrector_fused.

Each wrapper takes its plain version (``*_plain``: the port's stage
functions) for CPU tensors only.  For CUDA tensors it launches the kernel of
csrc/step3d.cu, one launch for all tracers or both directions, or raises;
it never falls back.  The kernels run on tiles of padded points whose
columns a block keeps in shared memory; ``tracer_plan`` and ``uv_plan``
size the tile and the block, ``tracer_layout`` and ``uv_layout`` report a
kernel's registers and stack frame on the card.  ``wrapper.launches``
counts kernel launches.  The gates ``use_tracer`` and ``use_uv`` decide,
as the JAX step's ``use_tracer_pallas`` / ``use_uv_pallas`` do, whether
the step calls the wrappers at all.  The TPU kernel's folded harmonic
mixing (``mix_in_predictor``, off by default there) is not ported.
"""

from __future__ import annotations

import torch

from ..config import Config
from ..grid import Grid
from . import bc
from ._kernels import MAX_TRACERS, SMEM_MAX, bc_kinds, check_tensors, \
    column_ints, kernel_layout, launch, on_card
from .pre_step3d import predictor_coefs, tracer_phase as tracer_predictor_plain
from .step3d_t import step3d_t as tracer_corrector_plain
from .step3d_uv import corrector_cff, step3d_uv as uv_corrector_plain

# the schemes step3d_pallas lets into its kernels, and their codes in ours
_OK_SCHEMES = {"C2", "U1", "U3", "C4", "A4", "SPLINES"}
_HADV_CODE = {"U3": 0, "C4": 1, "C2": 2, "U1": 3, "A4": 4}  # HScheme
_VADV_CODE = {"C4": 0, "SPLINES": 1, "C2": 2, "U1": 3, "A4": 4}  # VScheme
TILE = 32                # padded points a tile holds, at most
TILE_THREADS = 256       # threads a tile block (step3d.cu kTileThreads)


def _largest_tile(col_bytes: int) -> int:
    """The largest power of two up to TILE whose columns of col_bytes
    leave room for three blocks an SM, and at least one column."""
    tile = TILE
    while tile > 1 and tile * col_bytes > SMEM_MAX // 3:
        tile //= 2
    return tile


def tracer_plan(name: str, dtype, N: int, NT: int, ny: int, nx: int) -> dict:
    """The launch of tracer kernel `name` ("tracer_predictor" or
    "tracer_corrector") on a padded ny x nx grid: {"tile": padded points a
    block, "blocks", "threads": a block, "smem_bytes": its dynamic shared
    memory}.  A tile column holds step3d.cuh tracer_rows words.  The tile
    is the largest power of two up to TILE whose columns leave room for
    three blocks an SM, and at least one column; the block's threads are a
    multiple of it (one per column and level slot)."""
    if name == "tracer_predictor":
        rows = 7 * N + 1 + NT * (4 * N + 1)
    else:
        rows = 8 * N + 1 + min(NT, 2) * (N + 1) + NT * (4 * N + 1)
    col_bytes = rows * (8 if dtype == torch.float64 else 4)
    tile = _largest_tile(col_bytes)
    return dict(tile=tile, blocks=-(-ny * nx // tile), threads=TILE_THREADS,
                smem_bytes=tile * col_bytes)


def uv_plan(dtype, N: int, ny: int, nx: int) -> dict:
    """The momentum corrector's launch on a padded ny x nx grid of N
    levels, as tracer_plan's: a tile column holds step3d.cuh uv_rows words
    (both directions), the tile is the largest power of two up to TILE
    that leaves room for three blocks an SM, and the block has a thread
    per column and level slot: TILE_THREADS in float32, half as many in
    float64, whose registers would otherwise leave room for two blocks an
    SM (twice as fast at BENCHMARK1 on an H100)."""
    f64 = dtype == torch.float64
    col_bytes = 2 * (7 * N + 6) * (8 if f64 else 4)
    tile = _largest_tile(col_bytes)
    return dict(tile=tile, blocks=-(-ny * nx // tile),
                threads=TILE_THREADS // 2 if f64 else TILE_THREADS,
                smem_bytes=tile * col_bytes)


def uv_layout(dtype) -> dict:
    """The momentum corrector's kernel on the current card: {"registers":
    a thread, "stack_bytes": its local memory (stack frame) a thread}."""
    return kernel_layout("roms_uv_corrector_layout", dtype)


def _plan_ints(name: str, cfg: Config, dtype) -> list:
    plan = tracer_plan(name, dtype, cfg.N, cfg.ntracers, cfg.ny_tot,
                       cfg.nx_tot)
    return [plan["tile"], plan["threads"], plan["smem_bytes"]]


def tracer_layout(name: str, dtype) -> dict:
    """Tracer kernel `name` on the current card: {"registers": a thread,
    "stack_bytes": its local memory (stack frame) a thread}."""
    return kernel_layout("roms_tracer_layout", dtype,
                         int(name == "tracer_corrector"))


def use_tracer(cfg: Config, bry=None, clm=None, sources=None,
               want_diags=False) -> bool:
    """Gate of the two tracer kernels (step3d_pallas.use_tracer_pallas)."""
    if not cfg.pallas2d or bc.current_ctx() is not None:
        return False
    if bry is not None or clm is not None or sources is not None \
            or want_diags:
        return False
    if bc.has_advanced(cfg.lbc_t):
        return False
    nt = cfg.ntracers
    return nt >= 1 and all(s in _OK_SCHEMES for s in cfg.t_hadv[:nt]) and \
        all(s in _OK_SCHEMES for s in cfg.t_vadv[:nt])


def use_uv(cfg: Config, bry=None, sources=None, wet=None) -> bool:
    """Gate of the momentum-corrector kernel (step3d_pallas.use_uv_pallas)."""
    if not cfg.pallas2d or bc.current_ctx() is not None:
        return False
    if bry is not None or sources is not None or wet is not None:
        return False
    return not (bc.has_advanced(cfg.lbc_u) or bc.has_advanced(cfg.lbc_v))


def _tracer_ints(cfg: Config, name: str) -> list:
    """The per-tracer scheme codes; raise for a tracer count or scheme the
    kernels do not take."""
    nt = cfg.ntracers
    if not 1 <= nt <= MAX_TRACERS:
        raise ValueError(f"{name} kernel: {nt} tracers outside "
                         f"1..{MAX_TRACERS}")
    hs, vs = cfg.t_hadv[:nt], cfg.t_vadv[:nt]
    if any(s not in _HADV_CODE for s in hs) or \
            any(s not in _VADV_CODE for s in vs):
        raise ValueError(f"{name} kernel: advection schemes {hs}/{vs} (it "
                         f"takes {sorted(_HADV_CODE)} horizontal, "
                         f"{sorted(_VADV_CODE)} vertical)")
    return [_HADV_CODE[s] for s in hs] + [_VADV_CODE[s] for s in vs]


def _akt_shape(cfg: Config, Akt):
    """Akt's expected shape: as many planes as it has, at least the ones the
    tracers read (tracer 0, and 1 for all others when NT >= 2)."""
    need = 2 if cfg.ntracers >= 2 else 1
    return (max(Akt.shape[0], need), cfg.N + 1, cfg.ny_tot, cfg.nx_tot)


def tracer_predictor(cfg: Config, grid: Grid, iic: int, t, t_prev, Hz,
                     Huon, Hvom, W, Akt, stflx, btflx, srflx=None,
                     ghats=None, swdk_w=None):
    """Returns the stacks (t3, t_nnew), (NT,N,Ny,Nx) each."""
    if not on_card(t):
        return tracer_predictor_plain(cfg, grid, iic, t, t_prev, Hz, Huon,
                                      Hvom, W, Akt, stflx, btflx,
                                      srflx=srflx, ghats=ghats,
                                      swdk_w=swdk_w)
    name = "tracer_predictor"
    ints = column_ints(cfg, name)
    schemes = _tracer_ints(cfg, name)
    nt, N = cfg.ntracers, cfg.N
    s2 = (cfg.ny_tot, cfg.nx_tot)
    s3, sw = (N,) + s2, (N + 1,) + s2
    sol = srflx is not None and swdk_w is not None
    ins = dict(t=t, t_prev=t_prev, Hz=Hz, Huon=Huon, Hvom=Hvom, W=W,
               Akt=Akt, pm=grid.pm, pn=grid.pn, stflx=stflx, btflx=btflx)
    shapes = dict(t=(nt,) + s3, t_prev=(nt,) + s3, Hz=s3, Huon=s3, Hvom=s3,
                  W=sw, Akt=_akt_shape(cfg, Akt), pm=s2, pn=s2,
                  stflx=(nt,) + s2, btflx=(nt,) + s2)
    if ghats is not None:
        ins["ghats"] = ghats
        shapes["ghats"] = (ghats.shape[0],) + sw
    if sol:
        ins.update(srflx=srflx, swdk_w=swdk_w)
        shapes.update(srflx=s2, swdk_w=sw)
    f64 = check_tensors("roms_tracer_predictor", ins, shapes, t.dtype,
                        t.device)
    t3, t_nnew = torch.empty_like(t), torch.empty_like(t)
    ng = 0 if ghats is None else min(ghats.shape[0], nt)
    coefs = [c for itrc in range(nt) for c in predictor_coefs(cfg, iic, itrc)]
    launch("roms_tracer_predictor", f64,
           [t, t_prev, Hz, Huon, Hvom, W, Akt, grid.pm, grid.pn, stflx,
            btflx, ghats, srflx if sol else None, swdk_w if sol else None,
            t3, t_nnew],
           ints + [nt, ng, int(sol)] + bc_kinds(cfg.lbc_t) + schemes +
           _plan_ints(name, cfg, t.dtype), [cfg.dt] + coefs,
           torch.cuda.current_stream(t.device))
    tracer_predictor.launches += 1
    return t3, t_nnew


def tracer_corrector(cfg: Config, grid: Grid, t_nnew, t3, Huon, Hvom, W,
                     Hz_new, z_r_new, Akt):
    """Returns the new tracers (NT,N,Ny,Nx), halo-filled."""
    if not on_card(t_nnew):
        return tracer_corrector_plain(cfg, grid, t_nnew, t3, Huon, Hvom, W,
                                      Hz_new, z_r_new, Akt)
    name = "tracer_corrector"
    ints = column_ints(cfg, name)
    schemes = _tracer_ints(cfg, name)
    nt, N = cfg.ntracers, cfg.N
    s2 = (cfg.ny_tot, cfg.nx_tot)
    s3, sw = (N,) + s2, (N + 1,) + s2
    thomas = not cfg.splines_vdiff
    ins = dict(t_nnew=t_nnew, t3=t3, Huon=Huon, Hvom=Hvom, W=W,
               Hz_new=Hz_new, Akt=Akt, pm=grid.pm, pn=grid.pn)
    shapes = dict(t_nnew=(nt,) + s3, t3=(nt,) + s3, Huon=s3, Hvom=s3, W=sw,
                  Hz_new=s3, Akt=_akt_shape(cfg, Akt), pm=s2, pn=s2)
    if thomas:
        ins["z_r_new"] = z_r_new
        shapes["z_r_new"] = s3
    f64 = check_tensors("roms_tracer_corrector", ins, shapes,
                        t_nnew.dtype, t_nnew.device)
    out = torch.empty_like(t_nnew)
    launch("roms_tracer_corrector", f64,
           [t_nnew, t3, Huon, Hvom, W, Hz_new, z_r_new if thomas else None,
            Akt, grid.pm, grid.pn, out],
           ints + [nt] + bc_kinds(cfg.lbc_t) + [int(cfg.splines_vdiff)] +
           schemes + _plan_ints(name, cfg, t_nnew.dtype), [cfg.dt],
           torch.cuda.current_stream(t_nnew.device))
    tracer_corrector.launches += 1
    return out


def uv_corrector(cfg: Config, grid: Grid, iic: int, u_nnew, v_nnew, ru, rv,
                 Hz_new, Akv, DU_avg1, DV_avg1, DU_avg2, DV_avg2, Huon_old,
                 Hvom_old):
    """Returns (u, v, ubar, vbar, Huon, Hvom), all halo-filled."""
    if not on_card(u_nnew):
        return uv_corrector_plain(cfg, grid, iic, u_nnew, v_nnew, ru, rv,
                                  Hz_new, Akv, DU_avg1, DV_avg1, DU_avg2,
                                  DV_avg2, Huon_old, Hvom_old)
    ints = column_ints(cfg, "uv_corrector")
    N = cfg.N
    s2 = (cfg.ny_tot, cfg.nx_tot)
    s3, sw = (N,) + s2, (N + 1,) + s2
    ins = dict(u_nnew=u_nnew, v_nnew=v_nnew, ru=ru, rv=rv, Hz_new=Hz_new,
               Akv=Akv, DU_avg1=DU_avg1, DV_avg1=DV_avg1, DU_avg2=DU_avg2,
               DV_avg2=DV_avg2, Huon_old=Huon_old, Hvom_old=Hvom_old,
               pm=grid.pm, pn=grid.pn, umask=grid.umask, vmask=grid.vmask)
    shapes = dict.fromkeys(ins, s2)
    shapes.update(dict.fromkeys(("u_nnew", "v_nnew", "ru", "rv", "Hz_new",
                                 "Huon_old", "Hvom_old"), s3), Akv=sw)
    f64 = check_tensors("roms_uv_corrector", ins, shapes, u_nnew.dtype,
                        u_nnew.device)
    outs = [torch.empty_like(a) for a in (u_nnew, v_nnew, DU_avg1, DV_avg1,
                                          u_nnew, v_nnew)]
    plan = uv_plan(u_nnew.dtype, N, cfg.ny_tot, cfg.nx_tot)
    launch("roms_uv_corrector", f64, list(ins.values()) + outs,
           ints + bc_kinds(cfg.lbc_u) + bc_kinds(cfg.lbc_v) +
           [int(cfg.splines_vvisc), plan["tile"], plan["threads"],
            plan["smem_bytes"]],
           [cfg.dt, corrector_cff(cfg.dt, iic), cfg.gamma2],
           torch.cuda.current_stream(u_nnew.device))
    uv_corrector.launches += 1
    return tuple(outs)


tracer_predictor.launches = 0
tracer_corrector.launches = 0
uv_corrector.launches = 0
