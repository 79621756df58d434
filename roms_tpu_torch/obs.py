"""Observation operators, observation files, and model-obs statistics.

Counterpart of ``roms_tpu/obs.py``: the analogs of the reference's
observation stack
  * extract_obs.F:1-462  - sample model fields at fractional grid
    coordinates (bilinear in the horizontal, linear in the vertical),
    with staggered-grid offsets for u/v points;
  * obs_read.F / obs_write.F + the s4dvar observation NetCDF format
    (obs_value, obs_time, obs_Xgrid/Ygrid/Zgrid, obs_type, obs_error,
    obs_provenance);
  * stats_modobs.F - innovation statistics per observed variable.

Fractional coordinates follow the ROMS convention: Xgrid/Ygrid are in
rho-point units (Xgrid = i means the rho point at ROMS index i; a u point
u(i) sits at Xgrid = i - 0.5), Zgrid is the fractional s-level (1..N)
(depth-space obs must be converted with grid z_r first, the obs_k2z.F
preprocessing step).  The samplers are plain tensor operations, so
torch.func.jvp / vjp and torch.autograd differentiate them.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from .config import Config

# s4dvar obs_type codes (mod_fourdvar.F ObsState2Type ordering)
OBS_TYPES = {"zeta": 1, "ubar": 2, "vbar": 3, "u": 4, "v": 5,
             "temp": 6, "salt": 7}
TYPE_FIELDS = {v: k for k, v in OBS_TYPES.items()}
# State attribute + tracer index for each observed variable
_FIELD_OF = {"zeta": ("zeta", None), "ubar": ("ubar", None),
             "vbar": ("vbar", None), "u": ("u", None), "v": ("v", None),
             "temp": ("t", 0), "salt": ("t", 1)}


def _stagger_offsets(var: str):
    """(dx, dy) added to Xgrid/Ygrid to land on the native staggered
    index of the field (extract_obs.F Cgrid offsets)."""
    if var in ("u", "ubar"):
        return 0.5, 0.0
    if var in ("v", "vbar"):
        return 0.0, 0.5
    return 0.0, 0.0


def _coord(a, device):
    """A coordinate (array, tensor or number) as a float64 tensor."""
    if isinstance(a, torch.Tensor):
        return a.to(device=device, dtype=torch.float64)
    return torch.as_tensor(np.asarray(a, np.float64), device=device)


def _numpy(a) -> np.ndarray:
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) \
        else np.asarray(a)


def interp2d(cfg: Config, f2, xg, yg, var: str = "zeta"):
    """Bilinear sample of a padded (..., Ny, Nx) field at fractional
    rho-unit coordinates (extract_obs.F:118-196 2-D branch)."""
    dx, dy = _stagger_offsets(var)
    ax = _coord(xg, f2.device) + dx + cfg.halo - 1.0
    ay = _coord(yg, f2.device) + dy + cfg.halo - 1.0
    i0 = torch.clamp(torch.floor(ax).to(torch.int64), 0, cfg.nx_tot - 2)
    j0 = torch.clamp(torch.floor(ay).to(torch.int64), 0, cfg.ny_tot - 2)
    wx = ax - i0
    wy = ay - j0
    f00 = f2[..., j0, i0]
    f01 = f2[..., j0, i0 + 1]
    f10 = f2[..., j0 + 1, i0]
    f11 = f2[..., j0 + 1, i0 + 1]
    return ((1 - wy) * ((1 - wx) * f00 + wx * f01) +
            wy * ((1 - wx) * f10 + wx * f11))


def interp3d(cfg: Config, f3, xg, yg, zg, var: str = "temp"):
    """Trilinear sample of a padded (N, Ny, Nx) field: gathers the 8
    corner values per observation instead of slicing whole levels."""
    dx, dy = _stagger_offsets(var)
    N = f3.shape[0]
    ax = _coord(xg, f3.device) + dx + cfg.halo - 1.0
    ay = _coord(yg, f3.device) + dy + cfg.halo - 1.0
    az = torch.clamp(_coord(zg, f3.device) - 1.0, 0.0, N - 1.0)
    i0 = torch.clamp(torch.floor(ax).to(torch.int64), 0, cfg.nx_tot - 2)
    j0 = torch.clamp(torch.floor(ay).to(torch.int64), 0, cfg.ny_tot - 2)
    k0 = torch.clamp(torch.floor(az).to(torch.int64), 0, max(N - 2, 0))
    wx = ax - i0
    wy = ay - j0
    wz = az - k0
    k1 = torch.clamp(k0 + 1, max=N - 1)

    c = {}
    for (sk, kk) in (("0", k0), ("1", k1)):
        for (sj, jj) in (("0", j0), ("1", j0 + 1)):
            for (si, ii) in (("0", i0), ("1", i0 + 1)):
                c[sk + sj + si] = f3[kk, jj, ii]
    lo = (1 - wy) * ((1 - wx) * c["000"] + wx * c["001"]) + \
        wy * ((1 - wx) * c["010"] + wx * c["011"])
    hi = (1 - wy) * ((1 - wx) * c["100"] + wx * c["101"]) + \
        wy * ((1 - wx) * c["110"] + wx * c["111"])
    return (1 - wz) * lo + wz * hi


@dataclass
class FracObs:
    """Observations of one variable at one model step, at fractional grid
    coordinates (the extract_obs.F sampling model).

    var: observed variable name (OBS_TYPES key); xg/yg: fractional
    rho-unit coordinates; zg: fractional s-level (ignored for 2-D vars);
    values/sigma as in fourdvar.Obs."""
    step: int
    var: str
    xg: np.ndarray
    yg: np.ndarray
    values: torch.Tensor
    zg: Optional[np.ndarray] = None
    sigma: float = 1.0

    def sample(self, cfg: Config, state):
        attr, tidx = _FIELD_OF[self.var]
        f = getattr(state, attr)
        if tidx is not None:
            f = f[tidx]
        if f.ndim == 2:
            return interp2d(cfg, f, self.xg, self.yg, self.var)
        zg = self.zg if self.zg is not None else f.shape[0]
        return interp3d(cfg, f, self.xg, self.yg, zg, self.var)


# ---------------------------------------------------------------------------
# Observation NetCDF files (s4dvar format; obs_read.F / obs_write.F)
# ---------------------------------------------------------------------------
def write_obs(path: str, cfg: Config, obs_list: Sequence[FracObs],
              dt: Optional[float] = None) -> None:
    """Write observations in the reference's 4D-Var observation file
    layout (one flat 'datum' dimension, survey metadata)."""
    from scipy.io import netcdf_file
    dt = cfg.dt if dt is None else dt
    obs_list = sorted(obs_list, key=lambda o: o.step)
    steps = sorted({o.step for o in obs_list})

    vals, times, xs, ys, zs, types, errs = [], [], [], [], [], [], []
    for o in obs_list:
        v = np.ravel(_numpy(o.values)).astype(np.float64)
        n = v.size
        vals.append(v)
        times.append(np.full(n, o.step * dt))
        xs.append(np.ravel(np.asarray(o.xg, np.float64)))
        ys.append(np.ravel(np.asarray(o.yg, np.float64)))
        zg = o.zg if o.zg is not None else np.zeros(n)
        zs.append(np.ravel(np.asarray(zg, np.float64)))
        types.append(np.full(n, OBS_TYPES[o.var], np.int32))
        errs.append(np.full(n, float(o.sigma) ** 2))

    f = netcdf_file(path, "w")
    nd = sum(v.size for v in vals)
    f.createDimension("datum", nd)
    f.createDimension("survey", len(steps))
    sv = f.createVariable("survey_time", "d", ("survey",))
    sv[:] = np.asarray([s * dt for s in steps])
    sv.units = b"seconds since initialization"
    nobs = f.createVariable("Nobs", "i", ("survey",))
    per = {s: 0 for s in steps}
    for o, v in zip(obs_list, vals):
        per[o.step] += v.size
    nobs[:] = np.asarray([per[s] for s in steps], np.int32)
    for name, data in (("obs_value", vals), ("obs_time", times),
                       ("obs_Xgrid", xs), ("obs_Ygrid", ys),
                       ("obs_Zgrid", zs), ("obs_error", errs)):
        v = f.createVariable(name, "d", ("datum",))
        v[:] = np.concatenate(data)
    v = f.createVariable("obs_type", "i", ("datum",))
    v[:] = np.concatenate(types)
    f.flush()
    f.close()


def read_obs(path: str, cfg: Config, dt: Optional[float] = None,
             device: torch.device | str = torch.device("cuda")) -> list:
    """Read an s4dvar-format observation file -> list[FracObs], grouped
    by (survey step, variable) exactly as obs_read.F ingests per-survey
    blocks; the values are float64 tensors on `device`."""
    from scipy.io import netcdf_file
    dt = cfg.dt if dt is None else dt
    f = netcdf_file(path, "r", mmap=False)
    try:
        val = np.asarray(f.variables["obs_value"][:], np.float64)
        tim = np.asarray(f.variables["obs_time"][:], np.float64)
        xg = np.asarray(f.variables["obs_Xgrid"][:], np.float64)
        yg = np.asarray(f.variables["obs_Ygrid"][:], np.float64)
        zg = np.asarray(f.variables["obs_Zgrid"][:], np.float64)
        typ = np.asarray(f.variables["obs_type"][:], np.int32)
        err = np.asarray(f.variables["obs_error"][:], np.float64)
    finally:
        f.close()

    out = []
    steps = np.rint(tim / dt).astype(int)
    for s in sorted(set(steps.tolist())):
        for ty in sorted(set(typ[steps == s].tolist())):
            m = (steps == s) & (typ == ty)
            var = TYPE_FIELDS[ty]
            sig = float(np.sqrt(np.mean(err[m]))) if m.any() else 1.0
            out.append(FracObs(
                step=int(s), var=var, xg=xg[m], yg=yg[m],
                zg=zg[m] if var in ("u", "v", "temp", "salt") else None,
                values=torch.as_tensor(val[m], device=device),
                sigma=sig))
    return out


# ---------------------------------------------------------------------------
# Model-observation statistics (stats_modobs.F)
# ---------------------------------------------------------------------------
def stats_modobs(cfg: Config, obs_list: Sequence[FracObs],
                 sample_states: Dict[int, object]) -> Dict[str, dict]:
    """Innovation statistics per observed variable: count, bias
    (model-obs mean), RMSE, std, correlation (stats_modobs.F summary
    table).  sample_states maps step -> State at that step."""
    per: Dict[str, list] = {}
    for o in obs_list:
        if o.step not in sample_states:
            continue
        model = np.ravel(_numpy(o.sample(cfg, sample_states[o.step])))
        data = np.ravel(_numpy(o.values))
        per.setdefault(o.var, []).append((model, data))

    out = {}
    for var, pairs in per.items():
        m = np.concatenate([p[0] for p in pairs])
        d = np.concatenate([p[1] for p in pairs])
        diff = m - d
        cor = (np.corrcoef(m, d)[0, 1] if m.size > 1 and d.std() > 0
               and m.std() > 0 else np.nan)
        out[var] = {
            "count": int(m.size),
            "bias": float(diff.mean()),
            "rmse": float(np.sqrt((diff ** 2).mean())),
            "std": float(diff.std()),
            "corr": float(cor),
            "model_mean": float(m.mean()),
            "obs_mean": float(d.mean()),
        }
    return out
