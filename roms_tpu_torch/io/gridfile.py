"""File-driven domains: grid and initial/restart state from NetCDF
(counterpart of ``roms_tpu/io/gridfile.py``).

The analog of the reference's get_grid.F (read h, pm/pn, f, angle, lon/lat,
land masks from GRDNAME and derive the metrics) and get_state.F (read the
prognostic fields and time from an INI/HIS/RST file into the model state).
The analytic builders in grid.py and models/ are the ana_grid/ana_initial
path.

Both ROMS-native layouts (rho dims include the boundary ring: xi_rho =
Lm+2, staggered u/v dims one short) and the interior-only history layout
of io/netcdf.py (xi_rho = Lm) are accepted; the layout is inferred from
the dimension sizes.  Files are read with scipy's NetCDF-3 reader, whose
arrays are big-endian: every read goes through ``_get`` or load_state's
``rec_of``, which copy into native float64 before any tensor is made.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from scipy.io import netcdf_file

from ..config import Config
from ..grid import _assemble, _fill_periodic, torch_dtype
from ..state import State, initial_state


def _get(f, *names):
    """The first of `names` in the file, as a native float64 copy."""
    for n in names:
        if n in f.variables:
            return np.asarray(f.variables[n][:], dtype=np.float64).copy()
    return None


def embed(cfg: Config, a: np.ndarray, stagger: str = "r") -> np.ndarray:
    """Embed a file array (trailing dims (eta, xi)) into the padded layout.

    stagger: 'r' (rho), 'u', 'v', 'p'.  Accepts ROMS-native extents (rho:
    (Mm+2, Lm+2) with the boundary ring; u: (Mm+2, Lm+1); v: (Mm+1, Lm+2);
    p: (Mm+1, Lm+1)) or interior-only (Mm, Lm).  Cells the file does not
    cover are filled by edge replication, then periodic axes are wrapped
    (get_grid.F's exchange_2d calls after the read)."""
    H = cfg.halo
    L, M = cfg.Lm, cfg.Mm
    ny, nx = a.shape[-2], a.shape[-1]
    out = np.zeros(a.shape[:-2] + (cfg.ny_tot, cfg.nx_tot), dtype=a.dtype)

    if nx == L and ny == M:                      # interior-only layout
        j0, i0 = H, H
    elif nx in (L + 2, L + 1) and ny in (M + 2, M + 1):  # ROMS-native
        # rho-based dims start at ROMS index 0 -> padded H-1; u xi / v eta
        # dims start at ROMS index 1 -> padded H
        i0 = H - 1 if nx == L + 2 else H
        j0 = H - 1 if ny == M + 2 else H
    else:
        raise ValueError(
            f"field shape {a.shape} does not match Lm={L}, Mm={M} in "
            "either ROMS-native or interior layout")
    out[..., j0:j0 + ny, i0:i0 + nx] = a
    out[..., :, :i0] = out[..., :, i0:i0 + 1]
    out[..., :, i0 + nx:] = out[..., :, i0 + nx - 1:i0 + nx]
    out[..., :j0, :] = out[..., j0:j0 + 1, :]
    out[..., j0 + ny:, :] = out[..., j0 + ny - 1:j0 + ny, :]
    return _fill_periodic(cfg, out)


def load_grid(path: str, cfg: Optional[Config] = None,
              device: torch.device | str = torch.device("cuda"),
              **cfg_kwargs):
    """Read a ROMS grid NetCDF file -> (grid, cfg) with cfg finalized, the
    tensors on `device`.

    Without `cfg`, a Config is built from the file's dimensions (Lm, Mm
    from xi_rho/eta_rho) and cfg_kwargs (N, dt, the vertical coordinate...
    come from the caller: a grid file carries none of them).  Reads h, f,
    pm, pn, angle, lon/lat (or x/y) and mask_rho (all water by default),
    and derives the staggered masks as set_masks.F where the file has
    none."""
    f = netcdf_file(path, "r", mmap=False)
    try:
        nxr = f.dimensions.get("xi_rho")
        nyr = f.dimensions.get("eta_rho")
        if nxr is None or nyr is None:
            raise ValueError(f"{path}: no xi_rho/eta_rho dimensions")
        if cfg is None:
            roms_native = "xi_u" in f.dimensions or "spherical" in f.variables
            Lm = nxr - 2 if roms_native else nxr
            Mm = nyr - 2 if roms_native else nyr
            cfg_kwargs.setdefault("ew_periodic", False)
            cfg_kwargs.setdefault("ns_periodic", False)
            cfg = Config(Lm=Lm, Mm=Mm, **cfg_kwargs)
        elif nxr not in (cfg.Lm, cfg.Lm + 2) or \
                nyr not in (cfg.Mm, cfg.Mm + 2):
            raise ValueError(f"{path}: dims ({nyr},{nxr}) do not match "
                             f"config Lm={cfg.Lm} Mm={cfg.Mm}")

        h = _get(f, "h")
        if h is None:
            raise ValueError(f"{path}: no bathymetry variable 'h'")
        h = embed(cfg, h)
        fcor = _get(f, "f")
        fcor = embed(cfg, fcor) if fcor is not None else np.zeros_like(h)
        pm = _get(f, "pm")
        pn = _get(f, "pn")
        if pm is None or pn is None:
            raise ValueError(f"{path}: pm/pn metrics required")
        pm = embed(cfg, pm)
        pn = embed(cfg, pn)
        xr = _get(f, "lon_rho", "x_rho")
        yr = _get(f, "lat_rho", "y_rho")
        xr = embed(cfg, xr) if xr is not None else np.zeros_like(h)
        yr = embed(cfg, yr) if yr is not None else np.zeros_like(h)
        angler = _get(f, "angle", "angler")
        angler = embed(cfg, angler) if angler is not None else None

        rmask = _get(f, "mask_rho")
        rmask = np.ones_like(h) if rmask is None else embed(cfg, rmask)
        um = _get(f, "mask_u")
        vm = _get(f, "mask_v")
        pmsk = _get(f, "mask_psi")
        umask = embed(cfg, um, "u") if um is not None else \
            rmask * np.roll(rmask, 1, axis=-1)
        vmask = embed(cfg, vm, "v") if vm is not None else \
            rmask * np.roll(rmask, 1, axis=-2)
        pmask = embed(cfg, pmsk, "p") if pmsk is not None else \
            umask * np.roll(umask, 1, axis=-2)
    finally:
        f.close()
    return _assemble(cfg, h, fcor, pm, pn, xr, yr, rmask, umask, vmask,
                     pmask, device, angler=angler)


def save_grid(path: str, cfg: Config, grid) -> None:
    """Write a ROMS-native grid NetCDF file (xi_rho = Lm+2 with the
    boundary ring; the layout get_grid.F expects), in float64."""
    H = cfg.halo
    L, M = cfg.Lm, cfg.Mm
    ring = (slice(H - 1, H + M + 1), slice(H - 1, H + L + 1))

    f = netcdf_file(path, "w")
    f.createDimension("xi_rho", L + 2)
    f.createDimension("eta_rho", M + 2)
    f.createDimension("xi_u", L + 1)
    f.createDimension("eta_u", M + 2)
    f.createDimension("xi_v", L + 2)
    f.createDimension("eta_v", M + 1)
    f.type = b"ROMS-compatible grid file (roms_tpu_torch)"

    def put(name, a, dims=("eta_rho", "xi_rho"), sl=ring):
        v = f.createVariable(name, "d", dims)
        v[:] = a.detach().cpu().to(torch.float64).numpy()[sl]

    put("h", grid.h)
    put("f", grid.f)
    put("pm", grid.pm)
    put("pn", grid.pn)
    put("angle", grid.angler)
    if cfg.spherical:
        put("lon_rho", grid.xr)
        put("lat_rho", grid.yr)
    else:
        put("x_rho", grid.xr)
        put("y_rho", grid.yr)
    put("mask_rho", grid.rmask)
    put("mask_u", grid.umask, ("eta_u", "xi_u"),
        (slice(H - 1, H + M + 1), slice(H, H + L + 1)))
    put("mask_v", grid.vmask, ("eta_v", "xi_v"),
        (slice(H, H + M + 1), slice(H - 1, H + L + 1)))
    # a global attribute carries the flag (scipy's NetCDF-3 writer makes
    # scalar variables awkward; load_grid keys the layout off xi_u)
    f.spherical = b"T" if cfg.spherical else b"F"
    f.flush()
    f.close()


# get_state.F field-name mapping: State attr -> (NetCDF names, stagger)
_STATE_VARS = {
    "zeta": (("zeta",), "r"),
    "ubar": (("ubar",), "u"),
    "vbar": (("vbar",), "v"),
    "u": (("u",), "u"),
    "v": (("v",), "v"),
}
# perfect-restart extras (wrt_rst.F:37-156 PERFECT_RESTART field set)
_RESTART_VARS = {
    "rzeta": (("rzeta",), "r"),
    "rubar": (("rubar",), "u"),
    "rvbar": (("rvbar",), "v"),
    "DU_avg1": (("DU_avg1",), "u"),
    "DV_avg1": (("DV_avg1",), "v"),
    "DU_avg2": (("DU_avg2",), "u"),
    "DV_avg2": (("DV_avg2",), "v"),
    "Akv": (("AKv",), "r"),
    "tke": (("tke",), "r"),
    "gls": (("gls",), "r"),
}


def load_state(cfg: Config, path: str, rec: int = -1,
               device: torch.device | str = torch.device("cuda")) -> State:
    """Read an initial / history / restart NetCDF file -> State on
    `device` (get_state.F).

    rec selects the time record (default the last, the reference's
    tindex=0 "latest" convention).  Missing fields keep their cold-start
    values; an N-level file field fills an N+1-level State field with its
    top level repeated; tracers are found by the varinfo names (temp,
    salt, then cfg's extra tracer names).  ``time`` is a host float, in
    the precision of cfg.dtype."""
    from .varinfo import tracer_names
    dtype = torch_dtype(cfg)
    np_dtype = np.float64 if dtype == torch.float64 else np.float32
    f = netcdf_file(path, "r", mmap=False)
    try:
        s = initial_state(cfg, device=device)

        def rec_of(name):
            v = f.variables[name]
            a = np.asarray(v[:], dtype=np.float64)
            if v.dimensions and v.dimensions[0] == "ocean_time":
                a = a[rec]
            return a

        def ten(a):
            return torch.as_tensor(np.ascontiguousarray(a, np.float64)).to(
                device=device, dtype=dtype)

        upd = {}
        if "ocean_time" in f.variables:
            tvals = np.atleast_1d(
                np.asarray(f.variables["ocean_time"][:], np.float64))
            upd["time"] = float(np.asarray(tvals[rec], np_dtype))

        for attr, (names, stg) in {**_STATE_VARS, **_RESTART_VARS}.items():
            for nm in names:
                if nm in f.variables:
                    a = embed(cfg, rec_of(nm), stg)
                    shape = tuple(getattr(s, attr).shape)
                    if a.shape != shape:          # e.g. N+1-level fields
                        if a.shape[0] == shape[0] - 1:
                            a = np.concatenate([a, a[-1:]], axis=0)
                        else:
                            break
                    upd[attr] = ten(a)
                    break

        t = s.t.clone()
        got_t = False
        for idx, nm in tracer_names(cfg).items():
            if idx < cfg.ntracers and nm in f.variables:
                t[idx] = ten(embed(cfg, rec_of(nm)))
                got_t = True
        if got_t:
            upd["t"] = t
            upd["t_prev"] = t.clone()
        s = s.replace(**upd)
    finally:
        f.close()
    return s
