"""NetCDF history/averages/quick-save, diagnostics and floats output.

Counterpart of ``roms_tpu/io/netcdf.py``: the reference's def_his/wrt_his
(ROMS/Utility/def_his.F, wrt_his.F) through NetCDF3-classic via scipy.
Fields are written with interior-only extents (halo stripped), CF
metadata from the varinfo registry, and a config stamp (the reference's
wrt_info.F global attributes).  Adler-32 checksums of each record mirror
get_hash.F.  The file layout, variables and attributes are the JAX
package's; only the ``history`` attribute names this package.

The writers take numpy arrays: a state is a ``{field: array}`` dict (as
``convert.state_to_numpy`` returns it, ``time`` included) or an object
with those attributes; the grid's fields may also be CPU tensors.
"""

from __future__ import annotations

import json
import zlib
from collections.abc import Mapping
from typing import Dict, Optional

import numpy as np
from scipy.io import netcdf_file

from ..config import Config
from .varinfo import REGISTRY


def _interior(cfg: Config, a: np.ndarray) -> np.ndarray:
    H = cfg.halo
    return a[..., H:H + cfg.Mm, H:H + cfg.Lm]


def field(state, name: str):
    """`name` of a state given as a dict of arrays or as an object."""
    if isinstance(state, Mapping):
        return state[name]
    return getattr(state, name)


def _host(a) -> np.ndarray:
    """A field as a numpy array (a tensor is copied to the host)."""
    if hasattr(a, "detach"):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def adler32(a: np.ndarray) -> int:
    """Field checksum (the reference's get_hash.F Adler-32)."""
    return zlib.adler32(np.ascontiguousarray(a).tobytes())


class HistoryWriter:
    """Append-mode NetCDF writer for time records of model fields."""

    GRID_DIMS = {
        "r2": ("ocean_time", "eta_rho", "xi_rho"),
        "u2": ("ocean_time", "eta_rho", "xi_rho"),
        "v2": ("ocean_time", "eta_rho", "xi_rho"),
        "r3": ("ocean_time", "s_rho", "eta_rho", "xi_rho"),
        "w3": ("ocean_time", "s_w", "eta_rho", "xi_rho"),
    }

    def __init__(self, path: str, cfg: Config, grid=None,
                 fields=("zeta", "ubar", "vbar", "u", "v", "temp", "salt")):
        self.path = path
        self.cfg = cfg
        # the default list writes every tracer under its registered name
        # (mod_ncparam idTvar analog): temp alone for one tracer, the
        # biology's or generic names after salt for more than two
        self._tracer_idx = {}
        from .varinfo import tracer_names
        tnames = tracer_names(cfg)
        if fields == HistoryWriter.__init__.__defaults__[1]:
            fields = tuple(fields[:5]) + tuple(
                tnames[i] for i in range(cfg.ntracers))
        self._tracer_idx = {v: k for k, v in tnames.items()}
        self.fields = fields
        self.checksums = []
        self._nrec = 0

        f = netcdf_file(path, "w")
        f.createDimension("ocean_time", None)   # unlimited must come first
        f.createDimension("xi_rho", cfg.Lm)
        f.createDimension("eta_rho", cfg.Mm)
        f.createDimension("s_rho", cfg.N)
        f.createDimension("s_w", cfg.N + 1)
        f.history = "roms_tpu_torch history file"
        f.type = "ROMS-compatible history"
        # config stamp (wrt_info.F analog)
        f.config = json.dumps(
            {k: v for k, v in cfg.__dict__.items()
             if isinstance(v, (int, float, str, bool))}).encode()

        tvar = f.createVariable("ocean_time", "d", ("ocean_time",))
        tvar.units = b"seconds since initialization"
        self._tvar = tvar

        if grid is not None:
            for name, src in (("h", grid.h), ("f", grid.f),
                              ("pm", grid.pm), ("pn", grid.pn),
                              ("x_rho", grid.xr), ("y_rho", grid.yr)):
                v = f.createVariable(name, "d", ("eta_rho", "xi_rho"))
                info = REGISTRY[name]
                v.long_name = info.long_name.encode()
                v.units = info.units.encode()
                v[:] = _interior(cfg, _host(src))
            for name, src in (("Cs_r", grid.Cs_r), ("Cs_w", grid.Cs_w)):
                dim = "s_rho" if name == "Cs_r" else "s_w"
                v = f.createVariable(name, "d", (dim,))
                v[:] = _host(src)

        self._vars = {}
        for name in fields:
            info = REGISTRY[name]
            v = f.createVariable(name, "d", self.GRID_DIMS[info.grid])
            v.long_name = info.long_name.encode()
            v.units = info.units.encode()
            self._vars[name] = v
        self._f = f

    # output name -> State attribute when they differ
    ATTR_OF = {"AKv": "Akv", "AKt": "Akt"}
    # quick-save surface slices (wrt_quick.F): name -> (attr, tracer idx)
    SURFACE = {"temp_sur": ("t", 0), "salt_sur": ("t", 1),
               "u_sur": ("u", None), "v_sur": ("v", None)}

    def extract(self, state, name: str, extra=None) -> np.ndarray:
        """Resolve an output field name against a state (or the
        `extra` dict of derived records - the quadratic averages)."""
        if extra is not None and name in extra:
            return _host(extra[name])
        if name in self._tracer_idx:
            return _host(field(state, "t")[self._tracer_idx[name]])
        if name in self.SURFACE:
            attr, tidx = self.SURFACE[name]
            a = field(state, attr)
            if tidx is not None:
                a = a[tidx]
            return _host(a[-1])
        attr = self.ATTR_OF.get(name, name)
        a = _host(field(state, attr))
        if name == "AKt":
            a = a[0]
        return a

    def write(self, state, time: Optional[float] = None, extra=None):
        """Append one record from a state; extra supplies derived fields
        not carried by the State (set_avg.F quadratic averages)."""
        n = self._nrec
        t = float(field(state, "time")) if time is None else time
        self._tvar[n] = t
        rec_sums: Dict[str, int] = {}
        for name in self.fields:
            a = _interior(self.cfg, self.extract(state, name, extra))
            self._vars[name][n] = a
            rec_sums[name] = adler32(a)
        self.checksums.append(rec_sums)
        self._nrec += 1

    def close(self):
        self._f.flush()
        self._f.close()


class DiagWriter:
    """NetCDF writer for the per-term budget diagnostics stream (the
    reference's DIA file: ROMS/Utility/wrt_diags.F:1-866 writing the
    mod_diags.F accumulators).

    Accepts a dict of budget terms: tracer terms shaped (NT, N, Ny, Nx)
    are split into per-tracer variables (<tracer>_<term>), momentum terms
    (N, Ny, Nx) become u_<term>/v_<term>."""

    def __init__(self, path: str, cfg: Config):
        self.path = path
        self.cfg = cfg
        self._nrec = 0
        f = netcdf_file(path, "w")
        f.createDimension("ocean_time", None)
        f.createDimension("xi_rho", cfg.Lm)
        f.createDimension("eta_rho", cfg.Mm)
        f.createDimension("s_rho", cfg.N)
        f.type = b"ROMS-compatible diagnostics file (roms_tpu)"
        tvar = f.createVariable("ocean_time", "d", ("ocean_time",))
        tvar.units = b"seconds since initialization"
        self._tvar = tvar
        self._f = f
        self._vars: Dict[str, object] = {}
        from .varinfo import tracer_names
        self._tnames = tracer_names(cfg)

    def _var(self, name: str, term: str):
        if name not in self._vars:
            from .varinfo import DIA_TERMS
            v = self._f.createVariable(
                name, "d", ("ocean_time", "s_rho", "eta_rho", "xi_rho"))
            v.long_name = (name.split("_")[0] + " " +
                           DIA_TERMS.get(term, term)).encode()
            self._vars[name] = v
        return self._vars[name]

    def write(self, dia: Dict[str, np.ndarray],
              time: float, scale: float = 1.0):
        """Append one record of (possibly accumulated) diagnostics;
        scale divides (e.g. 1/navg for time means)."""
        n = self._nrec
        self._tvar[n] = time
        for key, val in sorted(dia.items()):
            a = np.asarray(val) * scale
            if a.ndim == 4:          # (NT,N,Ny,Nx) tracer term
                for ti in range(a.shape[0]):
                    nm = f"{self._tnames.get(ti, f'tracer{ti}')}_{key}"
                    self._var(nm, key)[n] = _interior(self.cfg, a[ti])
            elif a.ndim == 3:        # (N,Ny,Nx) momentum term (u_/v_...)
                term = key.split("_", 1)[-1]
                self._var(key, term)[n] = _interior(self.cfg, a)
        self._nrec += 1

    def close(self):
        self._f.flush()
        self._f.close()


class FloatsWriter:
    """Trajectory NetCDF for Lagrangian floats (wrt_floats.F layout:
    one record per sample, per-drifter coordinates)."""

    def __init__(self, path: str, cfg: Config, nfloats: int):
        self.path = path
        self.cfg = cfg
        self._nrec = 0
        f = netcdf_file(path, "w")
        f.createDimension("ocean_time", None)
        f.createDimension("drifter", nfloats)
        f.type = b"ROMS-compatible floats file (roms_tpu)"
        tvar = f.createVariable("ocean_time", "d", ("ocean_time",))
        tvar.units = b"seconds since initialization"
        self._tvar = tvar
        self._vars = {}
        for name, units in (("Xgrid", "nondimensional"),
                            ("Ygrid", "nondimensional"),
                            ("Zgrid", "nondimensional")):
            v = f.createVariable(name, "d", ("ocean_time", "drifter"))
            v.units = units.encode()
            self._vars[name] = v
        self._f = f

    def write(self, fl, time: float):
        """Append one record from a floats state with xg, yg, zg arrays
        shaped (4, nfloats): slot 3 of the Milne/Hamming history is the
        newest position."""
        n = self._nrec
        self._tvar[n] = time
        self._vars["Xgrid"][n] = np.asarray(field(fl, "xg")[3])
        self._vars["Ygrid"][n] = np.asarray(field(fl, "yg")[3])
        self._vars["Zgrid"][n] = np.asarray(field(fl, "zg")[3])
        self._nrec += 1

    def close(self):
        self._f.flush()
        self._f.close()


class FileRing:
    """Multi-file output ring (mod_iounits.F NDEFHIS semantics /
    output.F:172-586): a new file is created every `ndef` records,
    named <base>_NNNN.nc.  Wraps any writer class with the
    (path, *args, **kwargs) constructor convention."""

    def __init__(self, writer_cls, base: str, ndef: int, *args, **kw):
        self._cls = writer_cls
        self._base = base.rsplit(".nc", 1)[0]
        self._ndef = max(1, ndef)
        self._args = args
        self._kw = kw
        self._count = 0
        self._findex = 0
        self._w = None
        self.paths = []
        self._roll()

    def _roll(self):
        if self._w is not None:
            self._w.close()
        self._findex += 1
        path = f"{self._base}_{self._findex:04d}.nc"
        self.paths.append(path)
        self._w = self._cls(path, *self._args, **self._kw)
        self._count = 0

    def write(self, *args, **kw):
        if self._count >= self._ndef:
            self._roll()
        self._w.write(*args, **kw)
        self._count += 1

    def __getattr__(self, name):
        return getattr(self._w, name)

    def close(self):
        self._w.close()


def read_history(path: str):
    """Read a history file back into dict of numpy arrays."""
    f = netcdf_file(path, "r", mmap=False)
    out = {k: v[:].copy() for k, v in f.variables.items()}
    f.close()
    return out
