"""Station (point time-series) output (ROMS/Utility/wrt_station.F +
def_station.F + read_stapar.F); counterpart of
``roms_tpu/io/stations.py``.

The reference extracts named (lon,lat)/(I,J) positions every NSTA steps
and appends them to a stations NetCDF file.  Here a StationWriter holds
the station list as gather indices; `write` gathers the requested fields
at all stations from a state of numpy arrays (a ``{field: array}`` dict
as ``convert.state_to_numpy`` returns it, or an object with those
attributes) and appends a record.  Positions are grid indices (the
reference also supports lon/lat with grid search - supply indices from
your grid tooling)."""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
from scipy.io import netcdf_file

from ..config import Config
from .netcdf import field
from .varinfo import REGISTRY, tracer_names


class StationWriter:
    """Append-mode NetCDF station writer.

    stations: sequence of (i, j) ROMS interior rho indices (1..Lm/Mm).
    fields: state fields to record; 2-D fields store (time, station),
    3-D fields store (time, s_rho, station)."""

    def __init__(self, path: str, cfg: Config,
                 stations: Sequence[Tuple[int, int]],
                 fields=("zeta", "ubar", "vbar", "u", "v", "temp",
                         "salt")):
        self.path = path
        self.cfg = cfg
        H = cfg.halo
        ij = np.asarray(stations, dtype=np.int64)
        if ij.ndim != 2 or ij.shape[1] != 2:
            raise ValueError("stations must be a list of (i, j) pairs")
        if (ij[:, 0] < 1).any() or (ij[:, 0] > cfg.Lm).any() or \
                (ij[:, 1] < 1).any() or (ij[:, 1] > cfg.Mm).any():
            raise ValueError("station indices outside the interior")
        self._ia = ij[:, 0] + H - 1          # padded array indices
        self._ja = ij[:, 1] + H - 1
        tnames = tracer_names(cfg)
        self._tracer_idx = {v: k for k, v in tnames.items()}
        self.fields = tuple(fields)
        self._nrec = 0

        f = netcdf_file(path, "w")
        f.createDimension("ocean_time", None)
        f.createDimension("station", len(ij))
        f.createDimension("s_rho", cfg.N)
        f.type = "ROMS-compatible stations"
        tvar = f.createVariable("ocean_time", "d", ("ocean_time",))
        tvar.units = b"seconds since initialization"
        self._tvar = tvar
        for nm, col in (("Ipos", ij[:, 0]), ("Jpos", ij[:, 1])):
            v = f.createVariable(nm, "i", ("station",))
            v[:] = col.astype(np.int32)
        self._vars = {}
        for name in self.fields:
            info = REGISTRY[name]
            dims = ("ocean_time", "s_rho", "station") if \
                info.grid in ("r3", "w3") else ("ocean_time", "station")
            if info.grid == "w3":
                # sample W fields at rho levels (upper interface)
                dims = ("ocean_time", "s_rho", "station")
            v = f.createVariable(name, "d", dims)
            v.long_name = info.long_name.encode()
            v.units = info.units.encode()
            self._vars[name] = v
        self._f = f

    def write(self, state, time: Optional[float] = None):
        n = self._nrec
        self._tvar[n] = float(field(state, "time")) if time is None \
            else time
        for name in self.fields:
            if name in self._tracer_idx:
                a = np.asarray(field(state, "t")[self._tracer_idx[name]])
            elif name == "AKv":
                a = np.asarray(field(state, "Akv")[1:])
            else:
                a = np.asarray(field(state, name))
            self._vars[name][n] = a[..., self._ja, self._ia]
        self._nrec += 1

    def close(self):
        self._f.flush()
        self._f.close()


def read_stations(path: str) -> Dict[str, np.ndarray]:
    """Load a stations file back into arrays (copies)."""
    f = netcdf_file(path, "r")
    out = {k: np.array(v[:]) for k, v in f.variables.items()}
    f.close()
    return out
