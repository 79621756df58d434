"""Sharded (parallel) NetCDF output, the mod_pio_netcdf analog
(counterpart of ``roms_tpu/io/pio.py``, in the same file format, so that
each package reads the other's parts).

The reference's PIO path (ROMS/Modules/mod_pio_netcdf.F) lets every MPI
rank write its tile of each field directly, with no gather to a master
rank.  Here each process writes only the blocks it steps
(parallel/smap.py) to a part file of its own, ``<base>.pNNN.nc`` (NetCDF3
via scipy; NNN the exchange's rank, 0 in process), one variable a block
and field, ``<field>_s<k>`` (k = row * xi_blocks + column), with the
block's offsets into the global interior as attributes eta0 / xi0.
``read_sharded`` rebuilds the global interiors from all parts and
``assemble`` merges them into one file (the PIO rearranger, offline).
"""

from __future__ import annotations

import glob
from typing import Dict, Optional, Sequence

import numpy as np
from scipy.io import netcdf_file

from ..config import Config

_FIELDS_2D = ("zeta", "ubar", "vbar")
_FIELDS_3D = ("u", "v")


class ShardedHistoryWriter:
    """A process's part of a sharded history stream: at each write, the
    interior of every block it holds, of each field."""

    def __init__(self, base: str, cfg: Config, layout,
                 fields: Sequence[str] = _FIELDS_2D + _FIELDS_3D + ("t",)):
        from ..parallel import smap
        self.base = base
        self.cfg = cfg
        self.layout = smap.as_layout(layout)
        self.fields = tuple(fields)
        self.path = f"{base}.p{self.layout.exchange.rank:03d}.nc"
        self._nc = netcdf_file(self.path, "w")
        self._nc.createDimension("time", None)
        v = self._nc.createVariable("time", "d", ("time",))
        v.units = "seconds"
        self._nc.Lm = cfg.Lm
        self._nc.Mm = cfg.Mm
        self._nc.N = cfg.N
        self._nc.ntracers = cfg.ntracers
        self._vars: Dict[str, object] = {}
        self._nrec = 0
        self._dims: Dict[str, str] = {}

    def _dim(self, n: int) -> str:
        name = f"d{n}"
        if name not in self._dims:
            self._nc.createDimension(name, n)
            self._dims[name] = name
        return name

    def _shard_var(self, key: str, shape, eta0: int, xi0: int):
        if key not in self._vars:
            dims = ("time",) + tuple(self._dim(n) for n in shape)
            v = self._nc.createVariable(key, "d", dims)
            v.eta0 = eta0
            v.xi0 = xi0
            self._vars[key] = v
        return self._vars[key]

    def write(self, blocks: dict, time: float):
        """Append one record from {pos: block state} (this process's
        blocks)."""
        from ..parallel import smap
        cfg, lay = self.cfg, self.layout
        H = cfg.halo
        n = self._nrec
        self._nc.variables["time"][n] = float(time)
        for pos in sorted(blocks):
            j0, m, i0, l = smap.bounds(cfg, lay, pos)
            k = pos[0] * lay.xi + pos[1]
            for name in self.fields:
                a = getattr(blocks[pos], name)[..., H:H + m, H:H + l]
                sub = a.detach().to("cpu", copy=True).numpy()
                self._shard_var(f"{name}_s{k}", sub.shape, j0, i0)[n] = sub
        self._nrec += 1
        self._nc.flush()

    def close(self):
        self._nc.close()


def _global_shape(name: str, Mm: int, Lm: int, N: int, nt: int):
    if name in _FIELDS_2D:
        return (Mm, Lm)
    if name in _FIELDS_3D:
        return (N, Mm, Lm)
    if name == "t":
        return (nt, N, Mm, Lm)
    raise KeyError(name)


def read_sharded(base: str) -> Dict[str, np.ndarray]:
    """{field: (T, ...global interior...)} and 'time' from all part files
    of a sharded stream (this package's or roms_tpu's)."""
    parts = sorted(glob.glob(f"{base}.p*.nc"))
    if not parts:
        raise FileNotFoundError(f"no part files match {base}.p*.nc")
    out: Dict[str, np.ndarray] = {}
    time = None
    for path in parts:
        nc = netcdf_file(path, "r", mmap=False)
        Lm, Mm, N = int(nc.Lm), int(nc.Mm), int(nc.N)
        nt = int(nc.ntracers)
        time = np.asarray(nc.variables["time"][:])
        T = len(time)
        for key, v in nc.variables.items():
            if key == "time" or "_s" not in key:
                continue
            name = key.rsplit("_s", 1)[0]
            if name not in out:
                out[name] = np.zeros(
                    (T,) + _global_shape(name, Mm, Lm, N, nt))
            e0, x0 = int(v.eta0), int(v.xi0)
            blk = np.asarray(v[:])
            sh = blk.shape
            out[name][..., e0:e0 + sh[-2], x0:x0 + sh[-1]] = blk
        nc.close()
    out["time"] = time
    return out


def assemble(base: str, out_path: Optional[str] = None) -> str:
    """Merge the part files into one canonical NetCDF (the offline PIO
    rearranger); returns its path."""
    out_path = out_path or f"{base}.nc"
    data = read_sharded(base)
    time = data.pop("time")
    nc = netcdf_file(out_path, "w")
    nc.createDimension("time", None)
    tv = nc.createVariable("time", "d", ("time",))
    dims = {}

    def dim(n):
        name = f"d{n}"
        if name not in dims:
            nc.createDimension(name, n)
            dims[name] = name
        return name

    for name, arr in data.items():
        v = nc.createVariable(
            name, "d", ("time",) + tuple(dim(n) for n in arr.shape[1:]))
        v[:] = arr
    tv[:] = time
    nc.close()
    return out_path
