"""Conversion between the JAX package's objects and the port's.

The JAX side is handed over as plain Python and numpy: a ``roms_tpu``
Config (a frozen dataclass, read field by field), Grid/State as
``dict[str, np.ndarray]`` (the caller does the ``np.asarray``; a grid read
by roms_tpu's io/gridfile.load_grid is a Grid like any other, and an
ice-shelf grid carries its zice), the 2-D-only mode's Fast2DState the same
way, the step's
dicts ``bry``, ``clm`` and ``wet`` as dicts of arrays or scalars, and
point sources as the fields of a ``PointSources``.  This module imports no jax.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import config as _config
from .config import Config
from .grid import Grid, torch_dtype
from .ops.bbl import BBLParams, MBBBLParams, SGBBLParams
from .ops.sediment import SedParams
from .ops.sources import PointSources
from .ops.step2d import FS_FIELDS, Fast2DState
from .state import State, TENSOR_FIELDS

# nested frozen dataclasses of the reference Config, rebuilt as the port's
_NESTED = {"LBC": _config.LBC, "GLSParams": _config.GLSParams,
           "SedParams": SedParams, "BBLParams": BBLParams,
           "MBBBLParams": MBBBLParams, "SGBBLParams": SGBBLParams}


def config_from_reference(ref_cfg) -> Config:
    """The port's Config with the field values of a roms_tpu Config."""
    kw = {}
    for f in dataclasses.fields(Config):
        val = getattr(ref_cfg, f.name)
        if dataclasses.is_dataclass(val):
            cls = _NESTED.get(type(val).__name__)
            if cls is None:
                raise NotImplementedError(
                    f"Config.{f.name}: {type(val).__name__} parameters are "
                    "not ported")
            val = cls(**{g.name: getattr(val, g.name)
                         for g in dataclasses.fields(cls)})
        elif val is not None and f.name == "bio_params":
            raise NotImplementedError(f"Config.{f.name} is not ported")
        kw[f.name] = val
    return Config(**kw)


def _tensor(a, dtype, device):
    return torch.tensor(np.asarray(a), dtype=dtype, device=device)


def grid_from_numpy(cfg: Config, arrays: dict,
                    device=torch.device("cuda")) -> Grid:
    """A Grid from {field name: array} (the JAX Grid's fields)."""
    dtype = torch_dtype(cfg)
    kw = {}
    for f in dataclasses.fields(Grid):
        a = arrays.get(f.name)
        kw[f.name] = None if a is None else _tensor(a, dtype, device)
    return Grid(**kw)


def state_from_numpy(cfg: Config, arrays: dict,
                     device=torch.device("cuda")) -> State:
    """A State from {field name: array} (the JAX State's fields); time and
    iic become host numbers."""
    dtype = torch_dtype(cfg)
    kw = {k: _tensor(arrays[k], dtype, device) for k in TENSOR_FIELDS}
    return State(time=float(arrays["time"]), iic=int(arrays["iic"]), **kw)


def fields_from_numpy(cfg: Config, fields: dict,
                      device=torch.device("cuda")) -> dict:
    """A dict of fields from {key: array or scalar}: arrays become tensors
    in the configuration's dtype, scalars stay floats.  It carries the
    step's dicts across: open-boundary data `bry` (ops/obc.py), the
    climatology `clm` (ubarclm/vbarclm/m2nudg, uclm/vclm/m3nudg,
    tclm/tnudg) and the fast loop's averaged wet/dry masks `wet`."""
    dtype = torch_dtype(cfg)
    return {k: float(v) if np.ndim(v) == 0 else _tensor(v, dtype, device)
            for k, v in fields.items()}


def sources_from_numpy(cfg: Config, arrays: dict,
                       device=torch.device("cuda")) -> PointSources:
    """PointSources from {field: array} (the JAX PointSources' fields):
    the indices as int64, the transports and tracer values in the
    configuration's dtype."""
    dtype = torch_dtype(cfg)
    ints = ("isrc", "jsrc", "dsrc")
    kw = {k: None if a is None else
          _tensor(a, torch.int64 if k in ints else dtype, device)
          for k, a in arrays.items()}
    return PointSources(**kw)


def state_to_numpy(state: State) -> dict:
    """{field name: numpy array} of a State, time and iic included."""
    out = {k: getattr(state, k).detach().cpu().numpy()
           for k in TENSOR_FIELDS}
    out["time"] = np.asarray(state.time)
    out["iic"] = np.asarray(state.iic)
    return out


def fast_state_from_numpy(cfg: Config, arrays: dict,
                          device=torch.device("cuda")) -> Fast2DState:
    """A Fast2DState from {field name: array} (the JAX Fast2DState's
    fields), in the configuration's dtype."""
    dtype = torch_dtype(cfg)
    return Fast2DState(**{k: _tensor(arrays[k], dtype, device)
                          for k in FS_FIELDS})


def fast_state_to_numpy(fs: Fast2DState) -> dict:
    """{field name: numpy array} of a Fast2DState."""
    return {k: getattr(fs, k).detach().cpu().numpy() for k in FS_FIELDS}
