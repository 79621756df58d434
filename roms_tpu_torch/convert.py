"""Conversion between the JAX package's objects and the port's.

The JAX side is handed over as plain Python and numpy: a ``roms_tpu``
Config (a frozen dataclass, read field by field), and Grid/State as
``dict[str, np.ndarray]`` (the caller does the ``np.asarray``).  This
module imports no jax.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import config as _config
from .config import Config
from .grid import Grid, torch_dtype
from .state import State, TENSOR_FIELDS

# nested frozen dataclasses of the reference Config, rebuilt as the port's
_NESTED = {"LBC": _config.LBC, "GLSParams": _config.GLSParams}


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
        elif val is not None and f.name in ("bio_params", "sed_params",
                                            "bbl_params"):
            raise NotImplementedError(f"Config.{f.name} is not ported")
        kw[f.name] = val
    return Config(**kw)


def _tensor(a, dtype, device):
    return torch.tensor(np.asarray(a), dtype=dtype, device=device)


def grid_from_numpy(cfg: Config, arrays: dict, device="cpu") -> Grid:
    """A Grid from {field name: array} (the JAX Grid's fields)."""
    dtype = torch_dtype(cfg)
    kw = {}
    for f in dataclasses.fields(Grid):
        a = arrays.get(f.name)
        kw[f.name] = None if a is None else _tensor(a, dtype, device)
    return Grid(**kw)


def state_from_numpy(cfg: Config, arrays: dict, device="cpu") -> State:
    """A State from {field name: array} (the JAX State's fields); time and
    iic become host numbers."""
    dtype = torch_dtype(cfg)
    kw = {k: _tensor(arrays[k], dtype, device) for k in TENSOR_FIELDS}
    return State(time=float(arrays["time"]), iic=int(arrays["iic"]), **kw)


def state_to_numpy(state: State) -> dict:
    """{field name: numpy array} of a State, time and iic included."""
    out = {k: getattr(state, k).detach().cpu().numpy()
           for k in TENSOR_FIELDS}
    out["time"] = np.asarray(state.time)
    out["iic"] = np.asarray(state.iic)
    return out
