"""Perfect-restart checkpointing.

Counterpart of ``roms_tpu/io/checkpoint.py``: the reference's RST stream
(def_rst/wrt_rst/get_state with PERFECT_RESTART).  All explicit time
levels and filter accumulators are State fields, so a restart is one file
written by ``torch.save``: a dict of the State's tensors on the host, plus
``time`` and ``iic``.  A restored run continues bit for bit, on the card
or the CPU whichever side wrote the file.
"""

from __future__ import annotations

import os

import torch

from ..state import State, TENSOR_FIELDS


def save(path: str, state: State) -> None:
    """Write `state` to the file `path` (replaced if it exists)."""
    data = {k: getattr(state, k).detach().cpu() for k in TENSOR_FIELDS}
    data["time"] = float(state.time)
    data["iic"] = int(state.iic)
    tmp = path + ".tmp"
    torch.save(data, tmp)
    os.replace(tmp, path)


def restore(path: str, template: State) -> State:
    """The State saved in `path`, its tensors on the device and in the
    dtype of `template`'s."""
    data = torch.load(path, map_location=template.zeta.device,
                      weights_only=True)
    missing = set(TENSOR_FIELDS) - set(data)
    if missing:
        raise ValueError(f"{path}: not a restart file, missing "
                         f"{sorted(missing)}")
    kw = {}
    for k in TENSOR_FIELDS:
        t = getattr(template, k)
        if tuple(data[k].shape) != tuple(t.shape):
            raise ValueError(f"{path}: {k} has shape "
                             f"{tuple(data[k].shape)}, the template "
                             f"{tuple(t.shape)}")
        kw[k] = data[k].to(device=t.device, dtype=t.dtype)
    return State(time=float(data["time"]), iic=int(data["iic"]), **kw)
