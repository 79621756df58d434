"""SED_TOY: the small sediment-transport test case (counterpart of
``roms_tpu/models/sed_toy.py``; ROMS/Include/sed_toy.h and
External/sediment_toy.in).

UPWELLING's physics with suspended sediment classes appended as passive
tracers (kg/m3), a uniform initial bed, and the sediment stage
(ops/sediment.py: settling, erosion and deposition, the bed layers,
optional bedload) every slow step.
"""

from __future__ import annotations

import dataclasses

import torch

from ..config import Config
from ..ops.sediment import SedParams
from ..state import initial_state
from . import upwelling

SED_INI = 0.0     # initial suspended concentration kg/m3 (a clean start)


def make_config(Lm: int = 8, Mm: int = 10, N: int = 10,
                dt: float = 300.0, ndtfast: int = 30,
                params: SedParams | None = None,
                dtype: str = "float64") -> Config:
    """UPWELLING's configuration with 2 + NST tracers (U3/C4, no tracer
    diffusion) and the sediment classes from tracer 2 on."""
    p = dataclasses.replace(params or SedParams(), ised0=2)
    nt = 2 + p.NST
    cfg = upwelling.make_config(Lm=Lm, Mm=Mm, N=N, dt=dt, ndtfast=ndtfast,
                                dtype=dtype)
    return cfg.replace(
        name="sed_toy", ntracers=nt,
        t_hadv=nt * ("U3",), t_vadv=nt * ("C4",), tnu2=nt * (0.0,),
        sediment=True, sed_params=p)


def build(cfg: Config | None = None,
          device: torch.device | str = torch.device("cuda"),
          conc: float = SED_INI):
    """Returns (cfg, grid, state0, forcing_fn) with tensors on `device`:
    UPWELLING's grid, initial state and wind, the sediment classes at
    `conc` everywhere and the uniform bed."""
    cfg = cfg or make_config()
    p = cfg.sed_params
    cfg_uw = cfg.replace(ntracers=2, sediment=False, sed_params=None)
    cfg_uw, grid, s_uw, ffn = upwelling.build(cfg_uw, device=device)
    # the grid-finished fields (hmin, the fast filter's nfast)
    cfg = cfg.replace(hmin=cfg_uw.hmin, nfast=cfg_uw.nfast)
    sed = torch.stack([torch.full_like(s_uw.t[0], conc)
                       for _ in range(p.NST)])
    t = torch.cat([s_uw.t, sed], dim=0)
    return cfg, grid, initial_state(cfg, device=device, zeta=s_uw.zeta,
                                    t=t), ffn
