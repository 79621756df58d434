"""SOLITON: the equatorial Rossby soliton, 2-D only and nondimensional
(counterpart of ``roms_tpu/models/soliton.py``).

ROMS/Include/soliton.h and roms_soliton.in (96x32, DT=0.05, NDTFAST=1,
NTIMES=2400); ana_grid.h (Xsize=48, Esize=16, depth 1, f0=0, beta=1, g=1)
and the SOLITON section of ana_initial.h.  The soliton travels west and
keeps its shape; the run is `ops.step2d.step_2d_only`, one call a step.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import Config, LBC
from ..grid import build_grid, torch_dtype
from ..ops import bc
from ..ops.step2d import make_fast_state


def make_config(Lm: int = 96, Mm: int = 32, dt: float = 0.05,
                dtype: str = "float64") -> Config:
    per = LBC.periodic_ew()
    return Config(
        name="soliton",
        Lm=Lm, Mm=Mm, N=1, ntracers=0,
        ew_periodic=True, ns_periodic=False,
        dt=dt, ndtfast=1, nfast=1,
        solve3d=False,
        uv_adv=True, uv_cor=True, uv_vis2=False, visc2=0.0,
        bottom_drag="quadratic", rdrg2=3.0e-3,
        g_override=1.0,
        lbc_zeta=per, lbc_ubar=per, lbc_vbar=per, lbc_u=per, lbc_v=per,
        lbc_t=per, dtype=dtype)


def build(cfg: Config | None = None,
          device: torch.device | str = torch.device("cuda")):
    """Returns (cfg, grid, fast_state0) with tensors on `device`."""
    cfg = cfg or make_config()
    Xsize, Esize = 48.0, 16.0
    grid, cfg = build_grid(cfg, Xsize, Esize, f0=0.0, beta=1.0,
                           depth_fn=lambda x, y, i, j, c: np.ones_like(x),
                           device=device)
    cfg = cfg.replace(nfast=1)            # main2d mode runs nfast = 1

    # the initial soliton (ana_initial.h SOLITON), in float64 numpy
    x0 = 2.0 * Xsize / 3.0
    y0 = 0.5 * Esize
    val1 = 0.395
    val2 = 0.771 * (val1 * val1)
    xr = grid.xr.cpu().numpy().astype(np.float64)
    yr = grid.yr.cpu().numpy().astype(np.float64)

    def sech2amp(x):
        e = np.exp(-val1 * x)
        return val2 * ((2.0 * e / (1.0 + e * e)) ** 2)

    x = xr - x0
    y = yr - y0
    zeta = 0.25 * sech2amp(x) * (6.0 * y * y + 3.0) * np.exp(-0.5 * y * y)
    xu = 0.5 * (np.roll(xr, 1, -1) + xr) - x0
    yu = yr - y0
    ubar = 0.25 * sech2amp(xu) * (6.0 * yu * yu - 9.0) * \
        np.exp(-0.5 * yu * yu)
    xv = xr - x0
    yv = 0.5 * (np.roll(yr, 1, -2) + yr) - y0
    vbar = 2.0 * sech2amp(xv) * yv * (-2.0 * val1 * np.tanh(val1 * xv)) * \
        np.exp(-0.5 * yv * yv)

    kw = dict(dtype=torch_dtype(cfg), device=grid.h.device)
    fs = make_fast_state(
        cfg, *(bc.fill_halo(cfg, torch.tensor(a, **kw))
               for a in (zeta, ubar, vbar)))
    return cfg, grid, fs
