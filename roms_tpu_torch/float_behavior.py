"""Biological float behaviours (counterpart of
``roms_tpu/float_behavior.py``; FLOAT_BIOLOGY, biology_floats.F with
oyster_floats.h, Dekshenieks et al. 1993-1997, and a diel vertical
migration).

A behaviour gives each float a vertical velocity (m/s), which rides
floats.step_floats' w_vwalk slot once converted to w-level units, and a
state carried beside FloatsState.  roms_tpu's documented reductions of
oyster_floats.h are kept: the closed-form sinking law SR = 2.665
exp(0.0058 (L - 220)) um/s (oyster_floats.h:34), linear food-limited growth
and Gaussian temperature and salinity growth factors in place of the
lookup tables of mod_behavior.F, and constant ambient food and turbidity
(oyster_floats.h:229-232).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .config import Config


def diel_migration_w(cfg: Config, z_float, time, z_day=-40.0,
                     z_night=-5.0, w_swim=0.01):
    """The vertical velocity (m/s) of a diel vertical migration: toward
    z_day from 06 to 18 h and toward z_night otherwise, at up to w_swim.
    z_float: the floats' depths (m, negative); time in seconds."""
    tday = torch.as_tensor(time, dtype=z_float.dtype,
                           device=z_float.device) / 86400.0
    hour = 24.0 * (tday - torch.floor(tday))
    is_day = (hour >= 6.0) & (hour < 18.0)
    target = torch.where(is_day, torch.full_like(z_float, z_day),
                         torch.full_like(z_float, z_night))
    dz = target - z_float
    return torch.clamp(dz / 3600.0, -w_swim, w_swim)


class OysterParams(NamedTuple):
    """Defaults of the reference's behaviour metadata (mod_behavior.F and
    the floats input script)."""
    size0: float = 60.0          # initial larval size (um)
    size_settle: float = 330.0   # settlement size (um)
    food_supply: float = 1.0     # ambient food (mg Carbon/l)
    turb_ambi: float = 0.05      # ambient turbidity (g/l)
    turb_crit: float = 0.1       # critical turbidity
    growth_max: float = 0.018    # maximum growth rate (um/s scale 1/3600)
    temp_opt: float = 25.0       # growth-optimal temperature (C)
    temp_sig: float = 6.0
    salt_opt: float = 22.0       # growth-optimal salinity
    salt_sig: float = 8.0
    swim_Tmin: float = 0.2       # swimming-time fraction bounds
    swim_Tmax: float = 1.0
    w_swim: float = 2.0e-3       # upward swimming speed (m/s)
    slope_Tinc: float = 0.8      # swim-time response to dS/dt > 0
    slope_Tdec: float = -1.6     # and to dS/dt < 0 (halocline cue)


class OysterState(NamedTuple):
    size: torch.Tensor           # larval length (um)
    swim_time: torch.Tensor      # swimming-time fraction [0..1]
    settled: torch.Tensor        # 1.0 once settled on the bed


def init_oysters(nfloats: int, p: OysterParams, dtype=torch.float64,
                 device=None) -> OysterState:
    return OysterState(
        size=torch.full((nfloats,), p.size0, dtype=dtype, device=device),
        swim_time=torch.full((nfloats,), 0.5 * (p.swim_Tmin + p.swim_Tmax),
                             dtype=dtype, device=device),
        settled=torch.zeros((nfloats,), dtype=dtype, device=device))


def oyster_behavior(cfg: Config, p: OysterParams, st: OysterState,
                    temp_f, salt_f, dsalt, z_float, h_float):
    """One behavioural update (oyster_floats.h:174-330).  temp_f, salt_f:
    the fields at the floats; dsalt: the salinity change along the track
    this step (the halocline cue); z_float: depth (m, negative); h_float:
    the water depth (m).  Returns (OysterState, w_bio): w_bio is upward
    swimming for the swimming fraction of the time and Dekshenieks sinking
    for the rest, zero once settled."""
    dt = cfg.dt
    # growth: food-limited rate x T,S factor x turbidity effect
    food_lim = p.food_supply / (p.food_supply + 0.5)
    gfac_T = torch.exp(-0.5 * ((temp_f - p.temp_opt) / p.temp_sig) ** 2)
    gfac_S = torch.exp(-0.5 * ((salt_f - p.salt_opt) / p.salt_sig) ** 2)
    turb_ef = 0.4 if p.turb_ambi > p.turb_crit else 1.0
    growth = p.growth_max * food_lim * gfac_T * gfac_S * turb_ef
    size = torch.where(st.settled > 0.5, st.size,
                       st.size + dt / 3600.0 * growth * 3600.0 *
                       (1.0 - st.size / (1.3 * p.size_settle)))

    # the swimming fraction follows the salinity trend along the track
    # (oyster_floats.h:260-300)
    swim = st.swim_time + torch.where(dsalt >= 0.0, p.slope_Tinc * dsalt,
                                      p.slope_Tdec * (-dsalt))
    swim = torch.clamp(swim, p.swim_Tmin, p.swim_Tmax)

    # sinking rate SR = 2.665 exp(0.0058 (L - 220)) um/s, in m/s
    w_sink = 2.665e-6 * torch.exp(0.0058 * (size - 220.0))
    w_bio = swim * p.w_swim - (1.0 - swim) * w_sink

    # settlement: large enough and within 1 m of the bed
    near_bed = z_float <= (-h_float + 1.0)
    settled = torch.where((size >= p.size_settle) & near_bed, 1.0,
                          st.settled)
    w_bio = torch.where(settled > 0.5, 0.0, w_bio)
    return OysterState(size=size, swim_time=swim, settled=settled), w_bio
