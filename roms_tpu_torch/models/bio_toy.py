"""BIO_TOY: the one-dimensional (horizontally uniform) biology test case
(counterpart of ``roms_tpu/models/bio_toy.py``; External/bio_toy.in and
ana_biology.h:197-212).

UPWELLING's physics with the four NPZD Powell compartments appended as
passive tracers, uniform at the start (npzd_Powell.in BioIni), under a
constant photosynthetically available radiation (CONST_PAR, Powell &
Spitz's 158.075 W/m2).

SETUPS, model_config and build_model set each of the other seven models of
the biology slot up on UPWELLING the same way, with the tracer counts and
initial values roms_tpu's tests of those models give them (roms_tpu has
no case for them).
"""

from __future__ import annotations

import torch

from ..config import Config
from ..constants import Cp, rho0_default
from ..ops import bio_models as bm
from ..ops.biology import NPZDParams
from ..state import initial_state
from . import upwelling

BIO_INI = (1.67, 0.08, 0.06, 0.04)     # NO3, Phyt, Zoop, SDet [mmol/m3]


def make_config(Lm: int = 10, Mm: int = 12, N: int = 12,
                dt: float = 300.0, ndtfast: int = 30,
                params: NPZDParams | None = None,
                dtype: str = "float64") -> Config:
    """UPWELLING's configuration with 6 tracers (U3/C4, no tracer
    diffusion) and the NPZD compartments at tracers 2-5."""
    cfg = upwelling.make_config(Lm=Lm, Mm=Mm, N=N, dt=dt, ndtfast=ndtfast,
                                dtype=dtype)
    return cfg.replace(
        name="bio_toy", ntracers=6,
        t_hadv=6 * ("U3",), t_vadv=6 * ("C4",), tnu2=6 * (0.0,),
        biology="npzd_powell", ibio=(2, 3, 4, 5),
        bio_params=params or NPZDParams(const_par=158.075))


def build(cfg: Config | None = None,
          device: torch.device | str = torch.device("cuda")):
    """Returns (cfg, grid, state0, forcing_fn) with tensors on `device`:
    UPWELLING's grid, initial state and wind, and the bio compartments at
    BIO_INI everywhere."""
    cfg = cfg or make_config()
    cfg_uw = cfg.replace(ntracers=2, biology=None, bio_params=None)
    cfg_uw, grid, s_uw, ffn = upwelling.build(cfg_uw, device=device)
    # the grid-finished fields (hmin, the fast filter's nfast)
    cfg = cfg.replace(hmin=cfg_uw.hmin, nfast=cfg_uw.nfast)
    bio = torch.stack([torch.full_like(s_uw.t[0], v) for v in BIO_INI])
    t = torch.cat([s_uw.t, bio], dim=0)
    return cfg, grid, initial_state(cfg, device=device, zeta=s_uw.zeta,
                                    t=t), ffn


# Each biology model on UPWELLING (41 x 80 x 16 unless cut): its
# parameters, its initial bio values (uniform; the ones roms_tpu's
# tests/test_bio_models.py start from) and the forcing fields it reads
# beside UPWELLING's wind: the shortwave flux (W/m2, as the kinematic
# srflx), the 10 m wind, the respiration rate (mmol O2/m3/day), the cyst
# map (cysts/cm3) and the DIN climatology (mmol/m3).
SETUPS = {
    "npzd_franks": dict(params=bm.FranksParams(), ini=BIO_INI, srflx=150.0),
    "npzd_iron": dict(params=bm.IronParams(const_par=158.075),
                      ini=(17.0, 1.0, 1.0, 1.0, 0.06, 0.01)),
    "fennel": dict(params=bm.FennelParams(const_par=158.075),
                   ini=(10.0, 0.5, 0.1, 0.5, 0.3, 0.1, 0.1)),
    "fennel_oxygen_carbon": dict(
        params=bm.FennelParams(oxygen=True, carbon=True, const_par=158.075),
        ini=(10.0, 1.0, 0.5, 1.0, 0.5, 0.5, 0.5, 0.5, 0.5, 2300.0, 2300.0,
             100.0), wind=5.0),
    "hypoxia_srm": dict(params=bm.HypoxiaParams(), ini=(100.0,), wind=10.0,
                        respiration=10.0),
    "nemuro": dict(params=bm.NemuroParams(const_par=200.0),
                   ini=(0.2, 0.2, 0.05, 0.05, 0.02, 5.0, 0.5, 0.1, 0.2, 10.0,
                        0.1)),
    "red_tide": dict(params=bm.RedTideParams(), ini=(100.0,), srflx=300.0,
                     cysts=1000.0, din=5.0),
    "ecosim": dict(params=bm.EcosimParams(),
                   ini=(8.0, 0.5, 0.6, 6.0, 2100.0, 1.0, 0.12, 0.008, 0.3,
                        1.0, 0.12, 0.008, 0.15, 0.3, 0.5, 10.0, 1.0, 2.0,
                        0.5, 0.06), srflx=150.0),
}


def model_config(setup: str, Lm: int = 41, Mm: int = 80, N: int = 16,
                 dt: float = 300.0, ndtfast: int = 30,
                 dtype: str = "float64") -> Config:
    """UPWELLING's configuration with the biology model of `setup` (one of
    SETUPS) on 2 + its bio tracers (U3/C4, no tracer diffusion)."""
    st = SETUPS[setup]
    nbio = len(st["ini"])
    nt = 2 + nbio
    biology = setup.split("_oxygen")[0]
    cfg = upwelling.make_config(Lm=Lm, Mm=Mm, N=N, dt=dt, ndtfast=ndtfast,
                                dtype=dtype)
    return cfg.replace(
        name=setup, ntracers=nt, t_hadv=nt * ("U3",), t_vadv=nt * ("C4",),
        tnu2=nt * (0.0,), akt_bak=(1e-6, 1e-6), biology=biology,
        ibio=tuple(range(2, nt)), bio_params=st["params"])


def build_model(setup: str, cfg: Config | None = None,
                device: torch.device | str = torch.device("cuda")):
    """Returns (cfg, grid, state0, forcing_fn) of `setup` on UPWELLING:
    the bio tracers at the setup's uniform values and the forcing its
    model reads."""
    st = SETUPS[setup]
    cfg = cfg or model_config(setup)
    cfg_uw = cfg.replace(ntracers=2, biology=None, bio_params=None)
    cfg_uw, grid, s_uw, ffn0 = upwelling.build(cfg_uw, device=device)
    cfg = cfg.replace(hmin=cfg_uw.hmin, nfast=cfg_uw.nfast)
    bio = torch.stack([torch.full_like(s_uw.t[0], v) for v in st["ini"]])
    t = torch.cat([s_uw.t, bio], dim=0)
    s0 = initial_state(cfg, device=device, zeta=s_uw.zeta, t=t)

    def forcing_fn(cfg_, grid_, time):
        frc = dict(ffn0(cfg_, grid_, time))
        one = torch.ones_like(grid_.h)
        if "srflx" in st:
            frc["srflx"] = st["srflx"] / (rho0_default * Cp) * one
        if "wind" in st:
            frc["Uwind"] = st["wind"] * one
            frc["Vwind"] = 0.0 * one
        if "respiration" in st:
            frc["respiration"] = st["respiration"] * torch.ones(
                (cfg_.N,) + one.shape, dtype=one.dtype, device=one.device)
        if "cysts" in st:
            frc["CystIni"] = st["cysts"] * one
            frc["DIN_obs"] = st["din"] * torch.ones(
                (cfg_.N,) + one.shape, dtype=one.dtype, device=one.device)
        return frc

    return cfg, grid, s0, forcing_fn
