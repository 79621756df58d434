"""Model state: a dataclass of tensors with explicitly named time levels.

Counterpart of ``roms_tpu/state.py``, field for field, so that a JAX state
converts one to one (``convert.py``).  ``time`` and ``iic`` are host
numbers: the step counter selects the AB3 start-up weights on the host.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch

from .config import Config
from .grid import torch_dtype
from .ops.sediment import initial_bed


@dataclass
class State:
    time: float          # seconds since initialization
    iic: int             # slow step counter (0-based)

    # prognostic fields at time n
    zeta: torch.Tensor   # (Ny,Nx) free surface (= Zt_avg1 of previous step)
    ubar: torch.Tensor   # (Ny,Nx)
    vbar: torch.Tensor
    u: torch.Tensor      # (N,Ny,Nx)
    v: torch.Tensor
    t: torch.Tensor      # (NT,N,Ny,Nx)
    t_prev: torch.Tensor  # tracers at n-1 (LF-AM3 predictor history)

    # slow RHS history (pre_step3d.F AB3 ladder)
    ru_prev: torch.Tensor
    ru_prev2: torch.Tensor
    rv_prev: torch.Tensor
    rv_prev2: torch.Tensor

    # depth-integrated slow-forcing history
    rufrc0_prev: torch.Tensor
    rufrc0_prev2: torch.Tensor
    rvfrc0_prev: torch.Tensor
    rvfrc0_prev2: torch.Tensor

    # fast-loop RHS history carried across slow steps
    rzeta: torch.Tensor
    rubar: torch.Tensor
    rvbar: torch.Tensor

    # vertical mixing coefficients
    Akv: torch.Tensor    # (N+1,Ny,Nx)
    Akt: torch.Tensor    # (NAT,N+1,Ny,Nx)
    hsbl: torch.Tensor
    hbbl: torch.Tensor

    # GLS closure state
    tke: torch.Tensor
    gls: torch.Tensor
    tke_prev: torch.Tensor
    gls_prev: torch.Tensor
    Akk: torch.Tensor
    Akp: torch.Tensor
    Lscale: torch.Tensor

    # fast-time-averaged fields of the last completed step
    DU_avg1: torch.Tensor
    DV_avg1: torch.Tensor
    DU_avg2: torch.Tensor
    DV_avg2: torch.Tensor

    # sediment bed layers; shape (0,0,Ny,Nx) when sediment is off
    bed_mass: torch.Tensor

    # wave-current BBL memory
    rheight: torch.Tensor
    rlength: torch.Tensor
    tau_cwmax: torch.Tensor

    def replace(self, **kw) -> "State":
        return dataclasses.replace(self, **kw)


TENSOR_FIELDS = tuple(f.name for f in dataclasses.fields(State)
                      if f.name not in ("time", "iic"))


def initial_state(cfg: Config,
                  device: torch.device | str = torch.device("cuda"),
                  zeta=None, ubar=None, vbar=None, u=None, v=None,
                  t=None) -> State:
    """Cold-start state (ini_fields semantics: histories zeroed, mixing
    coefficients at background values, a uniform sediment bed where the
    configuration has sediment)."""
    dtype = torch_dtype(cfg)
    shp2 = (cfg.ny_tot, cfg.nx_tot)
    shp3 = (cfg.N,) + shp2
    shpw = (cfg.N + 1,) + shp2
    nat = min(cfg.ntracers, 2) if cfg.ntracers else 1
    kw = dict(dtype=dtype, device=device)
    z2 = lambda: torch.zeros(shp2, **kw)
    z3 = lambda: torch.zeros(shp3, **kw)
    given = lambda a, zero: zero() if a is None else \
        torch.as_tensor(a).to(**kw).clone()

    zeta = given(zeta, z2)
    ubar = given(ubar, z2)
    vbar = given(vbar, z2)
    u = given(u, z3)
    v = given(v, z3)
    t = given(t, lambda: torch.zeros((cfg.ntracers,) + shp3, **kw))
    gp = cfg.gls_params
    return State(
        time=0.0, iic=0,
        zeta=zeta, ubar=ubar, vbar=vbar, u=u, v=v, t=t, t_prev=t.clone(),
        ru_prev=z3(), ru_prev2=z3(), rv_prev=z3(), rv_prev2=z3(),
        rufrc0_prev=z2(), rufrc0_prev2=z2(), rvfrc0_prev=z2(),
        rvfrc0_prev2=z2(),
        rzeta=z2(), rubar=z2(), rvbar=z2(),
        Akv=torch.full(shpw, cfg.akv_bak, **kw),
        Akt=torch.stack([torch.full(shpw, cfg.akt_bak[i], **kw)
                         for i in range(nat)], dim=0),
        hsbl=z2(), hbbl=z2(),
        tke=torch.full(shpw, gp.Kmin, **kw),
        gls=torch.full(shpw, gp.Pmin, **kw),
        tke_prev=torch.full(shpw, gp.Kmin, **kw),
        gls_prev=torch.full(shpw, gp.Pmin, **kw),
        Akk=torch.full(shpw, gp.akk_bak, **kw),
        Akp=torch.full(shpw, gp.akp_bak, **kw),
        Lscale=torch.zeros(shpw, **kw),
        DU_avg1=z2(), DV_avg1=z2(), DU_avg2=z2(), DV_avg2=z2(),
        bed_mass=_initial_bed_mass(cfg, device),
        rheight=z2(), rlength=torch.full(shp2, _initial_rlength(cfg), **kw),
        tau_cwmax=z2())


def _initial_rlength(cfg: Config) -> float:
    """The relict ripple wavelength floor 535 d50 (ssw_bbl.h's sheet-flow
    value), so that the ripple roughness ar rh^2 / rl is defined from the
    first step."""
    if cfg.bbl_params is not None:
        return 535.0 * cfg.bbl_params.d50
    return 535.0 * 0.00015


def _initial_bed_mass(cfg: Config, device):
    """The initial bed (Nbed, NST, Ny, Nx) kg/m2 of ops/sediment.initial_bed,
    or a (0, 0, Ny, Nx) tensor without sediment."""
    if not cfg.sediment or cfg.sed_params is None:
        return torch.zeros((0, 0, cfg.ny_tot, cfg.nx_tot),
                           dtype=torch_dtype(cfg), device=device)
    return initial_bed(cfg, cfg.sed_params, device)
