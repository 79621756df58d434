"""Tidal forcing (counterpart of ``roms_tpu/ops/tides.py``; mod_tides.F,
set_tides.F and equilibrium_tide.F).

``tidal_boundary`` evaluates per-constituent amplitude/phase tables at
model time into open-boundary values for the `bry` dict of ops/obc.py:
    zeta_bry = sum_k amp_k * cos(omega_k * t - phase_k),
and the same sum of (major-axis) current amplitudes.
``harmonic_constituents`` and ``equilibrium_tide`` give the
tide-generating force (TIDE_GENERATING_FORCES): the equilibrium elevation
that enters the pressure gradient through prsgrd's ``eq_tide``.  The
astronomical arguments are host arithmetic on a date number in Python
floats (float64), as in the reference.
"""

from __future__ import annotations

import math
from typing import Dict, NamedTuple, Optional

import torch

# standard constituent periods (hours), mod_tides convention
PERIODS_H = {
    "M2": 12.4206012, "S2": 12.0, "N2": 12.65834751, "K2": 11.96723606,
    "K1": 23.93447213, "O1": 25.81933871, "P1": 24.06588766,
    "Q1": 26.868350, "MF": 327.8599387, "MM": 661.3111655,
}


class TidalConstituent(NamedTuple):
    name: str
    zeta_amp: torch.Tensor     # (nbpts,) SSH amplitude along the boundary
    zeta_phase: torch.Tensor   # radians
    u_amp: Optional[torch.Tensor] = None   # barotropic current amplitude
    u_phase: Optional[torch.Tensor] = None


def tidal_boundary(constituents, time: float, side: str = "west") -> Dict:
    """The constituent sum at model time (s): {zeta_<side>} and, when
    current amplitudes are given, ubar_<side> (west/east) or vbar_<side>
    (south/north)."""
    z = u = None
    for c in constituents:
        omega = 2.0 * math.pi / (PERIODS_H[c.name] * 3600.0)
        zc = c.zeta_amp * torch.cos(omega * time - c.zeta_phase)
        z = zc if z is None else z + zc
        if c.u_amp is not None:
            uc = c.u_amp * torch.cos(omega * time - c.u_phase)
            u = uc if u is None else u + uc
    out = {f"zeta_{side}": z}
    if u is not None:
        key = "ubar" if side in ("west", "east") else "vbar"
        out[f"{key}_{side}"] = u
    return out


# equilibrium_tide.F harmonic_constituents tables: name -> (omega [rad/s],
# amplitude [m], Love-number reduction, species: 1 diurnal (sin 2 lat),
# 2 semidiurnal (cos^2 lat))
_EQ_CONSTITUENTS = {
    "Q1": (0.6495854e-4, 1.9273e-2, 0.695, 1),
    "O1": (0.6759774e-4, 10.0661e-2, 0.695, 1),
    "K1": (0.7292117e-4, 14.1565e-2, 0.736, 1),
    "N2": (1.378797e-4, 4.6397e-2, 0.693, 2),
    "M2": (1.405189e-4, 24.2334e-2, 0.693, 2),
    "S2": (1.454441e-4, 11.2743e-2, 0.693, 2),
    "K2": (1.458423e-4, 3.0684e-2, 0.693, 2),
}


def harmonic_constituents(tide_datenum: float, lnodal: bool = True):
    """Astronomical phases chi and nodal corrections (f, nu) at the tidal
    reference date (equilibrium_tide.F harmonic_constituents).

    tide_datenum: fractional day number of the tide reference time
    (utils.dateclock.datenum convention).  Returns {name: (amplitude * f *
    love, chi + nu in degrees, omega, species)}, used as
    cos(omega * t + deg2rad * (species * lon + chi + nu))."""
    astro = 2451545.0           # datenum(2000, 1, 1, 12) (J2000)
    T = (tide_datenum - astro) / 36524.25
    s = 218.316 + 481267.8812 * T
    h = 280.466 + 36000.7698 * T
    p = 83.353 + 4069.0137 * T
    N = math.radians(-234.955 - 1934.1363 * T)
    if lnodal:
        f = {"O1": 1.009 + 0.187 * math.cos(N) - 0.015 * math.cos(2 * N),
             "K1": 1.006 + 0.115 * math.cos(N) - 0.009 * math.cos(2 * N),
             "M2": 1.0 - 0.037 * math.cos(N),
             "S2": 1.0,
             "K2": 1.024 + 0.286 * math.cos(N) + 0.008 * math.cos(2 * N)}
        nu = {"O1": 10.8 * math.sin(N) - 1.3 * math.sin(2 * N),
              "K1": -8.9 * math.sin(N) + 0.7 * math.sin(2 * N),
              "M2": -2.1 * math.sin(N),
              "S2": 0.0,
              "K2": -17.7 * math.sin(N) + 0.7 * math.sin(2 * N)}
    else:
        f = {k: 1.0 for k in ("O1", "K1", "M2", "S2", "K2")}
        nu = {k: 0.0 for k in ("O1", "K1", "M2", "S2", "K2")}
    f["Q1"], nu["Q1"] = f["O1"], nu["O1"]
    f["N2"], nu["N2"] = f["M2"], nu["M2"]
    chi = {"Q1": h - 3.0 * s + p - 90.0,
           "O1": h - 2.0 * s - 90.0,
           "K1": h + 90.0,
           "N2": 2.0 * h - 3.0 * s + p,
           "M2": 2.0 * h - 2.0 * s,
           "S2": 0.0,
           "K2": 2.0 * h}
    return {name: (amp * f[name] * love, chi[name] + nu[name], omega,
                   species)
            for name, (omega, amp, love, species) in _EQ_CONSTITUENTS.items()}


def equilibrium_tide(grid, time: float, constituents):
    """Equilibrium tidal elevation (m) at rho points (equilibrium_tide.F:
    100-160): diurnal species ride sin(2 lat), semidiurnal cos^2(lat),
    longitudes enter as species * lon.  grid.xr/yr are lon/lat in degrees;
    `constituents` is harmonic_constituents' dict; time in seconds since
    the tide reference date."""
    deg2rad = math.pi / 180.0
    lat = grid.yr * deg2rad
    sinlat2 = torch.sin(2.0 * lat)
    cos2lat = torch.cos(lat) ** 2
    eq = torch.zeros_like(grid.xr)
    for name, (afl, chinu, omega, species) in constituents.items():
        latfac = sinlat2 if species == 1 else cos2lat
        eq = eq + afl * latfac * torch.cos(
            omega * time + deg2rad * (species * grid.xr + chinu))
    return eq
