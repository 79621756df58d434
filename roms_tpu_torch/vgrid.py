"""Terrain-following vertical coordinate.

Counterpart of ``roms_tpu/vgrid.py``: stretching functions Vstretching 1-5
(set_scoord.F:184-532) computed once in float64 numpy, and the depth
transform Vtransform 1-2 (set_depth.F:160-250) on tensors every slow step.
"""

from __future__ import annotations

import numpy as np
import torch


def scoord(vstretching: int, theta_s: float, theta_b: float, N: int):
    """Return (sc_r, Cs_r, sc_w, Cs_w) as float64 numpy arrays.

    sc_r/Cs_r have length N (k=1..N bottom->surface), sc_w/Cs_w length N+1
    (k=0..N).  Matches set_scoord.F exactly for each Vstretching option.
    """
    sc_w = np.zeros(N + 1)
    Cs_w = np.zeros(N + 1)
    sc_r = np.zeros(N)
    Cs_r = np.zeros(N)
    ds = 1.0 / N
    k_w = np.arange(N + 1, dtype=np.float64)        # 0..N
    k_r = np.arange(1, N + 1, dtype=np.float64)     # 1..N

    if vstretching == 1:
        # Song & Haidvogel (1994)  (set_scoord.F:184-236)
        sc_w = ds * (k_w - N)
        sc_r = ds * (k_r - N - 0.5)
        if theta_s != 0.0:
            c1 = 1.0 / np.sinh(theta_s)
            c2 = 0.5 / np.tanh(0.5 * theta_s)

            def C(s):
                return (1.0 - theta_b) * c1 * np.sinh(theta_s * s) + \
                    theta_b * (c2 * np.tanh(theta_s * (s + 0.5)) - 0.5)

            Cs_w, Cs_r = C(sc_w), C(sc_r)
        else:
            Cs_w, Cs_r = sc_w.copy(), sc_r.copy()
        sc_w[0] = -1.0
        Cs_w[0] = -1.0

    elif vstretching == 2:
        # Shchepetkin cosh stretching with optional bottom blend
        # (set_scoord.F:240-312)
        Aweight, Bweight = 1.0, 1.0
        sc_w = ds * (k_w - N)
        sc_w[0] = -1.0
        sc_r = ds * (k_r - N - 0.5)

        def C(s):
            if theta_s > 0.0:
                Csur = (1.0 - np.cosh(theta_s * s)) / (np.cosh(theta_s) - 1.0)
                if theta_b > 0.0:
                    Cbot = np.sinh(theta_b * (s + 1.0)) / np.sinh(theta_b) - 1.0
                    Cw = (s + 1.0) ** Aweight * (
                        1.0 + (Aweight / Bweight) *
                        (1.0 - (s + 1.0) ** Bweight))
                    return Cw * Csur + (1.0 - Cw) * Cbot
                return Csur
            return np.asarray(s, dtype=np.float64)

        Cs_w, Cs_r = C(sc_w), C(sc_r)
        Cs_w[0], Cs_w[N] = -1.0, 0.0

    elif vstretching == 3:
        # R. Geyer bottom-boundary-layer stretching (set_scoord.F:316-376)
        exp_sur, exp_bot, Hscale = theta_s, theta_b, 3.0
        sc_w = ds * (k_w - N)
        sc_w[0] = -1.0
        sc_r = ds * (k_r - N - 0.5)

        def C(s):
            Cbot = np.log(np.cosh(Hscale * (s + 1.0) ** exp_bot)) / \
                np.log(np.cosh(Hscale)) - 1.0
            Csur = -np.log(np.cosh(Hscale * np.abs(s) ** exp_sur)) / \
                np.log(np.cosh(Hscale))
            Cw = 0.5 * (1.0 - np.tanh(Hscale * (s + 0.5)))
            return Cw * Cbot + (1.0 - Cw) * Csur

        Cs_w, Cs_r = C(sc_w), C(sc_r)
        Cs_w[0], Cs_w[N] = -1.0, 0.0

    elif vstretching == 4:
        # Shchepetkin double stretching (set_scoord.F:380-446)
        sc_w = ds * (k_w - N)
        sc_w[0] = -1.0
        sc_r = ds * (k_r - N - 0.5)

        def C(s):
            if theta_s > 0.0:
                Csur = (1.0 - np.cosh(theta_s * s)) / (np.cosh(theta_s) - 1.0)
            else:
                Csur = -s ** 2
            if theta_b > 0.0:
                return (np.exp(theta_b * Csur) - 1.0) / (1.0 - np.exp(-theta_b))
            return Csur

        Cs_w, Cs_r = C(sc_w), C(sc_r)
        Cs_w[0], Cs_w[N] = -1.0, 0.0

    elif vstretching == 5:
        # Souza et al. 2015 quadratic Legendre (set_scoord.F:450-532)
        rN = float(N)

        def s_of(rk):
            return -(rk * rk - 2.0 * rk * rN + rk + rN * rN - rN) / \
                (rN * rN - rN) - 0.01 * (rk * rk - rk * rN) / (1.0 - rN)

        sc_w = s_of(k_w)
        sc_w[0], sc_w[N] = -1.0, 0.0
        sc_r = s_of(k_r - 0.5)

        def C(s):
            if theta_s > 0.0:
                Csur = (1.0 - np.cosh(theta_s * s)) / (np.cosh(theta_s) - 1.0)
            else:
                Csur = -s ** 2
            if theta_b > 0.0:
                return (np.exp(theta_b * Csur) - 1.0) / (1.0 - np.exp(-theta_b))
            return Csur

        Cs_w, Cs_r = C(sc_w), C(sc_r)
        Cs_w[0], Cs_w[N] = -1.0, 0.0
    else:
        raise ValueError(f"unknown Vstretching={vstretching}")

    return sc_r, Cs_r, sc_w, Cs_w


def compute_hc(vtransform: int, tcline: float, hmin: float) -> float:
    """Critical depth hc (set_scoord.F:171-178)."""
    if vtransform == 1:
        return min(hmin, tcline)
    if vtransform == 2:
        return tcline
    raise ValueError(f"unknown Vtransform={vtransform}")


def set_depth(h, zeta, hc, sc_r, Cs_r, sc_w, Cs_w, vtransform: int,
              zice=None):
    """Depths z_r (N,Ny,Nx), z_w (N+1,Ny,Nx) and thicknesses Hz (N,Ny,Nx)
    from h and zeta (Ny,Nx); z is negative downward and z_w[0] = -h.
    The stretching tables are (K,) tensors of h's dtype and device.

    zice (ICESHELF): the ice-shelf draft (negative).  h is then the resting
    water-column thickness everywhere (bathymetry less |zice| under the
    shelf), the levels stretch over h and the whole column is displaced
    down by |zice| (set_depth.F:183-192,231-241 with hwater = h_bottom -
    |zice|): z_w[-1] = zeta - |zice| and z_w[0] = -(h + |zice|)."""
    if zice is not None:
        dz_ice = torch.abs(zice)
        z_r, z_w, Hz = set_depth(h, zeta, hc, sc_r, Cs_r, sc_w, Cs_w,
                                 vtransform)
        return z_r - dz_ice, z_w - dz_ice, Hz
    sc_r = sc_r[:, None, None]
    Cs_r = Cs_r[:, None, None]
    # interior w levels k=1..N; k=0 handled explicitly as -h
    sc_wk = sc_w[1:, None, None]
    Cs_wk = Cs_w[1:, None, None]

    if vtransform == 1:
        hinv = 1.0 / h
        z_w0 = hc * (sc_wk - Cs_wk) + Cs_wk * h
        z_wk = z_w0 + zeta * (1.0 + z_w0 * hinv)
        z_r0 = hc * (sc_r - Cs_r) + Cs_r * h
        z_r = z_r0 + zeta * (1.0 + z_r0 * hinv)
    elif vtransform == 2:
        hinv = 1.0 / (hc + h)
        cff_w = (hc * sc_wk + Cs_wk * h) * hinv
        z_wk = zeta + (zeta + h) * cff_w
        cff_r = (hc * sc_r + Cs_r * h) * hinv
        z_r = zeta + (zeta + h) * cff_r
    else:
        raise ValueError(f"unknown Vtransform={vtransform}")

    z_w = torch.cat([-h[None], z_wk], dim=0)
    Hz = z_w[1:] - z_w[:-1]
    return z_r, z_w, Hz
