"""Equation of state (counterpart of ``roms_tpu/ops/eos.py``).

Linear EOS (rho_eos.F:576-886 linear branch) and the Jackett & McDougall
(1995) nonlinear polynomial EOS (rho_eos.F:111-570; check values in the
reference header).  rho is the density anomaly (kg/m3 - 1000).

Fields are [k, j, i] with k=0 the bottom level (ROMS k=1).
"""

from __future__ import annotations

import torch

from .. import constants as C
from ..config import Config

# Jackett & McDougall 1995 polynomial coefficients (mod_eoscoef.F)
_A00, _A01, _A02, _A03, _A04 = +1.909256e+04, +2.098925e+02, -3.041638e+00, -1.852732e-03, -1.361629e-05
_B00, _B01, _B02, _B03 = +1.044077e+02, -6.500517e+00, +1.553190e-01, +2.326469e-04
_D00, _D01, _D02 = -5.587545e+00, +7.390729e-01, -1.909078e-02
_E00, _E01, _E02, _E03 = +4.721788e-01, +1.028859e-02, -2.512549e-04, -5.939910e-07
_F00, _F01, _F02 = -1.571896e-02, -2.598241e-04, +7.267926e-06
_G00 = +2.042967e-03
_G01, _G02, _G03 = +1.045941e-05, -5.782165e-10, +1.296821e-07
_H00, _H01, _H02 = -2.595994e-07, -1.248266e-09, -3.508914e-09
_Q00, _Q01, _Q02, _Q03, _Q04 = +9.99842594e+02, +6.793952e-02, -9.095290e-03, +1.001685e-04, -1.120083e-06
_Q05 = +6.536332e-09
_U00, _U01, _U02, _U03, _U04 = +8.24493e-01, -4.08990e-03, +7.64380e-05, -8.24670e-07, +5.38750e-09
_V00, _V01, _V02 = -5.72466e-03, +1.02270e-04, -1.65460e-06
_W00 = +4.8314e-04


def rho_linear(cfg: Config, temp, salt):
    """Linear EOS (rho_eos.F linear kernel):
    rho = R0 - R0*Tcoef*(T-T0) + R0*Scoef*(S-S0) - 1000."""
    rho = cfg.R0 - cfg.R0 * cfg.Tcoef * (temp - cfg.T0)
    if cfg.ntracers >= 2 and cfg.Scoef != 0.0 and salt is not None:
        rho = rho + cfg.R0 * cfg.Scoef * (salt - cfg.S0)
    return rho - 1000.0


def _jm95_parts(temp, salt):
    """den1 (surface density) and bulk-modulus polynomials K0, K1, K2
    (rho_eos.F:247-322)."""
    Tt = temp
    Ts = torch.clamp(salt, min=0.0)
    sqrtTs = torch.sqrt(Ts)

    C0 = _Q00 + Tt * (_Q01 + Tt * (_Q02 + Tt * (_Q03 + Tt * (_Q04 + Tt * _Q05))))
    C1 = _U00 + Tt * (_U01 + Tt * (_U02 + Tt * (_U03 + Tt * _U04)))
    C2 = _V00 + Tt * (_V01 + Tt * _V02)
    den1 = C0 + Ts * (C1 + sqrtTs * C2 + Ts * _W00)

    K0 = _A00 + Tt * (_A01 + Tt * (_A02 + Tt * (_A03 + Tt * _A04))) + \
        Ts * (_B00 + Tt * (_B01 + Tt * (_B02 + Tt * _B03)) +
              sqrtTs * (_D00 + Tt * (_D01 + Tt * _D02)))
    K1 = _E00 + Tt * (_E01 + Tt * (_E02 + Tt * _E03)) + \
        Ts * (_F00 + Tt * (_F01 + Tt * _F02) + sqrtTs * _G00)
    K2 = _G01 + Tt * (_G02 + Tt * _G03) + \
        Ts * (_H00 + Tt * (_H01 + Tt * _H02))
    return den1, K0, K1, K2


def rho_jm95(temp, salt, z_r):
    """Nonlinear Jackett & McDougall 1995 in-situ density anomaly.

    rho_eos.F:111-570: den1 (density at the surface) plus bulk-modulus
    pressure correction using depth z_r (m, negative) as pressure proxy.
    Check value: T=3, S=35.5, z=-5000 -> den = 1050.3639165364 - 1000.
    """
    den1, K0, K1, K2 = _jm95_parts(temp, salt)
    bulk = K0 - z_r * (K1 - z_r * K2)
    den = (den1 * bulk) / (bulk + 0.1 * z_r)
    return den - 1000.0


def brunt_vaisala(cfg: Config, t, z_r, z_w):
    """bvf at interior w-interfaces, (N+1,Ny,Nx) with bvf[0]=bvf[N]=0.

    Linear EOS: bvf = -(g/rho0) d(rho)/dz (rho_eos.F:758-762).
    JM95: adiabatic (neutral) form comparing densities displaced to the
    common interface pressure z_w(k) (rho_eos.F:390-416).
    """
    temp = t[0]
    salt = t[1] if cfg.ntracers >= 2 else torch.zeros_like(temp)
    zero = torch.zeros_like(z_w[:1])
    dz = z_r[1:] - z_r[:-1]
    if cfg.eos == "linear":
        rho = rho_linear(cfg, temp, salt)
        bvf = -(C.g / cfg.rho0) * (rho[1:] - rho[:-1]) / dz
    else:
        den1, K0, K1, K2 = _jm95_parts(temp, salt)
        zwk = z_w[1:-1]
        bulk_up = K0[1:] - zwk * (K1[1:] - K2[1:] * zwk)
        bulk_dn = K0[:-1] - zwk * (K1[:-1] - K2[:-1] * zwk)
        den_up = den1[1:] * bulk_up / (bulk_up + 0.1 * zwk)
        den_dn = den1[:-1] * bulk_dn / (bulk_dn + 0.1 * zwk)
        bvf = -C.g * (den_up - den_dn) / (0.5 * (den_up + den_dn) * dz)
    return torch.cat([zero, bvf, zero], dim=0)


def rho_eos(cfg: Config, t, z_r):
    """Density anomaly from the tracer stack t[itrc, k, j, i] at one time
    level.  itrc 0 = temp, 1 = salt."""
    rho, _ = rho_eos_pden(cfg, t, z_r)
    return rho


def rho_eos_pden_bvf(cfg: Config, t, z_r, z_w):
    """(rho, pden, bvf) with the JM95 polynomials evaluated ONCE
    (rho_eos.F computes den/den1 and bvf in the same sweep; the
    separate rho_eos_pden + brunt_vaisala calls each re-evaluate the
    den1/K polynomials).  The plain version of the eos kernel
    (ops/diag_cuda.py) when bvf is wanted."""
    temp = t[0]
    salt = t[1] if cfg.ntracers >= 2 else torch.zeros_like(temp)
    zero = torch.zeros_like(z_w[:1])
    dz = z_r[1:] - z_r[:-1]
    if cfg.eos == "linear":
        rho = rho_linear(cfg, temp, salt)
        bvf = -(C.g / cfg.rho0) * (rho[1:] - rho[:-1]) / dz
        return rho, rho, torch.cat([zero, bvf, zero], dim=0)
    den1, K0, K1, K2 = _jm95_parts(temp, salt)
    bulk = K0 - z_r * (K1 - z_r * K2)
    den = (den1 * bulk) / (bulk + 0.1 * z_r)
    zwk = z_w[1:-1]
    bulk_up = K0[1:] - zwk * (K1[1:] - K2[1:] * zwk)
    bulk_dn = K0[:-1] - zwk * (K1[:-1] - K2[:-1] * zwk)
    den_up = den1[1:] * bulk_up / (bulk_up + 0.1 * zwk)
    den_dn = den1[:-1] * bulk_dn / (bulk_dn + 0.1 * zwk)
    bvf = -C.g * (den_up - den_dn) / (0.5 * (den_up + den_dn) * dz)
    return (den - 1000.0, den1 - 1000.0,
            torch.cat([zero, bvf, zero], dim=0))


def rho_eos_pden(cfg: Config, t, z_r):
    """(in-situ density anomaly, potential density anomaly) - the
    reference returns both (rho, pden); for the linear EOS they coincide
    (rho_eos.F linear branch sets pden=rho)."""
    temp = t[0]
    salt = t[1] if cfg.ntracers >= 2 else None
    if cfg.eos == "linear":
        rho = rho_linear(cfg, temp, salt)
        return rho, rho
    if cfg.eos == "jm95":
        if salt is None:
            salt = torch.zeros_like(temp)
        rho = rho_jm95(temp, salt, z_r)
        den1, _, _, _ = _jm95_parts(temp, salt)
        return rho, den1 - 1000.0
    raise ValueError(f"unknown eos {cfg.eos}")
