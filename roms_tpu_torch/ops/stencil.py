"""Shift/average/difference helpers for the staggered Arakawa C-grid.

Counterpart of ``roms_tpu/ops/stencil.py``.  Fields live on halo-padded
tensors indexed ``[..., eta(j), xi(i)]``; array index a = roms_i + halo - 1.
Shifts are ``torch.roll``, which wraps at the edge of the padded array
exactly as ``jnp.roll`` does: wrapped values land only in the halo ring,
which a halo fill or boundary write refreshes before it is read.
"""

from __future__ import annotations

import torch


def take_k(arr, ks):
    """``arr[ks[y,x], ..., y, x]``: gather along the leading (k) axis;
    ``ks`` is clipped to the valid range."""
    idx = ks.long().clamp(0, arr.shape[0] - 1)
    idx = idx.reshape((1,) * (arr.ndim - idx.ndim) + idx.shape)
    return torch.gather(arr, 0, idx.expand((1,) + arr.shape[1:]))[0]


def shift(a, di: int = 0, dj: int = 0):
    """result[..., j, i] = a[..., j+dj, i+di] (wraps in the halo ring)."""
    if di == 0 and dj == 0:
        return a
    if di == 0:
        return torch.roll(a, -dj, -2)
    if dj == 0:
        return torch.roll(a, -di, -1)
    return torch.roll(a, (-dj, -di), (-2, -1))


def maximum(a, b: float):
    """jnp.maximum(a, b) for a number b: torch.clamp(a, min=b)'s values,
    and JAX's derivative, which is half where a == b (torch.clamp's is
    whole there), so that the tangent-linear and adjoint steps match
    roms_tpu's where a flux or velocity is exactly b.  b is a 0-d CPU
    tensor, which a CUDA operation takes without a launch of its own."""
    return torch.maximum(a, torch.tensor(b, dtype=a.dtype))


def minimum(a, b: float):
    """jnp.minimum(a, b) for a number b (see maximum)."""
    return torch.minimum(a, torch.tensor(b, dtype=a.dtype))


# --- neighbor accessors (named after the offset) -------------------------
def ip1(a):
    return shift(a, di=1)


def im1(a):
    return shift(a, di=-1)


def jp1(a):
    return shift(a, dj=1)


def jm1(a):
    return shift(a, dj=-1)


# --- staggered averages ---------------------------------------------------
def at_u(r):
    """rho -> u:  0.5*(r[i-1,j] + r[i,j])."""
    return 0.5 * (im1(r) + r)


def at_v(r):
    """rho -> v:  0.5*(r[i,j-1] + r[i,j])."""
    return 0.5 * (jm1(r) + r)


def at_p(r):
    """rho -> psi: 0.25*(r[i-1,j-1]+r[i,j-1]+r[i-1,j]+r[i,j])."""
    return 0.25 * (r + im1(r) + jm1(r) + shift(r, di=-1, dj=-1))


def u_to_r(u):
    """u -> rho: 0.5*(u[i,j] + u[i+1,j])."""
    return 0.5 * (u + ip1(u))


def v_to_r(v):
    """v -> rho: 0.5*(v[i,j] + v[i,j+1])."""
    return 0.5 * (v + jp1(v))


# --- differences ----------------------------------------------------------
def dxi_r(u_like):
    """xi-difference landing on rho points: d[i] = a[i+1] - a[i]."""
    return ip1(u_like) - u_like


def deta_r(v_like):
    """eta-difference landing on rho points: d[j] = a[j+1] - a[j]."""
    return jp1(v_like) - v_like


def dxi_u(r_like):
    """xi-difference landing on u points: d[i] = a[i] - a[i-1]."""
    return r_like - im1(r_like)


def deta_v(r_like):
    """eta-difference landing on v points: d[j] = a[j] - a[j-1]."""
    return r_like - jm1(r_like)
