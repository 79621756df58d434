"""Point sources (river runoff); counterpart of ``roms_tpu/ops/sources.py``
(mod_sources.F and the LuvSrc sites in step2d, step3d_uv, and the tracer
advective-flux overrides of pre_step3d/step3d_t).

Sources are static index lists with transports handed over through the
forcing dict, ``frc["sources"] = PointSources(...)``:

    isrc, jsrc   padded array indices of the source FACE, (nsrc,) int64
    dsrc         0: u-face, 1: v-face (mod_sources Dsrc), (nsrc,)
    Qbar         barotropic transport m3/s, (nsrc,)
    Qshape       vertical distribution summing to 1, (N, nsrc)
    Tsrc         tracer values, (NT, N, nsrc), or None

The index tensors live on the state's device.  Every function returns new
tensors; its inputs are left unchanged.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from .stencil import im1, jm1


class PointSources(NamedTuple):
    isrc: torch.Tensor        # (nsrc,) padded i index of the face
    jsrc: torch.Tensor
    dsrc: torch.Tensor        # (nsrc,) 0 = u-face, 1 = v-face
    Qbar: torch.Tensor        # (nsrc,) m3/s
    Qshape: torch.Tensor      # (N, nsrc)
    Tsrc: Optional[torch.Tensor] = None   # (NT, N, nsrc)

    @property
    def Qsrc(self):
        return self.Qshape * self.Qbar[None]


def _set_faces(f, src: PointSources, vals, on_face):
    """A copy of f with f[..., jsrc, isrc] = vals where on_face."""
    out = f.clone()
    old = f[..., src.jsrc, src.isrc]
    out[..., src.jsrc, src.isrc] = torch.where(on_face, vals, old)
    return out


def apply_ubar_sources(src: PointSources, ubar, vbar, zeta, h, on_u, om_v):
    """step2d LuvSrc (step2d_LF_AM3.h:2478-2504): the barotropic velocity
    at source faces set to Qbar / (face width * depth)."""
    D = zeta + h
    Du = 0.5 * (D + im1(D)) * on_u
    Dv = 0.5 * (D + jm1(D)) * om_v
    u_val = src.Qbar / Du[src.jsrc, src.isrc]
    v_val = src.Qbar / Dv[src.jsrc, src.isrc]
    is_u = src.dsrc == 0
    return (_set_faces(ubar, src, u_val, is_u),
            _set_faces(vbar, src, v_val, ~is_u))


def apply_uv_sources(src: PointSources, u, v, z_w, on_u, om_v):
    """step3d_uv LuvSrc (step3d_uv.F:1390-1419): the vertical transport
    profile imposed at source faces."""
    dz = z_w[1:] - z_w[:-1]                    # (N,Ny,Nx)
    dzu = 0.5 * (dz + im1(dz))
    dzv = 0.5 * (dz + jm1(dz))
    qs = src.Qsrc                              # (N,nsrc)
    u_val = qs / (on_u[src.jsrc, src.isrc][None] *
                  dzu[:, src.jsrc, src.isrc])
    v_val = qs / (om_v[src.jsrc, src.isrc][None] *
                  dzv[:, src.jsrc, src.isrc])
    is_u = src.dsrc == 0
    return (_set_faces(u, src, u_val, is_u[None]),
            _set_faces(v, src, v_val, ~is_u[None]))


def apply_tracer_flux_sources(src: PointSources, itrc: int, FX, FE,
                              Huon, Hvom):
    """Tracer advective flux at source faces (pre_step3d.F / step3d_t.F
    LuvSrc): FX(Isrc) = Huon(Isrc) * Tsrc."""
    if src.Tsrc is None:
        return FX, FE
    tv = src.Tsrc[itrc]                        # (N,nsrc)
    fx_val = Huon[:, src.jsrc, src.isrc] * tv
    fe_val = Hvom[:, src.jsrc, src.isrc] * tv
    is_u = src.dsrc == 0
    return (_set_faces(FX, src, fx_val, is_u[None]),
            _set_faces(FE, src, fe_val, ~is_u[None]))
