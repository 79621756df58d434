"""Slow momentum RHS assembly (counterpart of ``roms_tpu/ops/rhs3d.py``;
rhs3d.F).

Adds to the pressure-gradient ru/rv: Coriolis, curvilinear metric terms,
3rd-order upstream-biased horizontal advection (Gadv=-0.25) and 4th-order
centered vertical advection; then integrates vertically into the barotropic
forcing rufrc/rvfrc and adds the surface - bottom stress difference.
With `clm` (uclm/vclm and m3nudg) it nudges toward the 3-D momentum
climatology after the advection (rhs3d.F:211-241).
"""

from __future__ import annotations

import torch

from ..config import Config
from ..grid import Grid
from . import bc
from .stencil import ip1, im1, jp1, jm1

GADV = -0.25
ALL_PIECES = ("cor", "curv", "hadv", "vadv", "clm", "bodyforce", "frc")


def rhs3d_momentum(cfg: Config, grid: Grid, u, v, Huon, Hvom, W, Hz,
                   ru, rv, sustr, svstr, bustr, bvstr,
                   clm=None, want_diags: bool = False, parts: str = "uv",
                   pieces=ALL_PIECES):
    """Returns (ru, rv, rufrc, rvfrc), plus a dict of per-term
    contributions (cor/xadv/yadv/vadv, each a (u, v) pair) when
    want_diags.  parts "u"/"v" computes one direction and returns (r,
    rfrc), or r alone without the "frc" piece; pieces restricts which
    physics blocks run, in the same accumulation order."""
    if want_diags and (parts != "uv" or set(pieces) != set(ALL_PIECES)):
        # the reference reaches a NameError on this combination
        raise ValueError("want_diags needs parts='uv' and every piece")
    if cfg.bodyforce:
        raise NotImplementedError("BODYFORCE stresses")
    H = cfg.halo
    L, M = cfg.Lm, cfg.Mm
    dia = {} if want_diags else None
    do_u = "u" in parts
    do_v = "v" in parts
    pieces = set(pieces)

    # ---- Coriolis (rhs3d.F:181-207) ----
    cor_u = cor_v = 0.0
    if cfg.uv_cor and "cor" in pieces:
        cor = 0.5 * Hz * grid.fomn
        if do_u:
            UFx = cor * (v + jp1(v))
            cor_u = 0.5 * (UFx + im1(UFx))
            ru = ru + cor_u
        if do_v:
            VFe = cor * (u + ip1(u))
            cor_v = -0.5 * (VFe + jm1(VFe))
            rv = rv + cor_v

    # ---- curvilinear metric advection terms (rhs3d.F CURVGRID) ----
    if cfg.curvgrid and cfg.uv_adv and "curv" in pieces:
        cff = 0.5 * (v + jp1(v)) * grid.dndx - \
            0.5 * (u + ip1(u)) * grid.dmde
        if do_u:
            cff_v = Hz * cff * 0.5 * (v + jp1(v))
            curv_u = 0.5 * (cff_v + im1(cff_v))
            ru = ru + curv_u
            cor_u = cor_u + curv_u
        if do_v:
            cff_u = Hz * cff * 0.5 * (u + ip1(u))
            curv_v = -0.5 * (cff_u + jm1(cff_u))
            rv = rv + curv_v
            cor_v = cor_v + curv_v
    if want_diags:
        dia["cor"] = (cor_u + torch.zeros_like(ru),
                      cor_v + torch.zeros_like(rv))

    zero3 = torch.zeros_like(ru if do_u else rv)
    xadv_u = yadv_u = vadv_u = xadv_v = yadv_v = vadv_v = zero3
    if cfg.uv_adv:
        c1, c2 = 9.0 / 16.0, 1.0 / 16.0
        N = (u if do_u else v).shape[0]
        if do_u and "hadv" in pieces:
            # ---- U3 horizontal advection (rhs3d.F:244-430) ----
            uxx = im1(u) - 2.0 * u + ip1(u)
            Huxx = im1(Huon) - 2.0 * Huon + ip1(Huon)
            uxx = bc.extrap_west(cfg, uxx, H)
            Huxx = bc.extrap_west(cfg, Huxx, H)
            uxx = bc.extrap_east(cfg, uxx, H + L)
            Huxx = bc.extrap_east(cfg, Huxx, H + L)
            cff1 = u + ip1(u)
            cup = torch.where(cff1 > 0.0, uxx, ip1(uxx))
            UFx = 0.25 * (cff1 + GADV * cup) * (
                Huon + ip1(Huon) + GADV * 0.5 * (Huxx + ip1(Huxx)))

            uee = jm1(u) - 2.0 * u + jp1(u)
            uee = bc.extrap_south(cfg, uee, H - 1)
            uee = bc.extrap_north(cfg, uee, H + M)
            Hvxx = im1(Hvom) - 2.0 * Hvom + ip1(Hvom)
            cff1 = u + jm1(u)
            cff2 = Hvom + im1(Hvom)
            cup = torch.where(cff2 > 0.0, jm1(uee), uee)
            UFe = 0.25 * (cff1 + GADV * cup) * (
                cff2 + GADV * 0.5 * (Hvxx + im1(Hvxx)))

            xadv_u = -(UFx - im1(UFx))
            yadv_u = -(jp1(UFe) - UFe)
            ru = ru + xadv_u + yadv_u

        if do_u and "vadv" in pieces:
            # ---- 4th-order vertical advection (rhs3d.F:433-520) ----
            Wu = c1 * (W + im1(W)) - c2 * (ip1(W) + torch.roll(W, 2, -1))
            flux_int = (c1 * (u[1:-2] + u[2:-1]) -
                        c2 * (u[:-3] + u[3:])) * Wu[2:-2]
            f1 = ((c1 * (u[0] + u[1]) - c2 * (u[0] + u[2])) * Wu[1])[None]
            fNm1 = ((c1 * (u[N - 2] + u[N - 1]) -
                     c2 * (u[N - 3] + u[N - 1])) * Wu[N - 1])[None]
            zero = torch.zeros_like(f1)
            FCu = torch.cat([zero, f1, flux_int, fNm1, zero], dim=0)
            vadv_u = -(FCu[1:] - FCu[:-1])
            ru = ru + vadv_u
        if do_v and "hadv" in pieces:
            vxx = im1(v) - 2.0 * v + ip1(v)
            vxx = bc.extrap_west(cfg, vxx, H - 1)
            vxx = bc.extrap_east(cfg, vxx, H + L)
            Huee = jm1(Huon) - 2.0 * Huon + jp1(Huon)
            cff1 = v + im1(v)
            cff2 = Huon + jm1(Huon)
            cup = torch.where(cff2 > 0.0, im1(vxx), vxx)
            VFx = 0.25 * (cff1 + GADV * cup) * (
                cff2 + GADV * 0.5 * (Huee + jm1(Huee)))

            vee = jm1(v) - 2.0 * v + jp1(v)
            Hvee = jm1(Hvom) - 2.0 * Hvom + jp1(Hvom)
            vee = bc.extrap_south(cfg, vee, H)
            Hvee = bc.extrap_south(cfg, Hvee, H)
            vee = bc.extrap_north(cfg, vee, H + M)
            Hvee = bc.extrap_north(cfg, Hvee, H + M)
            cff1 = v + jp1(v)
            cup = torch.where(cff1 > 0.0, vee, jp1(vee))
            VFe = 0.25 * (cff1 + GADV * cup) * (
                Hvom + jp1(Hvom) + GADV * 0.5 * (Hvee + jp1(Hvee)))

            xadv_v = -(ip1(VFx) - VFx)
            yadv_v = -(VFe - jm1(VFe))
            rv = rv + xadv_v + yadv_v

        if do_v and "vadv" in pieces:
            Wv = c1 * (W + jm1(W)) - c2 * (jp1(W) + torch.roll(W, 2, -2))
            flux_int = (c1 * (v[1:-2] + v[2:-1]) -
                        c2 * (v[:-3] + v[3:])) * Wv[2:-2]
            f1 = ((c1 * (v[0] + v[1]) - c2 * (v[0] + v[2])) * Wv[1])[None]
            fNm1 = ((c1 * (v[N - 2] + v[N - 1]) -
                     c2 * (v[N - 3] + v[N - 1])) * Wv[N - 1])[None]
            zero = torch.zeros_like(f1)
            FCv = torch.cat([zero, f1, flux_int, fNm1, zero], dim=0)
            vadv_v = -(FCv[1:] - FCv[:-1])
            rv = rv + vadv_v
    if want_diags:
        dia["xadv"] = (xadv_u, xadv_v)
        dia["yadv"] = (yadv_u, yadv_v)
        dia["vadv"] = (vadv_u, vadv_v)

    # ---- nudging toward the 3-D momentum climatology (rhs3d.F:211-241) ----
    if clm is not None and "uclm" in clm and "clm" in pieces:
        nudg = clm.get("m3nudg", 0.0)
        if do_u:
            ru = ru + nudg * (grid.om_u * grid.on_u) * 0.5 * \
                (Hz + im1(Hz)) * (clm["uclm"] - u)
        if do_v:
            rv = rv + nudg * (grid.om_v * grid.on_v) * 0.5 * \
                (Hz + jm1(Hz)) * (clm["vclm"] - v)

    # ---- vertical integral -> barotropic forcing (rhs3d.F:523-559) ----
    if "frc" in pieces:
        if do_u:
            rufrc = torch.sum(ru, dim=0) + \
                (sustr - bustr) * grid.om_u * grid.on_u
        if do_v:
            rvfrc = torch.sum(rv, dim=0) + \
                (svstr - bvstr) * grid.om_v * grid.on_v
    if parts == "u":
        return (ru, rufrc) if "frc" in pieces else ru
    if parts == "v":
        return (rv, rvfrc) if "frc" in pieces else rv
    if want_diags:
        return ru, rv, rufrc, rvfrc, dia
    return ru, rv, rufrc, rvfrc
