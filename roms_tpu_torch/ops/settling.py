"""Vertical sinking of a profile by the CFL-free PPM + WENO semi-Lagrangian
scheme (counterpart of ``roms_tpu/ops/biology.py::ppm_sink``;
sed_settling.F:300-580, npzd_Powell.h:430-630).

Shared by the sediment settling (ops/sediment.py) and, once it is ported,
the biology's sinking.  The departure-point search of the reference (a
double k loop) is a broadcast (N, N) mask sum, as in roms_tpu: N is small.
Material that crosses the seabed leaves the column; its amount is returned
(the reference's bottom flux FC(i,0)).
"""

from __future__ import annotations

import torch

_WENO_EPS = 1.0e-14


def _monotonize(dltR, dltL, cffR, cffL, strict: bool):
    """The reference's three-branch PPM slope limiter."""
    prod = dltR * dltL
    zero = prod < 0.0 if strict else prod <= 0.0
    condA = torch.abs(dltR) > torch.abs(cffL)
    condB = torch.abs(dltL) > torch.abs(cffR)
    z = torch.zeros_like(dltR)
    dR = torch.where(zero, z, torch.where(condA, cffL, dltR))
    dL = torch.where(zero, z, torch.where(condA, dltL,
                                          torch.where(condB, cffR, dltL)))
    return dR, dL


def ppm_sink(qc, Hz, z_w, dist):
    """Sink the profile qc (N,Ny,Nx) a distance `dist` (m, a host float)
    downward.  Returns (the new profile, the seabed export in m x units)."""
    N = qc.shape[0]
    fcg = (qc[1:] - qc[:-1]) / (Hz[:-1] + Hz[1:])          # (N-1,...)

    # parabolic segments for the interior boxes k = 1..N-2
    q, hzm, hz, hzp = qc[1:-1], Hz[:-2], Hz[1:-1], Hz[2:]
    dltR = hz * fcg[1:]
    dltL = hz * fcg[:-1]
    cff = hzm + 2.0 * hz + hzp
    dltR, dltL = _monotonize(dltR, dltL, cff * fcg[1:], cff * fcg[:-1],
                             strict=False)
    c = (dltR - dltL) / (hzm + hz + hzp)
    dltR = dltR - c * hzp
    dltL = dltL + c * hzm
    zero1 = torch.zeros_like(qc[:1])
    bR = torch.cat([qc[:1], q + dltR, qc[-1:]])
    bL = torch.cat([qc[:1], q - dltL, qc[-1:]])
    WR = torch.cat([zero1, (2.0 * dltR - dltL) ** 2, zero1])
    WL = torch.cat([zero1, (dltR - 2.0 * dltL) ** 2, zero1])

    # WENO reconciliation of the interface values, boxes k = 1..N-3
    dl = torch.clamp(WL[1:N - 2], min=_WENO_EPS)
    dr = torch.clamp(WR[2:N - 1], min=_WENO_EPS)
    mid = (dr * bR[1:N - 2] + dl * bL[2:N - 1]) / (dr + dl)
    bR = torch.cat([bR[:1], mid, bR[N - 2:]])
    bL = torch.cat([bL[:2], mid, bL[N - 1:]])

    # strictly monotonic end conditions (npzd_Powell.h:520-535)
    bR = bR.clone()
    bL = bL.clone()
    bR[N - 1] = qc[N - 1]
    bR[N - 2] = qc[N - 1]
    bL[N - 1] = qc[N - 1]
    bR[0] = qc[0]
    bL[1] = qc[0]
    bL[0] = qc[0]

    # re-monotonize inside each box
    dltR, dltL = _monotonize(bR - qc, qc - bL, 2.0 * (bR - qc),
                             2.0 * (qc - bL), strict=True)
    bR = qc + dltR
    bL = qc - dltL

    # semi-Lagrangian flux through the bottom interface of every box
    wld = z_w[:-1] + dist                                   # (N,...)
    wrq = Hz * qc
    dev = qc.device
    kk = torch.arange(N, device=dev)[:, None]
    ss = torch.arange(N, device=dev)[None, :]
    # boxes ks wholly below the departure level sink through interface k
    full = ((ss >= kk) & (ss <= N - 2))[..., None, None] & \
        (wld[:, None] > z_w[None, 1:])
    fc_whole = torch.sum(torch.where(full, wrq[None],
                                     torch.zeros_like(wrq[None])), dim=1)
    ksrc = kk[..., None] + torch.sum(full, dim=1)
    ksrc = torch.clamp(ksrc, max=N - 1)

    def take(a):
        return torch.gather(a, 0, ksrc)

    HzS = take(Hz)
    cu = torch.clamp((wld - take(z_w[:-1])) / HzS, max=1.0)
    bLs, bRs, qs = take(bL), take(bR), take(qc)
    frac = HzS * cu * (
        bLs + cu * (0.5 * (bRs - bLs) -
                    (1.5 - cu) * (bRs + bLs - 2.0 * qs)))
    fc = fc_whole + frac                                    # (N,...)
    fci = torch.cat([fc, torch.zeros_like(fc[:1])])         # top flux 0
    return qc + (fci[1:] - fci[:-1]) / Hz, fc[0]
