"""roms_tpu_torch: the horizontal mixing operators of ops/mix3d.py beyond
the harmonic s-surface ones.

(a) each operator against roms_tpu's on three small UPWELLING-based grids
    (E-W periodic; closed with no-slip walls; north-south periodic with
    gradient east and west walls), random fields made with numpy from a
    seed, float64, to 1e-12 x max|field| over the whole padded array:
    Smagorinsky viscosity (through uv3dmix2), uv3dmix4,
    t3dmix4, t3dmix2/4 along geopotentials and isopycnals, uv3dmix2/4
    along geopotentials.  roms_tpu's operators run under one jax.jit a
    grid;
(b) the port's analogs of tests/test_mix3d.py: the rotated tracer
    operators conserve tracer mass on a doubly periodic grid, reduce to
    the s-surface operators on a flat one, isopycnal diffusion leaves a
    tracer aligned with density unchanged and spreads a blob down its
    gradient, and the rotated viscosity dissipates kinetic energy.
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from roms_tpu.config import LBC as JLBC, BC_GRADIENT, BC_PERIODIC
from roms_tpu.models import upwelling as jup
from roms_tpu.ops import mix3d as jmix
from roms_tpu_torch import vgrid
from roms_tpu_torch.config import LBC
from roms_tpu_torch.grid import build_grid, hc_of
from roms_tpu_torch.models import upwelling
from roms_tpu_torch.ops import bc, mix3d as tmix
from test_torch_stages import T, _close, build_pair

torch.set_num_threads(1)

J = jnp.asarray
# operator -> (function name, the Config change it runs under, its kind:
# "uv" takes (u, v, Hz[, z_r], u_nnew, v_nnew, rufrc, rvfrc), "t"
# (t, Hz[, z_r], t_nnew), "iso" (t, pden, Hz, z_r, t_nnew))
OPS = {
    "uv3dmix2_smagorinsky": ("uv3dmix2", dict(uv_smagorinsky=True), "uv"),
    "uv3dmix4": ("uv3dmix4", {}, "uv"),
    "t3dmix4": ("t3dmix4", {}, "t"),
    "t3dmix2_geo": ("t3dmix2_geo", {}, "t_z"),
    "t3dmix4_geo": ("t3dmix4_geo", {}, "t_z"),
    "t3dmix2_iso": ("t3dmix2_iso", {}, "iso"),
    "t3dmix4_iso": ("t3dmix4_iso", dict(tnu4=(0.0, 4.0e7)), "iso"),
    "uv3dmix2_geo": ("uv3dmix2_geo", {}, "uv_z"),
    "uv3dmix4_geo": ("uv3dmix4_geo", {}, "uv_z"),
}
_MIX = dict(tnu2=(30.0, 30.0), tnu4=(1.0e8, 1.0e8), ts_dif4=True,
            visc4=1.0e8, uv_vis4=True, smagor_coef=0.1)


def _grid_cfg(kind):
    cfg = jup.make_config(Lm=10, Mm=12, N=4, ndtfast=6)
    if kind == "closed":
        cfg = dataclasses.replace(
            cfg, ew_periodic=False, lbc_zeta=JLBC(), lbc_ubar=JLBC(),
            lbc_vbar=JLBC(), lbc_u=JLBC(), lbc_v=JLBC(), lbc_t=JLBC(),
            gamma2=-1.0)
    elif kind == "ns_periodic":
        per = JLBC(BC_GRADIENT, BC_PERIODIC, BC_GRADIENT, BC_PERIODIC)
        cfg = dataclasses.replace(
            cfg, ew_periodic=False, ns_periodic=True, lbc_zeta=per,
            lbc_ubar=per, lbc_vbar=per, lbc_u=per, lbc_v=per, lbc_t=per)
    return dataclasses.replace(cfg, **_MIX)


def _args(kind, f, conv):
    uv = [conv(f[k]) for k in ("u_nnew", "v_nnew", "rufrc", "rvfrc")]
    if kind == "uv":
        return [conv(f["u"]), conv(f["v"]), conv(f["Hz"])] + uv
    if kind == "uv_z":
        return [conv(f[k]) for k in ("u", "v", "Hz", "z_r")] + uv
    if kind == "t":
        return [conv(f[k]) for k in ("t", "Hz", "t_nnew")]
    if kind == "t_z":
        return [conv(f[k]) for k in ("t", "Hz", "z_r", "t_nnew")]
    return [conv(f[k]) for k in ("t", "pden", "Hz", "z_r", "t_nnew")]


@pytest.fixture(scope="module", params=["ew_periodic", "closed",
                                        "ns_periodic"])
def grid_case(request):
    """One grid in both packages, random fields (numpy) and roms_tpu's
    results of every operator of OPS from one jitted call."""
    cfg_j, grid_j, cfg_t, grid_t = build_pair(_grid_cfg(request.param))
    rng = np.random.default_rng(15)
    s2 = (cfg_j.ny_tot, cfg_j.nx_tot)
    s3 = (cfg_j.N,) + s2
    zeta = 0.3 * rng.standard_normal(s2)
    z_r, _, Hz = vgrid.set_depth(grid_t.h, T(zeta), hc_of(cfg_t),
                                 grid_t.sc_r, grid_t.Cs_r, grid_t.sc_w,
                                 grid_t.Cs_w, cfg_t.vtransform)
    t = np.stack([14.0 + 4.0 * rng.random(s3), 35.0 + rng.random(s3)])
    f = dict(u=0.1 * rng.standard_normal(s3), v=0.1 * rng.standard_normal(s3),
             t=t, Hz=Hz.numpy(), z_r=z_r.numpy(),
             pden=1027.0 - 0.17 * (t[0] - 14.0) - 0.5 * z_r.numpy(),
             t_nnew=Hz.numpy()[None] * (1.0 + rng.random((2,) + s3)),
             u_nnew=0.1 * rng.standard_normal(s3),
             v_nnew=0.1 * rng.standard_normal(s3),
             rufrc=1e-3 * rng.standard_normal(s2),
             rvfrc=1e-3 * rng.standard_normal(s2))

    def all_ops(fields):
        out = {}
        for op, (fn, change, kind) in OPS.items():
            cfg = dataclasses.replace(cfg_j, **change)
            out[op] = getattr(jmix, fn)(cfg, grid_j, *_args(kind, fields, J),
                                        cfg.dt)
        out["smagorinsky_visc"] = jmix.smagorinsky_visc(
            cfg_j, grid_j, fields["u"], fields["v"])
        return out

    ref = jax.jit(all_ops)({k: J(v) for k, v in f.items()})
    return cfg_t, grid_t, f, ref


@pytest.mark.parametrize("op", list(OPS))
def test_operator_matches(grid_case, op):
    cfg_t, grid_t, f, ref = grid_case
    fn, change, kind = OPS[op]
    cfg = cfg_t.replace(**change)
    got = getattr(tmix, fn)(cfg, grid_t, *_args(kind, f, T), cfg.dt)
    if kind.startswith("uv"):
        for a, b, name in zip(got, ref[op], ("u_nnew", "v_nnew", "rufrc",
                                             "rvfrc")):
            _close(a, b, f"{op} {name}")
        assert not torch.equal(got[0], T(f["u_nnew"]))
    else:
        _close(got, ref[op], op)
        for k in range(2):
            on = (cfg.tnu4 if "4" in fn else cfg.tnu2)[k] != 0.0
            assert torch.equal(got[k], T(f["t_nnew"][k])) != on, (op, k)


def test_smagorinsky_viscosity_matches(grid_case):
    """The deformation-rate viscosity itself, at rho points, and its
    effect on uv3dmix2."""
    cfg_t, grid_t, f, ref = grid_case
    got = tmix.smagorinsky_visc(cfg_t, grid_t, T(f["u"]), T(f["v"]))
    _close(got, ref["smagorinsky_visc"], "smagorinsky_visc")
    assert bool((got >= 0.0).all()) and float(got.max()) > 0.0
    plain = tmix.uv3dmix2(cfg_t, grid_t, *_args("uv", f, T), cfg_t.dt)
    smag = tmix.uv3dmix2(cfg_t.replace(uv_smagorinsky=True), grid_t,
                         *_args("uv", f, T), cfg_t.dt)
    assert not torch.equal(plain[0], smag[0])


# ---------------------------------------------------------------------------
# (b) physics, on the port's own grids
# ---------------------------------------------------------------------------
def _setup(flat: bool):
    """A doubly periodic 10x12x10 UPWELLING-based grid, flat (100 m) or
    with a sinusoidal bottom, at rest; a smooth tracer with structure in
    every direction: (cfg, grid, t, Hz, z_r)."""
    per = LBC.doubly_periodic()
    cfg = upwelling.make_config(Lm=10, Mm=12, N=10).replace(
        ew_periodic=True, ns_periodic=True, lbc_zeta=per, lbc_ubar=per,
        lbc_vbar=per, lbc_u=per, lbc_v=per, lbc_t=per,
        tnu2=(30.0, 30.0), tnu4=(1.0e8, 1.0e8), ts_dif4=True, visc4=1.0e8,
        uv_vis4=True)

    def depth(xr, yr, i, j, c):
        if flat:
            return np.full_like(xr, 100.0)
        return 100.0 - 40.0 * np.sin(2 * np.pi * i / c.Lm) * \
            np.cos(2 * np.pi * j / c.Mm)

    grid, cfg = build_grid(cfg, 50.0e3, 60.0e3, f0=-1.0e-4, beta=0.0,
                           depth_fn=depth, device="cpu")
    z_r, _, Hz = vgrid.set_depth(grid.h, torch.zeros_like(grid.h),
                                 hc_of(cfg), grid.sc_r, grid.Cs_r,
                                 grid.sc_w, grid.Cs_w, cfg.vtransform)
    x, y = grid.xr / 50.0e3, grid.yr / 60.0e3
    q = 14.0 + 4.0 * torch.exp(z_r / 40.0) + \
        torch.sin(2 * math.pi * x) * torch.cos(4 * math.pi * y)
    q = bc.fill_halo(cfg, q)
    return cfg, grid, torch.stack([q, torch.full_like(q, 35.0)]), Hz, z_r


def _inner(cfg):
    H = cfg.halo
    return slice(H, H + cfg.Mm), slice(H, H + cfg.Lm)


def test_rotated_operators_conserve_mass():
    cfg, grid, t, Hz, z_r = _setup(flat=False)
    pden = 1027.0 - 0.17 * (t[0] - 14.0)
    zero = torch.zeros_like(t)
    jj, ii = _inner(cfg)
    area = grid.omn[jj, ii]
    for name, dT in [
            ("geo2", tmix.t3dmix2_geo(cfg, grid, t, Hz, z_r, zero, cfg.dt)),
            ("geo4", tmix.t3dmix4_geo(cfg, grid, t, Hz, z_r, zero, cfg.dt)),
            ("iso2", tmix.t3dmix2_iso(cfg, grid, t, pden, Hz, z_r, zero,
                                      cfg.dt)),
            ("iso4", tmix.t3dmix4_iso(cfg, grid, t, pden, Hz, z_r, zero,
                                      cfg.dt))]:
        assert bool(torch.isfinite(dT).all()), name
        mass = float((dT[0][:, jj, ii] * area).sum())
        ref = float((dT[0][:, jj, ii].abs() * area).sum()) + \
            float(t[0].abs().max())
        assert abs(mass) < 1e-9 * ref, (name, mass, ref)
        assert float(dT[0].abs().max()) > 0.0, name


def test_geo_reduces_to_s_surfaces_on_flat_grid():
    cfg, grid, t, Hz, z_r = _setup(flat=True)
    zero = torch.zeros_like(t)
    np.testing.assert_allclose(
        tmix.t3dmix2_geo(cfg, grid, t, Hz, z_r, zero, cfg.dt).numpy(),
        tmix.t3dmix2(cfg, grid, t, Hz, zero, cfg.dt).numpy(),
        rtol=1e-12, atol=1e-14)
    np.testing.assert_allclose(
        tmix.t3dmix4_geo(cfg, grid, t, Hz, z_r, zero, cfg.dt).numpy(),
        tmix.t3dmix4(cfg, grid, t, Hz, zero, cfg.dt).numpy(),
        rtol=1e-10, atol=1e-14)
    u, v = _uv_fields(cfg, grid, z_r)
    zu, zv, z2 = torch.zeros_like(u), torch.zeros_like(v), \
        torch.zeros_like(grid.h)
    for s_op, geo_op in ((tmix.uv3dmix2, tmix.uv3dmix2_geo),
                         (tmix.uv3dmix4, tmix.uv3dmix4_geo)):
        ref = s_op(cfg, grid, u, v, Hz, zu, zv, z2, z2, cfg.dt)
        got = geo_op(cfg, grid, u, v, Hz, z_r, zu, zv, z2, z2, cfg.dt)
        for a, b in zip(got[:3], ref[:3]):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-10,
                                       atol=1e-16)


def test_iso_null_on_density_aligned_tracer_and_downgradient():
    """A tracer linear in pden has no isopycnal tendency on the interior
    levels (given stratification above the 0.5 kg/m3 floor); a blob on
    one isopycnal layer loses variance."""
    cfg, grid, t, Hz, z_r = _setup(flat=False)
    x, y = grid.xr / 50.0e3, grid.yr / 60.0e3
    temp = bc.fill_halo(cfg, 14.0 + 2.5 * (z_r + 140.0) + 2.0 * torch.sin(
        2 * math.pi * x) * torch.cos(2 * math.pi * y))
    pden = 1027.0 - 0.17 * (temp - 14.0)
    tt = torch.stack([temp, 3.0 + 0.5 * pden])
    dT = tmix.t3dmix2_iso(cfg, grid, tt, pden, Hz, z_r,
                          torch.zeros_like(tt), cfg.dt)
    assert float(dT[1][1:-1].abs().max()) < 1e-10 * float(
        dT[0].abs().max() + 1e-30)
    assert float(dT[0].abs().max()) > 0.0

    pden = 1027.0 - 0.17 * (t[0] - 14.0)
    blob = torch.exp(-((grid.xr / 50.0e3 - 0.5) / 0.15) ** 2) * \
        torch.exp(-((z_r + 30.0) / 15.0) ** 2)
    tt = torch.stack([t[0], blob])
    dT = tmix.t3dmix2_iso(cfg, grid, tt, pden, Hz, z_r,
                          torch.zeros_like(tt), cfg.dt)
    jj, ii = _inner(cfg)
    w = Hz[:, jj, ii] * grid.omn[jj, ii]
    q0 = blob[:, jj, ii]
    q1 = q0 + dT[1][:, jj, ii] / Hz[:, jj, ii]
    assert float((q1 ** 2 * w).sum()) < float((q0 ** 2 * w).sum())


def _uv_fields(cfg, grid, z_r):
    x, y, zz = grid.xr / 50.0e3, grid.yr / 60.0e3, z_r / 100.0
    u = 0.1 * torch.sin(2 * math.pi * x) * torch.cos(2 * math.pi * y) * \
        (1.0 + zz)
    v = 0.1 * torch.cos(4 * math.pi * x) * torch.sin(2 * math.pi * y) * \
        (1.0 - 0.3 * zz)
    return bc.fill_halo(cfg, u), bc.fill_halo(cfg, v)


@pytest.mark.parametrize("op", ["uv3dmix2_geo", "uv3dmix4_geo"])
def test_rotated_viscosity_dissipates(op):
    cfg, grid, _, Hz, z_r = _setup(flat=False)
    u, v = _uv_fields(cfg, grid, z_r)
    z2 = torch.zeros_like(grid.h)
    du, dv, _, _ = getattr(tmix, op)(cfg, grid, u, v, Hz, z_r,
                                     torch.zeros_like(u),
                                     torch.zeros_like(v), z2, z2, cfg.dt)
    assert bool(torch.isfinite(du).all() and torch.isfinite(dv).all())
    assert float(du.abs().max()) > 0.0
    jj, ii = _inner(cfg)
    Hz_u = 0.5 * (Hz + torch.roll(Hz, 1, -1))
    Hz_v = 0.5 * (Hz + torch.roll(Hz, 1, -2))

    def ke(uu, vv):
        return float((uu[:, jj, ii] ** 2 * Hz_u[:, jj, ii]).sum() +
                     (vv[:, jj, ii] ** 2 * Hz_v[:, jj, ii]).sum())

    assert ke(u + du / Hz_u, v + dv / Hz_v) < ke(u, v)
