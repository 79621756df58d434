"""Write tests/data/torch_nesting_small.npz: roms_tpu's refinement and
composite nesting and its decomposed steps at the sizes of its own tests,
the reference that roms_tpu_torch's nesting.py and parallel/ are held to
(tests/test_torch_nesting*.py, tests/test_torch_smap*.py, chip_smoke.py
phase 21):

  nested     the closed 24 x 20 x 4 parent of tests/test_nesting.py with a
             2 km zeta bump and the refined patch (9-16) x (7-14) at
             factor 3, NESTED_STEPS parent steps with two_way, conserve
             and flux_coupling: both grids' states;
  composite  two abutting 16 x 12 x 6 grids of the DOGBONE-class test
             (olap 4, a 3 km pulse at x = 12 km), COMPOSITE_STEPS steps:
             both states;
  smap       UPWELLING 24 x 16 x 4 (ndtfast 8) through roms_tpu's
             shard_map stepper on a 2 x 4 mesh of 8 virtual CPU devices,
             SMAP_STEPS steps (tests/test_smap.py), unblocked;
  partition  UPWELLING 26 x 26 x 4 through roms_tpu's GSPMD path on the
             2 x 4 mesh (tests/test_partition_invariance.py, whose
             ndtfast 6 blows up after 3 steps in both packages; ndtfast 15
             here), PARTITION_STEPS steps.

    JAX_PLATFORMS=cpu python scripts/torch_nesting_fixture.py  (~2 min)
    JAX_PLATFORMS=cpu python scripts/torch_nesting_fixture.py --report

Importing this file runs nothing and imports no jax: the sizes, the cases'
builders for either package (``port()`` / ``reference()``), the port's
side of every part (``port_part``) and ``errors`` with the bounds stated
here.  ``--report`` writes nothing and prints what the bounds rest on:
roms_tpu's own change when the initial zeta (nested, composite) or
tracers (smap, partition) move up by one ulp, roms_tpu's one-device run
against its 2 x 4 run (smap, partition), and roms_tpu_torch's CPU errors
against the fixture.

Stored under "<part>/<grid>/<field>": the interior of zeta, ubar, vbar,
u, v and t after the steps (grid "c" and "f" nested, "a" and "b"
composite, "g" the global state of smap and partition).
"""

from __future__ import annotations

import os
import sys
from types import SimpleNamespace

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, "tests", "data", "torch_nesting_small.npz")

PARENT = dict(Lm=24, Mm=20, N=4)
SPEC = dict(istr=9, iend=16, jstr=7, jend=14, factor=3)
NESTED_STEPS = 3
COMPOSITE = dict(LA=16, LB=16, olap=4, Mm=12, N=6)
COMPOSITE_STEPS = 10
SMAP = dict(Lm=24, Mm=16, N=4, ndtfast=8)
SMAP_STEPS = 4
PARTITION = dict(Lm=26, Mm=26, N=4, ndtfast=15)
PARTITION_STEPS = 5
LAYOUT = (2, 4)
PARTS = {"nested": ("c", "f"), "composite": ("a", "b"),
         "smap": ("g",), "partition": ("g",)}
FIELDS = ("zeta", "ubar", "vbar", "u", "v", "t")
# Pointwise bound on |port - fixture| on the CPU, times max|field| (each
# tracer against its own, vbar and v against ubar's and u's max too), by
# part; every number is printed by --report.  roms_tpu_torch on the CPU
# measures at most 6.6e-13 (nested; roms_tpu's own one-ulp zeta spread
# 3.6e-13), 2.2e-13 (composite), 5.9e-11 (smap) and 3.3e-11 (partition).
# The UPWELLING parts start from rest under a wind ramped up from zero:
# after one step their velocities are ~1e-6 of what they become, and the
# port's difference is already 2e-11 of max|v| there and does not grow
# over the steps (nor at ndtfast 30); roms_tpu's own one-device run
# differs from its 2 x 4 run by up to 3.2e-12, and its tracers one ulp up
# move v by 4.1e-12.
BOUNDS = {"nested": 2e-12, "composite": 1e-12, "smap": 1e-10,
          "partition": 1e-10}
PARTNER = {"vbar": "ubar", "v": "u"}


# ---------------------------------------------------------------------------
# the two packages behind one face
# ---------------------------------------------------------------------------
def port(device="cpu"):
    import torch
    from roms_tpu_torch import config, grid, nesting, state, stepping
    from roms_tpu_torch.models import upwelling
    from roms_tpu_torch.ops import bc
    return SimpleNamespace(
        name="roms_tpu_torch", config=config, nesting=nesting,
        stepping=stepping, upwelling=upwelling, fill_halo=bc.fill_halo,
        build_grid=lambda *a, **kw: grid.build_grid(*a, device=device, **kw),
        initial_state=lambda cfg, **kw: state.initial_state(
            cfg, device=device, **kw),
        asarray=lambda a: torch.as_tensor(np.asarray(a), device=device),
        numpy=lambda a: a.detach().cpu().numpy(), device=device)


def reference():
    import jax.numpy as jnp
    from roms_tpu import config, grid, nesting, state, stepping
    from roms_tpu.models import upwelling
    from roms_tpu.ops import bc
    return SimpleNamespace(
        name="roms_tpu", config=config, nesting=nesting, stepping=stepping,
        upwelling=upwelling, fill_halo=bc.fill_halo,
        build_grid=grid.build_grid, initial_state=state.initial_state,
        asarray=jnp.asarray, numpy=np.asarray, device=None)


def nested_parent(P, depth=100.0):
    """The closed parent of tests/test_nesting.py and its grid."""
    per = P.config.LBC()
    cfg = P.config.Config(
        name="nest_parent", **PARENT, ntracers=2,
        ew_periodic=False, ns_periodic=False,
        dt=60.0, ndtfast=10, solve3d=True,
        vtransform=2, vstretching=4, theta_s=0.0, theta_b=0.0,
        tcline=1.0e16, uv_adv=True, uv_cor=True,
        bottom_drag="linear", rdrg=0.0,
        vmix="none", eos="linear", Tcoef=0.0, Scoef=0.0,
        t_hadv=("U3", "U3"), t_vadv=("C4", "C4"),
        lbc_zeta=per, lbc_ubar=per, lbc_vbar=per,
        lbc_u=per, lbc_v=per, lbc_t=per, dtype="float64")
    grid, cfg = P.build_grid(cfg, Xsize=24.0e3, Esize=20.0e3, f0=0.0,
                             beta=0.0,
                             depth_fn=lambda x, y, i, j, c: depth + 0 * x)
    return cfg, grid


def nested_state(P, cfg, grid, width=2.0e3, amp=0.05, zeta_up=False):
    """A zeta bump of `width` at parent cell (12, 10), T 17, S 35."""
    H = cfg.halo
    xr, yr = P.numpy(grid.xr), P.numpy(grid.yr)
    x = xr - xr[H + 10, H + 12]
    y = yr - yr[H + 10, H + 12]
    z0 = amp * np.exp(-(x ** 2 + y ** 2) / width ** 2)
    if zeta_up:
        z0 = np.nextafter(z0, np.inf)
    t0 = np.stack([np.full((cfg.N, cfg.ny_tot, cfg.nx_tot), 17.0),
                   np.full((cfg.N, cfg.ny_tot, cfg.nx_tot), 35.0)])
    return P.initial_state(cfg, zeta=P.fill_halo(cfg, P.asarray(z0)),
                           t=P.asarray(t0))


def run_nested(P, zeta_up=False, steps=NESTED_STEPS):
    """{"c": parent state, "f": fine state} after `steps` parent steps."""
    cfg_c, grid_c = nested_parent(P)
    spec = P.nesting.RefineSpec(**SPEC)
    cfg_f, grid_f = P.nesting.build_refined(cfg_c, grid_c, spec)
    sc = nested_state(P, cfg_c, grid_c, zeta_up=zeta_up)
    sf = P.nesting.init_refined(cfg_c, grid_c, sc, spec, cfg_f, grid_f)
    stepn = P.nesting.make_nested_stepper(cfg_c, grid_c, cfg_f, grid_f,
                                          spec, conserve=True,
                                          flux_coupling=True)
    for _ in range(steps):
        sc, sf = stepn(sc, sf)
    return {"c": (cfg_c, sc), "f": (cfg_f, sf)}


def composite_member(P, Lm, lbc_w, lbc_e, name):
    """A member of the DOGBONE-class test: Lm x 12 x 6, 1 km cells,
    north-south periodic, 50 m deep."""
    pick = lambda w, e: P.config.LBC(w, "Per", e, "Per")
    lbc = pick(lbc_w, lbc_e)
    cfg = P.config.Config(
        name=name, Lm=Lm, Mm=COMPOSITE["Mm"], N=COMPOSITE["N"], ntracers=1,
        ew_periodic=False, ns_periodic=True, dt=30.0, ndtfast=20,
        uv_vis2=True, visc2=5.0, tnu2=(0.0,),
        t_hadv=("U3",), t_vadv=("C4",),
        akv_bak=1e-5, akt_bak=(1e-6,), bottom_drag=None,
        eos="linear", R0=1027.0, T0=10.0, Tcoef=1.7e-4, Scoef=0.0,
        theta_s=0.0, theta_b=0.0, tcline=1e16, vtransform=1,
        vstretching=1, lbc_zeta=lbc, lbc_ubar=lbc, lbc_vbar=lbc,
        lbc_u=lbc, lbc_v=lbc, lbc_t=lbc, dtype="float64")
    grid, cfg = P.build_grid(cfg, Lm * 1000.0, COMPOSITE["Mm"] * 1000.0,
                             f0=0.0, beta=0.0,
                             depth_fn=lambda x, y, i, j, c: 50.0 + 0 * x)
    return cfg, grid


def pulse(P, cfg, grid, xc, zeta_up=False):
    """A 0.1 m Gaussian pulse of 3 km at x = xc, T 10."""
    z0 = 0.1 * np.exp(-((P.numpy(grid.xr) - xc) / 3000.0) ** 2)
    if zeta_up:
        z0 = np.nextafter(z0, np.inf)
    t0 = np.full((1, cfg.N, cfg.ny_tot, cfg.nx_tot), 10.0)
    return P.initial_state(cfg, zeta=P.fill_halo(cfg, P.asarray(z0)),
                           t=P.asarray(t0))


def run_composite(P, zeta_up=False, steps=COMPOSITE_STEPS, la=None,
                  lb=None, xc=12e3):
    """{"a": west state, "b": east state} after `steps` steps."""
    olap = COMPOSITE["olap"]
    la = la or COMPOSITE["LA"]
    lb = lb or COMPOSITE["LB"]
    cfg_a, grid_a = composite_member(P, la, "Clo", "Cla", "A")
    cfg_b, grid_b = composite_member(P, lb, "Cla", "Clo", "B")
    sa = pulse(P, cfg_a, grid_a, xc, zeta_up)
    sb = pulse(P, cfg_b, grid_b, xc - (la - olap) * 1000.0, zeta_up)
    step = P.nesting.make_composite_stepper(
        cfg_a, grid_a, cfg_b, grid_b, P.nesting.CompositeSpec(olap))
    for _ in range(steps):
        sa, sb = step(sa, sb)
    return {"a": (cfg_a, sa), "b": (cfg_b, sb)}


def upwelling_case(P, sizes, up=None):
    """UPWELLING at `sizes`; up "t" or "zeta": those initial values one
    ulp up."""
    cfg = P.upwelling.make_config(**sizes)
    kw = {} if P.device is None else {"device": P.device}
    cfg, grid, s0, ffn = P.upwelling.build(cfg, **kw)
    if up == "t":
        t = P.asarray(np.nextafter(P.numpy(s0.t), np.inf))
        s0 = s0.replace(t=t, t_prev=t)
    elif up == "zeta":
        s0 = s0.replace(zeta=P.asarray(np.nextafter(P.numpy(s0.zeta),
                                                     np.inf)))
    return cfg, grid, s0, ffn


def _reference_decomposed(part, up=None):
    """roms_tpu's state after the part's steps on the 2 x 4 mesh."""
    import jax
    from roms_tpu.parallel import shard, smap
    P = reference()
    sizes = SMAP if part == "smap" else PARTITION
    cfg, grid, s0, ffn = upwelling_case(P, sizes, up)
    mesh = shard.make_mesh(jax.devices()[:8], shape=LAYOUT)
    if part == "smap":
        step = smap.make_smap_stepper(cfg, grid, mesh, ffn)
        sb = smap.block(cfg, mesh, s0)
        for _ in range(SMAP_STEPS):
            sb = step(sb)
        s = smap.unblock(cfg, mesh, sb)
    else:
        grid_s = shard.shard_state(mesh, grid)
        s = shard.shard_state(mesh, s0)
        run = jax.jit(lambda x: P.stepping.run(cfg, grid_s, x,
                                               PARTITION_STEPS, ffn))
        s = run(s)
    return {"g": (cfg, jax.device_get(s))}


def _reference_one_device(part):
    """roms_tpu's state after the part's steps on one device (jitted)."""
    import jax
    P = reference()
    sizes = SMAP if part == "smap" else PARTITION
    nsteps = SMAP_STEPS if part == "smap" else PARTITION_STEPS
    cfg, grid, s0, ffn = upwelling_case(P, sizes)
    run = jax.jit(lambda x: P.stepping.run(cfg, grid, x, nsteps, ffn))
    return {"g": (cfg, jax.device_get(run(s0)))}


def port_decomposed(part, layout=LAYOUT, device="cpu"):
    """roms_tpu_torch's blocked run of `part` on `layout` (in process),
    unblocked."""
    from roms_tpu_torch.parallel import smap
    P = port(device)
    sizes = SMAP if part == "smap" else PARTITION
    nsteps = SMAP_STEPS if part == "smap" else PARTITION_STEPS
    cfg, grid, s0, ffn = upwelling_case(P, sizes)
    lay = smap.Layout(*layout)
    step = smap.make_smap_stepper(cfg, grid, lay, ffn)
    sb = smap.block(cfg, lay, s0)
    for _ in range(nsteps):
        sb = step(sb)
    return {"g": (cfg, smap.unblock(cfg, lay, sb))}


def port_part(part, device="cpu"):
    """roms_tpu_torch's side of `part`: {grid: (cfg, state)}."""
    if part == "nested":
        return run_nested(port(device))
    if part == "composite":
        return run_composite(port(device))
    return port_decomposed(part, device=device)


def reference_part(part, up=None):
    """roms_tpu's side of `part`; up "zeta" or "t" (smap, partition): those
    initial values one ulp up."""
    if part == "nested":
        return run_nested(reference(), zeta_up=up == "zeta")
    if part == "composite":
        return run_composite(reference(), zeta_up=up == "zeta")
    return _reference_decomposed(part, up=up)


def interiors(P, states: dict) -> dict:
    """{"<grid>/<field>": interior array} of {grid: (cfg, state)}."""
    out = {}
    for g, (cfg, s) in states.items():
        H = cfg.halo
        for k in FIELDS:
            a = P.numpy(getattr(s, k))
            out[f"{g}/{k}"] = np.asarray(a[..., H:H + cfg.Mm,
                                           H:H + cfg.Lm], np.float64)
    return out


def _compare(got: dict, want: dict) -> dict:
    """{name: |got - want| / scale}, each tracer apart ("t[n]")."""
    out = {}
    for name, w in want.items():
        g = got[name]
        grid_, field = name.split("/")
        if field == "t":
            for n in range(len(w)):
                out[f"{name}[{n}]"] = float(
                    np.abs(g[n] - w[n]).max() / max(np.abs(w[n]).max(),
                                                    1e-300))
            continue
        scale = np.abs(w).max()
        if field in PARTNER:
            scale = max(scale, np.abs(want[f"{grid_}/{PARTNER[field]}"])
                        .max())
        out[name] = float(np.abs(g - w).max() / max(scale, 1e-300))
    return out


def errors(part: str, states: dict, ref, factor: float = 1.0) -> dict:
    """{name: (|port - fixture| / scale, bound)} of roms_tpu_torch's
    `states` ({grid: (cfg, state)}) against the loaded fixture `ref`."""
    got = interiors(port(), states)
    want = {k: ref[f"{part}/{k}"] for k in got}
    return {k: (e, factor * BOUNDS[part])
            for k, e in _compare(got, want).items()}


def report() -> None:
    """Print the measurements the bounds of this file rest on."""
    import torch
    torch.set_num_threads(1)
    ref = np.load(OUT)
    P = reference()
    for part in [p for p in sys.argv[1:] if p in PARTS] or list(PARTS):
        a = interiors(P, reference_part(part))
        up = "zeta" if part in ("nested", "composite") else "t"
        b = interiors(P, reference_part(part, up=up))
        for key, e in _compare(b, a).items():
            print(f"{part}: roms_tpu, initial {up} one ulp up: "
                  f"{key:10s} {e:.3e}")
        if part in ("smap", "partition"):
            b = interiors(P, _reference_one_device(part))
            for key, e in _compare(b, a).items():
                print(f"{part}: roms_tpu, one device against 2 x 4: "
                      f"{key:10s} {e:.3e}")
        for key, (e, lim) in errors(part, port_part(part), ref).items():
            print(f"{part}: roms_tpu_torch (CPU) against the fixture: "
                  f"{key:10s} {e:.3e} (bound {lim:g})")


def main() -> int:
    sys.path.insert(0, ROOT)
    flags = os.environ.get("XLA_FLAGS", "")
    if "host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8").strip()
    import jax
    jax.config.update("jax_enable_x64", True)
    if "--report" in sys.argv[1:]:
        report()
        return 0
    out = {}
    P = reference()
    for part in PARTS:
        for k, v in interiors(P, reference_part(part)).items():
            out[f"{part}/{k}"] = v
        print(f"{part}: done", flush=True)
    np.savez_compressed(OUT, **out)
    print(f"wrote {OUT} ({os.path.getsize(OUT)} bytes)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
