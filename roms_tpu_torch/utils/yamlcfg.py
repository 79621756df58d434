"""YAML run configuration (the analog of the reference's roms_*.in keyword
scripts parsed by inp_par.F/read_phypar.F); counterpart of
``roms_tpu/utils/yamlcfg.py`` for the cases this package has.

Schema::

    case: upwelling            # model case builder (CASES)
    nsteps: 1440               # NTIMES
    config:                    # overrides of Config fields (DT, NDTFAST...)
      dt: 300.0                # (lists become tuples; lbc_* fields take
                               #  [west, south, east, north])
      ndtfast: 30
      Lm: 41
    output:
      his_file: ocean_his.nc   # HISNAME
      nhis: 72                 # NHIS
      rst_file: ocean_rst      # RSTNAME
      nrst: 288                # NRST
      ninfo: 10                # NINFO

The file-driven case (GRDNAME/ININAME/FRCNAME of roms_*.in; see
examples/file_driven.yaml) reads its domain from NetCDF::

    case: file
    grid_file: grd.nc          # GRDNAME (h, f, pm, pn, masks, angle)
    ini_file: ini.nc           # ININAME (optional; record ini_rec, default
    ini_rec: -1                #   the last)
    frc_file: frc.nc           # FRCNAME (optional): sustr, svstr, shflux,
    frc_vars: {sustr: sms_time}  # swrad on their time axes (days)
    frc_cycle: 172800.0        # optional forcing cycle (s)
    config: {N: 6, dt: 600.0, ...}   # what a grid file cannot carry

The file-grid cases (inlet_test, test_head) take `grid_file` too.

Reading a YAML file needs PyYAML, imported only by `build_from_yaml`; a
file in JSON (a subset of YAML) is read without it.  `build_from_dict`
takes the same document as a dict.
"""

from __future__ import annotations

import importlib
import inspect
import json

import torch

from ..config import LBC

CASES = {
    "upwelling": ("roms_tpu_torch.models.upwelling", "build", "make_config"),
    "benchmark": ("roms_tpu_torch.models.benchmark", "build", "make_config"),
    "basin": ("roms_tpu_torch.models.cases", "basin", "basin_config"),
    "double_gyre": ("roms_tpu_torch.models.cases", "double_gyre",
                    "double_gyre_config"),
    "grav_adj": ("roms_tpu_torch.models.cases", "grav_adj",
                 "grav_adj_config"),
    "seamount": ("roms_tpu_torch.models.cases", "seamount",
                 "seamount_config"),
    "canyon3d": ("roms_tpu_torch.models.cases", "canyon3d",
                 "canyon3d_config"),
    "kelvin": ("roms_tpu_torch.models.cases", "kelvin", "kelvin_config"),
    "overflow": ("roms_tpu_torch.models.cases", "overflow",
                 "overflow_config"),
    "windbasin": ("roms_tpu_torch.models.cases", "windbasin",
                  "windbasin_config"),
    "estuary": ("roms_tpu_torch.models.cases", "estuary", "estuary_config"),
    "riverplume": ("roms_tpu_torch.models.cases", "riverplume",
                   "riverplume_config"),
    "lab_canyon": ("roms_tpu_torch.models.cases4", "lab_canyon",
                   "lab_canyon_config"),
    "channel_neck": ("roms_tpu_torch.models.cases4", "channel_neck",
                     "channel_neck_config"),
    "inlet_test": ("roms_tpu_torch.models.cases4", "inlet_test",
                   "inlet_test_config"),
    "test_head": ("roms_tpu_torch.models.cases4", "test_head",
                  "test_head_config"),
    "soliton": ("roms_tpu_torch.models.soliton", "build", "make_config"),
    "sed_toy": ("roms_tpu_torch.models.sed_toy", "build", "make_config"),
    "bio_toy": ("roms_tpu_torch.models.bio_toy", "build", "make_config"),
    "lake_signell": ("roms_tpu_torch.models.cases", "lake_signell",
                     "lake_signell_config"),
    **{name: ("roms_tpu_torch.models.cases2", name, name + "_config")
       for name in ("channel", "lmd_test", "mixed_layer", "test_chan",
                    "riverplume2", "weddell", "bl_test", "sed_test1",
                    "flt_test", "shoreface")},
}
# the surface forcing a file case reads by default: variable -> time axis
FRC_VARS = {"sustr": "sms_time", "svstr": "sms_time", "shflux": "shf_time",
            "swrad": "srf_time"}


def build_from_yaml(path: str,
                    device: torch.device | str = torch.device("cuda")):
    """Returns (cfg, grid, state0, forcing_fn, run_opts dict).  A file in
    JSON (a subset of YAML) is read as JSON, which needs no PyYAML and
    keeps numbers such as 1e-06 numbers (YAML 1.1 reads them as strings);
    any other file needs PyYAML."""
    with open(path) as f:
        text = f.read()
    try:
        doc = json.loads(text)
    except json.JSONDecodeError:
        import yaml
        doc = yaml.safe_load(text)
    return build_from_dict(doc, device=device)


def build_from_dict(doc: dict,
                    device: torch.device | str = torch.device("cuda")):
    """Returns (cfg, grid, state0, forcing_fn, run_opts dict) with the
    tensors on `device`; run_opts["mode"] is "3d", or "2d" for a 2-D-only
    case, whose state0 is then the Fast2DState of ops/step2d.py and
    forcing_fn None."""
    case = doc.get("case", "upwelling")
    if case == "file":
        return _build_file_case(doc, device)
    if case not in CASES:
        raise NotImplementedError(
            f"not ported: case '{case}'; this package has {sorted(CASES)}")
    modname, buildname, mkcfgname = CASES[case]
    mod = importlib.import_module(modname)
    overrides = _overrides(doc)

    mkcfg = getattr(mod, mkcfgname)
    sig = inspect.signature(mkcfg)
    cfg = mkcfg(**{k: v for k, v in overrides.items()
                   if k in sig.parameters})
    rest = {k: v for k, v in overrides.items() if k not in sig.parameters}
    if rest:
        cfg = cfg.replace(**rest)
    build = getattr(mod, buildname)
    kw = {}
    if doc.get("grid_file") and \
            "grid_path" in inspect.signature(build).parameters:
        kw["grid_path"] = doc["grid_file"]
    out = build(cfg, device=device, **kw)
    if len(out) == 4:
        cfg, grid, state0, forcing_fn = out
        mode = "3d"
    else:               # a 2-D-only case (soliton): (cfg, grid, fs)
        cfg, grid, state0 = out
        forcing_fn = None
        mode = "2d"
    run_opts = dict(doc.get("output", {}) or {})
    run_opts["nsteps"] = int(doc.get("nsteps", 0))
    run_opts["mode"] = mode
    return cfg, grid, state0, forcing_fn, run_opts


def _overrides(doc: dict) -> dict:
    """The document's config section as Config field values: a list
    becomes a tuple, and a boundary selection lbc_* given as [west, south,
    east, north] an LBC."""
    out = {}
    for k, v in (doc.get("config", {}) or {}).items():
        if k.startswith("lbc_") and isinstance(v, (list, tuple)):
            v = LBC(*v)
        elif isinstance(v, list):
            v = tuple(v)
        out[k] = v
    return out


def _build_file_case(doc: dict, device):
    """case: file (get_grid/get_state/get_data path): the grid from
    grid_file (io/gridfile.load_grid with the config overrides), the
    initial state from ini_file (or at rest), and the surface forcing from
    frc_file through forcing.series_from_netcdf and series_interp; shflux
    (W/m2) becomes stflux[0] / (rho0 * 3985) and swrad becomes srflx the
    same way."""
    from .. import forcing as frc
    from ..grid import torch_dtype
    from ..io import gridfile
    from ..state import initial_state
    grid_path = doc.get("grid_file")
    if not grid_path:
        raise ValueError("case 'file' requires grid_file")
    overrides = _overrides(doc)
    grid, cfg = gridfile.load_grid(grid_path, device=device, **overrides)
    ini_path = doc.get("ini_file")
    if ini_path:
        state0 = gridfile.load_state(cfg, ini_path,
                                     rec=doc.get("ini_rec", -1),
                                     device=device)
    else:
        state0 = initial_state(cfg, device=device)
    forcing_fn = None
    frc_path = doc.get("frc_file")
    if frc_path:
        from scipy.io import netcdf_file
        frc_vars = doc.get("frc_vars", FRC_VARS)
        with netcdf_file(frc_path, "r", mmap=False) as fnc:
            present = {v: tv for v, tv in frc_vars.items()
                       if v in fnc.variables}
        series = {v: frc.series_from_netcdf(frc_path, v, tv, cfg=cfg,
                                            cycle=doc.get("frc_cycle"),
                                            device=device)
                  for v, tv in present.items()}
        dtype = torch_dtype(cfg)

        def forcing_fn(c, g, t, _series=series):
            out = {v: frc.series_interp(fs, t).to(dtype)
                   for v, fs in _series.items()}
            rho0cp = c.rho0 * 3985.0
            if "shflux" in out:
                shf = out.pop("shflux")
                st = torch.zeros((max(c.ntracers, 1),) + tuple(shf.shape),
                                 dtype=shf.dtype, device=shf.device)
                st[0] = shf / rho0cp
                out["stflux"] = st
            if "swrad" in out:
                out["srflx"] = out.pop("swrad") / rho0cp
            return out
    run_opts = dict(doc.get("output", {}) or {})
    run_opts["nsteps"] = int(doc.get("nsteps", 0))
    run_opts["mode"] = "3d"
    return cfg, grid, state0, forcing_fn, run_opts
