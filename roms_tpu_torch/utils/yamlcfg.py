"""YAML run configuration (the analog of the reference's roms_*.in keyword
scripts parsed by inp_par.F/read_phypar.F); counterpart of
``roms_tpu/utils/yamlcfg.py`` for the cases this package has.

Schema::

    case: upwelling            # model case builder (CASES)
    nsteps: 1440               # NTIMES
    config:                    # overrides of Config fields (DT, NDTFAST...)
      dt: 300.0
      ndtfast: 30
      Lm: 41
    output:
      his_file: ocean_his.nc   # HISNAME
      nhis: 72                 # NHIS
      rst_file: ocean_rst      # RSTNAME
      nrst: 288                # NRST
      ninfo: 10                # NINFO

Reading a YAML file needs PyYAML, imported only by `build_from_yaml`;
`build_from_dict` takes the same document as a dict.
"""

from __future__ import annotations

import importlib
import inspect

import torch

CASES = {
    "upwelling": ("roms_tpu_torch.models.upwelling", "build", "make_config"),
    "benchmark": ("roms_tpu_torch.models.benchmark", "build", "make_config"),
    "kelvin": ("roms_tpu_torch.models.cases", "kelvin", "kelvin_config"),
    "estuary": ("roms_tpu_torch.models.cases", "estuary", "estuary_config"),
    "riverplume": ("roms_tpu_torch.models.cases", "riverplume",
                   "riverplume_config"),
}


def build_from_yaml(path: str,
                    device: torch.device | str = torch.device("cuda")):
    """Returns (cfg, grid, state0, forcing_fn, run_opts dict)."""
    import yaml
    with open(path) as f:
        doc = yaml.safe_load(f)
    return build_from_dict(doc, device=device)


def build_from_dict(doc: dict,
                    device: torch.device | str = torch.device("cuda")):
    """Returns (cfg, grid, state0, forcing_fn, run_opts dict) with the
    tensors on `device`."""
    case = doc.get("case", "upwelling")
    if case == "file":
        raise NotImplementedError(
            "not ported: case 'file' (io/gridfile with the curvilinear "
            "grid)")
    if case not in CASES:
        raise NotImplementedError(
            f"not ported: case '{case}'; this package has {sorted(CASES)}")
    modname, buildname, mkcfgname = CASES[case]
    mod = importlib.import_module(modname)
    overrides = doc.get("config", {}) or {}

    mkcfg = getattr(mod, mkcfgname)
    sig = inspect.signature(mkcfg)
    cfg = mkcfg(**{k: v for k, v in overrides.items()
                   if k in sig.parameters})
    rest = {k: v for k, v in overrides.items() if k not in sig.parameters}
    if rest:
        cfg = cfg.replace(**rest)
    cfg, grid, state0, forcing_fn = getattr(mod, buildname)(cfg,
                                                            device=device)
    run_opts = dict(doc.get("output", {}) or {})
    run_opts["nsteps"] = int(doc.get("nsteps", 0))
    return cfg, grid, state0, forcing_fn, run_opts
