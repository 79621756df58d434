"""roms_tpu_torch: Config parity with roms_tpu, and no jax at import."""

import dataclasses
import inspect
import os
import subprocess
import sys

import pytest
import torch

from roms_tpu import config as jcfg
from roms_tpu.models import upwelling as jup
from roms_tpu_torch import config as tcfg, convert, forcing as tforcing, \
    grid as tgrid, state as tstate
from roms_tpu_torch.utils import yamlcfg
from roms_tpu_torch.models import upwelling as tup

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _defaults(cls):
    out = {}
    for f in dataclasses.fields(cls):
        val = f.default if f.default is not dataclasses.MISSING \
            else f.default_factory()
        out[f.name] = dataclasses.asdict(val) \
            if dataclasses.is_dataclass(val) else val
    return out


def test_config_fields_and_defaults_match():
    for name in ("Config", "LBC", "GLSParams"):
        assert _defaults(getattr(tcfg, name)) == \
            _defaults(getattr(jcfg, name)), name
    for name in dir(jcfg):
        if name.startswith("BC_"):
            assert getattr(tcfg, name) == getattr(jcfg, name)
    cfg = jcfg.Config()
    assert (cfg.dtfast, cfg.nx_tot, cfg.ny_tot) == \
        (tcfg.Config().dtfast, tcfg.Config().nx_tot, tcfg.Config().ny_tot)
    assert tcfg.index_of(tcfg.Config(), 1) == jcfg.index_of(cfg, 1)


def test_config_conversion_from_reference():
    cfg_j, *_ = jup.build(jup.make_config(Lm=12, Mm=10, N=4, ndtfast=6))
    cfg_t, *_ = tup.build(tup.make_config(Lm=12, Mm=10, N=4, ndtfast=6),
                          device="cpu")
    conv = convert.config_from_reference(cfg_j)
    assert conv == cfg_t
    assert isinstance(conv.lbc_zeta, tcfg.LBC)
    assert isinstance(conv.gls_params, tcfg.GLSParams)


def test_entry_points_default_to_the_card():
    """The entry points put their tensors on the CUDA card unless asked
    for another device; without a card they raise torch's own error."""
    for fn in (tup.build, tgrid.build_grid, tstate.initial_state,
               convert.grid_from_numpy, convert.state_from_numpy,
               yamlcfg.build_from_dict, yamlcfg.build_from_yaml,
               tforcing.make_series, tforcing.series_from_netcdf):
        default = inspect.signature(fn).parameters["device"].default
        assert torch.device(default) == torch.device("cuda"), fn.__name__
    cfg = tup.make_config(Lm=12, Mm=10, N=4, ndtfast=6)
    if torch.cuda.is_available():
        _, grid, s0, _ = tup.build(cfg)
        assert grid.h.is_cuda and s0.t.is_cuda
    else:
        with pytest.raises((AssertionError, RuntimeError)):
            tup.build(cfg)


def test_import_leaves_jax_out():
    code = (
        "import pkgutil, sys, roms_tpu_torch\n"
        "for m in pkgutil.walk_packages(roms_tpu_torch.__path__,"
        " 'roms_tpu_torch.'):\n"
        "    __import__(m.name)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in"
        " ('jax', 'jaxlib', 'flax', 'roms_tpu', 'yaml'))\n"
        "assert not bad, bad\n"
        "want = {'driver', 'forcing', '__main__', 'io.varinfo',"
        " 'io.netcdf', 'io.checkpoint', 'io.stations', 'utils.timers',"
        " 'utils.diag', 'utils.yamlcfg', 'utils.dateclock',"
        " 'utils.fields', 'nesting', 'parallel', 'parallel.halo',"
        " 'parallel.smap', 'parallel.run', 'io.pio'}\n"
        "missing = {m for m in want if 'roms_tpu_torch.' + m not in"
        " sys.modules}\n"
        "assert not missing, missing\n"
        "from roms_tpu_torch import stepping\n"
        "assert stepping.run_accum and stepping.make_stepper\n"
        "print('ok')\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"
