"""Count the device launches one step of roms_tpu_torch makes on a card,
from a CPU run: the step's aten operations under a TorchDispatchMode, less
views and other operations that launch nothing, plus one launch for each
kernel-wrapper call (whose plain version then runs uncounted).  The
momentum phase takes the chain it takes on the card.

    python roms_tpu_torch/launch_count.py [--case CASE] [--root CHECKOUT]

CASE is upwelling (the default), benchmark, a regional case (kelvin,
estuary, riverplume), an operator case (basin, double_gyre, grav_adj,
seamount, canyon3d, overflow, windbasin, channel_neck), lab_canyon, one
of channel, lmd_test, mixed_layer, test_chan, riverplume2, weddell,
bl_test, flt_test and shoreface, a sediment case (sed_toy, lake_signell,
sed_test1), bio_toy, or a biology model on UPWELLING
(models/bio_toy.SETUPS: npzd_franks, npzd_iron, fennel,
fennel_oxygen_carbon, hypoxia_srm, nemuro, red_tide, ecosim), float32 as
on the card.  --case benchmark counts a BENCHMARK1
step at 64x32 instead of 512x64 (the count depends on N, not on the
horizontal size); the other cases run at their published sizes, with
their plain stages (the general fast loop, KPP, GLS, MY2.5, the bottom
boundary layers, sediment, biology, the radiation stress, the mixing
operators outside the kernels) counted as stages.

--root counts the roms_tpu_torch of another checkout (an older tree has
fewer kernel wrappers; the ones it lacks are skipped).  Prints the count
by stage and the total.  Needs torch and numpy only; importing this module
runs nothing.
"""

from __future__ import annotations

import argparse
import collections
import importlib
import os
import sys

# operations that allocate or re-view memory and launch nothing on a card
NO_LAUNCH = {
    "view", "_unsafe_view", "slice", "select", "unsqueeze", "squeeze",
    "expand", "as_strided", "alias", "t", "transpose", "permute", "detach",
    "_reshape_alias", "reshape", "lift_fresh", "empty", "empty_like",
    "empty_strided", "unbind", "split", "split_with_sizes"}
# kernel wrappers: module -> names (an older tree lacks some)
WRAPPERS = {
    "diag_cuda": ("grid_flux", "eos", "omega"),
    "step2d_cuda": ("fast_loop",),
    "prsgrd_cuda": ("prsgrd32",),
    "step3d_cuda": ("tracer_predictor", "uv_corrector", "tracer_corrector"),
    "rhs3d_cuda": ("rhs3d",),
    "mix3d_cuda": ("uv3dmix2", "t3dmix2_geo"),
}
# plain stages the step calls by name, counted op by op
STAGES = {"stepping": ("set_vbc", "momentum_init", "rhs3d_momentum",
                       "bulk_flux", "lmd_vmix", "swfrac", "my25_corstep",
                       "apply_sediment", "apply_biology", "set_massflux"),
          "ops.nearshore": ("radiation_stress", "radiation_stress08"),
          "ops.bbl": ("bblm", "bblm_mb", "bblm_sg"),
          "ops.mix3d": ("t3dmix2", "t3dmix4", "t3dmix2_iso", "t3dmix4_iso",
                        "t3dmix4_geo", "uv3dmix4", "uv3dmix2_geo",
                        "uv3dmix4_geo"),
          "ops.prsgrd": ("prsgrd",),
          "vgrid": ("set_depth",),
          "ops.step2d": ("fast_loop",),
          "ops.step3d_cuda": ("tracer_predictor_plain", "uv_corrector_plain",
                              "tracer_corrector_plain"),
          "ops.gls": ("gls_prestep", "gls_corstep"),
          "ops.diag_cuda": ("grid_flux_plain", "eos_plain", "omega_plain")}
REGIONAL = ("kelvin", "estuary", "riverplume")
OPERATORS = ("basin", "double_gyre", "grav_adj", "seamount", "canyon3d",
             "overflow", "windbasin", "channel_neck")
CASES2 = ("channel", "lmd_test", "mixed_layer", "test_chan", "riverplume2",
          "weddell", "bl_test", "sed_test1", "flt_test", "shoreface")
# the module of models/ that builds each case of --case
MODULE = {**dict.fromkeys(REGIONAL + OPERATORS, "cases"),
          **dict.fromkeys(CASES2, "cases2"),
          "channel_neck": "cases4", "lab_canyon": "cases4",
          "lake_signell": "cases"}
# the biology models on UPWELLING (models/bio_toy.SETUPS)
BIO_SETUPS = ("npzd_franks", "npzd_iron", "fennel", "fennel_oxygen_carbon",
              "hypoxia_srm", "nemuro", "red_tide", "ecosim")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--case", choices=("upwelling", "benchmark", "sed_toy",
                                       "bio_toy") + tuple(MODULE) +
                    BIO_SETUPS,
                    default="upwelling")
    ap.add_argument("--root", default=os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))))
    args = ap.parse_args()
    root = args.root
    sys.path.insert(0, root)
    import torch
    from torch.utils._python_dispatch import (TorchDispatchMode,
                                              _disable_current_modes)
    from roms_tpu_torch import stepping
    from roms_tpu_torch.models import upwelling
    torch.set_num_threads(2)

    counts = collections.Counter()
    stage = ["other"]

    class Count(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, a=(), k=None):
            if func._overloadpacket.__name__ not in NO_LAUNCH:
                counts[stage[0]] += 1
            return func(*a, **(k or {}))

    def span(name, fn, kernel):
        def call(*a, **kw):
            outer, stage[0] = stage[0], name
            try:
                if not kernel:
                    return fn(*a, **kw)
                counts["kernel " + name] += 1
                with _disable_current_modes():
                    return fn(*a, **kw)
            finally:
                stage[0] = outer
        return call

    for mod_name, names in WRAPPERS.items():
        try:
            mod = importlib.import_module("roms_tpu_torch.ops." + mod_name)
        except ImportError:
            continue
        for name in names:
            if not hasattr(mod, name):
                continue
            plain = getattr(mod, name + "_plain")
            setattr(mod, name, span(name, plain, True))
        if mod_name == "rhs3d_cuda":
            # momentum_rhs: the card's chain of wrappers, not its plain one
            mod.on_card = lambda t: True
    for mod_name, names in STAGES.items():
        try:
            mod = importlib.import_module("roms_tpu_torch." + mod_name)
        except ImportError:
            continue
        for name in names:
            if hasattr(mod, name):
                setattr(mod, name, span(name, getattr(mod, name), False))

    if args.case in MODULE:
        mod = importlib.import_module("roms_tpu_torch.models." +
                                      MODULE[args.case])
        cfg, grid, s, ffn = getattr(mod, args.case)(
            getattr(mod, args.case + "_config")(dtype="float32"),
            device="cpu")
    elif args.case == "sed_toy":
        from roms_tpu_torch.models import sed_toy
        cfg, grid, s, ffn = sed_toy.build(
            sed_toy.make_config(dtype="float32"), device="cpu")
    elif args.case == "bio_toy":
        from roms_tpu_torch.models import bio_toy
        cfg, grid, s, ffn = bio_toy.build(
            bio_toy.make_config(dtype="float32"), device="cpu")
    elif args.case in BIO_SETUPS:
        from roms_tpu_torch.models import bio_toy
        cfg, grid, s, ffn = bio_toy.build_model(
            args.case, bio_toy.model_config(args.case, dtype="float32"),
            device="cpu")
    elif args.case == "benchmark":
        from roms_tpu_torch.models import benchmark
        cfg, grid, s, ffn = benchmark.build(
            benchmark.make_config(Lm=64, Mm=32, dtype="float32"),
            device="cpu")
    else:
        cfg, grid, s, ffn = upwelling.build(
            upwelling.make_config(dtype="float32"), device="cpu")
    s = stepping.run(cfg, grid, s, 3, ffn)
    counts.clear()
    with Count():
        stepping.step(cfg, grid, s, ffn)
    for key, n in sorted(counts.items(), key=lambda kv: -kv[1]):
        print(f"{n:5d}  {key}")
    print(f"{sum(counts.values()):5d}  launches a step")
    return 0


if __name__ == "__main__":
    sys.exit(main())
