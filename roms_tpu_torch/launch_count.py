"""Count the device launches one UPWELLING step of roms_tpu_torch makes on a
card, from a CPU run: the step's aten operations under a TorchDispatchMode,
less views and other operations that launch nothing, plus one launch for
each kernel-wrapper call (whose plain version then runs uncounted).  The
momentum phase takes the chain it takes on the card.

    python roms_tpu_torch/launch_count.py [--root CHECKOUT]

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
    "mix3d_cuda": ("uv3dmix2",),
}
# plain stages the step calls by name, counted op by op
STAGES = {"stepping": ("set_vbc", "momentum_init", "rhs3d_momentum",
                       "uv3dmix2", "t3dmix2"),
          "vgrid": ("set_depth",)}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))))
    root = ap.parse_args().root
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
            plain = getattr(mod, name + "_plain")
            setattr(mod, name, span(name, plain, True))
        if mod_name == "rhs3d_cuda":
            # momentum_rhs: the card's chain of wrappers, not its plain one
            mod.on_card = lambda t: True
    for mod_name, names in STAGES.items():
        mod = importlib.import_module("roms_tpu_torch." + mod_name)
        for name in names:
            if hasattr(mod, name):
                setattr(mod, name, span(name, getattr(mod, name), False))

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
