"""ms/step of roms_tpu_torch on the card with the package of another tree,
so that two commits can be run in turns in one chip call (parent, tree,
tree, parent): chip_smoke.py's phase 5 (1440 float32 UPWELLING steps) and,
by default, phase 10 (200 float32 BENCHMARK1 steps); with
``--upwelling-profile``, phase 5 and phase 6 (torch.profiler over 10
UPWELLING steps: launches, device busy and idle, device time by kernel);
with ``--profiles``, phases 6 and 11 alone (the profiles of UPWELLING and
of 5 BENCHMARK1 steps).

    cd CHECKOUT && python3 scripts/torch_step_times.py TREE
    cd CHECKOUT && python3 scripts/torch_step_times.py TREE \\
        --upwelling-profile
    cd CHECKOUT && python3 scripts/torch_step_times.py TREE --profiles

TREE holds the roms_tpu_torch to time (a `git archive` checkout of
another commit, or `.`); chip_smoke.py comes from the current directory.
Needs a CUDA card.
"""

import os
import sys


def main() -> int:
    tree = os.path.abspath(sys.argv[1])
    sys.path.insert(0, tree)
    sys.path.insert(1, os.getcwd())
    import torch

    import chip_smoke
    import roms_tpu_torch

    print("[steps] roms_tpu_torch from",
          os.path.dirname(roms_tpu_torch.__file__), flush=True)
    dev = torch.device("cuda:0")
    name = torch.cuda.get_device_name(0)
    if "--profiles" in sys.argv[2:]:
        chip_smoke.profile(dev)
        chip_smoke.profile(dev, "benchmark")
        return 0
    chip_smoke.long_run(dev, name)
    if "--upwelling-profile" in sys.argv[2:]:
        chip_smoke.profile(dev)
    else:
        chip_smoke.bench_long_run(dev, name)
    return 0


if __name__ == "__main__":
    sys.exit(main())
