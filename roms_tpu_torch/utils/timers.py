"""Region-based wall-clock profiler.

Counterpart of ``roms_tpu/utils/timers.py``: the reference's
wclock_on/wclock_off region profiler (ROMS/Utility/timers.F:2-564; region
taxonomy in mod_strings.F:162-240).  Named regions accumulate wall time
and are reported as a percentage table.  For device detail use `trace()`,
which wraps torch.profiler.
"""

from __future__ import annotations

import contextlib
import os
import tempfile
import time
from collections import defaultdict
from typing import Optional

import torch


class Profiler:
    def __init__(self):
        self.acc = defaultdict(float)
        self.calls = defaultdict(int)
        self._t0 = time.perf_counter()

    @contextlib.contextmanager
    def region(self, name: str, sync: bool = False):
        """Accumulate wall time of a named region.  sync=True waits for the
        card's queued work so the time is attributable (use sparingly)."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if sync and torch.cuda.is_initialized():
                torch.cuda.synchronize()
            self.acc[name] += time.perf_counter() - t0
            self.calls[name] += 1

    def report(self) -> str:
        """Percentage table like the reference's finalize report."""
        total = time.perf_counter() - self._t0
        lines = ["", " Elapsed wall CPU time for each process (seconds):",
                 ""]
        for name, t in sorted(self.acc.items(), key=lambda kv: -kv[1]):
            lines.append(f"  {name:<42s} {t:12.3f}  "
                         f"({100.0 * t / max(total, 1e-12):6.4f} %)")
        lines.append(f"  {'Total':<42s} {total:12.3f}")
        return "\n".join(lines)


@contextlib.contextmanager
def trace(logdir: Optional[str] = None):
    """torch.profiler trace of the host and, where there is one, the card;
    written to logdir/trace.json (Chrome trace format; default logdir
    roms_tpu_torch_trace under the temporary directory)."""
    if logdir is None:
        logdir = os.path.join(tempfile.gettempdir(), "roms_tpu_torch_trace")
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
