"""Wall-time profiling scopes: the torch counterpart of
dflo_tpu/utils/profiling.py.

Equivalent of the MPI tree's deal.II TimerOutput (named scopes "Setup",
"Time loop", "Output" with a summary table printed at exit,
src_mpi/claw.cc:966-967).  A scope is also a ``torch.profiler`` record
function, so it shows up in a device trace.  On the card a scope must
synchronize (pass a CUDA tensor as ``block``) or it only times the launch.

Usage:
    timer = Timer()
    with timer("Time loop", block=u):
        u = step(u)
    print(timer.summary())
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict

import torch


class Timer:
    def __init__(self):
        self._acc = defaultdict(float)
        self._calls = defaultdict(int)
        self._t0 = time.perf_counter()

    @contextlib.contextmanager
    def __call__(self, name: str, block=None):
        with torch.profiler.record_function(name):
            t0 = time.perf_counter()
            try:
                yield
            finally:
                if isinstance(block, torch.Tensor) and block.is_cuda:
                    torch.cuda.synchronize(block.device)
                self._acc[name] += time.perf_counter() - t0
                self._calls[name] += 1

    def summary(self) -> str:
        """Wall-time table like TimerOutput's rank-0 summary."""
        total = time.perf_counter() - self._t0
        lines = [f"{'Section':<24}{'calls':>8}{'wall (s)':>12}{'%':>7}"]
        lines.append("-" * 51)
        for name in sorted(self._acc, key=self._acc.get, reverse=True):
            w = self._acc[name]
            lines.append(f"{name:<24}{self._calls[name]:>8}{w:>12.3f}"
                         f"{100.0 * w / total:>6.1f}%")
        lines.append("-" * 51)
        lines.append(f"{'total wall':<24}{'':>8}{total:>12.3f}")
        return "\n".join(lines)


@contextlib.contextmanager
def device_trace(logdir: str):
    """Capture a torch.profiler trace (CPU, and CUDA where there is a card)
    and write it to logdir/trace.json (Chrome trace format, for Perfetto or
    chrome://tracing)."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
