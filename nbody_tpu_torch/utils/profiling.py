"""Tracing, profiling and step telemetry (the counterpart of
``nbody_tpu/utils/profiling.py``):

  * ``trace(dir)``      context manager around ``torch.profiler``: host
                        activity, and the card's kernels when CUDA is
                        available; writes a Chrome-trace JSON into ``dir``
                        (open it in Perfetto or chrome://tracing);
  * ``annotate(name)``  a named span in such traces
                        (``torch.profiler.record_function``);
  * ``StepTimer``       host-side ring-buffer telemetry (steps/s, mean, p50
                        and p99 step latency);
  * ``flops_of``        not ported (it is XLA's cost analysis);
  * logging through the stdlib logger "nbody_tpu".

Nothing here falls back: a profiler that does not start raises.
"""

from __future__ import annotations

import contextlib
import logging
import os
import statistics
import time
from collections import deque

import torch

log = logging.getLogger("nbody_tpu")


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile a region into a Chrome-trace JSON file in ``log_dir``
    (created if missing): host activity, and the card's when CUDA is
    available.  Yields the profiler; the file is written when the region
    ends, and its path logged."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    path = os.path.join(log_dir, f"trace.{os.getpid()}."
                        f"{time.time_ns()}.json")
    prof.export_chrome_trace(path)
    log.info("profiler trace written to %s", path)


def annotate(name: str):
    """Named span visible in profiler traces."""
    return torch.profiler.record_function(name)


class StepTimer:
    """Ring-buffer step telemetry: time each step with ``with timer:``."""

    def __init__(self, window: int = 60):
        self.samples = deque(maxlen=window)
        self._t0 = None

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.samples.append(time.perf_counter() - self._t0)

    @property
    def steps_per_second(self) -> float:
        if not self.samples:
            return 0.0
        return len(self.samples) / max(sum(self.samples), 1e-12)

    def summary(self) -> dict:
        if not self.samples:
            return {}
        s = sorted(self.samples)
        return {
            "steps_per_second": round(self.steps_per_second, 3),
            "mean_ms": round(statistics.mean(s) * 1e3, 3),
            "p50_ms": round(s[len(s) // 2] * 1e3, 3),
            "p99_ms": round(s[min(len(s) - 1, int(len(s) * 0.99))] * 1e3, 3),
        }


def flops_of(fn, *args, **kwargs) -> dict:
    """The JAX package's ``flops_of`` is XLA's cost analysis of a compiled
    program; torch's flop counter cannot see the hand-written kernels, so
    it is not ported."""
    raise NotImplementedError(
        "flops_of (XLA cost analysis) is not yet ported to nbody_tpu_torch "
        "(ROADMAP.md, queue 1, item 14)")
