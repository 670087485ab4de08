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
  * ``flops_of``        the work of one call: the kernels' pair counts and
                        bytes from their launch shapes, plus the aten ops
                        that ``FlopCounterMode`` counts around them;
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
    """The work of one call ``fn(*args, **kwargs)``, which runs once:
    ``{"flops", "bytes_accessed"}`` (the JAX package's keys) and
    ``"kernel_flops"``, the kernels' share by wrapper name.

    Counted, in this thread only:
      * each call of a kernel wrapper (``ops/pairwise.py``,
        ``ops/group_force.py``): the pairs its inputs need times the FP32
        operations a pair (``ops/work.py`` ``PAIR_OPS``: 18 one-directional,
        25 Newton-3, 49 quadrupole, 19 norm trick), and its bytes, each
        input read once and each output written once; the same whether it
        launches its kernel or runs its plain twin on the CPU (the twin's
        own aten ops are not counted again);
      * ``torch.utils.flop_counter.FlopCounterMode``'s flops of the aten ops
        around them: matrix products, convolutions and attention.
    Not counted: elementwise work, reductions, sorts, gathers and scatters,
    and any bytes but the kernels'.  The kernels launch through ctypes, so
    ``FlopCounterMode`` alone would count none of them.  XLA's cost
    analysis (the JAX package's ``flops_of``) counts elementwise work and
    every buffer's bytes and lowers without running, so the two numbers are
    not comparable.  The pair counts read the masses back, so on the card
    the call runs with host syncs a plain call would not make."""
    from torch.utils.flop_counter import FlopCounterMode

    from nbody_tpu_torch.ops import work

    aten = FlopCounterMode(display=False)
    with aten, work.counting(aten) as count:
        fn(*args, **kwargs)
    kernel = sum(count.flops.values())
    return {
        "flops": kernel + aten.get_total_flops() - count.twin_aten,
        "bytes_accessed": count.bytes,
        "kernel_flops": dict(count.flops),
    }
