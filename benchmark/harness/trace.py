"""The traced slice of a ``--trace 1`` run: ``torch.profiler`` over a few
steady seconds inside the window, read back from its Chrome trace.

The slice starts and ends after a ``torch.cuda.synchronize()``, so it holds
whole steps; the traffic generator counts the steps in it.  What the
per-layer readers get (``Slice``):

  * ``device_ops``: every operation that ran on the card in the slice
    (kernels, copies, fills) as (name, category, start_us, dur_us);
  * ``busy_s``: the union of their intervals; ``wall_s``: the slice's
    length on the host's clock;
  * ``counters``: the program's counters the readers asked for, read at
    the slice's start and end;
  * ``breakdown``: the device operations that took the most time, and the
    longest idle gaps by the host operation that launched the work ending
    each gap.

The trace file is written under ``TMPDIR`` and deleted once read.
"""

from __future__ import annotations

import bisect
import copy
import importlib
import json
import os
import re
import tempfile
import time
from dataclasses import dataclass, field

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
TOP = 10


def _strip(name: str) -> str:
    name = re.sub(r"^void\s+", "", name)
    return name.replace("(anonymous namespace)::", "")


def kernel_base(name: str) -> str:
    """A device operation's bare name: ``void (anonymous namespace)::
    group_force_kernel<true, false>(float const*, ...)`` ->
    ``group_force_kernel``."""
    name = re.split(r"[<(]", _strip(name), maxsplit=1)[0].strip()
    return name.rsplit("::", 1)[-1]


def display_name(name: str, width: int = 120) -> str:
    """A device operation's name for the breakdown: without its return
    type and argument list, template arguments kept, cut to ``width``."""
    name = _strip(name)
    if name.endswith(")"):
        depth = 0
        for i in range(len(name) - 1, -1, -1):
            depth += {")": 1, "(": -1}.get(name[i], 0)
            if depth == 0:
                name = name[:i]
                break
    return name.strip()[:width]


def read_counters(specs) -> dict:
    """``{"module:attr": copy of the dict}`` for each (module, attr)."""
    out = {}
    for mod, attr in specs:
        out[f"{mod}:{attr}"] = copy.deepcopy(
            getattr(importlib.import_module(mod), attr))
    return out


@dataclass
class Slice:
    steps: int
    wall_s: float
    device_ops: list
    busy_s: float
    # the window's seconds spent starting and stopping the profiler (the
    # stop collects the trace), which no step runs in
    stall_s: float = 0.0
    counters: dict = field(default_factory=dict)  # key -> (before, after)
    breakdown: dict = field(default_factory=dict)


class Tracer:
    """The traced slice of a window: the card's operations alone for
    ``seconds`` in the window's middle, at step boundaries (the traffic
    generator calls ``poll`` with the seconds since the window's start
    between its steps, and ``finish`` at its end).  Every metric and
    ``busy_s`` read this slice.  Recording the host's operations too would
    slow the host more (at 100k about 4x against 3x), so the idle gaps of
    the breakdown are labelled from a few steps traced with the host's
    operations during set-up (``label_gaps``), which a ``--trace 1`` run
    does not report."""

    def __init__(self, card, counter_specs, steps_fn, seconds: float,
                 window_s: float):
        self.card = card
        self.specs = counter_specs
        self.steps_fn = steps_fn
        self.seconds = seconds
        self.t_on = max(0.0, (window_s - seconds) / 2)
        self.phase = "wait"
        self.gaps = []
        # a profiler's first start in either configuration sets CUPTI up
        # for seconds: both in set-up, not in the window
        for host in (True, False):
            with self._profile(host):
                card.torch.ones(1, device=card.device).add_(1)
                card.sync()

    def _profile(self, host: bool):
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU] if host else []
        if self.card.device == "cuda":
            acts.append(ProfilerActivity.CUDA)
        elif not host:
            acts.append(ProfilerActivity.CPU)
        return profile(activities=acts)

    def label_gaps(self, step, n: int):
        """Set-up: ``n`` calls of ``step`` traced with the host's
        operations, read for the breakdown's idle gaps."""
        with self._profile(True) as prof:
            for _ in range(n):
                step()
            self.card.sync()
        self.gaps = idle_gaps(_events(prof))

    def poll(self, now: float):
        if self.phase == "wait" and now >= self.t_on:
            self.card.sync()
            self.c0 = read_counters(self.specs)
            self.s0 = self.steps_fn()
            self.dev = self._profile(False)
            t = time.perf_counter()
            self.dev.start()
            self.t0 = time.perf_counter()
            self.stall = self.t0 - t
            self.phase = "device"
        elif self.phase == "device" and now >= self.t_on + self.seconds:
            self.finish()

    def finish(self):
        """End the slice (at the window's end at the latest)."""
        if self.phase == "device":
            self.card.sync()
            t = time.perf_counter()
            self.wall = t - self.t0
            self.dev.stop()
            self.stall += time.perf_counter() - t
            self.steps = self.steps_fn() - self.s0
            self.c1 = read_counters(self.specs)
            self.phase = "done"

    def read(self) -> Slice:
        if self.phase != "done":
            raise RuntimeError("the window ended before its traced slice")
        sl = parse(_events(self.dev), self.steps, self.wall)
        sl.stall_s = self.stall
        sl.counters = {k: (self.c0[k], self.c1[k]) for k in self.c0}
        sl.breakdown["idle_gaps"] = self.gaps
        return sl


def _events(prof) -> list:
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            data = json.load(f)
    finally:
        os.unlink(path)
    return data["traceEvents"] if isinstance(data, dict) else data


def _union(intervals):
    """Merged [start, end] intervals of sorted (start, end) pairs."""
    out = []
    for s, e in intervals:
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def parse(events, steps: int, wall_s: float) -> Slice:
    ops = _device_ops(events)
    merged = _union([(o[2], o[2] + o[3]) for o in ops])
    busy_us = sum(e - s for s, e in merged)
    sl = Slice(steps=steps, wall_s=wall_s,
               device_ops=[o[:4] for o in ops], busy_s=busy_us * 1e-6)

    by_name = {}
    for name, _, _, dur, _ in ops:
        k = display_name(name)
        by_name[k] = by_name.get(k, 0.0) + dur * 1e-6
    top_ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]

    sl.breakdown = {"device_ops": [[k, v] for k, v in top_ops]}
    return sl


def _device_ops(events) -> list:
    dev = [e for e in events
           if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS]
    return sorted(((e["name"], e["cat"], float(e["ts"]), float(e["dur"]),
                    (e.get("args") or {}).get("correlation"))
                   for e in dev), key=lambda o: o[2])


def idle_gaps(events) -> list:
    """The idle time between the card's operations, summed by the host
    operation around the launch of the operation that ends each gap: the
    innermost one on the launching thread (the profiler records the host
    operations of the thread that started it, so a launch from another
    thread, as the visualizer's stepping thread, or through ctypes outside
    any aten operation has none).  The ``TOP`` largest sums."""
    ops = _device_ops(events)
    merged = _union([(o[2], o[2] + o[3]) for o in ops])
    launches = {(e.get("args") or {}).get("correlation"): e for e in events
                if e.get("ph") == "X" and e.get("cat") in (
                    "cuda_runtime", "cuda_driver")}
    host = {}
    for e in events:
        if e.get("ph") == "X" and e.get("cat") in ("cpu_op",
                                                  "user_annotation"):
            host.setdefault(e.get("tid"), []).append(
                (float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                 e["name"]))
    for v in host.values():
        v.sort()
    starts = {tid: [o[0] for o in v] for tid, v in host.items()}
    first_op = {}
    for o in ops:  # the first operation starting at each merged start
        first_op.setdefault(o[2], o)
    by_label = {}
    for (_, e0), (s1, _) in zip(merged, merged[1:]):
        label = "no host operation recorded around the launch"
        op = first_op.get(s1)
        launch = launches.get(op[4]) if op else None
        if launch is not None:
            tid, t = launch.get("tid"), float(launch["ts"])
            v = host.get(tid, [])
            i = bisect.bisect_right(starts.get(tid, []), t) - 1
            for j in range(i, max(i - 200, -1), -1):
                if v[j][1] >= t:
                    label = v[j][2]
                    break
        by_label[label] = by_label.get(label, 0.0) + (s1 - e0) * 1e-6
    return [[k, v] for k, v in sorted(by_label.items(),
                                      key=lambda kv: -kv[1])[:TOP]]
