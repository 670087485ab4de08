"""Tracing, the span recorder and the work count (the counterpart of
``nbody_tpu/utils/profiling.py``):

  * ``SPANS``             the span recorder, off by default
                          (``SPANS.enable(every=1)``, which records one
                          root span in ``every``, and ``SPANS.disable()``);
                          its ring ``RECORDS`` holds the last ``RING``
                          recorded root spans as plain numbers;
  * ``annotate(name)``    a span: ``with annotate("step", device): ...``;
                          nested spans are its children, per thread;
  * ``mark(name)``        closes the phase ``name`` of the innermost open
                          span: from its opening, or its last mark, to now;
  * ``within(name)``      a span inside the innermost open span that its
                          phases pass over: timed from an event of its own,
                          and the phase that a later ``mark`` closes holds
                          it (``parallel/collectives.py``'s "collective");
  * ``span_medians``      the median time a record of each span name;
  * ``trace(dir)``        ``torch.profiler`` around a region, with the
                          recorder on: host activity, the card's kernels
                          when CUDA is available, and the recorder's marked
                          phases, in one Chrome-trace JSON in ``dir`` (open
                          it in Perfetto or chrome://tracing);
  * ``flops_of``          the work of one call: the kernels' pair counts and
                          bytes from their launch shapes, plus the aten ops
                          that ``FlopCounterMode`` counts around them;
  * logging through the stdlib logger "nbody_tpu".

Off, a span or a mark costs one flag test: no clock, no event, no
allocation, nothing on the stream.  On, each span records its name, its
parent and its host start and end on ``time.time_ns()``, the clock of
``torch.profiler``'s Chrome trace (a trace's ``ts`` is that clock in us
less the file's ``baseTimeNanoseconds``), so the spans lie over any trace
of the same process.  A root span opened with a CUDA ``device`` also
records a timing event at each boundary on the current stream, and its
record gets each span's time on the card's timeline (from the stream
reaching the span's opening to reaching its close: its work and the idle
in which the card waited for it) once its last event has completed, read
without a sync at a later root's opening or by ``SPANS.resolve()``.
Elsewhere a span's time is its host time.  While a profiler runs, a span
also opens ``torch.profiler.record_function``; a mark's phase enters a
trace through ``trace``, which adds them from the record.  Inside a CUDA
graph capture the recorder must be off.

Nothing here falls back: a profiler that does not start raises.
"""

from __future__ import annotations

import contextlib
import json
import logging
import os
import statistics
import threading
import time
from collections import deque

import torch

log = logging.getLogger("nbody_tpu")

#: records the ring keeps: ~14 s of 100k ``bh`` steps on the card, each
#: recorded, ~55 s at one in four
RING = 512

_OFF = contextlib.nullcontext()


class _Open:
    """A root span's record while it is open: its spans (the ring's lists),
    the index of each span's (opening, closing) event in ``evs``, the
    events in the order they were recorded, and their stream (None off
    the card)."""

    __slots__ = ("spans", "ix", "evs", "stream")

    def __init__(self, stream):
        self.spans, self.ix, self.evs, self.stream = [], [], [], stream


class _Frame:
    """An open span on its thread's stack, with the boundary its next mark
    starts from (its opening, last mark or last child's close; a
    ``within`` child's close leaves it)."""

    __slots__ = ("rec", "index", "t", "ev", "rf", "within")

    def __init__(self, rec, index, t, ev, rf, within=False):
        self.rec, self.index, self.t, self.ev, self.rf = rec, index, t, ev, rf
        self.within = within


class SpanRecorder:
    """The program's spans.  ``records`` (``RECORDS``) holds, oldest first,
    one dict a closed root span: ``root`` (its name), ``tid`` (the native
    thread id, a trace's ``tid``) and ``spans``, lists ``[name, parent,
    t0_ns, t1_ns, card_ms, marked]`` in opening order (the root first,
    ``parent`` an index into them, -1 for the root; ``marked``: closed by
    ``mark``).  ``card_ms`` is None until the record's events have
    completed.  Nothing but plain numbers lives there, so a copy of it
    (``copy.deepcopy``) is a snapshot.

    On the card a span opens at its record's last event (what was enqueued
    since belongs to it), so the children of a span that runs nothing
    between them sum to it; each close and mark records one event.  A
    ``within`` span records one more event, at its opening."""

    def __init__(self):
        self.on = False
        self.every = 1
        self._roots = 0
        self.records = deque(maxlen=RING)
        self._pending = deque()  # (record, _Open) waiting for the card
        self._pool = []          # timing events free for reuse
        self._local = threading.local()
        self._lock = threading.Lock()

    def enable(self, every: int = 1):
        """Record from now on, one root span in ``every`` (with the spans
        inside it; the others cost a counter and a flag each)."""
        self.every = every
        self.on = True

    def disable(self):
        self.on = False

    def clear(self):
        """Forget every record (and the pending ones)."""
        with self._lock:
            self.records.clear()
            self._pending.clear()

    def _frames(self) -> list:
        try:
            return self._local.frames
        except AttributeError:
            self._local.frames = []
            return self._local.frames

    def _event(self, rec: _Open) -> int:
        try:
            ev = self._pool.pop()
        except IndexError:
            ev = torch.cuda.Event(enable_timing=True)
        ev.record(rec.stream)
        rec.evs.append(ev)
        return len(rec.evs) - 1

    def _open(self, name: str, device, within: bool = False):
        frames = self._frames()
        if frames:
            if frames[-1] is None:  # inside a root left out
                frames.append(None)
                return
            t = time.time_ns()
            rec, parent = frames[-1].rec, frames[-1].index
            ev = (self._event(rec) if within and rec.stream is not None
                  else len(rec.evs) - 1)
        elif within:  # outside every span: not recorded
            frames.append(None)
            return
        else:
            self._roots += 1
            if self._roots % self.every:
                frames.append(None)
                return
            self._resolve()
            t = time.time_ns()
            cuda = device is not None and torch.device(device).type == "cuda"
            rec = _Open(torch.cuda.current_stream(device) if cuda else None)
            parent = -1
            ev = self._event(rec) if cuda else -1
        rec.spans.append([name, parent, t, None, None, False])
        rec.ix.append([ev, None])
        rf = None
        if torch.autograd._profiler_enabled():
            rf = torch.profiler.record_function(name)
            rf.__enter__()
        frames.append(_Frame(rec, len(rec.spans) - 1, t, ev, rf, within))

    def _close(self):
        frames = self._frames()
        fr = frames.pop()
        if fr is None:
            return
        if fr.rf is not None:
            fr.rf.__exit__(None, None, None)
        rec = fr.rec
        t = time.time_ns()
        ev = -1 if rec.stream is None else self._event(rec)
        rec.spans[fr.index][3] = t
        rec.ix[fr.index][1] = ev
        if frames:
            if not fr.within:
                frames[-1].t, frames[-1].ev = t, ev
        else:
            self._finish(rec)

    def mark(self, name: str):
        """Close the phase ``name`` of this thread's innermost open span:
        from that span's opening, or its last mark, to now."""
        if not self.on:
            return
        frames = self._frames()
        if not frames or frames[-1] is None:
            return
        fr = frames[-1]
        rec = fr.rec
        t = time.time_ns()
        ev = -1 if rec.stream is None else self._event(rec)
        rec.spans.append([name, fr.index, fr.t, t, None, True])
        rec.ix.append([fr.ev, ev])
        fr.t, fr.ev = t, ev

    def _finish(self, rec: _Open):
        out = {"root": rec.spans[0][0], "tid": threading.get_native_id(),
               "spans": rec.spans}
        if rec.stream is None:
            for s in rec.spans:
                s[4] = (s[3] - s[2]) * 1e-6
        with self._lock:
            self.records.append(out)
            if rec.stream is not None:
                self._pending.append(rec)

    def _resolve(self):
        """Give each pending record whose last event (its root's close) has
        completed its card times, each event timed from the first; no
        sync."""
        with self._lock:
            while self._pending:
                rec = self._pending[0]
                evs = rec.evs
                if not evs[-1].query():
                    break
                self._pending.popleft()
                at = [0.0] + [evs[0].elapsed_time(e) for e in evs[1:]]
                for s, (i, j) in zip(rec.spans, rec.ix):
                    s[4] = at[j] - at[i]
                self._pool.extend(evs)

    def resolve(self) -> list:
        """The records, oldest first, with every completed one resolved
        (after a ``torch.cuda.synchronize()``, all of them)."""
        self._resolve()
        with self._lock:
            return list(self.records)


SPANS = SpanRecorder()
#: the recorder's ring (the benchmark's span readers copy it)
RECORDS = SPANS.records
mark = SPANS.mark


class _Span:
    __slots__ = ("name", "device", "within")

    def __init__(self, name, device, within=False):
        self.name, self.device, self.within = name, device, within

    def __enter__(self):
        SPANS._open(self.name, self.device, self.within)
        return self

    def __exit__(self, *exc):
        SPANS._close()


def annotate(name: str, device=None):
    """A span named ``name``: a child of this thread's innermost open span,
    or a root whose record times it on the card when ``device`` is a CUDA
    device.  With the recorder off, a context that does nothing."""
    if not SPANS.on:
        return _OFF
    return _Span(name, device)


def within(name: str):
    """A span named ``name`` inside this thread's innermost open span,
    which its phases pass over: on the card it is timed from an event
    recorded at its opening (not from the span's last boundary), and its
    close leaves the boundary of the span's next ``mark``, so that the
    phase the mark closes holds it.  Outside every span, and with the
    recorder off, a context that does nothing."""
    if not SPANS.on:
        return _OFF
    return _Span(name, None, within=True)


def span_medians(records, root: str = "step") -> dict:
    """``{name: median ms}`` over the resolved records of root span
    ``root``: each record's time of every span of that name summed (on the
    card's timeline where the record was timed there)."""
    per = {}
    rows = [r for r in records if r["root"] == root
            and r["spans"][0][4] is not None]
    for r in rows:
        sums = {}
        for s in r["spans"]:
            sums[s[0]] = sums.get(s[0], 0.0) + s[4]
        for k, v in sums.items():
            per.setdefault(k, []).append(v)
    return {k: statistics.median(v + [0.0] * (len(rows) - len(v)))
            for k, v in per.items()}


def _add_marked(path: str, records, since_ns: int):
    """Add the marked phases of ``records`` opened after ``since_ns`` to
    the Chrome trace at ``path`` as annotations of their thread."""
    with open(path) as f:
        data = json.load(f)
    base = data.get("baseTimeNanoseconds", 0)
    pid = os.getpid()
    events = data["traceEvents"]
    for r in records:
        if r["spans"][0][2] < since_ns:
            continue
        for name, _, t0, t1, _, marked in r["spans"]:
            if marked:
                events.append({"ph": "X", "cat": "user_annotation",
                               "name": name, "pid": pid, "tid": r["tid"],
                               "ts": (t0 - base) / 1e3,
                               "dur": (t1 - t0) / 1e3})
    with open(path, "w") as f:
        json.dump(data, f)


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile a region into a Chrome-trace JSON file in ``log_dir``
    (created if missing) with the span recorder on: host activity, the
    card's when CUDA is available, and the marked phases of the spans
    opened in the region.  Yields the profiler; the file is written when
    the region ends, and its path logged."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    was = SPANS.on, SPANS.every
    SPANS.enable()
    since = time.time_ns()
    try:
        with profile(activities=activities) as prof:
            yield prof
    finally:
        SPANS.on, SPANS.every = was
    path = os.path.join(log_dir, f"trace.{os.getpid()}."
                        f"{time.time_ns()}.json")
    prof.export_chrome_trace(path)
    _add_marked(path, SPANS.resolve(), since)
    log.info("profiler trace written to %s", path)


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
    not comparable.  The pair counts are read back once the call has
    returned, so on the card the call ends in a host sync."""
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
