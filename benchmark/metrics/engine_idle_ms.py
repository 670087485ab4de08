"""engine_idle_ms (program span): in the traced slice, the card's idle time
that falls inside the host interval of a recorded step's ``force`` span
(the engine's call, ``core/stepper.py``), over the recorded steps whose
``force`` lies in the slice, in ms a step.  The idle time is the gaps
between the union of the slice's device operations; the spans come from
the recorder's ring as copied at the slice's end (one step in
``_spans.EVERY``), laid over the trace on their shared clock
(``time.time_ns()``; the trace's ``ts`` is that clock in us less a base,
the epoch's seconds floored to 7889238, or none where the trace's times
are absolute).  The rest of the idle time is the integrator's, the
stepper's Python and the caller's loop."""

from pathlib import Path

from harness import manifest
from harness.trace import _union

spans = manifest.plugin("metrics", "_spans",
                        Path(__file__).resolve().parents[1])
COUNTERS = spans.RING
TRIMONTH_S = 7889238


def _base_ns(t_ns: int, last_ts_us: float) -> int:
    if last_ts_us > 1e14:  # the trace's times are absolute
        return 0
    return t_ns // 10**9 // TRIMONTH_S * TRIMONTH_S * 10**9


def read(run):
    spans.done()
    sl = run.slice
    records = spans.copied(run, COUNTERS, 1)
    if not records or not sl.device_ops:
        return None
    busy = _union(sorted((o[2], o[2] + o[3]) for o in sl.device_ops))
    lo, hi = busy[0][0], busy[-1][1]
    base = _base_ns(records[-1]["spans"][0][2], hi)
    force = sorted(
        ((t0 - base) / 1e3, (t1 - base) / 1e3)
        for r in records if r["root"] == "step"
        for name, _, t0, t1, _, _ in r["spans"] if name == "force")
    force = [f for f in force if lo <= f[0] and f[1] <= hi]
    if not force:
        return None
    idle_us, j = 0.0, 0
    for (_, g0), (g1, _) in zip(busy, busy[1:]):
        while j < len(force) and force[j][1] <= g0:
            j += 1
        k = j
        while k < len(force) and force[k][0] < g1:
            idle_us += min(g1, force[k][1]) - max(g0, force[k][0])
            k += 1
    return idle_us * 1e-3 / len(force)
