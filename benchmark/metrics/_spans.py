"""What the span readers share (``step_ms``, the group readers,
``engine_idle_ms``, ``k3_counted_roofline_pct``): the program's span
recorder (``nbody_tpu_torch/utils/profiling.py`` ``SPANS``), switched on
when a reader is imported, and the copies of its ring and of the kernel
wrappers' pair tally (``nbody_tpu_torch/ops/work.py`` ``TALLY``) that the
harness takes at the traced slice's two ends (``COUNTERS``).

The recorder records one step in ``EVERY`` (the others cost it a counter
and a flag each): recording every step cost the 100k cell 4-11% of its
rate on the card, one in four 3-7%, one in eight 1-2% (PERF.md).  The
tally counts every K3 call.

``manifest.metrics_for`` imports the per-layer readers in ``--trace 1``
runs only, before set-up, so the recorder runs through the whole of such a
run and through no ``--trace 0`` run; a reader's ``read`` switches it off
again once the run is over.  A program without the recorder gives the
readers nothing to copy, and they read nothing.

A step's record is its ``step`` span and every span inside it; a group is
the phases of some names summed over a step, each on the card's timeline
(from the stream reaching the phase's opening to reaching its close: its
work and the idle in which the card waited for it).  The span readers take
the median over the last ``LAST`` recorded steps resolved before the slice
started: the recorder on, the profiler not yet, so the host runs at its
untraced pace.
"""

import importlib
import statistics

PROFILING = "nbody_tpu_torch.utils.profiling"
WORK = "nbody_tpu_torch.ops.work"
LAST = 256
EVERY = 8

#: the marks (``mark``) and spans of each group
GROUPS = {
    "step": ("step",),
    "build": ("build", "refined build"),
    "walk": ("walk", "regather"),
    "fb_eval": ("fb",),
    "assembly": ("assembly+dual",),
    "kernels": ("K3", "K4 dual", "K5", "K4"),
}


def _module(name):
    try:
        return importlib.import_module(name)
    except ImportError:
        return None


_profiling = _module(PROFILING)
RECORDER = getattr(_profiling, "SPANS", None)
if RECORDER is not None:
    RECORDER.enable(every=EVERY)

RING = [(PROFILING, "RECORDS")] if hasattr(_profiling, "RECORDS") else []
TALLY = [(WORK, "TALLY")] if hasattr(_module(WORK), "TALLY") else []


def done():
    """The run is over once its readers read: the recorder goes off (the
    CPU tests run many cells in one process)."""
    if RECORDER is not None:
        RECORDER.disable()


def copied(run, spec, end: int):
    """The copy of ``spec`` = [(module, attr)] taken at the traced slice's
    start (``end`` 0) or end (1), or None."""
    if run.slice is None or not spec:
        return None
    pair = run.slice.counters.get("{}:{}".format(*spec[0]))
    return None if pair is None else pair[end]


def group_ms(run, group: str):
    """The median over the last ``LAST`` recorded steps resolved before the
    slice of the group's ms a step, or None."""
    done()
    records = copied(run, RING, 0)
    if not records:
        return None
    names = GROUPS[group]
    steps = [r for r in records
             if r["root"] == "step" and r["spans"][0][4] is not None][-LAST:]
    if not steps:
        return None
    return statistics.median(sum(s[4] for s in r["spans"] if s[0] in names)
                             for r in steps)
