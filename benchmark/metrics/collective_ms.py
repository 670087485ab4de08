"""collective_ms (program span): the ``collective`` spans of a step (one
around each call of ``parallel/collectives.py`` above world size 1:
``all_gather``, ``psum``, ``psum_scatter``, ``ring_shift``; on the card's
timeline, from the stream reaching the call to the stream having its
result), summed, in ms a step: the median over the last steps resolved
before the traced slice (``_spans.py``).  Rank 0's.  A run with no such
span (one card, or a program that records none) reads nothing."""

import statistics
from pathlib import Path

from harness import manifest

spans = manifest.plugin("metrics", "_spans",
                        Path(__file__).resolve().parents[1])
COUNTERS = spans.RING
SPAN = "collective"


def read(run):
    spans.done()
    records = spans.copied(run, COUNTERS, 0)
    if not records:
        return None
    steps = [r for r in records
             if r["root"] == "step" and r["spans"][0][4] is not None
             ][-spans.LAST:]
    if not any(s[0] == SPAN for r in steps for s in r["spans"]):
        return None
    return statistics.median(sum(s[4] for s in r["spans"] if s[0] == SPAN)
                             for r in steps)
