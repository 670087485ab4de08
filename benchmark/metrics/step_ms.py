"""step_ms (program span): the ``step`` span (``core/stepper.py``: drift, force
and kick), on the card's timeline, in ms a step: the median over the last
steps resolved before the traced slice (``_spans.py``)."""

from pathlib import Path

from harness import manifest

spans = manifest.plugin("metrics", "_spans",
                        Path(__file__).resolve().parents[1])
COUNTERS = spans.RING


def read(run):
    return spans.group_ms(run, "step")
