"""walk_ms (program span): the walk group, the marks "walk"
(``ops/traversal.py`` ``_walk``: the collect walk) and "regather" (a cached
step's node rows), on the card's timeline, in ms a step: the median over the
last steps resolved before the traced slice (``_spans.py``)."""

from pathlib import Path

from harness import manifest

spans = manifest.plugin("metrics", "_spans",
                        Path(__file__).resolve().parents[1])
COUNTERS = spans.RING


def read(run):
    return spans.group_ms(run, "walk")
