"""build_ms (program span): the build group, the marks "build" and "refined
build" (``ops/tree.py`` ``build_octree``: the Morton sort, the leaf
statistics, the pyramid and its quadrupoles), on the card's timeline, in ms
a step: the median over the last steps resolved before the traced slice
(``_spans.py``)."""

from pathlib import Path

from harness import manifest

spans = manifest.plugin("metrics", "_spans",
                        Path(__file__).resolve().parents[1])
COUNTERS = spans.RING


def read(run):
    return spans.group_ms(run, "build")
