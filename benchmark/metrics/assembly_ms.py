"""assembly_ms (program span): the assembly group, the mark "assembly+dual"
(``ops/traversal.py``: the near lists, the slab's window and near rows, the
block-dual mask), on the card's timeline, in ms a step: the median over the
last steps resolved before the traced slice (``_spans.py``)."""

from pathlib import Path

from harness import manifest

spans = manifest.plugin("metrics", "_spans",
                        Path(__file__).resolve().parents[1])
COUNTERS = spans.RING


def read(run):
    return spans.group_ms(run, "assembly")
