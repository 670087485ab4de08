"""kernels_ms (program span): the kernels group, the marks "K3", "K4 dual",
"K5" and "K4" (the kernel wrappers' calls: on the card their launches and
the kernels' time), on the card's timeline, in ms a step: the median over
the last steps resolved before the traced slice (``_spans.py``)."""

from pathlib import Path

from harness import manifest

spans = manifest.plugin("metrics", "_spans",
                        Path(__file__).resolve().parents[1])
COUNTERS = spans.RING


def read(run):
    return spans.group_ms(run, "kernels")
