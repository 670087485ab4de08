"""fb_eval_ms (program span): the fb_eval group, the mark "fb"
(``ops/traversal.py`` ``_fb_eval``: the fallback rows' exact multipoles), on
the card's timeline, in ms a step: the median over the last steps resolved
before the traced slice (``_spans.py``)."""

from pathlib import Path

from harness import manifest

spans = manifest.plugin("metrics", "_spans",
                        Path(__file__).resolve().parents[1])
COUNTERS = spans.RING


def read(run):
    return spans.group_ms(run, "fb_eval")
