"""collective_mb_per_step (program counter): the bytes this rank's
collectives sent in the traced slice, in MB (10^6 bytes) a step: the
growth of the program's byte counter (``nbody_tpu_torch/ops/work.py``
``SENT``: each call of ``parallel/collectives.py`` above world size 1
adds the bytes the ring algorithm sends from this rank, known from the
shapes, while the span recorder is on) between the slice's two ends, over
the slice's steps.  Rank 0's.  A program without the counter, or a run
whose collectives sent nothing, reads nothing."""

from pathlib import Path

from harness import manifest

spans = manifest.plugin("metrics", "_spans",
                        Path(__file__).resolve().parents[1])
COUNTERS = ([(spans.WORK, "SENT")]
            if hasattr(spans._module(spans.WORK), "SENT") else [])


def read(run):
    spans.done()
    sl = run.slice
    before = spans.copied(run, COUNTERS, 0)
    after = spans.copied(run, COUNTERS, 1)
    if after is None or sl.steps <= 0:
        return None
    sent = sum(int(t["bytes"]) - int(before.get(k, {"bytes": 0})["bytes"])
               for k, t in after.items())
    if sent <= 0:
        return None
    return sent / 1e6 / sl.steps
