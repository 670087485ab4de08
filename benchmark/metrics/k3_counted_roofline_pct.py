"""k3_counted_roofline_pct (program counter): ``k3_roofline_pct``'s share
with the pairs and bytes counted by the program: K3's (``csrc/
group_force.cu`` ``group_force_kernel``) least possible time over the
slice, the larger of its pairs x 18 FP32 operations over 67 TFLOP/s and
its bytes over 3.35 TB/s (``harness/roofline.py``), over its device time in
the slice.  The pairs and bytes are the growth of the K3 wrappers' entries
of the program's tally (``nbody_tpu_torch/ops/work.py`` ``TALLY``: the
pairs each launch needs, summed on the card while the span recorder is on)
between the slice's two ends."""

from pathlib import Path

from harness import manifest, roofline
from harness.trace import kernel_base

spans = manifest.plugin("metrics", "_spans",
                        Path(__file__).resolve().parents[1])
COUNTERS = spans.TALLY
KERNEL = "group_force_kernel"
WRAPPERS = ("group_force", "group_force_masked")


def read(run):
    spans.done()
    sl = run.slice
    before = spans.copied(run, COUNTERS, 0)
    after = spans.copied(run, COUNTERS, 1)
    if after is None or sl.steps <= 0:
        return None
    pairs = nbytes = 0
    for name in WRAPPERS:
        if name in after:
            b = before.get(name, {"pairs": 0, "bytes": 0})
            pairs += int(after[name]["pairs"]) - int(b["pairs"])
            nbytes += after[name]["bytes"] - b["bytes"]
    dev_s = sum(op[3] for op in sl.device_ops
                if kernel_base(op[0]) == KERNEL) * 1e-6
    if pairs <= 0 or dev_s <= 0:
        return None
    return 100.0 * roofline.bound_s(pairs, "pair", nbytes)[0] / dev_s
