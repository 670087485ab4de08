"""k3_roofline_pct (device trace): K3's (``csrc/group_force.cu``
``group_force_kernel``) least possible time a step over its device time a
step.  The least time is the larger of the step's K3 operations (the pairs
its launch shapes need, ``harness/roofline.py`` ``k3_work``, x 18 FP32
operations a pair) over 67 TFLOP/s and its bytes over 3.35 TB/s, counted on
the calls of the step after the window (``SPY``: the wrapper's arguments);
the device time is K3's in the traced slice over the steps in it."""

from harness import roofline
from harness.trace import kernel_base

SPY = [("nbody_tpu_torch.ops.group_force", "group_force")]
KERNEL = "group_force_kernel"


def read(run):
    sl = run.slice
    calls = run.spied.get("nbody_tpu_torch.ops.group_force:group_force")
    if sl is None or sl.steps <= 0 or not calls:
        return None
    dev_s = sum(op[3] for op in sl.device_ops
                if kernel_base(op[0]) == KERNEL) * 1e-6 / sl.steps
    if dev_s <= 0:
        return None
    least = 0.0
    for args, kw in calls:
        pairs, nbytes = roofline.k3_work(args[0], args[1], kw["tile"],
                                         kw.get("mask"))
        least += roofline.bound_s(pairs, "pair", nbytes)[0]
    return 100.0 * least / dev_s
