"""nonkernel_device_ms (device trace): the device time a step of every
operation on the card other than the hand-written kernels K1-K6 (and the
pack and reduction kernels of their wrappers): the plain-torch build,
walk, fallback eval, assembly and integrator, in ms a step."""

from harness.trace import kernel_base

# the __global__ functions of nbody_tpu_torch/csrc/*.cu
HAND_WRITTEN = {"group_force_kernel", "quad_force_kernel",
                "acc_sym_tiles_kernel", "sym_reduce_kernel",
                "pack_sources_kernel", "acc_targets_kernel",
                "acc_mxu_kernel", "mxu_reduce_kernel", "rsqrt_sweep_kernel"}


def read(run):
    sl = run.slice
    if sl is None or sl.steps <= 0:
        return None
    us = sum(op[3] for op in sl.device_ops
             if kernel_base(op[0]) not in HAND_WRITTEN)
    return us * 1e-3 / sl.steps
