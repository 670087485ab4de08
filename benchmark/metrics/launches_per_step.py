"""launches_per_step (device trace): the kernels that ran on the card in
the traced slice over the steps in it: the host's dispatch work a step."""


def read(run):
    sl = run.slice
    if sl is None or sl.steps <= 0:
        return None
    return sum(1 for op in sl.device_ops if op[1] == "kernel") / sl.steps
