"""steps_per_s (end to end, host clock): every step the window completed
over the window's wall time, which ends in ``torch.cuda.synchronize()``."""


def read(run):
    w = run.window
    if "steps" not in w:
        return None
    return w["steps"] / w["seconds"]
