"""device_idle_pct (device trace): the share of the window's time in which
no operation ran on the card, outside the traced slice: 1 - (the card's
busy time a step in the slice, the union of its operations' intervals over
its steps) x (steps a second of the window outside the slice and the
profiler's start and stop).  Tracing slows the host (about 3x at 100k), so
the slice's own idle share (``busy_s`` over ``window_s``) overstates what
an untraced run leaves idle; the busy time a step does not depend on the
host's pace."""


def read(run):
    sl, w = run.slice, run.window
    if sl is None or sl.steps <= 0 or "steps" not in w:
        return None
    rest_steps = w["steps"] - sl.steps
    rest_s = w["seconds"] - sl.wall_s - sl.stall_s
    if rest_steps <= 0 or rest_s <= 0:
        return None
    return 100.0 * (1.0 - sl.busy_s / sl.steps * rest_steps / rest_s)
