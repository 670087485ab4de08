"""viewed_steps_per_s (end to end, host clock): the steps the visualizer's
stepping thread completed in the window while one viewer polled it, over
the window's wall time; the harness counts the thread's
``Simulation.step`` calls itself (``drivers/view.py``).  It is how fast
the simulation advances on the viewer's screen: a sync a step, the
positions readback and the boxes' build on the same stream all slow it."""


def read(run):
    w = run.window
    if "viewed_steps" not in w:
        return None
    return w["viewed_steps"] / w["seconds"]
