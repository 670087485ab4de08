"""Traffic kind ``batch``: what a user of ``Simulation.run`` or the CLI
does.  The window enqueues ``Simulation.run(chunk)`` calls with no host
sync until ``--seconds`` have passed, then waits for the card
(``torch.cuda.synchronize()``).

Parameters (the mix's file): ``chunk`` (steps a call), ``warm_steps``,
``engine_options`` (passed to ``Simulation``, e.g. ``walk_every``),
``trace_seconds`` and ``host_trace_steps`` (the traced slice of a
``--trace 1`` run, and the steps traced in its set-up to label idle gaps,
``harness/trace.py``).
"""

import time


class Driver:
    def __init__(self, sim, card, params: dict):
        self.sim, self.card, self.p = sim, card, params
        self.steps = 0

    def steps_done(self) -> int:
        return self.steps

    def step_once(self):
        self.sim.run(1)
        self.card.sync()

    def warm(self):
        self.sim.run(int(self.p["warm_steps"]))
        self.card.sync()

    def window(self, seconds: float, tracer=None) -> dict:
        sim, chunk = self.sim, int(self.p["chunk"])
        self.card.sync()
        t0 = time.perf_counter()
        while True:
            now = time.perf_counter() - t0
            if now >= seconds:
                break
            if tracer is not None:
                tracer.poll(now)
            sim.run(chunk)
            self.steps += chunk
        self.card.sync()
        if tracer is not None:
            tracer.finish()
        return {"steps": self.steps, "seconds": time.perf_counter() - t0,
                "attempted": self.steps, "failed": 0}

    def outputs(self) -> dict:
        """What the window served besides the state, each compared exactly
        once the window has closed: nothing in ``batch``."""
        return {}

    def check_step(self):
        self.step_once()

    def close(self):
        pass
