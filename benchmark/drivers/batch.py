"""Traffic kind ``batch``: what a user of ``Simulation.run`` or the CLI
does.  The window enqueues ``Simulation.run(chunk)`` calls with no host
sync until ``--seconds`` have passed, then waits for the card
(``torch.cuda.synchronize()``).

In a cell of more than one card every rank runs this driver on its
``ShardedSimulation``: before each chunk rank 0 decides by its own clock
whether the window goes on and the others do as it says
(``ranks.Team.decide``, a broadcast on the host), so every rank makes the
same ``run(chunk)`` calls; the window's ``steps`` and ``seconds`` are
rank 0's.  No rank syncs the card or reads a value from it in the loop.

With ``reset_every`` the window is a series of runs of that many steps
from one start, as the reference's headless benchmark (``init()``, then
1000 steps): before a chunk that would take the state past that many
steps from the start, ``Simulation.reset()`` puts the start back (no
work on the card, nothing compiled).  The start is the scene, or with
``settle_steps`` the scene evolved that many steps in set-up and made
the start by ``Simulation.init()``.  The steps of set-up after the start
count towards the first run; the check's step after the window never
resets, so the checked state is ``settle_steps`` to ``settle_steps +
reset_every + 1`` steps from the scene.

Parameters (the mix's file): ``chunk`` (steps a call), ``warm_steps``,
``reset_every`` and ``settle_steps`` (optional: the steps of one run, and
the steps from the scene to its start),
``engine_options`` (passed to ``Simulation``, e.g. ``walk_every``),
``trace_seconds`` and ``host_trace_steps`` (the traced slice of a
``--trace 1`` run, and the steps traced in its set-up to label idle gaps,
``harness/trace.py``).
"""

import time


class Driver:
    #: runs on several ranks (harness/ranks.py)
    RANKS = True

    def __init__(self, sim, card, params: dict):
        self.sim, self.card, self.p = sim, card, params
        self.steps = 0
        #: steps since the runs' start (set-up's and the window's)
        self.age = 0
        self.resets = 0

    def steps_done(self) -> int:
        return self.steps

    def step_once(self):
        self.sim.run(1)
        self.age += 1
        self.card.sync()

    def warm(self):
        settle = int(self.p.get("settle_steps", 0))
        if settle:
            self.sim.run(settle)
            self.sim.init()
            self.age = 0
        self.sim.run(int(self.p["warm_steps"]))
        self.age += int(self.p["warm_steps"])
        self.card.sync()

    def window(self, seconds: float, tracer=None) -> dict:
        sim, chunk, team = self.sim, int(self.p["chunk"]), self.card.team
        every = self.p.get("reset_every")
        self.card.sync()
        t0 = time.perf_counter()
        while True:
            now = time.perf_counter() - t0
            go = now < seconds
            if team is not None:
                go = team.decide(go)
            if not go:
                break
            if tracer is not None:
                tracer.poll(now)
            if every is not None and self.age + chunk > every:
                sim.reset()
                self.age = 0
                self.resets += 1
            sim.run(chunk)
            self.steps += chunk
            self.age += chunk
        self.card.sync()
        if tracer is not None:
            tracer.finish()
        return {"steps": self.steps, "seconds": time.perf_counter() - t0,
                "attempted": self.steps, "failed": 0, "resets": self.resets}

    def outputs(self) -> dict:
        """What the window served besides the state, each compared exactly
        once the window has closed: nothing in ``batch``."""
        return {}

    def check_step(self):
        self.step_once()

    def close(self):
        pass
