"""Traffic kind ``view``: one viewer of the interactive visualizer
(``nbody_tpu_torch.vis.server.VisServer``, bound to port 0 on 127.0.0.1).
Its stepping thread is unpaused at the window's start; the viewer
(``harness/viewer.py``) runs in a process of its own, as a browser does, so
that its polls take no turns of the server's interpreter lock: one closed
loop a route, as the repository's client polls (``vis/static/index.html``),
each poller asking again ``gap_ms`` after each reply.  The harness counts the stepping thread's steps itself, by wrapping
the ``Simulation.step`` the thread calls.

Parameters (the mix's file): ``pollers`` ({route: gap_ms}),
``max_points``, ``engine_options``, ``trace_seconds``,
``host_trace_steps``.
"""

import json
import subprocess
import sys
import time

from harness import check, viewer


class Driver:
    def __init__(self, sim, card, params: dict):
        from nbody_tpu_torch.vis.server import VisServer

        self.sim, self.card, self.p = sim, card, params
        self.steps = 0
        step = sim.step

        def counted(*a, **kw):
            out = step(*a, **kw)
            self.steps += 1
            return out

        sim.step = counted
        self.server = VisServer(sim, host="127.0.0.1", port=0,
                                max_points=int(params["max_points"]))
        self.port = self.client = None

    def steps_done(self) -> int:
        return self.steps

    def step_once(self):
        self.sim.step()
        self.sim.block_until_ready()

    def _get(self, path: str) -> bytes:
        return viewer.get(self.port, path)

    def warm(self):
        httpd = self.server.serve(block=False)
        self.port = httpd.server_address[1]
        for route in self.p["pollers"]:
            self._get(route)
        self.card.sync()
        self.client = subprocess.Popen(
            [sys.executable, viewer.__file__, str(self.port),
             json.dumps(self.p["pollers"])], stdin=subprocess.PIPE,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)

    def window(self, seconds: float, tracer=None) -> dict:
        loop = self.server.loop
        t0 = time.perf_counter()
        end = t0 + seconds
        steps0 = self.steps
        self.client.stdin.write(f"{seconds!r}\n")
        self.client.stdin.flush()
        loop.paused = False
        while tracer is not None and time.perf_counter() < end:
            tracer.poll(time.perf_counter() - t0)
            time.sleep(0.02)
        time.sleep(max(0.0, end - time.perf_counter()))
        if tracer is not None:
            tracer.finish()
        steps = self.steps - steps0
        window_s = time.perf_counter() - t0
        out, err = self.client.communicate(timeout=180)
        if self.client.returncode != 0:
            raise RuntimeError(f"the viewer failed: {err[-2000:]}")
        seen = json.loads(out)
        if loop.error is not None:
            raise RuntimeError(f"the stepping thread failed: {loop.error!r}")
        lat, failures = seen["latency_ms"], seen["failures"]
        attempted = sum(len(v) for v in lat.values()) + len(failures)
        return {"seconds": window_s, "viewed_steps": steps,
                "latency_ms": lat, "attempted": attempted,
                "failed": len(failures), "failures": failures}

    def outputs(self) -> dict:
        """Once the window has closed: the stepping thread stopped (the
        frame in flight ended), then ``payload_mismatch``, the float32
        values of the ``/api/positions`` body unlike the state's rows at
        the capacity stride (``harness/check.py``)."""
        loop = self.server.loop
        loop.paused = True
        with loop.lock:
            pass
        self.card.sync()
        st = self.sim.state
        want = check.expected_payload(st.pos, st.alive,
                                      int(self.p["max_points"]))
        return {"payload_mismatch": check.payload_mismatch(
            self._get("/api/positions"), want)}

    def check_step(self):
        with self.server.loop.lock:
            self.step_once()

    def close(self):
        if self.client is not None:
            if self.client.poll() is None:
                self.client.kill()
            self.client.wait()
        self.server.stop()
