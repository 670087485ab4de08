"""Interactive visualizer (the counterpart of ``nbody_tpu/vis/server.py``):
a background thread steps the simulation on the card while an HTTP server
streams particle positions and octree boxes to a browser, which renders
billboard discs and wireframe AABBs with an orbit camera.

The routes, payload formats, controls, frame loop and ``stop()`` semantics
are the JAX package's:

  * ``GET /``, ``/index.html``, ``/sim.js``, ``/client.js``: the front end
    (``vis/static/``, this package's own copy of the JAX package's files);
  * ``GET /api/positions[?stride=k]``: float32 xyz of the alive particles,
    decimated to about ``max_points`` by a capacity-based stride;
  * ``GET /api/boxes``: float32 records (min3, max3, depth fraction) of the
    occupied octree nodes (``Simulation.aux()['tree_boxes']``), at most
    ``max_boxes``; empty for an engine without ``aux``;
  * ``GET /api/meta``: stats and settings (JSON);
  * ``POST /api/control``: ``{"cmd": "pause" | "reset" | "step" (k, negative
    rewinds) | "settings" (values) | "reset_settings"}``.

Frame loop: while unpaused the thread takes one timed step, then keeps
stepping while the frame budget (1 / max_fps) remains, up to
``max_steps_per_frame``.  Each step ends in a device synchronise, so a step
is timed whole and the loop never queues work past its budget.

Two threads share the card: the stepping thread and the HTTP handlers,
whose copies to the host and ``aux()`` builds and walks launch the same
kernels.  Neither sets a CUDA stream, so both enqueue on the device's
default stream and a handler's reads are ordered behind the step in
flight.  Nothing falls back: an error in a step (a kernel that fails to
build or launch) ends the stepping thread, is kept in ``SimLoop.error``
and raised there.

Run:  python -m nbody_tpu_torch.vis [--engine bh --n 10000 --port 8000]
      (on the card; ``--cpu`` or ``--device cpu`` for the plain torch path)
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import deque
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

_STATIC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "static")


class SimLoop(threading.Thread):
    """Background stepping thread implementing the reference frame loop."""

    def __init__(self, sim):
        super().__init__(daemon=True)
        self.sim = sim
        self.lock = threading.Lock()
        self.paused = True
        self.max_fps = 60.0
        self.max_steps_per_frame = 100
        self.steps_done = 0
        self.step_time = 0.0
        self.frame_times = deque(maxlen=60)  # 60-sample ring of frame periods
        self._last_frame_start = None
        self._halt = False  # not "_stop": Thread.join() calls a _stop()
        self._pending = 0  # manual single steps (+fwd/-back)
        #: the exception that ended the thread, if one did
        self.error = None

    # -- controls ----------------------------------------------------------

    def toggle_pause(self):
        self.paused = not self.paused

    def request_steps(self, k: int):
        with self.lock:
            self._pending += k

    def reset_sim(self):
        with self.lock:
            self.sim.reset()
            self.steps_done = 0

    def set_settings(self, **kw):
        with self.lock:
            loop_keys = {}
            for k in ("max_fps", "max_steps_per_frame"):
                if k in kw:
                    loop_keys[k] = kw.pop(k)
            if kw:
                self.sim.set_settings(**kw)
            if "max_fps" in loop_keys:
                self.max_fps = float(loop_keys["max_fps"])
            if "max_steps_per_frame" in loop_keys:
                self.max_steps_per_frame = int(loop_keys["max_steps_per_frame"])

    # -- loop ---------------------------------------------------------------

    def _timed_step(self) -> float:
        t0 = time.perf_counter()
        self.sim.step()
        self.sim.block_until_ready()
        self.steps_done += 1
        return time.perf_counter() - t0

    def _frame(self):
        frame_start = time.perf_counter()
        # fps measures real frame-to-frame wall periods (the cap sleep
        # included), not per-frame work time, which on a paused sim is
        # microseconds
        if self._last_frame_start is not None:
            self.frame_times.append(frame_start - self._last_frame_start)
        self._last_frame_start = frame_start
        did = 0
        with self.lock:
            # manual steps first (forward, or rewind through a negative dt)
            while self._pending != 0:
                dt = float(self.sim.settings.dt)
                self.sim.step_by(dt if self._pending > 0 else -dt)
                self._pending += -1 if self._pending > 0 else 1
                self.steps_done += 1
                did += 1
            if not self.paused:
                self.step_time = self._timed_step()
                did += 1
                budget = 1.0 / self.max_fps
                # keep stepping while the budget has room for another step
                # of the current measured cost (an EMA of synchronised steps)
                while (time.perf_counter() - frame_start + self.step_time
                       < budget and did < self.max_steps_per_frame):
                    self.step_time = (0.7 * self.step_time
                                      + 0.3 * self._timed_step())
                    did += 1
        sleep = 1.0 / self.max_fps - (time.perf_counter() - frame_start)
        if sleep > 0:
            time.sleep(sleep)
        elif did == 0:
            time.sleep(0.02)

    def run(self):
        try:
            while not self._halt:
                self._frame()
        except BaseException as e:
            self.error = e
            raise

    def fps(self) -> float:
        if not self.frame_times:
            return 0.0
        return len(self.frame_times) / max(sum(self.frame_times), 1e-9)

    def stop(self, timeout: float = 5.0):
        """Stop the frame loop and join the thread (idempotent), so no
        stepping thread outlives its server in an in-process caller."""
        self._halt = True
        if self.is_alive():
            self.join(timeout)


class VisServer:
    def __init__(self, sim, host="127.0.0.1", port=8000, max_boxes=20000,
                 max_points=100_000):
        self.sim = sim
        self.loop = SimLoop(sim)
        self.host = host
        self.port = port
        self.max_boxes = max_boxes
        # positions are strided on the device down to <= max_points before
        # the copy to the host: 1M x f32 xyz is ~12 MB a frame
        self.max_points = int(max_points)
        self._initial_settings = self._settings_dict()

    def _settings_dict(self):
        s = self.sim.settings
        return {
            "dt": float(s.dt),
            "g": float(s.g),
            "g_soft": float(s.g_soft),
            "theta2": float(s.theta2),
            "max_fps": self.loop.max_fps,
            "max_steps_per_frame": self.loop.max_steps_per_frame,
        }

    # -- payload builders ----------------------------------------------------

    def point_stride(self) -> int:
        """Deterministic decimation stride: capacity-based, so the same
        particles stream every poll."""
        if self.max_points <= 0:
            return 1
        cap = self.sim.state.capacity
        return max(1, -(-cap // self.max_points))

    def positions_blob(self, stride: int | None = None) -> bytes:
        if stride is None:
            stride = self.point_stride()
        st = self.sim.state
        # the strided rows and their alive mask are selected on the device;
        # only the decimated rows cross to the host
        pos = st.pos if stride <= 1 else st.pos[::stride]
        alive = st.alive if stride <= 1 else st.alive[::stride]
        pos = pos[alive].cpu().numpy()
        return np.ascontiguousarray(pos, dtype=np.float32).tobytes()

    def boxes_blob(self) -> bytes:
        """f32 records (min3, max3, depth_frac) per octree node."""
        boxes = self.sim.aux().get("tree_boxes")
        if not boxes:
            return b""
        levels = [(lo, hi) for (lo, hi, cnt) in boxes if cnt > 0]
        if not levels:
            return b""
        max_depth = max(1, len(levels) - 1)
        out = []
        remaining = self.max_boxes
        for depth, (lo, hi) in enumerate(levels):
            k = min(len(lo), remaining)
            rec = np.empty((k, 7), np.float32)
            rec[:, 0:3] = lo[:k]
            rec[:, 3:6] = hi[:k]
            rec[:, 6] = depth / max_depth
            out.append(rec)
            remaining -= k
            if remaining <= 0:
                break
        return np.concatenate(out).tobytes()

    def meta(self) -> dict:
        # n_alive, elapsed and the box width each read the device, so each
        # waits for the step in flight (at most one: the loop synchronises
        # every step)
        return {
            "n_alive": self.sim.n_alive,
            "elapsed": self.sim.elapsed,
            "steps": self.loop.steps_done,
            "fps": round(self.loop.fps(), 1),
            "step_time_ms": round(self.loop.step_time * 1e3, 3),
            "paused": self.loop.paused,
            "settings": self._settings_dict(),
            "engine": self.sim.engine.name,
            "bounds_width": float(self.sim.settings.bounds.width),
            "point_stride": self.point_stride(),
        }

    # -- HTTP ----------------------------------------------------------------

    def make_handler(server):
        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def _send(self, data: bytes, ctype: str):
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(data)))
                self.send_header("Cache-Control", "no-store")
                self.end_headers()
                self.wfile.write(data)

            def do_GET(self):
                path, _, query = self.path.partition("?")
                if path in ("/", "/index.html"):
                    with open(os.path.join(_STATIC, "index.html"), "rb") as f:
                        self._send(f.read(), "text/html")
                elif path in ("/sim.js", "/client.js"):
                    with open(os.path.join(_STATIC, path[1:]), "rb") as f:
                        self._send(f.read(), "text/javascript")
                elif path == "/api/positions":
                    stride = None
                    for kv in query.split("&"):
                        if kv.startswith("stride="):
                            try:
                                stride = max(1, int(kv[7:]))
                            except ValueError:
                                pass
                    self._send(server.positions_blob(stride),
                               "application/octet-stream")
                elif path == "/api/boxes":
                    self._send(server.boxes_blob(),
                               "application/octet-stream")
                elif path == "/api/meta":
                    self._send(json.dumps(server.meta()).encode(),
                               "application/json")
                else:
                    self.send_error(404)

            def do_POST(self):
                n = int(self.headers.get("Content-Length", 0))
                body = json.loads(self.rfile.read(n) or b"{}")
                if self.path == "/api/control":
                    cmd = body.get("cmd")
                    if cmd == "pause":
                        server.loop.toggle_pause()
                    elif cmd == "reset":
                        server.loop.reset_sim()
                    elif cmd == "step":
                        server.loop.request_steps(int(body.get("k", 1)))
                    elif cmd == "reset_settings":
                        server.loop.set_settings(**server._initial_settings)
                    elif cmd == "settings":
                        server.loop.set_settings(**body.get("values", {}))
                    self._send(json.dumps(server.meta()).encode(),
                               "application/json")
                else:
                    self.send_error(404)

        return Handler

    def serve(self, block=True):
        self.loop.start()
        httpd = ThreadingHTTPServer((self.host, self.port), self.make_handler())
        self.httpd = httpd
        print(f"nbody_tpu_torch visualizer: http://{self.host}:"
              f"{httpd.server_address[1]}/")
        if block:
            try:
                httpd.serve_forever()
            finally:
                self.loop.stop()
        else:
            t = threading.Thread(target=httpd.serve_forever, daemon=True)
            t.start()
        return httpd

    def stop(self):
        """Shut down the HTTP server and the stepping thread (idempotent).
        Non-blocking callers of serve() own this; httpd.shutdown() alone
        leaves the SimLoop thread running."""
        if getattr(self, "httpd", None) is not None:
            self.httpd.shutdown()
            self.httpd.server_close()
        self.loop.stop()


def run(sim, host="127.0.0.1", port=8000, max_points=100_000):
    """Serve ``sim`` until interrupted."""
    VisServer(sim, host, port, max_points=max_points).serve()


def main(argv=None):
    import argparse

    import torch

    from nbody_tpu_torch.api import Simulation
    from nbody_tpu_torch.scenes import SCENES

    p = argparse.ArgumentParser(prog="nbody_tpu_torch.vis")
    p.add_argument("--n", type=int, default=10000)
    p.add_argument("--engine", default="bh")
    p.add_argument("--scene", default="disc", choices=sorted(SCENES))
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--dt", type=float, default=3e-2)
    p.add_argument("--g-soft", type=float, default=0.02)
    p.add_argument("--theta2", type=float, default=1.0)
    p.add_argument("--max-points", type=int, default=100_000,
                   help="decimate streamed positions to about this many "
                   "(0 = stream all; 1M x f32 is ~12 MB/frame)")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="'cuda' (the default) runs on the card or raises")
    p.add_argument("--cpu", action="store_true",
                   help="the same as --device cpu")
    args = p.parse_args(argv)

    pos, vel, mass = SCENES[args.scene](args.n, seed=0)
    sim = Simulation(
        pos, vel, mass, engine=args.engine,
        dt=args.dt, g_soft=args.g_soft, theta2=args.theta2,
        dtype=torch.float32, device="cpu" if args.cpu else args.device,
    )
    run(sim, args.host, args.port, max_points=args.max_points)


if __name__ == "__main__":
    main()
