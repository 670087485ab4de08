"""The port's visualizer server (``nbody_tpu_torch/vis``) on the CPU, held
against the JAX package's ``VisServer`` on the same seeded scene:
positions blobs bitwise equal, boxes within 1e-6 x the box width, the same
meta keys and ``aux`` counters; and the five cases of tests/test_vis.py
(decimation, boxes, rewind, HTTP endpoints, fps sanity) on the port.

Rewind is held against JAX after +3/-3 steps to 1e-6 relative: the
leapfrog returns to its start in both packages to rounding, an ulp a step
(tests/test_torch_diagnostics.py)."""

import json
import os
import subprocess
import sys
import time
import urllib.request

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nbody_tpu.api import Simulation as JaxSimulation
from nbody_tpu.scenes import self_gravitating_disc
from nbody_tpu.vis.server import SimLoop as JaxSimLoop
from nbody_tpu.vis.server import VisServer as JaxVisServer
from nbody_tpu_torch import Simulation
from nbody_tpu_torch.vis.server import SimLoop, VisServer
from torch_parity import one_intra_op_thread  # noqa: F401  (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# tests/test_vis.py's small bh configuration
BH_OPTS = dict(max_level=4, group_size=128, subgroups=8, window_pad=64,
               frontier_cap=2048, accept_cap=1024, near_cell_cap=512,
               near_particle_cap=512, start_level=1, chunk_groups=1)
COUNTERS = ("accept_dropped", "frontier_fallback", "near_fallback",
            "fb_spill")


def make_pair(n=200, engine="brute"):
    """The port's and the JAX package's Simulation on the same scene."""
    pos, vel, mass = self_gravitating_disc(n, seed=0)
    opts = BH_OPTS if engine.startswith("bh") else {}
    kw = dict(engine=engine, engine_options=opts, dt=3e-2, g_soft=0.02,
              theta2=1.0)
    return (Simulation(pos, vel, mass, device="cpu", **kw),
            JaxSimulation(pos, vel, mass, dtype=jnp.float32, **kw))


def get(base, path):
    return urllib.request.urlopen(base + path, timeout=60).read()


def post(base, body):
    req = urllib.request.Request(base + "/api/control",
                                 data=json.dumps(body).encode(),
                                 method="POST")
    return json.loads(urllib.request.urlopen(req, timeout=60).read())


@pytest.fixture(scope="module")
def bh_pair():
    return make_pair(300, engine="bh")


def test_aux_matches_jax(bh_pair):
    sim, jsim = bh_pair
    got, want = sim.aux(), jsim.aux()
    assert set(got) == set(want)
    for k in COUNTERS:
        assert type(got[k]) is int and got[k] == want[k], k
    assert [n for *_, n in got["tree_boxes"]] == [
        n for *_, n in want["tree_boxes"]]
    for engine in ("brute", "brute-dense", "brute-pallas"):
        assert make_pair(50, engine)[0].aux() == {}


def test_server_payloads_match_jax(bh_pair):
    sim, jsim = bh_pair
    srv, jsrv = VisServer(sim, port=0), JaxVisServer(jsim, port=0)
    for max_points in (100, 100_000):  # decimated (stride 4), and stride 1
        srv.max_points = jsrv.max_points = max_points
        assert srv.point_stride() == jsrv.point_stride()
        assert srv.positions_blob() == jsrv.positions_blob()
    assert srv.positions_blob(3) == jsrv.positions_blob(3)
    rec = np.frombuffer(srv.boxes_blob(), np.float32).reshape(-1, 7)
    want = np.frombuffer(jsrv.boxes_blob(), np.float32).reshape(-1, 7)
    assert rec.shape == want.shape and rec.shape[0] > 1
    np.testing.assert_allclose(rec, want, rtol=0, atol=1e-6 * 10.0)
    meta, jmeta = srv.meta(), jsrv.meta()
    assert set(meta) == set(jmeta)
    assert set(meta["settings"]) == set(jmeta["settings"])
    for k in ("n_alive", "elapsed", "steps", "paused", "engine",
              "bounds_width", "point_stride"):
        assert meta[k] == jmeta[k], k


def test_positions_decimation():
    sim, _ = make_pair(1000)  # capacity pads to 1024
    srv = VisServer(sim, port=0, max_points=256)
    assert srv.point_stride() == 4
    arr = np.frombuffer(srv.positions_blob(), np.float32).reshape(-1, 3)
    alive = sim.state.alive.numpy()[::4]
    np.testing.assert_array_equal(arr, sim.state.pos.numpy()[::4][alive])
    assert 200 <= arr.shape[0] <= 256
    full = np.frombuffer(srv.positions_blob(1), np.float32).reshape(-1, 3)
    np.testing.assert_array_equal(full, sim.get_points()[0])
    # the same subset every poll
    assert srv.positions_blob() == srv.positions_blob()


def test_boxes_blob_bh(bh_pair):
    srv = VisServer(bh_pair[0], port=0)
    rec = np.frombuffer(srv.boxes_blob(), np.float32).reshape(-1, 7)
    assert rec.shape[0] > 1
    assert np.all(rec[:, 0:3] < rec[:, 3:6])
    assert rec[:, 6].min() >= 0.0 and rec[:, 6].max() <= 1.0
    srv.max_boxes = 5
    assert len(srv.boxes_blob()) == 5 * 7 * 4
    assert VisServer(make_pair(50)[0], port=0).boxes_blob() == b""


def test_sim_loop_step_and_rewind():
    """Three manual steps forward and three back through the frame loop,
    held against the JAX loop's pending queue on the same scene."""
    sim, jsim = make_pair(100)
    loop, jloop = SimLoop(sim), JaxSimLoop(jsim)

    def jax_pending(k):
        jloop._pending = k
        while jloop._pending != 0:
            dt = float(jsim.settings.dt)
            jsim.step_by(dt if jloop._pending > 0 else -dt)
            jloop._pending += -1 if jloop._pending > 0 else 1

    for k, t in ((3, 0.09), (-3, 0.0)):
        loop.request_steps(k)
        loop._frame()
        jax_pending(k)
        assert loop._pending == 0
        assert abs(sim.elapsed - t) < 1e-6
        assert sim.elapsed == pytest.approx(jsim.elapsed, rel=1e-6, abs=1e-7)
        got, want = sim.get_points()[0], jsim.get_points()[0]
        np.testing.assert_allclose(got, want, rtol=1e-6,
                                   atol=1e-6 * np.abs(want).max())
    assert loop.steps_done == 6


def test_http_endpoints():
    sim, _ = make_pair(100)
    srv = VisServer(sim, port=0)
    httpd = srv.serve(block=False)
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    try:
        meta = json.loads(get(base, "/api/meta"))
        assert meta["n_alive"] == 101 and meta["paused"] is True
        assert meta["point_stride"] == 1
        assert b"nbody_tpu" in get(base, "/")
        for js in ("/sim.js", "/client.js"):
            assert len(get(base, js)) > 0
        blob = get(base, "/api/positions")
        assert len(blob) == 101 * 12
        assert 0 < len(get(base, "/api/positions?stride=4")) < len(blob)
        assert get(base, "/api/boxes") == b""  # brute: no aux
        meta = post(base, {"cmd": "settings", "values": {"theta2": 0.25}})
        assert abs(meta["settings"]["theta2"] - 0.25) < 1e-6
        # fps sanity: frame-to-frame wall periods, so a paused loop reports
        # about max_fps, never the tens of thousands of its work time
        time.sleep(0.6)
        meta = json.loads(get(base, "/api/meta"))
        assert 0.0 < meta["fps"] <= 4 * srv.loop.max_fps, meta["fps"]
        # unpaused, the thread steps; pausing again stops it
        post(base, {"cmd": "pause"})
        deadline = time.time() + 60
        while json.loads(get(base, "/api/meta"))["steps"] < 3:
            assert time.time() < deadline and srv.loop.is_alive()
            time.sleep(0.05)
        meta = post(base, {"cmd": "pause"})
        assert meta["paused"] is True and meta["step_time_ms"] > 0
        post(base, {"cmd": "reset"})
        assert json.loads(get(base, "/api/meta"))["elapsed"] == 0.0
    finally:
        srv.stop()
        assert not srv.loop.is_alive()


def test_boxes_while_stepping():
    """The handler threads' aux() and position copies run while the loop
    thread steps the same simulation: no error, the loop keeps stepping."""
    sim, _ = make_pair(300, engine="bh")
    srv = VisServer(sim, port=0, max_points=64)
    httpd = srv.serve(block=False)
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    try:
        post(base, {"cmd": "pause"})
        for _ in range(3):
            rec = np.frombuffer(get(base, "/api/boxes"), np.float32)
            assert rec.size > 0 and rec.size % 7 == 0
            pos = np.frombuffer(get(base, "/api/positions"), np.float32)
            assert pos.size % 3 == 0 and np.isfinite(pos).all()
        deadline = time.time() + 60
        while srv.loop.steps_done < 2:
            assert time.time() < deadline and srv.loop.is_alive()
            time.sleep(0.05)
        assert srv.loop.error is None
    finally:
        srv.stop()
        assert not srv.loop.is_alive()


@pytest.mark.filterwarnings(
    "ignore::pytest.PytestUnhandledThreadExceptionWarning")
def test_step_error_ends_the_loop():
    """No fallback: an error in a step ends the stepping thread and stays
    readable in ``SimLoop.error``."""
    sim, _ = make_pair(50)

    def broken():
        raise RuntimeError("kernel launch failed")

    sim.step = broken
    loop = SimLoop(sim)
    loop.paused = False
    loop.start()
    loop.join(30)
    assert not loop.is_alive()
    assert isinstance(loop.error, RuntimeError)


def test_static_files_are_copies_and_no_jax_is_imported():
    ours = os.path.join(ROOT, "nbody_tpu_torch", "vis", "static")
    theirs = os.path.join(ROOT, "nbody_tpu", "vis", "static")
    assert sorted(os.listdir(ours)) == sorted(os.listdir(theirs))
    for name in os.listdir(theirs):
        with open(os.path.join(ours, name), "rb") as a, \
                open(os.path.join(theirs, name), "rb") as b:
            assert a.read() == b.read(), name
    code = ("import sys, nbody_tpu_torch.vis, nbody_tpu_torch.vis.server; "
            "bad = sorted(m for m in sys.modules "
            "if m.split('.')[0] in ('jax', 'jaxlib', 'nbody_tpu')); "
            "print(bad); sys.exit(1 if bad else 0)")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


def test_main_needs_the_card_unless_asked_for_the_cpu(monkeypatch):
    from nbody_tpu_torch.vis import server

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        server.main(["--n", "50"])
    served = []
    monkeypatch.setattr(server, "run", lambda sim, *a, **kw: served.append(
        (sim, kw)))
    for flags in (["--cpu"], ["--device", "cpu"]):
        server.main(["--n", "50", "--engine", "brute", *flags])
        sim, kw = served.pop()
        assert sim.device.type == "cpu" and sim.engine.name == "brute"
        assert sim.state.dtype == torch.float32
        assert kw == {"max_points": 100_000}
