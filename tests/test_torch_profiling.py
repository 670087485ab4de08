"""The port's profiling surface on the CPU: ``trace`` writes a Chrome-trace
JSON holding the annotated spans, the span recorder (off: no clock read;
on: the span tree of each engine path, on the trace's clock, in a bounded
ring), the pair tally, ``--profile`` traces the CLI's timed loop with its
phases, and ``flops_of`` counts the kernels' work from their launch shapes
(the pair table of ``ops/work.py``) plus the aten matrix products around
them."""

import glob
import json
import os
import sys
import threading
import time

import jax
import jax.numpy as jnp
import pytest
import torch

from nbody_tpu.utils.profiling import flops_of as jax_flops_of
from nbody_tpu_torch import Simulation, cli
from nbody_tpu_torch.ops import group_force as gf
from nbody_tpu_torch.ops import pairwise as pw
from nbody_tpu_torch.ops import traversal, work
from nbody_tpu_torch.scenes import self_gravitating_disc
from nbody_tpu_torch.utils import profiling
from torch_parity import one_intra_op_thread  # noqa: F401  (autouse)


def _trace(log_dir):
    files = glob.glob(os.path.join(log_dir, "*.json"))
    assert len(files) == 1, files
    with open(files[0]) as f:
        return json.load(f)


def _events(log_dir):
    return [e.get("name", "") for e in _trace(log_dir)["traceEvents"]]


@pytest.fixture
def spans():
    """The span recorder on and empty for one test, off and empty after."""
    profiling.SPANS.clear()
    profiling.SPANS.enable()
    try:
        yield profiling.SPANS
    finally:
        profiling.SPANS.disable()
        profiling.SPANS.clear()


def _small_bh(monkeypatch, engine="bh", **options):
    """A 300-row disc on a small bh stack, its force sums routed through
    the kernel wrappers (their plain twins on the CPU), as on the card."""
    monkeypatch.setattr(traversal, "_resolve_eval_mode",
                        lambda cfg, t: "pallas")
    return Simulation(*self_gravitating_disc(299, seed=0), engine=engine,
                      device="cpu", dt=1e-3, g_soft=0.02, theta2=1.0,
                      engine_options=dict(max_level=4, group_size=128,
                                          subgroups=8, window_pad=64,
                                          chunk_groups=1, block_dual=True,
                                          **options))


def test_trace_writes_a_chrome_trace(tmp_path):
    d = str(tmp_path / "prof")
    with profiling.trace(d):
        with profiling.annotate("nbody_span"):
            torch.ones(64, 64) @ torch.ones(64, 64)
    names = _events(d)
    assert "nbody_span" in names
    assert any(n.startswith("aten::") for n in names)
    assert not profiling.SPANS.on


def test_the_recorder_off_reads_no_clock(monkeypatch):
    """Off (the default), a span or a mark reads no clock, makes no event
    and records nothing, on a whole bh step."""
    assert not profiling.SPANS.on
    profiling.SPANS.clear()

    def refuse(*a, **k):
        raise AssertionError("the recorder is off")

    monkeypatch.setattr(time, "time_ns", refuse)
    monkeypatch.setattr(torch.cuda, "Event", refuse)
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    sim = _small_bh(monkeypatch)
    with profiling.annotate("outer", "cuda"):
        profiling.mark("inner")
        sim.run(1)
    assert list(profiling.RECORDS) == [] and work.TALLY == {}


# the phases a force span holds, in the order they close
ORDER = ["moved_frac", "refresh", "build", "refined build", "regather",
         "walk", "fb", "assembly+dual", "K3", "K4 dual", "K5", "K4",
         "scatter"]


def _tree(rec):
    """[(name, parent name)] of a record, each child checked inside its
    parent and after its elder siblings."""
    s = rec["spans"]
    out = []
    for i, (name, parent, t0, t1, ms, _) in enumerate(s):
        assert t0 <= t1 and ms == pytest.approx((t1 - t0) * 1e-6)
        if parent >= 0:
            assert s[parent][2] <= t0 and t1 <= s[parent][3]
            sib = [x for x in s[:i] if x[1] == parent]
            assert not sib or sib[-1][3] <= t0
        out.append((name, s[parent][0] if parent >= 0 else None))
    return out


@pytest.mark.parametrize("path", ["bh", "walk_reuse", "bh-lazy"])
def test_the_span_tree_of_each_bh_path(path, spans, monkeypatch):
    """The step's spans (step > drift, force, kick) and the phases under
    force in order: a plain bh step, a walk-reuse cached step (its moved
    fraction, refresh and regather) and a bh-lazy step."""
    engine = "bh-lazy" if path == "bh-lazy" else "bh"
    opts = dict(walk_every=2) if path == "walk_reuse" else {}
    sim = _small_bh(monkeypatch, engine, **opts)
    sim.run(2)
    recs = spans.resolve()
    assert [r["root"] for r in recs] == ["step", "step"]
    tree = _tree(recs[-1])
    assert tree[:3] == [("step", None), ("drift", "step"), ("force", "step")]
    assert tree[-1] == ("kick", "step")
    phases = [n for n, p in tree if p == "force"]
    assert phases == sorted(phases, key=ORDER.index)
    want = {"bh": ["build", "walk", "fb", "assembly+dual", "K3",
                   "K4 dual", "K4", "scatter"],
            "walk_reuse": ["moved_frac", "refresh", "regather", "fb",
                           "assembly+dual", "K3", "K4 dual", "K4",
                           "scatter"],
            "bh-lazy": ["moved_frac", "refresh", "walk", "fb",
                        "assembly+dual", "K3", "K4 dual", "K4",
                        "scatter"]}[path]
    assert phases == want
    assert len(tree) == 4 + len(want)
    assert recs[-1]["tid"] == threading.get_native_id()


def test_spans_lie_on_the_traces_clock(tmp_path, spans):
    """Inside ``trace``, an aten op run within a span lies within the
    span's interval on the trace's clock (its ``ts`` after the file's
    ``baseTimeNanoseconds``), and a marked phase enters the trace."""
    d = str(tmp_path / "prof")
    a = torch.ones(96, 96)
    with profiling.trace(d):
        with profiling.annotate("outer"):
            torch.sin(a)
            profiling.mark("phase")
            a @ a
    data = _trace(d)
    base = data["baseTimeNanoseconds"]
    rec = spans.resolve()[-1]
    (_, _, o0, o1, _, _), (_, _, p0, p1, _, marked) = rec["spans"]
    assert marked and o0 <= p0 <= p1 <= o1
    ev = {e["name"]: e for e in data["traceEvents"] if e.get("ph") == "X"}
    for op, (t0, t1) in (("aten::mm", (p1, o1)), ("aten::sin", (o0, p1))):
        start = base + float(ev[op]["ts"]) * 1e3
        assert t0 <= start and start + float(ev[op]["dur"]) * 1e3 <= t1
    mine = ev["phase"]
    assert mine["tid"] == ev["aten::sin"]["tid"]
    assert base + float(mine["ts"]) * 1e3 == pytest.approx(p0, abs=1e3)


def test_the_ring_stays_bounded(spans):
    for i in range(profiling.RING + 40):
        with profiling.annotate("step"):
            profiling.mark("phase")
    recs = spans.resolve()
    assert len(recs) == profiling.RING and profiling.RECORDS.maxlen == \
        profiling.RING
    assert all(len(r["spans"]) == 2 for r in recs)
    assert recs[0]["spans"][0][2] > 0


def test_one_root_in_every(spans):
    """``enable(every=3)``: one root span in three is recorded, with every
    span and mark inside it; the others leave nothing."""
    spans.enable(every=3)
    for _ in range(9):
        with profiling.annotate("step"):
            with profiling.annotate("inner"):
                profiling.mark("phase")
    recs = spans.resolve()
    assert len(recs) == 3
    for r in recs:
        assert _tree(r) == [("step", None), ("inner", "step"),
                            ("phase", "inner")]


def test_threads_record_their_own_spans(spans):
    """Four threads open spans and tally at once, switching often: each
    record holds one thread's spans, and no record or tally is lost."""
    interval = sys.getswitchinterval()
    work.reset_tally()

    def run():
        for _ in range(100):
            with profiling.annotate("step"):
                profiling.mark("a")
                with profiling.annotate("inner"):
                    profiling.mark("b")
                work.tally("x", lambda: (1, 2))

    threads = [threading.Thread(target=run) for _ in range(4)]
    try:
        sys.setswitchinterval(1e-6)
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
    finally:
        sys.setswitchinterval(interval)
    try:
        assert not any(t.is_alive() for t in threads)
        recs = spans.resolve()
        assert len(recs) == 400
        assert len({r["tid"] for r in recs}) == 4
        for r in recs:
            assert _tree(r) == [("step", None), ("a", "step"),
                                ("inner", "step"), ("b", "inner")]
        assert work.TALLY["x"] == {"pairs": 400, "bytes": 800, "calls": 400}
    finally:
        work.reset_tally()


@pytest.mark.parametrize("masked", [False, True])
def test_the_k3_tally_is_group_works_count(masked, spans):
    """With the recorder on, the K3 wrapper adds the pairs its launch needs
    (``work.group_work``'s count, kept as a tensor) to ``TALLY``."""
    g = torch.Generator().manual_seed(3)
    tgt8 = torch.rand(3, 64, 8, generator=g)
    slab = torch.rand(3, 256, 8, generator=g)
    slab[..., 3] *= torch.rand(3, 256, generator=g) > 0.4
    mask = (torch.rand(3, 4, 4, generator=g) > 0.5) if masked else None
    work.reset_tally()
    try:
        for _ in range(2):
            gf.group_force(tgt8, slab, 1.0, 0.02, tile=64, mask=mask)
        pairs, nbytes = work.group_work(tgt8, slab, 64, mask)
        name = "group_force_masked" if masked else "group_force"
        t = work.TALLY[name]
        assert isinstance(t["pairs"], torch.Tensor)
        assert int(t["pairs"]) == 2 * int(pairs) > 0
        assert t["bytes"] == 2 * nbytes and t["calls"] == 2
        if masked:
            keep = (~mask).repeat_interleave(16, 1).repeat_interleave(64, 2)
            assert int(pairs) == int((keep & (slab[:, None, :, 3] != 0))
                                     .sum())
    finally:
        work.reset_tally()


def test_cli_profile(tmp_path):
    d = str(tmp_path / "cli_prof")
    res = cli.main(["-n", "200", "--steps", "3", "--engine", "brute",
                    "--device", "cpu", "--json", "--profile", d])
    assert res["steps"] == 3
    names = _events(d)
    assert any(n.startswith("aten::") for n in names)
    assert {"step", "drift", "force", "kick"} <= set(names)
    assert set(res["spans"]) == {"step", "drift", "force", "kick"}


def test_cli_profile_shows_the_phases(tmp_path, monkeypatch):
    """``--profile`` on bh: the trace holds every phase of a step, and the
    JSON result each span's median ms a step."""
    monkeypatch.setattr(traversal, "_resolve_eval_mode",
                        lambda cfg, t: "pallas")
    d = str(tmp_path / "cli_prof")
    res = cli.main(["-n", "300", "--steps", "2", "--engine", "bh",
                    "--device", "cpu", "--json", "--profile", d,
                    "--dt", "1e-3"])
    names = set(_events(d))
    phases = {"build", "walk", "fb", "assembly+dual", "K3", "K4", "scatter"}
    assert phases | {"step", "force"} <= names
    sp = res["spans"]
    assert phases | {"step", "drift", "force", "kick"} <= set(sp)
    assert sum(sp[k] for k in phases) <= sp["force"] <= sp["step"]
    assert not profiling.SPANS.on


@pytest.mark.parametrize("n,kernel", [(2048, "pairwise_acc_targets"),
                                      (8192, "pairwise_acc_sym")])
def test_flops_of_brute_pallas_counts_the_pairs(n, kernel):
    """One brute-pallas step on the CPU: the K2 route below 4096 (every
    target against every massive source, 18 operations a pair) and the K1
    route above (every unordered pair once, 25).  The plain twins and the
    step are elementwise, so the kernel count is the whole count."""
    sim = Simulation(*self_gravitating_disc(n - 1, seed=0),
                     engine="brute-pallas", device="cpu", dt=3e-2,
                     g_soft=0.02)
    assert sim.state.capacity == n and sim.n_alive == n
    res = profiling.flops_of(sim.run, 1)
    pairs = n * n if kernel == "pairwise_acc_targets" else n * (n - 1) // 2
    ops = 18 if kernel == "pairwise_acc_targets" else 25
    assert res["kernel_flops"] == {kernel: pairs * ops}
    assert res["flops"] == pairs * ops
    assert res["bytes_accessed"] == 28 * n
    # the JAX package's keys
    jres = jax_flops_of(jax.jit(lambda x: x @ x), jnp.ones((8, 8)))
    assert set(jres) <= set(res)


def test_flops_of_aten_and_twins():
    """FlopCounterMode's matrix products count; a plain twin's own (K6's
    twin runs a bmm) do not count again beside its pair table."""
    res = profiling.flops_of(lambda a: a @ a, torch.ones(8, 8))
    assert res == {"flops": 2 * 8 ** 3, "bytes_accessed": 0,
                   "kernel_flops": {}}
    pos = torch.from_numpy(self_gravitating_disc(255, seed=1)[0]).float()
    mass = torch.ones(256)
    mass[::5] = 0.0
    res = profiling.flops_of(pw.pairwise_acc_mxu, pos, mass, 1.0, 0.02)
    want = 19 * 256 * int((mass != 0).sum())
    assert res["kernel_flops"] == {"pairwise_acc_mxu": want}
    assert res["flops"] == want


@pytest.mark.parametrize("route", ["xla", "kernels"])
def test_flops_of_bh_step(route, monkeypatch):
    """One small bh step.  On the CPU the walk's sums run in plain torch
    (matrix products, counted by FlopCounterMode); routed through the kernel
    wrappers, as on the card, K3 and K4 count by the pair table."""
    from nbody_tpu_torch.ops import traversal

    if route == "kernels":
        monkeypatch.setattr(traversal, "_resolve_eval_mode",
                            lambda cfg, t: "pallas")
    sim = Simulation(*self_gravitating_disc(300, seed=0), engine="bh",
                     device="cpu", dt=3e-2, g_soft=0.02, theta2=1.0,
                     engine_options=dict(max_level=4, group_size=128,
                                         subgroups=8, window_pad=64,
                                         chunk_groups=1))
    res = profiling.flops_of(sim.run, 1)
    kernels = res["kernel_flops"]
    assert res["flops"] > 0 and res["flops"] >= sum(kernels.values())
    if route == "xla":
        assert kernels == {} and res["bytes_accessed"] == 0
        return
    k3 = kernels.get("group_force", 0) + kernels.get("group_force_masked", 0)
    assert k3 > 0 and kernels["quad_force"] > 0
    assert res["bytes_accessed"] > 0


def test_flops_of_is_thread_local():
    """A count open in one thread sees none of another thread's kernel
    calls or matrix products."""
    pos = torch.from_numpy(self_gravitating_disc(127, seed=2)[0]).float()
    mass = torch.ones(128)
    started, release = threading.Event(), threading.Event()
    res = {}

    def idle():
        started.set()
        release.wait(60)

    t = threading.Thread(target=lambda: res.update(
        idle=profiling.flops_of(idle)))
    t.start()
    try:
        assert started.wait(60)
        busy = profiling.flops_of(lambda: (
            pw.pairwise_acc_targets(pos, pos, mass, 1.0, 0.02),
            torch.ones(4, 4) @ torch.ones(4, 4)))
    finally:
        release.set()
        t.join(60)
    assert not t.is_alive()
    assert busy["kernel_flops"] == {"pairwise_acc_targets": 18 * 128 * 128}
    assert busy["flops"] == 18 * 128 * 128 + 2 * 4 ** 3
    assert res["idle"] == {"flops": 0, "bytes_accessed": 0,
                           "kernel_flops": {}}


def test_a_within_span_leaves_the_marks(spans):
    """``within``: a span of the innermost open span (never marked) whose
    close leaves that span's mark boundary, so the phase the next mark
    closes holds it; outside every span it records nothing and counts no
    root."""
    with profiling.within("collective"):
        torch.ones(4).sum()
    assert spans.resolve() == [] and spans._frames() == []
    spans.enable(every=2)
    for _ in range(2):
        with profiling.annotate("step"):
            profiling.mark("a")
            torch.ones(8).sum()
            with profiling.within("collective"):
                time.sleep(1e-3)
            profiling.mark("b")
    rec, = spans.resolve()
    (_, _, s0, s1, _, _), a, c, b = rec["spans"]
    assert [x[0] for x in (a, c, b)] == ["a", "collective", "b"]
    assert [x[1] for x in (a, c, b)] == [0, 0, 0]
    assert [x[5] for x in (a, c, b)] == [True, False, True]
    # "b" runs from "a"'s close to its mark and holds the collective
    assert b[2] == a[3] <= c[2] <= c[3] <= b[3] <= s1
    assert c[4] >= 1.0  # ms, the host's time off the card


def test_collectives_at_world_size_one_record_nothing(spans):
    """At world size 1 the collectives are the identity: a domain step with
    the recorder on records no ``collective`` span and sends no byte, and
    the step's phases are the route's."""
    from nbody_tpu_torch.parallel import ShardedSimulation

    work.reset_tally()
    try:
        sim = ShardedSimulation(
            *self_gravitating_disc(499, seed=0), engine="bh", strategy="bh",
            n_devices=1, device="cpu", dt=1e-3, g_soft=0.02, theta2=1.0,
            engine_options=dict(max_level=4, group_size=128, subgroups=8,
                                window_pad=64, chunk_groups=1))
        assert sim.mesh.world == 1
        sim.run(1)
        rec, = spans.resolve()
        names = [s[0] for s in rec["spans"]]
        assert "collective" not in names
        assert {"build", "walk", "fb", "assembly+dual", "K3", "K4",
                "route"} <= set(names)
        assert work.SENT == {}
    finally:
        work.reset_tally()


def test_the_byte_counter_counts_only_while_the_recorder_is_on():
    work.reset_tally()
    try:
        work.sent("psum", 64)
        assert work.SENT == {}
        profiling.SPANS.enable()
        work.sent("psum", 64)
        work.sent("psum", 32)
        work.sent("ring_shift", 8)
        assert work.SENT == {"psum": {"bytes": 96, "calls": 2},
                             "ring_shift": {"bytes": 8, "calls": 1}}
    finally:
        profiling.SPANS.disable()
        work.reset_tally()
        profiling.SPANS.clear()
