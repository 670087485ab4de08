"""The port's profiling surface on the CPU: ``trace`` writes a Chrome-trace
JSON holding the annotated spans, ``StepTimer`` summarises, ``--profile``
traces the CLI's timed loop, and ``flops_of`` counts the kernels' work
from their launch shapes (the pair table of ``ops/work.py``) plus the aten
matrix products around them."""

import glob
import json
import os
import threading

import jax
import jax.numpy as jnp
import pytest
import torch

from nbody_tpu.utils.profiling import flops_of as jax_flops_of
from nbody_tpu_torch import Simulation, cli
from nbody_tpu_torch.ops import pairwise as pw
from nbody_tpu_torch.scenes import self_gravitating_disc
from nbody_tpu_torch.utils import profiling
from torch_parity import one_intra_op_thread  # noqa: F401  (autouse)


def _events(log_dir):
    files = glob.glob(os.path.join(log_dir, "*.json"))
    assert len(files) == 1, files
    with open(files[0]) as f:
        return [e.get("name", "") for e in json.load(f)["traceEvents"]]


def test_trace_writes_a_chrome_trace(tmp_path):
    d = str(tmp_path / "prof")
    with profiling.trace(d):
        with profiling.annotate("nbody_span"):
            torch.ones(64, 64) @ torch.ones(64, 64)
    names = _events(d)
    assert "nbody_span" in names
    assert any(n.startswith("aten::") for n in names)


def test_step_timer():
    t = profiling.StepTimer(window=4)
    assert t.steps_per_second == 0.0 and t.summary() == {}
    for _ in range(6):
        with t:
            sum(range(1000))
    s = t.summary()
    assert len(t.samples) == 4
    assert set(s) == {"steps_per_second", "mean_ms", "p50_ms", "p99_ms"}
    assert s["steps_per_second"] > 0 and s["p99_ms"] >= s["p50_ms"] >= 0


def test_cli_profile(tmp_path):
    d = str(tmp_path / "cli_prof")
    res = cli.main(["-n", "200", "--steps", "3", "--engine", "brute",
                    "--device", "cpu", "--json", "--profile", d])
    assert res["steps"] == 3
    names = _events(d)
    assert any(n.startswith("aten::") for n in names)


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
