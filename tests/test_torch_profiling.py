"""The port's profiling surface on the CPU: ``trace`` writes a Chrome-trace
JSON holding the annotated spans, ``StepTimer`` summarises, ``--profile``
traces the CLI's timed loop, and ``flops_of`` refuses."""

import glob
import json
import os

import pytest
import torch

from nbody_tpu_torch import cli
from nbody_tpu_torch.utils import profiling


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


def test_flops_of_is_not_ported():
    with pytest.raises(NotImplementedError, match="item 14"):
        profiling.flops_of(lambda x: x, 1.0)
