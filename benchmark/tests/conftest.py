"""Fixtures of the benchmark's CPU tests: a copy of the benchmark in a
temporary checkout with a small configuration of its own, and a driver
that runs a cell there on the CPU (the program's plain-torch path) the way
``run.py`` runs it on the card, past the look for a card."""

import contextlib
import io
import json
import shutil
import sys
import time
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
sys.path.insert(0, str(BENCH))
sys.path.insert(0, str(ROOT))

TINY = {
    "name": "disc-tiny", "source": "test", "scene": "disc", "n": 1999,
    "capacity": 2048, "engine": "bh", "engine_options": {},
    "dtype": "float32",
    "physics": {"g": 1.0, "eps": 0.02, "dt": 0.03, "theta2": 1.0,
                "center": [0.0, 0.0, 0.0], "width": 10.0},
    "disc": {"star_mass": 1.0, "disc_mass": 0.2},
    "assumed": [], "reduced": [], "check_rows": 256,
    "check": {"alive_mismatch": 0, "dead_inside": 0, "state_err": 1e-6,
              "force_e_p50": 1e-3},
}


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU; skips without one")


def tiny_manifest(traffics=("batch", "view")) -> dict:
    m = json.loads((ROOT / "BENCHMARK.json").read_text())
    m["configs"] = [{"name": "disc-tiny", "source": "test",
                     "file": "benchmark/configs/disc-tiny.json",
                     "reduced": [], "why": "a test's configuration"}]
    m["workloads"] = [{"name": f"disc-tiny.{t}", "config": "disc-tiny",
                       "traffic": t, "chips": 1, "why": "a test's cell"}
                      for t in traffics]
    # the metrics of disc-100k.<mix> go to the small configuration's cell
    # of the same mix
    cells = {w["name"] for w in m["workloads"]}
    for kind in ("end_to_end", "per_layer"):
        for met in m[kind]:
            if "workloads" in met:
                met["workloads"] = sorted(
                    {"disc-tiny." + c.split(".", 1)[1]
                     for c in met["workloads"]} & cells)
        m[kind] = [met for met in m[kind] if met.get("workloads", True)]
    if "view" in traffics:
        for kind, met in VIEW_METRICS:
            m[kind].append(dict(met, workloads=["disc-tiny.view"]))
    return m


# the view cell's metrics, added as data the way a cell of traffic kind
# ``view`` enters BENCHMARK.json (PERF.md: measured, not in it yet)
_VIEW_LAYER = ("visualizer handlers (vis/server.py positions_blob, "
               "boxes_blob, Simulation.aux)")
VIEW_METRICS = [
    ("end_to_end", {"name": "viewed_steps_per_s", "unit": "steps/s",
                    "better": "higher", "bound": 0.25,
                    "source": "host_clock"}),
    ("per_layer", {"name": "positions_ms_p95", "unit": "ms",
                   "better": "lower", "source": "host_clock",
                   "layer": _VIEW_LAYER, "moves": "viewed_steps_per_s"}),
    ("per_layer", {"name": "boxes_ms_p50", "unit": "ms", "better": "lower",
                   "source": "host_clock", "layer": _VIEW_LAYER,
                   "moves": "viewed_steps_per_s"}),
]


@pytest.fixture
def tree(tmp_path):
    """A checkout holding a copy of ``benchmark/`` and a manifest whose
    cells run the small configuration ``disc-tiny``."""
    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    (tmp_path / "benchmark/configs/disc-tiny.json").write_text(
        json.dumps(TINY))
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(tiny_manifest()))
    return tmp_path


def run_cell(root: Path, cell: str, seed=3, seconds=1.0, trace=0,
             config_edit=None):
    """Run ``cell`` of ``root``'s manifest on the CPU: (exit code, the
    result's dict or None, standard error)."""
    import torch
    from harness import main, manifest

    if config_edit is not None:
        p = root / "benchmark/configs/disc-tiny.json"
        cfg = json.loads(p.read_text())
        config_edit(cfg)
        p.write_text(json.dumps(cfg))
    m = manifest.load(root / "BENCHMARK.json")
    args = main.parse(["--workload", cell, "--seed", str(seed),
                       "--seconds", str(seconds), "--trace", str(trace)])
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = main.measure(args, m, time.perf_counter(),
                          main.Card(torch, "cpu"), root=root,
                          bench_dir=root / "benchmark")
    lines = out.getvalue().strip().splitlines()
    result = json.loads(lines[-1]) if rc == 0 and lines else None
    return rc, result, err.getvalue()
