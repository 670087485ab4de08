"""Fixtures of the benchmark's CPU tests: a copy of the benchmark in a
temporary checkout with a small configuration of its own, and a driver
that runs a cell there on the CPU (the program's plain-torch path) the way
``run.py`` runs it on the card, past the look for a card."""

import contextlib
import copy
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
    real = json.loads((ROOT / "BENCHMARK.json").read_text())
    m = copy.deepcopy(real)
    m["configs"] = [{"name": "disc-tiny", "source": "test",
                     "file": "benchmark/configs/disc-tiny.json",
                     "reduced": [], "why": "a test's configuration"}]
    m["workloads"] = [{"name": f"disc-tiny.{t}", "config": "disc-tiny",
                       "traffic": t, "chips": 1, "why": "a test's cell"}
                      for t in traffics]
    # the metrics of a cell go to the small configuration's cell of its
    # mix's kind (``disc-100k.headless``, kind ``batch``: ``disc-tiny.batch``)
    from harness import manifest

    tiny = {w["name"]: "disc-tiny." + manifest.traffic_of(w, BENCH)["kind"]
            for w in real["workloads"]}
    cells = {w["name"] for w in m["workloads"]}
    for kind in ("end_to_end", "per_layer"):
        for met in m[kind]:
            if "workloads" in met:
                met["workloads"] = sorted(
                    {tiny[c] for c in met["workloads"]} & cells)
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


#: a configuration of the sharded system for the cells of four ranks: the
#: Morton-range domain decomposition on gloo ranks
SHARD = dict(TINY, name="disc-shard", n=4095, check_rows=512,
             system="nbody_tpu_torch.parallel.sharded:ShardedSimulation",
             system_options={"strategy": "bh"})
del SHARD["capacity"]
#: one step a call, so that a window on the CPU holds a few calls
BATCH1 = {"kind": "batch", "chunk": 1, "warm_steps": 1,
          "trace_seconds": 0.5, "host_trace_steps": 1}


def ranks_checkout(root: Path) -> Path:
    """A checkout at ``root`` for runs of several ranks as processes: the
    benchmark, a copy of the program (a run takes only the program of its
    own checkout), ``tests/cpu_entry.py`` beside ``run.py``, and cells of
    ``disc-shard`` on four ranks (``batch1``, ``view``) beside the small
    configuration's on one."""
    shutil.copytree(BENCH, root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copytree(ROOT / "nbody_tpu_torch", root / "nbody_tpu_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(BENCH / "tests" / "cpu_entry.py", root / "benchmark")
    (root / "benchmark/configs/disc-tiny.json").write_text(json.dumps(TINY))
    (root / "benchmark/configs/disc-shard.json").write_text(
        json.dumps(SHARD))
    (root / "benchmark/traffic/batch1.json").write_text(json.dumps(BATCH1))
    m = tiny_manifest()
    m["configs"].append({"name": "disc-shard", "source": "test",
                         "file": "benchmark/configs/disc-shard.json",
                         "reduced": [], "why": "a test's configuration"})
    for t in ("batch1", "view"):
        m["workloads"].append({"name": f"disc-shard.{t}",
                               "config": "disc-shard", "traffic": t,
                               "chips": 4, "why": "a test's cell"})
    for kind in ("end_to_end", "per_layer"):
        for met in m[kind]:
            if "disc-tiny.batch" in met.get("workloads", ()):
                met["workloads"].append("disc-shard.batch1")
    (root / "BENCHMARK.json").write_text(json.dumps(m))
    return root


def run_entry(root: Path, cell: str, out: Path, seed=2**31 + 41,
              seconds=1.0, trace=0, env=None, timeout=600):
    """Run ``cell`` of ``root`` (a ``ranks_checkout``) as ``run.py`` runs
    on the card, rank 0 a process of its own: (exit code, standard output,
    standard error, seconds until it ended on the wall clock's
    ``time.time()``).  ``out`` is the entry's ``CPU_ENTRY_DIR``."""
    import os
    import subprocess

    out.mkdir(parents=True, exist_ok=True)
    p = subprocess.run(
        [sys.executable, "benchmark/cpu_entry.py", "--workload", cell,
         "--seed", str(seed), "--seconds", str(seconds), "--trace",
         str(trace)], cwd=root, capture_output=True, text=True,
        timeout=timeout, env={**os.environ, "OMP_NUM_THREADS": "1",
                              "CPU_ENTRY_DIR": str(out), **(env or {})})
    return p.returncode, p.stdout, p.stderr, time.time()


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
