"""The import guard, and the runs that must end without a result."""

import json
import os
import shutil
import subprocess
import sys
import types

import pytest

from conftest import BENCH, ROOT, run_cell
from harness import device


@pytest.mark.parametrize("name", ["jax", "jaxlib", "flax", "nbody_tpu",
                                  "nbody_tpu.ops.pairwise", "jax.numpy"])
def test_the_guard_catches(name):
    assert device.forbidden_modules({name: None, "numpy": None}) == [name]


@pytest.mark.parametrize("name", ["nbody_tpu_torch", "nbody_tpu_torch.ops",
                                  "jaxtyping", "flaxen", "nbody"])
def test_the_guard_passes(name):
    assert device.forbidden_modules({name: None}) == []


CELL = json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"][0]


def _run_py(cwd, env=None):
    return subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", CELL["name"],
         "--seed", "5", "--seconds", "1", "--trace", "0"], cwd=cwd,
        capture_output=True, text=True, timeout=300,
        env={**os.environ, **(env or {})})


def test_no_card_exits_nonzero_without_a_result():
    p = _run_py(ROOT, {"CUDA_VISIBLE_DEVICES": ""})
    assert p.returncode != 0
    assert "{" not in p.stdout
    assert "cuda" in p.stderr.lower()


def test_the_benchmark_alone_exits_nonzero(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = _run_py(tmp_path)
    assert p.returncode != 0 and "{" not in p.stdout


def test_a_loaded_jax_module_ends_the_run_without_a_result(tree,
                                                           monkeypatch):
    monkeypatch.setitem(sys.modules, "nbody_tpu",
                        types.ModuleType("nbody_tpu"))
    rc, result, err = run_cell(tree, "disc-tiny.batch")
    assert rc != 0 and result is None
    assert "nbody_tpu" in err
