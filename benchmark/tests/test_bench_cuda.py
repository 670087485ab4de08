"""On the card: one short run of each cell through ``run.py``.  Skips
without a card; run on the chip with
``python -m pytest benchmark/tests/test_bench_cuda.py -q``."""

import json
import subprocess
import sys

import pytest

from conftest import ROOT

CELLS = json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", [w["name"] for w in CELLS])
def test_a_short_run_is_correct(cell):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    p = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", cell, "--seed",
         "2147483700", "--seconds", "3", "--trace", "0"], cwd=ROOT,
        capture_output=True, text=True, timeout=900)
    assert p.returncode == 0, p.stderr[-4000:]
    result = json.loads(p.stdout.strip().splitlines()[-1])
    assert result["correct"], result["checks"]
    assert result["device"]["platform"] == "gpu"
