"""On the card: one short run of each cell through ``run.py``, and the
check's reference at 2^25 + 1 rows.  Skips without a card (a cell also
without as many cards as it asks for); run on the chip with
``python -m pytest benchmark/tests/test_bench_cuda.py -q -s``."""

import json
import subprocess
import sys
import time

import pytest

from conftest import ROOT

CELLS = json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]


def _cards(n: int = 1):
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < n:
        pytest.skip(f"needs {n} NVIDIA GPU(s)")
    return torch


@pytest.mark.cuda
@pytest.mark.parametrize("cell", [w["name"] for w in CELLS])
def test_a_short_run_is_correct(cell):
    chips = next(w["chips"] for w in CELLS if w["name"] == cell)
    _cards(chips)
    p = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", cell, "--seed",
         "2147483700", "--seconds", "3", "--trace", "0"], cwd=ROOT,
        capture_output=True, text=True, timeout=900)
    assert p.returncode == 0, p.stderr[-4000:]
    result = json.loads(p.stdout.strip().splitlines()[-1])
    assert result["correct"], result["checks"]
    assert result["device"]["platform"] == "gpu"
    assert result["device"]["count"] == chips


@pytest.mark.cuda
def test_the_check_at_2_25_rows_fits_and_its_time():
    """``step_check`` on the disc at 2^25 + 1 rows (padded to a multiple
    of 32768), with four states on the card as a run's check holds them
    (a pair of its first step's, both of the checked step's): the peak
    stays under 16 GiB.  The state judged is the reference's own step in
    float32.  Prints the seconds and bytes."""
    torch = _cards()
    from harness import check, manifest, reference

    n, seed = 2**25, 2**31 + 97
    pos, vel, mass = manifest.plugin("scenes", "disc").make(
        n, box_width=10.0, seed=seed)
    cap = -(-(n + 1) // 32768) * 32768

    def padded(a):
        t = torch.zeros((cap, *a.shape[1:]), dtype=torch.float32)
        t[:n + 1] = torch.as_tensor(a, dtype=torch.float32)
        return t.cuda()

    alive = torch.arange(cap, device="cuda") < n + 1
    before = {"pos": padded(pos), "vel": padded(vel), "mass": padded(mass),
              "alive": alive}
    before["acc"] = torch.zeros_like(before["pos"])
    del pos, vel, mass
    phys = {"g": 1.0, "eps": 0.02, "dt": 0.03, "center": [0.0, 0.0, 0.0],
            "width": 10.0}
    rows = torch.as_tensor(reference.sample_rows(
        alive.cpu().numpy(), 4096, seed, 0), device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    after = reference.control_step(before, before["acc"], phys, rows,
                                   dtype=torch.float32)
    torch.cuda.synchronize()
    step_s = time.perf_counter() - t0
    held = [{k: v.clone() for k, v in s.items()} for s in (before, after)]
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    numbers = check.stats(reference.step_check(before, after, phys, rows))
    torch.cuda.synchronize()
    check_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    print(json.dumps({"rows": cap, "alive": n + 1, "check_rows": 4096,
                      "chunk": reference.sum_chunk(cap, 8),
                      "check_step_s": check_s, "reference_step_f32_s": step_s,
                      "peak_bytes": peak, "numbers": numbers,
                      "card": torch.cuda.get_device_name(0)}))
    del held
    assert peak < 16 * 2**30
    assert numbers["alive_mismatch"] == 0 and numbers["state_err"] < 1e-5
