"""A cell run end to end on the CPU (the program's plain-torch path, past
the look for a card): the result's line, and a configuration, a traffic
mix and a metric added as new files only."""

import json

import pytest

from conftest import TINY, run_cell


@pytest.fixture(scope="module")
def batch_run(tmp_path_factory):
    from conftest import tiny_manifest, BENCH
    import shutil

    root = tmp_path_factory.mktemp("checkout")
    shutil.copytree(BENCH, root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    (root / "benchmark/configs/disc-tiny.json").write_text(json.dumps(TINY))
    (root / "BENCHMARK.json").write_text(json.dumps(tiny_manifest()))
    return run_cell(root, "disc-tiny.batch", seed=2**31 + 11)


def test_the_last_line(batch_run):
    rc, result, err = batch_run
    assert rc == 0
    assert list(result) == ["correct", "attempted", "failed", "metrics",
                            "device", "checks"]
    assert result["correct"] is True and result["failed"] == 0
    assert set(result["metrics"]) == {"steps_per_s", "setup_s"}
    for v in result["metrics"].values():
        assert set(v) == {"value", "unit"} and v["value"] > 0
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(
        result["device"])
    for row in result["checks"].values():
        assert set(row) == {"value", "limit"}


def test_the_compared_numbers_end_standard_error(batch_run):
    rc, result, err = batch_run
    tail = err.strip().splitlines()[-len(result["checks"]):]
    assert [l.split()[1] for l in tail] == list(result["checks"])
    assert all(l.startswith("check ") and " limit " in l for l in tail)


def test_the_view_cell_counts_the_stepping_threads_steps(tree):
    rc, result, err = run_cell(tree, "disc-tiny.view", seed=2**31 + 17,
                                seconds=4.0)
    assert rc == 0 and result["correct"], err
    assert set(result["metrics"]) == {"viewed_steps_per_s", "setup_s"}
    assert result["metrics"]["viewed_steps_per_s"]["value"] > 0
    assert result["checks"]["payload_mismatch"] == {"value": 0, "limit": 0}


SCENE = """
from harness import manifest


def make(n, *, box_width, seed, **params):
    pos, vel, mass = manifest.plugin("scenes", "disc").make(
        n, box_width=box_width, seed=seed, **params)
    return pos[:, [1, 0, 2]], vel[:, [1, 0, 2]], mass
"""

DRIVER = """
from harness import manifest

batch = manifest.plugin("drivers", "batch")


class Driver(batch.Driver):
    def window(self, seconds, tracer=None):
        self.p = dict(self.p, chunk=self.p["burst"])
        return super().window(seconds, tracer)
"""


READER = """
COUNTERS = [("nbody_tpu_torch.ops.traversal", "HOST_READS")]


def read(run):
    if run.slice is None:
        return None
    before, after = run.slice.counters[
        "nbody_tpu_torch.ops.traversal:HOST_READS"]
    assert set(before) == set(after)
    return run.slice.steps + sum(after.values()) - sum(before.values())
"""


def test_new_files_are_found_by_name(tree):
    """A configuration (with a scene of its own and options passed to the
    system), a traffic mix of a new kind and a per-layer metric reading a
    program counter, that exist only as new files (and the cell naming
    them), run with no file of the benchmark edited."""
    cfg = dict(TINY, name="disc-tiny2", n=1499, capacity=1536,
               scene="swapped", swapped=TINY["disc"],
               system_options={"integrator": "leapfrog"})
    new = {"configs/disc-tiny2.json": json.dumps(cfg),
           "scenes/swapped.py": SCENE,
           "drivers/burst.py": DRIVER,
           "traffic/burst3.json": json.dumps(
               {"kind": "burst", "burst": 3, "warm_steps": 2,
                "trace_seconds": 0.5, "host_trace_steps": 1}),
           "metrics/steps_in_slice.py": READER}
    before = {p: p.read_bytes() for p in (tree / "benchmark").rglob("*")
              if p.is_file()}
    for rel, text in new.items():
        (tree / "benchmark" / rel).write_text(text)
    m = json.loads((tree / "BENCHMARK.json").read_text())
    m["configs"].append({"name": "disc-tiny2", "source": "test",
                         "file": "benchmark/configs/disc-tiny2.json",
                         "reduced": [], "why": "new"})
    m["workloads"].append({"name": "disc-tiny2.burst3",
                           "config": "disc-tiny2", "traffic": "burst3",
                           "chips": 1, "why": "new"})
    for met in m["end_to_end"]:
        if met["name"] == "steps_per_s":
            met["workloads"].append("disc-tiny2.burst3")
    m["per_layer"].append({"name": "steps_in_slice", "unit": "steps",
                           "better": "higher", "source": "program_counter",
                           "layer": "test", "moves": "steps_per_s",
                           "workloads": ["disc-tiny2.burst3"]})
    (tree / "BENCHMARK.json").write_text(json.dumps(m))
    rc, result, err = run_cell(tree, "disc-tiny2.burst3", seconds=0.5)
    assert rc == 0 and result["correct"], err
    assert result["attempted"] % 3 == 0
    rc, result, err = run_cell(tree, "disc-tiny2.burst3", seconds=0.5,
                               trace=1)
    assert rc == 0 and result["metrics"]["steps_in_slice"]["value"] >= 3
    assert {"busy_s", "window_s"} <= set(result["device"])
    assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
    assert all(p.read_bytes() == b for p, b in before.items())


def test_a_system_outside_the_program_is_refused(tree):
    from harness import manifest

    with pytest.raises(manifest.ManifestError):
        run_cell(tree, "disc-tiny.batch", config_edit=lambda c: c.update(
            system="nbody_tpu.api:Simulation"))


def test_reset_every_starts_each_run_from_the_scene():
    """With ``reset_every`` no state the window makes is more steps from
    the runs' start than that, the start is the scene evolved
    ``settle_steps`` in set-up, set-up's steps after it count towards the
    first run, and the check's step after the window never resets."""
    from harness import traffic

    calls = []

    class Sim:
        def run(self, n):
            calls.append(n)

        def reset(self):
            calls.append("reset")

        def init(self):
            calls.append("init")

    class Card:
        team = None

        def sync(self):
            pass

    drv = traffic.generator("batch")(
        Sim(), Card(), {"chunk": 10, "warm_steps": 10, "reset_every": 30,
                        "settle_steps": 45})
    drv.step_once()
    drv.warm()
    win = drv.window(0.05)
    drv.check_step()
    assert calls[:6] == [1, 45, "init", 10, 10, 10]
    assert calls[6] == "reset"
    assert calls[-1] == 1 and calls[-2] == 10
    age, ages = 0, []
    for c in calls[3:-1]:
        age = 0 if c == "reset" else age + c
        ages.append(age)
    assert max(ages) <= 30 and ages[-1] > 0
    assert win["resets"] == calls.count("reset") > 1
    assert win["steps"] == 10 * calls[4:-1].count(10)


def test_a_run_with_resets_is_correct(tree):
    """The check after a window of runs from a settled start, on the
    program's own ``Simulation.init`` and ``reset``: correct, and the
    window reset."""
    mix = {"kind": "batch", "chunk": 1, "warm_steps": 1, "reset_every": 1,
           "settle_steps": 2, "trace_seconds": 0.5, "host_trace_steps": 1}
    (tree / "benchmark/traffic/reset3.json").write_text(json.dumps(mix))
    m = json.loads((tree / "BENCHMARK.json").read_text())
    m["workloads"].append({"name": "disc-tiny.reset3", "config": "disc-tiny",
                           "traffic": "reset3", "chips": 1,
                           "why": "a test's cell"})
    for met in m["end_to_end"] + m["per_layer"]:
        if "disc-tiny.batch" in met.get("workloads", ()):
            met["workloads"].append("disc-tiny.reset3")
    (tree / "BENCHMARK.json").write_text(json.dumps(m))
    rc, result, err = run_cell(tree, "disc-tiny.reset3", seed=2**31 + 23,
                                seconds=3.0)
    assert rc == 0 and result["correct"], err
    window = next(l for l in err.splitlines()
                  if l.startswith("benchmark: window "))
    assert json.loads(window.split(" ", 2)[2])["resets"] >= 1
