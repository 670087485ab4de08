"""The four-card cell ``disc-32m.domain``: its entries in BENCHMARK.json,
its configuration and traffic files, its metrics, and the two readers of
the collectives (``collective_ms``, ``collective_mb_per_step``) on
records made up here and on a traced run of four gloo ranks."""

import json

import pytest

from conftest import BENCH, ROOT, ranks_checkout, run_entry
from harness import manifest

CELL = "disc-32m.domain"
SPAN_RING = "nbody_tpu_torch.utils.profiling:RECORDS"
SENT = "nbody_tpu_torch.ops.work:SENT"


@pytest.fixture
def m():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def test_the_domain_cell_keeps_the_rules(m):
    manifest.validate(m)
    cell = manifest.cell(m, CELL)
    assert cell["chips"] == 4
    four = [w for w in m["workloads"] if w["chips"] == 4]
    assert len(four) <= max(1, len(m["workloads"]) // 4)
    cfg = manifest.config_of(m, cell, ROOT)
    assert cfg["n"] == (1 << 25) - 1 and cfg["capacity"] == 1 << 25
    assert cfg["capacity"] // cell["chips"] == 1 << 23
    assert cfg["reduced"] == ["n"]
    assert cfg["system_options"] == {"strategy": "bh",
                                     "n_devices": cell["chips"]}
    assert cfg["engine"] == "bh" and cfg["dtype"] == "float32"
    # the scene and physics of the one-card disc, and no looser limits
    base = json.loads((BENCH / "configs/disc-100k.json").read_text())
    for k in ("scene", "physics", "disc", "check_rows"):
        assert cfg[k] == base[k], k
    for k, limit in base["check"].items():
        assert cfg["check"][k] <= limit, k
    assert cfg["check"]["force_e_p99"] <= 5e-2
    assert cfg["check"]["force_e_p50"] <= 2e-3
    assert manifest.traffic_of(cell) == {
        "kind": "batch", "chunk": 2, "warm_steps": 6,
        "trace_seconds": 10.0, "host_trace_steps": 2}


def test_the_domain_cells_metrics(m):
    names = lambda tr: [x["name"] for x in  # noqa: E731
                        manifest.metrics_for(m, CELL, tr)]
    assert names(False) == ["steps_per_s", "setup_s"]
    assert names(True) == [
        "device_idle_pct", "launches_per_step", "nonkernel_device_ms",
        "k3_roofline_pct", "step_ms", "build_ms", "walk_ms", "fb_eval_ms",
        "assembly_ms", "kernels_ms", "engine_idle_ms",
        "k3_counted_roofline_pct", "collective_ms", "collective_mb_per_step"]
    headless = [x["name"] for x in
                manifest.metrics_for(m, "disc-100k.headless", True)]
    assert "collective_ms" not in headless
    assert "collective_mb_per_step" not in headless


def _run(counters, steps=2):
    from harness.main import Run
    from harness.trace import Slice

    sl = Slice(steps=steps, wall_s=1.0, device_ops=[], busy_s=0.0,
               counters=counters)
    return Run(cell={}, config={}, traffic={}, setup_s=1.0,
               window={"seconds": 1.0}, slice=sl)


def _step(collectives_ms, other_ms=5.0):
    spans = [["step", -1, 0, 1, sum(collectives_ms) + other_ms, False],
             ["walk", 0, 0, 1, other_ms, False]]
    spans += [["collective", 0, 0, 1, ms, False] for ms in collectives_ms]
    return {"root": "step", "tid": 1, "spans": spans}


def test_collective_ms_sums_a_steps_collective_spans():
    reader = manifest.reader("collective_ms")
    records = [_step([1.0, 2.0]), _step([4.0, 0.5]), _step([3.0])]
    assert reader.read(_run({SPAN_RING: (records, records)})) == 3.0
    # one card, or a program that records no collective span
    plain = [_step([]), _step([])]
    assert reader.read(_run({SPAN_RING: (plain, plain)})) is None
    assert reader.read(_run({})) is None


def test_collective_mb_per_step_is_the_counters_growth_a_step():
    reader = manifest.reader("collective_mb_per_step")
    before = {"psum": {"bytes": 1000, "calls": 1}}
    after = {"psum": {"bytes": 5000, "calls": 3},
             "ring_shift": {"bytes": 2_000_000, "calls": 2}}
    got = reader.read(_run({SENT: (before, after)}, steps=2))
    assert got == pytest.approx((4000 + 2_000_000) / 1e6 / 2)
    # nothing sent (one card), or a program without the counter
    assert reader.read(_run({SENT: ({}, {})})) is None
    assert reader.read(_run({})) is None


#: the small four-rank cell's mix with set-up enough for the span readers:
#: they read the steps the recorder kept (one in ``_spans.EVERY``) before
#: the slice, and the warm-up's steps count, however slow the CPU
WARM = {"kind": "batch", "chunk": 1, "warm_steps": 8, "trace_seconds": 0.5,
        "host_trace_steps": 1}


def test_a_traced_run_of_four_ranks_reads_the_collectives(tmp_path_factory):
    """A small cell of four gloo ranks (``disc-shard``, the tests' sharded
    configuration, under a batch mix) given the four-card cell's metrics:
    rank 0's collective spans and bytes are read."""
    root = ranks_checkout(tmp_path_factory.mktemp("domain"))
    (root / "benchmark/traffic/warm8.json").write_text(json.dumps(WARM))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "disc-shard.warm8",
                               "config": "disc-shard", "traffic": "warm8",
                               "chips": 4, "why": "a test's cell"})
    real = json.loads((ROOT / "BENCHMARK.json").read_text())
    ours = {x["name"] for x in manifest.metrics_for(real, CELL, True)}
    for met in bench["end_to_end"] + bench["per_layer"]:
        if met["name"] in ours | {"steps_per_s"}:
            met["workloads"].append("disc-shard.warm8")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    rc, stdout, stderr, _ = run_entry(root, "disc-shard.warm8",
                                      tmp_path_factory.mktemp("out"),
                                      seed=2**31 + 47, seconds=3.0, trace=1)
    assert rc == 0, stderr[-3000:]
    result = json.loads(stdout.strip().splitlines()[-1])
    assert result["correct"] is True
    got = result["metrics"]
    assert got["collective_ms"]["value"] > 0
    assert got["collective_ms"]["unit"] == "ms"
    assert got["collective_ms"]["value"] < got["step_ms"]["value"]
    assert got["collective_mb_per_step"]["value"] > 0
    assert got["collective_mb_per_step"]["unit"] == "MB/step"
