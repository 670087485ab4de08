"""BENCHMARK.json against the benchmark's rules, and the files it names."""

import copy
import json
import re

import pytest

from conftest import BENCH, ROOT
from harness import manifest


@pytest.fixture
def m():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def test_the_manifest_keeps_the_rules(m):
    manifest.validate(m)
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert 1 <= len(m["paths"]) <= 16 and len(m["command"]) <= 32
    for p in m["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", p)
        assert (ROOT / p).is_dir() and not p.endswith("_torch")
    for word in m["command"][1:]:
        assert not word.startswith("/") and ".." not in word
        assert any(word.startswith(p + "/") for p in m["paths"])
    budget = (2 + 14 * 24) * (m["run_seconds"] + 60) + 24 * 180 + 1200
    assert budget <= 43200


def test_every_cell_and_metric_has_its_files(m):
    used = {w["config"] for w in m["workloads"]}
    for c in m["configs"]:
        assert c["name"] in used
        assert any(c["file"].startswith(p + "/") for p in m["paths"])
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
        assert set(cfg["check"]) >= {"alive_mismatch", "dead_inside",
                                     "state_err"}
    for w in m["workloads"]:
        assert w["chips"] == 1
        manifest.traffic_of(w)
    for met in m["end_to_end"] + m["per_layer"]:
        assert callable(manifest.reader(met["name"]).read)
    for w in m["workloads"]:
        e2e = [x["name"] for x in manifest.metrics_for(m, w["name"], False)]
        assert "setup_s" in e2e and len(e2e) >= 2
        assert manifest.metrics_for(m, w["name"], True)
    bounds = {x["name"]: x["bound"] for x in m["end_to_end"]}
    assert bounds["setup_s"] <= 0.25
    assert all(0.01 <= b <= 0.25 for b in bounds.values())


def test_a_reader_that_finds_nothing_returns_nothing(m):
    from harness.main import Run

    empty = Run(cell={}, config={}, traffic={}, setup_s=1.0,
                window={"seconds": 1.0})
    for met in m["per_layer"]:
        assert manifest.reader(met["name"]).read(empty) is None


@pytest.mark.parametrize("edit", [
    lambda m: m["workloads"][0].update(name="has space"),
    lambda m: m["workloads"][0].update(chips=2),
    lambda m: m["workloads"].append(dict(m["workloads"][0], traffic="x")),
    lambda m: m["workloads"].append(dict(m["workloads"][0], name="other")),
    lambda m: m["workloads"][0].update(config="nowhere"),
    lambda m: m["end_to_end"][0].update(unit="steps per s"),
    lambda m: m["end_to_end"][0].update(better="up"),
    lambda m: m["end_to_end"][0].update(why="a key the contract refuses"),
    lambda m: m["per_layer"][0].update(moves="device_idle_pct"),
    lambda m: m["per_layer"][0].update(source="guess"),
    lambda m: m["per_layer"][0].update(layer="two\nlines"),
    lambda m: m["per_layer"][0].update(workloads=["no-such-cell"]),
    lambda m: m["configs"][0].update(reduced=["bad/key"]),
    lambda m: m.update(run_seconds=52),
    lambda m: m.update(extra=1),
    lambda m: m.update(end_to_end=[x for x in m["end_to_end"]
                                   if x["name"] != "setup_s"]),
])
def test_a_broken_manifest_is_refused(m, edit):
    bad = copy.deepcopy(m)
    edit(bad)
    with pytest.raises(manifest.ManifestError):
        manifest.validate(bad)


def test_metrics_for_a_cell(m):
    names = lambda cell, tr: [x["name"] for x in
                              manifest.metrics_for(m, cell, tr)]
    assert names("disc-100k.batch", False) == ["steps_per_s", "setup_s"]
    assert names("disc-100k.batch", True) == [
        "device_idle_pct", "launches_per_step", "nonkernel_device_ms",
        "k3_roofline_pct"]


def test_the_view_cells_metrics_are_found_for_it_alone():
    from conftest import tiny_manifest

    m = manifest.validate(tiny_manifest())
    names = lambda cell, tr: [x["name"] for x in
                              manifest.metrics_for(m, cell, tr)]
    assert names("disc-tiny.view", False) == ["setup_s",
                                              "viewed_steps_per_s"]
    assert names("disc-tiny.view", True) == ["positions_ms_p95",
                                             "boxes_ms_p50"]
    assert "positions_ms_p95" not in names("disc-tiny.batch", True)
    for met in m["end_to_end"] + m["per_layer"]:
        assert callable(manifest.reader(met["name"]).read)


@pytest.mark.parametrize("subdir,name", [("metrics", "no_such_metric"),
                                         ("drivers", "no-such-kind"),
                                         ("scenes", "no_such_scene"),
                                         ("metrics", "../harness/main")])
def test_a_file_that_is_not_there_is_refused(subdir, name):
    with pytest.raises(manifest.ManifestError):
        manifest.plugin(subdir, name)


def test_files_under_paths_are_named_from_name_characters():
    for p in BENCH.rglob("*"):
        if "__pycache__" in p.parts:
            continue
        rel = p.relative_to(ROOT).as_posix()
        assert re.fullmatch(r"[A-Za-z0-9_./-]+", rel), rel
