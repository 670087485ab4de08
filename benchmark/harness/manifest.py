"""``BENCHMARK.json`` and the files it names.

A cell (an entry of ``workloads``) names a configuration and a traffic mix.
Everything that belongs to one of them lives in a file of its own, found
by name, so that a configuration, a mix, a scene, a kind of traffic or a
metric is added by adding a file and never by editing one:

  * ``benchmark/configs/<config>.json``  (the ``file`` of its ``configs`` entry)
  * ``benchmark/scenes/<scene>.py``      (the configuration's ``scene``:
    ``make(n, *, box_width, seed, **params)``)
  * ``benchmark/traffic/<traffic>.json`` (the mix's parameters)
  * ``benchmark/drivers/<kind>.py``      (the mix's ``kind``: ``Driver``,
    which drives the window with those parameters)
  * ``benchmark/metrics/<metric>.py``    (a reader: ``read(run)``)
"""

from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
TOP_KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer"}


class ManifestError(ValueError):
    pass


def _line(s, what):
    if not isinstance(s, str) or not 1 <= len(s) <= 200 or any(
            c in s for c in "\n\r\t"):
        raise ManifestError(f"{what}: 1 to 200 characters on one line")


def _name(s, what):
    if not isinstance(s, str) or not NAME.match(s):
        raise ManifestError(f"{what}: {s!r} is not a valid name")


def validate(m: dict) -> dict:
    """Raise ``ManifestError`` where ``m`` breaks the benchmark's rules on
    keys, names, units and references; return ``m``."""
    if set(m) != TOP_KEYS:
        raise ManifestError(f"top-level keys must be {sorted(TOP_KEYS)}")
    if not isinstance(m["run_seconds"], int) or not 1 <= m["run_seconds"] <= 51:
        raise ManifestError("run_seconds: a whole number from 1 to 51")
    configs = {}
    for c in m["configs"]:
        if set(c) != {"name", "source", "file", "reduced", "why"}:
            raise ManifestError(f"config {c.get('name')}: wrong keys")
        _name(c["name"], "config name")
        _line(c["source"], "config source")
        _line(c["why"], "config why")
        for k in c["reduced"]:
            _name(k, "reduced key")
        configs[c["name"]] = c
    if len(configs) != len(m["configs"]):
        raise ManifestError("two configurations share a name")
    cells, pairs = set(), set()
    for w in m["workloads"]:
        if set(w) != {"name", "config", "traffic", "chips", "why"}:
            raise ManifestError(f"workload {w.get('name')}: wrong keys")
        for k in ("name", "config", "traffic"):
            _name(w[k], f"workload {k}")
        _line(w["why"], "workload why")
        if w["config"] not in configs:
            raise ManifestError(f"workload {w['name']}: no config "
                                f"{w['config']!r}")
        if w["chips"] not in (1, 4):
            raise ManifestError(f"workload {w['name']}: chips is 1 or 4")
        if (w["config"], w["traffic"]) in pairs or w["name"] in cells:
            raise ManifestError(f"workload {w['name']} repeats")
        pairs.add((w["config"], w["traffic"]))
        cells.add(w["name"])
    names = set()
    for kind in ("end_to_end", "per_layer"):
        for met in m[kind]:
            keys = ({"name", "unit", "better", "bound", "source"}
                    if kind == "end_to_end" else
                    {"name", "unit", "better", "source", "layer", "moves"})
            if not keys <= set(met) or set(met) - keys - {"workloads"}:
                raise ManifestError(f"metric {met.get('name')}: wrong keys")
            _name(met["name"], "metric name")
            if met["name"] in names:
                raise ManifestError(f"metric {met['name']} repeats")
            names.add(met["name"])
            if not UNIT.match(str(met["unit"])):
                raise ManifestError(f"metric {met['name']}: bad unit")
            if met["better"] not in ("lower", "higher"):
                raise ManifestError(f"metric {met['name']}: better")
            if met["source"] not in SOURCES:
                raise ManifestError(f"metric {met['name']}: source")
            for cell in met.get("workloads", []):
                if cell not in cells:
                    raise ManifestError(f"metric {met['name']}: no cell "
                                        f"{cell!r}")
            if kind == "per_layer":
                _line(met["layer"], "layer")
    e2e = {met["name"] for met in m["end_to_end"]}
    for met in m["per_layer"]:
        if met["moves"] not in e2e:
            raise ManifestError(f"metric {met['name']}: moves "
                                f"{met['moves']!r}, not an end-to-end metric")
    if "setup_s" not in e2e:
        raise ManifestError("setup_s is missing")
    return m


def load(path: Path = None) -> dict:
    path = ROOT / "BENCHMARK.json" if path is None else path
    with open(path) as f:
        return validate(json.load(f))


def cell(m: dict, name: str) -> dict:
    for w in m["workloads"]:
        if w["name"] == name:
            return w
    raise ManifestError(f"no workload {name!r} in BENCHMARK.json")


def config_of(m: dict, w: dict, root: Path = ROOT) -> dict:
    entry = next(c for c in m["configs"] if c["name"] == w["config"])
    with open(root / entry["file"]) as f:
        return json.load(f)


def traffic_of(w: dict, bench_dir: Path = BENCH_DIR) -> dict:
    with open(bench_dir / "traffic" / f"{w['traffic']}.json") as f:
        return json.load(f)


def _reports(met: dict, cell_name: str, reported: set) -> bool:
    if "workloads" in met:
        return cell_name in met["workloads"]
    return met.get("moves", met["name"]) in reported


def metrics_for(m: dict, cell_name: str, trace: bool) -> list:
    """The metric entries a run of ``cell_name`` reports: its end-to-end
    metrics, or with ``trace`` its per-layer ones (those listing the cell,
    or without a list those that move an end-to-end metric it reports)."""
    e2e = [met for met in m["end_to_end"]
           if "workloads" not in met or cell_name in met["workloads"]]
    if not trace:
        return e2e
    reported = {met["name"] for met in e2e}
    return [met for met in m["per_layer"] if _reports(met, cell_name,
                                                      reported)]


def plugin(subdir: str, name: str, bench_dir: Path = BENCH_DIR):
    """The module ``benchmark/<subdir>/<name>.py``."""
    _name(name, subdir)
    path = bench_dir / subdir / f"{name}.py"
    if not path.exists():
        raise ManifestError(f"no {subdir}/{name}.py")
    spec = importlib.util.spec_from_file_location(
        f"bench_{subdir}_{name.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(name: str, bench_dir: Path = BENCH_DIR):
    """The reader module of metric ``name``: ``metrics/<name>.py``."""
    return plugin("metrics", name, bench_dir)
