"""The general traffic generator.  A mix is a data file
(``benchmark/traffic/<mix>.json``) whose ``kind`` names the driver that
runs it (``benchmark/drivers/<kind>.py``, found by name) and whose other
keys are that driver's parameters.  A driver's ``window`` returns what the
metrics read (steps and seconds, and for ``view`` every reply's latency by
route); ``check_step`` runs one more step through the window's own call
once the window has closed, for the check; ``outputs`` gives what else the
window served, compared exactly.

The system under test is built from the configuration alone: its
``system`` (``module:class`` inside ``nbody_tpu_torch``, by default
``nbody_tpu_torch.api:Simulation``), with the physics, engine, dtype and
capacity it states and any further keyword arguments in its
``system_options`` (``compensated``, ``strategy``, ...).
"""

from __future__ import annotations

import importlib

from harness import manifest

DEFAULT_SYSTEM = "nbody_tpu_torch.api:Simulation"


def system_class(config: dict):
    """The class the configuration names; only the program's own."""
    spec = config.get("system", DEFAULT_SYSTEM)
    mod_name, _, attr = spec.partition(":")
    if mod_name.split(".")[0] != "nbody_tpu_torch" or not attr:
        raise manifest.ManifestError(
            f"system {spec!r}: not a class of nbody_tpu_torch")
    return getattr(importlib.import_module(mod_name), attr)


def make_simulation(torch, config: dict, traffic: dict, scene,
                    device="cuda"):
    """The system under test over ``scene`` = (pos, vel, mass), as the
    configuration states it."""
    phys = config["physics"]
    opts = dict(config.get("engine_options") or {})
    opts.update(traffic.get("engine_options") or {})
    pos, vel, mass = scene
    return system_class(config)(
        pos, vel, mass, engine=config["engine"], dtype=getattr(
            torch, config["dtype"]), capacity=config.get("capacity"),
        bounds_center=tuple(phys["center"]), bounds_width=phys["width"],
        engine_options=opts or None, device=device, g=phys["g"],
        g_soft=phys["eps"], dt=phys["dt"], theta2=phys["theta2"],
        **config.get("system_options", {}))


def generator(kind: str, bench_dir=manifest.BENCH_DIR):
    """The driver class of traffic kind ``kind``."""
    return manifest.plugin("drivers", kind, bench_dir).Driver
