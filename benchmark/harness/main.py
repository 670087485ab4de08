"""One run of one cell: set-up, the measured window, the check, the result.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Set-up (``setup_s``, from the start of ``run.py``): import torch and the
program, the scene from ``--seed``, the system as the configuration
states it, the run's first step (kept for the check), and the traffic's
warm-up, which runs every shape the window will use.  The window then runs
for ``--seconds``; with ``--trace 1`` a slice of it is traced and the
per-layer metrics are reported in place of the end-to-end ones.  Once the
window has closed: the memory peak, what else the window served (the
driver's ``outputs``), one more step for the check, the readers, the
program freed, the reference, the guard against JAX modules, and the
result's line, last on standard output.

A cell of more than one card (``chips`` above 1) runs as that many ranks,
one process a card (``harness/ranks.py``): this process is rank 0 and
starts the others.  Every rank makes the same scene, builds the system on
its card, runs the same driver calls (rank 0 decides when the window
ends) and takes part in the gathers: of the whole state for each checked
step (``snapshot``, in rank order, which is the scene's), of the memory
peaks and of the steps each rank made, which must agree.  Rank 0 alone
traces, reads the metrics, runs the reference and prints the result, once
every follower has ended with code 0; a rank that fails ends the run
without a result (``ranks.py`` states how fast).  At one card no process
is started and no process group is made.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import importlib
import json
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path

from harness import check, device, manifest, ranks, reference, trace, traffic


def parse(argv):
    p = argparse.ArgumentParser(prog="benchmark/run.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    # a follower's place, given by rank 0 (harness/ranks.py)
    p.add_argument("--rank", type=int, default=0, help=argparse.SUPPRESS)
    p.add_argument("--store", help=argparse.SUPPRESS)
    return p.parse_args(argv)


class Card:
    """The device a run measures: ``cuda`` (the card, as every run of
    ``run.py``) or ``cpu`` (the tests, which drive a run without one).
    ``team`` (``ranks.Team``) is this rank's place in a run of more than
    one card, None at one."""

    def __init__(self, torch, device: str, team=None):
        self.torch, self.device, self.team = torch, device, team

    def sync(self):
        if self.device == "cuda":
            self.torch.cuda.synchronize()

    def peak_bytes(self) -> int:
        if self.device == "cuda":
            return int(self.torch.cuda.max_memory_allocated())
        return 0

    def describe(self, chips: int) -> dict:
        if self.device == "cuda":
            kind, platform = self.torch.cuda.get_device_name(0), "gpu"
        else:
            kind, platform = "cpu", "cpu"
        peak = self.peak_bytes()
        if self.team is not None:
            peak = max(self.team.ints(peak))
        return {"platform": platform, "kind": kind, "count": chips,
                "memory_peak_bytes": peak}


@dataclass
class Run:
    """What the metric readers read (``benchmark/metrics/<name>.py``)."""
    cell: dict
    config: dict
    traffic: dict
    setup_s: float
    window: dict
    slice: trace.Slice = None
    spied: dict = field(default_factory=dict)


def snapshot(state, to_host: bool, team=None) -> dict:
    """The arrays of ``state`` the check reads, on the host or where the
    state is; with a ``team``, every rank's shard gathered on rank 0 in
    rank order (the shards are contiguous blocks of the padded state, so
    this is the state in the scene's order), and nothing on the other
    ranks."""
    out = {}
    for k in ("pos", "vel", "acc", "mass", "alive"):
        v = getattr(state, k)
        if team is None:
            out[k] = v.cpu() if to_host else v
            continue
        whole = team.gather(v)
        if whole is not None:
            out[k] = whole if to_host else whole.to(v.device)
    return out


@contextlib.contextmanager
def spies(specs):
    """Record every call of each (module, function) in ``specs`` while
    open: ``{"module:function": [(args, kwargs), ...]}``."""
    calls, orig = {}, []
    try:
        for mod_name, attr in specs:
            mod = importlib.import_module(mod_name)
            fn = getattr(mod, attr)
            key = f"{mod_name}:{attr}"
            calls[key] = []

            def spy(*a, _fn=fn, _key=key, **kw):
                calls[_key].append((a, kw))
                return _fn(*a, **kw)

            orig.append((mod, attr, fn))
            setattr(mod, attr, spy)
        yield calls
    finally:
        for mod, attr, fn in orig:
            setattr(mod, attr, fn)


def _declared(readers, name):
    out = []
    for r in readers.values():
        for spec in getattr(r, name, ()):
            if tuple(spec) not in out:
                out.append(tuple(spec))
    return out


def fail(msg: str, code: int = 1) -> int:
    print(f"benchmark: {msg}", file=sys.stderr, flush=True)
    return code


def run(argv, t_start: float, where: str = "cuda",
        root: Path = manifest.ROOT,
        bench_dir: Path = manifest.BENCH_DIR) -> int:
    """``run.py``: one run on the card, or a non-zero exit without one;
    for a cell of more than one card, this rank's part of the run, its
    followers started first on rank 0.  ``where`` is ``cpu`` only in the
    tests, which run the ranks without a card."""
    args = parse(argv)
    m = manifest.load(root / "BENCHMARK.json")
    cell = manifest.cell(m, args.workload)
    chips = cell["chips"]
    followers = None
    if args.rank > 0:
        ranks.watch_rank0()
    elif chips > 1:
        kind = manifest.traffic_of(cell, bench_dir)["kind"]
        if not getattr(traffic.generator(kind, bench_dir), "RANKS", False):
            return fail(f"traffic kind {kind!r} runs on one card; the cell "
                        f"asks for {chips}")
        followers = ranks.Followers(argv, chips)
        args.store = followers.store
    try:
        import torch

        if where == "cuda":
            try:
                device.require_cards(torch, chips)
            except device.NoCard as e:
                return fail(str(e), 2)
        sys.path.insert(0, str(root))
        import nbody_tpu_torch

        if not Path(nbody_tpu_torch.__file__).resolve().is_relative_to(
                root):
            return fail(f"nbody_tpu_torch loaded from "
                        f"{nbody_tpu_torch.__file__}, not from this checkout")
        team = None
        if chips > 1:
            team = ranks.join(torch, where, args.rank, chips, args.store,
                              followers)
        return measure(args, m, t_start, Card(torch, where, team), root,
                       bench_dir)
    finally:
        if followers is not None:
            followers.stop()


def measure(args, m: dict, t_start: float, card: Card,
            root: Path = manifest.ROOT, bench_dir: Path = manifest.BENCH_DIR,
            control: bool = False) -> int:
    """Set-up, window, check and result of the cell ``args.workload`` of
    the manifest ``m`` on ``card``; prints the result and returns 0, or
    prints why not and returns non-zero.  ``control`` (``control.py``,
    never a benchmark run) also puts the reference in the program's place
    in bfloat16 on both checked steps, judges its numbers by the same
    limits and adds them and that verdict to the result under
    ``control``.  A follower (``card.team`` of a rank above 0) makes the
    same calls up to the last gather and returns 0 there."""
    torch = card.torch
    team = card.team
    lead = team is None or team.lead

    cell = manifest.cell(m, args.workload)
    config = manifest.config_of(m, cell, root)
    mix = manifest.traffic_of(cell, bench_dir)
    metrics = (manifest.metrics_for(m, cell["name"], bool(args.trace))
               if lead else [])
    readers = {met["name"]: manifest.reader(met["name"], bench_dir)
               for met in metrics}
    torch.set_num_threads(1)

    # -- set-up -------------------------------------------------------------
    phys = config["physics"]
    seed = args.seed % (1 << 64)
    pos, vel, mass = manifest.plugin("scenes", config["scene"],
                                     bench_dir).make(
        config["n"], box_width=phys["width"], seed=seed,
        **config.get(config["scene"], {}))
    sim = traffic.make_simulation(torch, config, mix, (pos, vel, mass),
                                  card.device)
    drv = traffic.generator(mix["kind"], bench_dir)(sim, card, mix)
    first = [snapshot(sim.state, True, team)]
    drv.step_once()
    first.append(snapshot(sim.state, True, team))
    drv.warm()
    tracer = None
    if args.trace and lead:
        tracer = trace.Tracer(card, _declared(readers, "COUNTERS"),
                              drv.steps_done, float(mix["trace_seconds"]),
                              args.seconds)
        tracer.label_gaps(drv.step_once, int(mix["host_trace_steps"]))
    elif args.trace:  # the steps rank 0 traces in label_gaps
        for _ in range(int(mix["host_trace_steps"])):
            drv.step_once()
    setup_s = time.perf_counter() - t_start

    # -- the window ---------------------------------------------------------
    win = drv.window(args.seconds, tracer)
    card.sync()
    print("benchmark: window " + json.dumps(
        {k: v for k, v in win.items() if isinstance(v, (int, float))}),
        file=sys.stderr)
    dev = card.describe(cell["chips"])

    # -- after the window ---------------------------------------------------
    numbers = drv.outputs()
    exact = sorted(numbers)
    last = [snapshot(sim.state, False, team)]
    with spies(_declared(readers, "SPY")) as spied:
        drv.check_step()
    last.append(snapshot(sim.state, False, team))
    drv.close()
    if team is not None:
        made = team.ints(drv.steps_done())
        if not lead:
            team.finish()
            return 0
        print(f"benchmark: steps by rank {made}", file=sys.stderr)
        if len(set(made)) != 1:
            return fail(f"the ranks made different numbers of steps: {made}")

    data = Run(cell=cell, config=config, traffic=mix, setup_s=setup_s,
               window=win, slice=tracer.read() if tracer else None,
               spied=spied)
    values = {}
    for met in metrics:
        v = readers[met["name"]].read(data)
        if v is not None:
            values[met["name"]] = {"value": float(v), "unit": met["unit"]}
        elif not args.trace:
            return fail(f"end-to-end metric {met['name']} read nothing")
    if card.device == "cuda":
        dev["power_limit"] = device.power_limit()
    if tracer:
        dev["busy_s"] = data.slice.busy_s
        dev["window_s"] = data.slice.wall_s
    breakdown = data.slice.breakdown if tracer else None
    del sim, drv, spied, data, tracer
    gc.collect()
    if card.device == "cuda":
        torch.cuda.empty_cache()

    # -- the check ----------------------------------------------------------
    t_check = time.perf_counter()
    steps, ctl = [], []
    for salt, (b, a) in enumerate((first, last)):
        b = {k: v.to(card.device) for k, v in b.items()}
        a = {k: v.to(card.device) for k, v in a.items()}
        rows = torch.as_tensor(reference.sample_rows(
            a["alive"].cpu().numpy(), int(config["check_rows"]), seed, salt),
            device=card.device)
        steps.append(check.stats(reference.step_check(b, a, phys, rows)))
        if control:
            c = reference.control_step(b, a["acc"], phys, rows)
            ctl.append(check.stats(reference.step_check(b, c, phys, rows)))
    numbers.update(check.combine(steps))
    numbers["dead_inside"] = check.dead_inside(
        last[0]["pos"], last[0]["alive"], config["n"] + 1, phys)
    print(f"benchmark: the check took {time.perf_counter() - t_check:.1f} s",
          file=sys.stderr)
    limits = dict(config["check"])
    limits.update({name: 0 for name in exact})
    correct, table = check.judge(numbers, limits)
    if control:
        ctl_numbers = dict(numbers, **check.combine(ctl))
        ctl_correct, _ = check.judge(ctl_numbers, limits)

    bad = device.forbidden_modules()
    if bad:
        return fail("modules of JAX or of the JAX package are loaded: "
                    + ", ".join(bad), 3)
    if team is not None:
        bad = team.finish()
        if bad:
            return fail(f"ranks {bad} did not end with code 0",
                        ranks.FOLLOWER_FAILED)

    result = {"correct": bool(correct), "attempted": int(win["attempted"]),
              "failed": int(win["failed"]), "metrics": values,
              "device": dev}
    if breakdown is not None:
        result["breakdown"] = breakdown
    if control:
        result["control"] = {"correct": bool(ctl_correct),
                             "numbers": check.combine(ctl)}
    result["checks"] = table
    for name in sorted(numbers):
        print(f"reading {name} {numbers[name]!r}", file=sys.stderr)
    for failure in win.get("failures", [])[:5]:
        print(f"benchmark: request failed: {failure}", file=sys.stderr)
    for name, row in table.items():
        print(f"check {name} {row['value']!r} limit {row['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
