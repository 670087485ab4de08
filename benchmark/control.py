#!/usr/bin/env python3
"""The control of the check: the reference put in the program's place in
bfloat16, the precision below the configuration's float32, read beside the
program's own numbers on the same states.

    python3 benchmark/control.py --workload disc-100k.headless --seeds 1,2,3 \
        --seconds 50

Runs the cell as ``run.py`` does (set-up and a full window, since the
checked state is the one the window ends at) once a seed, in one process,
and prints one JSON line a seed: the program's numbers (``readings``), the
control's (``control``), the verdict of the configuration's limits on the
control's numbers (``control_correct``, which has to be false) and the
limits.  The limits in
``benchmark/configs/<config>.json`` lie between the largest program
reading over a dozen seeds and the smallest control reading (``PERF.md``).
Benchmark runs never run this.
"""

import contextlib
import io
import json
import sys
import time

from harness import main, manifest


def read_numbers(err: str) -> dict:
    out = {}
    for line in err.splitlines():
        if line.startswith("reading "):
            _, name, value = line.split(" ", 2)
            out[name] = float(value)
    return out


def run_control(workload: str, seeds, seconds: float, card, root=None,
                bench_dir=None):
    """One dict a seed: ``seed``, ``correct`` (the program's verdict),
    ``readings``, ``control`` (the control's numbers),
    ``control_correct`` (the verdict of the same limits on them, which has
    to be false) and ``limits``."""
    m = manifest.load(None if root is None else root / "BENCHMARK.json")
    kw = {} if root is None else {"root": root, "bench_dir": bench_dir}
    out = []
    for seed in seeds:
        args = main.parse(["--workload", workload, "--seed", str(seed),
                           "--seconds", str(seconds), "--trace", "0"])
        so, se = io.StringIO(), io.StringIO()
        with contextlib.redirect_stdout(so), contextlib.redirect_stderr(se):
            rc = main.measure(args, m, time.perf_counter(), card,
                              control=True, **kw)
        if rc != 0:
            raise RuntimeError(f"seed {seed}: exit {rc}\n{se.getvalue()}")
        res = json.loads(so.getvalue().strip().splitlines()[-1])
        out.append({"seed": seed, "correct": res["correct"],
                    "readings": read_numbers(se.getvalue()),
                    "control": res["control"]["numbers"],
                    "control_correct": res["control"]["correct"],
                    "limits": {k: v["limit"]
                               for k, v in res["checks"].items()}})
    return out


if __name__ == "__main__":
    import argparse

    import torch

    p = argparse.ArgumentParser(prog="benchmark/control.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, required=True)
    a = p.parse_args()
    if not torch.cuda.is_available():
        sys.exit("benchmark/control.py: no CUDA card")
    sys.path.insert(0, str(manifest.ROOT))
    for row in run_control(a.workload, [int(s) for s in a.seeds.split(",")],
                           a.seconds, main.Card(torch, "cuda")):
        print(json.dumps(row), flush=True)
