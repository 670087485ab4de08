#!/usr/bin/env python3
"""Two ranks on one card through gloo: does gloo take CUDA tensors for each
collective of the sharded path (``nbody_tpu_torch/parallel/collectives.py``)?

    python3 scripts/torch_gloo_two_rank.py

NCCL refuses two ranks on one GPU, so gloo is the only way to run more than
one rank on a one-card machine.  For each collective the script starts two
ranks (fresh interpreters, a ``file://`` store in a temporary directory,
both on ``cuda:0``) that call it once on small CUDA tensors: a rank that
gloo aborts cannot report, so each collective gets its own pair, and its
outcome is "ok", the exception raised, or the ranks' exit codes and the
last line gloo printed.  It prints one JSON line and kills the ranks if
they outlast their time limit.
"""

import json
import os
import shutil
import subprocess
import sys
import tempfile
from datetime import timedelta

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def _probe(mesh, name):
    """"ok" or the error of collective ``name`` on small CUDA tensors."""
    import torch

    from nbody_tpu_torch.parallel import collectives as coll

    dev, r, w = mesh.device, mesh.rank, mesh.world
    x = torch.arange(4, dtype=torch.float32, device=dev) + 10 * r
    checks = {
        "all_gather": lambda: torch.equal(
            coll.all_gather(x, mesh).cpu(),
            torch.cat([torch.arange(4.0) + 10 * k for k in range(w)])),
        "psum": lambda: torch.equal(
            coll.psum(x, mesh).cpu(),
            sum(torch.arange(4.0) + 10 * k for k in range(w))),
        "psum_scatter": lambda: torch.equal(
            coll.psum_scatter(torch.ones(2 * w, device=dev), mesh).cpu(),
            torch.full((2,), float(w))),
        "ring_shift": lambda: torch.equal(
            coll.ring_shift([x], mesh)[0].cpu(),
            torch.arange(4.0) + 10 * ((r - 1) % w)),
    }
    try:
        ok = checks[name]()
        torch.cuda.synchronize()
        return "ok" if ok else "wrong values"
    except Exception as e:  # the probe's finding: record it
        return f"{type(e).__name__}: {e}"[:400]


COLLECTIVES = ("all_gather", "psum", "psum_scatter", "ring_shift")


def rank_main(rank: int, job: str, store: str, out_dir: str):
    """One rank of a pair: probe collective ``job``."""
    import torch
    import torch.distributed as dist

    from nbody_tpu_torch.parallel.mesh import make_mesh

    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                            world_size=2, timeout=timedelta(seconds=60))
    try:
        mesh = make_mesh(2, "cuda")
        res = _probe(mesh, job)
    finally:
        dist.destroy_process_group()
    with open(os.path.join(out_dir, f"{job}_rank{rank}.json"), "w") as f:
        json.dump(res, f)


def _pair(job: str, out_dir: str):
    """Run ``job`` on two ranks: their results, or why there are none."""
    store = os.path.join(out_dir, f"store_{job}")
    env = dict(os.environ, PYTHONPATH=ROOT, LOCAL_RANK="0")
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__),
                               "--rank", str(r), job, store, out_dir],
                              env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(2)]
    rcs, tails = [], []
    for p in procs:
        try:
            text, _ = p.communicate(timeout=180)
            rcs.append(p.returncode)
        except subprocess.TimeoutExpired:
            p.kill()
            text, _ = p.communicate()
            rcs.append("timeout")
        lines = [l for l in (text or "").splitlines() if l.strip()]
        tails.append(lines[-1][-300:] if lines else "")
    res = []
    for r in range(2):
        path = os.path.join(out_dir, f"{job}_rank{r}.json")
        if os.path.exists(path):
            with open(path) as f:
                res.append(json.load(f))
    if len(res) == 2:
        return res
    return {"exit_codes": rcs, "last_lines": tails}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("torch_gloo_two_rank: CUDA is not available", file=sys.stderr)
        return 1
    out_dir = tempfile.mkdtemp(prefix="gloo2_")
    try:
        result = {"probe": {c: _pair(c, out_dir) for c in COLLECTIVES}}
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    if len(sys.argv) > 1 and sys.argv[1] == "--rank":
        rank_main(int(sys.argv[2]), sys.argv[3], sys.argv[4], sys.argv[5])
    else:
        sys.exit(main())
