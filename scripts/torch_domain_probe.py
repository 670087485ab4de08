#!/usr/bin/env python3
"""Accuracy of the domain-decomposed Barnes-Hut force on several cards.

    python3 scripts/torch_domain_probe.py --world 4 --n 33554431 \
        [--variants '{"fast": {"profile": "fast"}}'] [--steps 0,100,200] \
        [--step-variants '{"fb2k": {"fb_cap": 2048}}'] [--compare] \
        [--seed 0] [--out FILE]

Starts ``--world`` ranks itself (this process is rank 0; one NCCL group
on a ``file://`` store, card ``cuda:<rank>`` a rank), builds the disc of
``--n`` + star from ``--seed`` on every rank and, for each variant (the
``engine_options`` of ``ShardedSimulation(strategy="bh")`` it names: a
``profile`` and ``BHConfig`` fields; "auto" is the default), times one
``domain_accel`` call
after a warm one and reads its force at 4096 sampled alive rows against
the exact float64 sum
(each rank sums over its own shard, then one all-reduce), with the
walk's counters summed over the ranks and the largest rank's memory
peak.  ``--steps`` steps the first variant's ``ShardedSimulation`` and
reads it again at those steps from the scene, and there with each of
``--step-variants`` too: the first variant's configuration with those
``BHConfig`` fields replaced, on the same state.  ``--compare`` also holds
the first variant's call against the single-card ``bh_accel`` of the
whole state on rank 0's card, and against the same call with the wide
rows forced on (``ops/tree.py`` ``WIDE_N`` lowered).  One JSON line a
reading, on rank 0's standard output and in ``--out``.
"""

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROWS = 4096
COMMON = dict(dt=3e-2, g_soft=0.02, theta2=1.0, bounds_width=10.0)


def _exact(tgt, src, mass, eps, budget=2 << 30):
    """The float64 softened sum at ``tgt`` [K, 3] over ``src`` [N, 3]."""
    import torch

    chunk = max(1, min(64, budget // (10 * 8 * src.shape[0])))
    out = torch.empty_like(tgt)
    for i in range(0, tgt.shape[0], chunk):
        d = src[None] - tgt[i:i + chunk, None]
        w = mass[None] * torch.rsqrt((d * d).sum(-1) + eps * eps) ** 3
        out[i:i + chunk] = torch.einsum("cn,cnk->ck", w, d)
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--world", type=int, default=4)
    ap.add_argument("--n", type=int, default=(1 << 25) - 1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--variants", default='{"auto": {}}')
    ap.add_argument("--steps", default="")
    ap.add_argument("--step-variants", default="{}")
    ap.add_argument("--compare", action="store_true")
    ap.add_argument("--out", default=os.path.join(ROOT, "build",
                                                  "domain_probe.jsonl"))
    ap.add_argument("--cpu", action="store_true",
                    help="gloo ranks on the CPU (a rehearsal at a small --n)")
    ap.add_argument("--rank", type=int, default=0)
    ap.add_argument("--store", default=None)
    args = ap.parse_args()

    procs = []
    if args.rank == 0 and args.world > 1:
        args.store = tempfile.mkdtemp(prefix="domain_probe_")
        for r in range(1, args.world):
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), *sys.argv[1:],
                 "--rank", str(r), "--store", args.store],
                env=dict(os.environ, LOCAL_RANK=str(r))))
    try:
        rc = probe(args)
    finally:
        for p in procs:
            p.wait(timeout=600)
    return rc or max([p.returncode for p in procs] or [0])


def probe(args) -> int:
    import numpy as np
    import torch
    import torch.distributed as dist

    sys.path.insert(0, ROOT)
    from nbody_tpu_torch.ops import tree as ttree
    from nbody_tpu_torch.ops.traversal import bh_accel
    from nbody_tpu_torch.parallel import ShardedSimulation
    from nbody_tpu_torch.parallel import collectives as coll
    from nbody_tpu_torch.parallel.domain import domain_accel
    from nbody_tpu_torch.scenes import self_gravitating_disc

    dev = "cpu" if args.cpu else "cuda"
    cuda = dev == "cuda"
    if cuda:
        torch.cuda.set_device(args.rank)
    if args.world > 1:
        dist.init_process_group(
            "nccl" if cuda else "gloo",
            init_method="file://" + os.path.join(args.store, "pg"),
            rank=args.rank, world_size=args.world)
    lead = args.rank == 0
    if lead:
        os.makedirs(os.path.dirname(args.out), exist_ok=True)
    out = open(args.out, "a") if lead else None

    def emit(**rec):
        if lead:
            line = json.dumps(rec)
            print(line, flush=True)
            out.write(line + "\n")
            out.flush()

    name = torch.cuda.get_device_name(0) if cuda else "cpu"
    emit(device=name, world=args.world, n=args.n, seed=args.seed)
    pos, vel, mass = self_gravitating_disc(args.n, seed=args.seed)
    variants = json.loads(args.variants)
    first = next(iter(variants))

    def make(over):
        return ShardedSimulation(pos, vel, mass, engine="bh", strategy="bh",
                                 n_devices=args.world, engine_options=over,
                                 device=dev, **COMMON)

    def read(sim, label, steps, compare=False, over=None):
        st, p, cfg = sim.state, sim.settings, sim._bh_config
        if over:
            cfg = dataclasses.replace(cfg, **over)
        m = st.effective_mass()
        mesh = sim.mesh
        n_loc = st.pos.shape[0]

        def call():
            return domain_accel(st.pos, m, p.bounds, p.theta2, p.g,
                                p.g_soft, cfg, mesh)

        sync = torch.cuda.synchronize if cuda else (lambda: None)
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        call()
        sync()
        t0 = time.perf_counter()
        acc, stats = call()
        sync()
        ms = 1e3 * (time.perf_counter() - t0)
        # the sampled rows, their forces and the exact sums
        alive = coll.all_gather(m > 0, mesh).cpu().numpy()
        rows = np.sort(np.random.default_rng([args.seed, steps]).choice(
            np.nonzero(alive)[0], ROWS, replace=False))
        rows_t = torch.as_tensor(rows, device=st.pos.device)
        mine = (rows_t >= mesh.rank * n_loc) & (rows_t < (mesh.rank + 1)
                                                * n_loc)
        loc = torch.clamp(rows_t - mesh.rank * n_loc, 0, n_loc - 1)
        got = coll.psum(torch.where(mine[:, None], acc[loc].double(), 0.0),
                        mesh)
        tgt = coll.psum(torch.where(mine[:, None], st.pos[loc].double(),
                                    0.0), mesh)
        ref = coll.psum(_exact(tgt, st.pos.double(), m.double(),
                               float(p.g_soft)), mesh)
        rn = ref.norm(dim=1)
        e = (got - ref).norm(dim=1) / torch.clamp(rn, min=float(rn.median()))
        q = torch.quantile(e, torch.tensor([0.5, 0.9, 0.99, 1.0],
                                           dtype=e.dtype, device=e.device))
        counts = {k: int(coll.psum(stats[k].sum().to(torch.int64), mesh))
                  for k in ("accept_dropped", "frontier_fallback",
                            "near_fallback", "fb_spill")}
        peak = coll.all_gather(torch.tensor(
            [torch.cuda.max_memory_allocated() if cuda else 0],
            device=st.pos.device),
            mesh)
        rec = dict(variant=label, steps=steps, ms=round(ms, 2),
                   p50=float(q[0]), p90=float(q[1]), p99=float(q[2]),
                   max=float(q[3]), peak_gb=float(peak.max()) / 1e9,
                   max_level=cfg.max_level, wide=ttree.wide_ranges(
                       n_loc * mesh.world, st.pos.dtype), **counts)
        if compare:
            old = ttree.WIDE_N
            ttree.WIDE_N = 1
            try:
                acc_w, _ = call()
            finally:
                ttree.WIDE_N = old
            rec["wide_vs_call"] = float(coll.psum(
                (acc_w - acc).norm(dim=1).max()[None], mesh).max()
                / rn.median())
            whole_pos = coll.all_gather(st.pos, mesh)
            whole_m = coll.all_gather(m, mesh)
            whole = coll.all_gather(acc, mesh)
            if lead:
                single, _ = bh_accel(whole_pos, whole_m, p.bounds, p.theta2,
                                     p.g, p.g_soft, cfg)
                d = (single - whole).norm(dim=1)
                rec["single_vs_call"] = float(d.max() / rn.median())
                rec["single_p99"] = float(torch.quantile(
                    ((single[rows_t].double() - ref).norm(dim=1)
                     / torch.clamp(rn, min=float(rn.median()))), 0.99))
            del whole_pos, whole_m, whole
            coll.psum(torch.zeros(1, device=st.pos.device), mesh)
        emit(**rec)

    for label, over in variants.items():
        sim = make(over)
        read(sim, label, 0, compare=args.compare and label == first)
        del sim
        if cuda:
            torch.cuda.empty_cache()
    if args.steps:
        sim = make(variants[first])
        done = 0
        for s in sorted(int(x) for x in args.steps.split(",")):
            if s > done:
                t0 = time.perf_counter()
                sim.run(s - done)
                sim.block_until_ready()
                emit(variant=first, ran=s - done,
                     steps_per_s=(s - done) / (time.perf_counter() - t0))
                done = s
            read(sim, first, s)
            for label, over in json.loads(args.step_variants).items():
                read(sim, label, s, over=over)
    if args.world > 1:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
