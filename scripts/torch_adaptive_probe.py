#!/usr/bin/env python3
"""Step-by-step accuracy of the density-adaptive stacks on the card.

    python3 scripts/torch_adaptive_probe.py [--steps 8] [--out FILE]

Needs one NVIDIA GPU (the kernels are built at first use).  For each of
``chip_smoke.ADAPTIVE_RUNS`` (the bench's Plummer spheres, each on the
stack ``engine="auto"`` resolves there) it steps the run and, at every
step, reads the sampled force error p99_typ of 4096 alive rows against
the K2 oracle for the resolved stack and for budget variants of it, with
the walk's frontier fallbacks.  For the group holding the particle nearest the
centre (the core group) it prints the widest subgroup box and, per walk
level, the cells that want to expand against the level's parent cap.  On
the deep run it also reads the final state of 5 steps driven by the exact
force (``brute-pallas``) and the same walk in float64 plain torch.  One
JSON line a reading goes to ``--out``.
"""

import argparse
import dataclasses
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("torch_adaptive_probe: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from nbody_tpu_torch import Simulation
    from nbody_tpu_torch.ops import traversal as tt
    from nbody_tpu_torch.ops import tree as ttree
    from nbody_tpu_torch.scenes import plummer_sphere

    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--out", default=os.path.join(
        ROOT, "build", "adaptive_probe.jsonl"))
    args = ap.parse_args()
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    out = open(args.out, "w")

    def emit(**rec):
        out.write(json.dumps(rec) + "\n")
        print(json.dumps(rec), flush=True)

    variants = {"resolved": {}, "frontier 4096": dict(frontier_cap=4096),
                "frontier 8192": dict(frontier_cap=8192),
                "big budgets": dict(tt._ADAPTIVE_BIG_BUDGETS),
                "subgroups 256": dict(subgroups=256)}
    # the walk's budget prefixes, recorded per call: (wanting [G], cap)
    capped, log = tt._capped, []

    def logged(mask, cap):
        log.append((mask.sum(1), cap))
        return capped(mask, cap)

    def reading(st, prm, cfg, label, step, name):
        m = st.effective_mass()
        log.clear()
        acc, stats = tt.bh_accel(st.pos, m, prm.bounds, prm.theta2, prm.g,
                                 prm.g_soft, cfg)
        med, p99 = cs.sampled_error(st.pos, m, st.alive, acc)
        emit(run=label, step=step, variant=name, p99_typ=p99, median=med,
             **{k: int(stats[k]) for k in ("accept_dropped",
                                            "frontier_fallback")})

    def core_group(st, prm, cfg, label, step):
        """The core group's widest subgroup box and its expansions wanted
        against each coarse level's parent cap."""
        m = st.effective_mass()
        b0 = prm.bounds.centered()
        tree = ttree.build_octree(st.pos - prm.bounds.center, m, b0,
                                  cfg.max_level, **tt._refine_args(cfg))
        log.clear()
        walk = tt._walk(tree, b0, prm.theta2, prm.g_soft, cfg,
                        st.pos.shape[0])[-1]
        r = tree.pos_s.norm(dim=1) + (tree.mass_s == 0) * 1e30
        g = int(torch.argmin(r)) // cfg.group_size
        B, S = cfg.group_size, cfg.subgroups
        gp = tree.pos_s[g * B:(g + 1) * B].reshape(S, B // S, 3)
        gm = tree.mass_s[g * B:(g + 1) * B].reshape(S, B // S) > 0
        lo = torch.where(gm[..., None], gp, 1e30).amin(1)
        hi = torch.where(gm[..., None], gp, -1e30).amax(1)
        width = (hi - lo).amax(1)[gm.any(1)]
        n_coarse = cfg.max_level - cfg.start_level
        emit(run=label, step=step, core_group=g,
             widest_subgroup=float(width.max()),
             median_subgroup=float(width.median()),
             wanted_vs_parent_cap=[(int(w[g]), c)
                                   for w, c in log[:n_coarse]],
             **{k: int(walk[k][g]) for k in ("frontier_fallback",
                                              "near_fallback",
                                              "refine_near_totals")})

    tt._capped = logged
    try:
        for label, n, width, stack, _ in cs.ADAPTIVE_RUNS:
            pos, vel, mass = plummer_sphere(n, seed=0)
            keep = np.all(np.abs(pos) <= 20.0, axis=1)
            kw = dict(capacity=n, bounds_width=width, device="cuda",
                      dt=3e-2, g_soft=cs.EPS, theta2=1.0)
            # the stack engine='auto' resolves there (chip_smoke phase 19)
            over = dict(getattr(tt, stack))
            sim = Simulation(pos[keep], vel[keep], mass[keep], engine="bh",
                             engine_options=over, **kw)
            for step in range(args.steps + 1):
                st, prm = sim.state, sim.settings
                for name, extra in variants.items():
                    cfg = tt.BHConfig.auto_for(st.capacity,
                                               **{**over, **extra})
                    reading(st, prm, cfg, label, step, name)
                core_group(st, prm, tt.BHConfig.auto_for(st.capacity, **over),
                           label, step)
                sim.run(1)
            if stack != "ADAPTIVE_OVERRIDES":
                continue
            # the deep run's state after 5 steps of the exact force, and
            # the walk in float64 plain torch on the adaptive-driven state
            exact = Simulation(pos[keep], vel[keep], mass[keep],
                               engine="brute-pallas", **kw)
            exact.run(5)
            cfg = tt.BHConfig.auto_for(n, **over)
            reading(exact.state, exact.settings, cfg, label, 5,
                    "resolved, exact-driven state")
            sim.reset()
            sim.run(5)
            st, prm = sim.state, sim.settings
            b64 = dataclasses.replace(prm.bounds,
                                      center=prm.bounds.center.double(),
                                      half_width=prm.bounds.half_width.double())
            m64 = st.effective_mass().double()
            acc, _ = tt.bh_accel(st.pos.double(), m64, b64, prm.theta2,
                                 prm.g, prm.g_soft, dataclasses.replace(
                                     cfg, eval_mode="xla", mxu_blocks=False))
            med, p99 = cs.sampled_error(st.pos, st.effective_mass(),
                                        st.alive, acc.float())
            emit(run=label, step=5, variant="resolved, float64 plain torch",
                 p99_typ=p99, median=med)
            del exact
            del sim
    finally:
        tt._capped = capped
        out.close()
    print(cs.nvidia_smi())
    return 0


if __name__ == "__main__":
    sys.exit(main())
