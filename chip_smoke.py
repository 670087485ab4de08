#!/usr/bin/env python3
"""On-card smoke test of the PyTorch / CUDA port (``nbody_tpu_torch``).

    python3 chip_smoke.py

Needs one NVIDIA GPU (Hopper: the kernels are built for sm_90a) and the CUDA
toolkit.  It builds the kernels from ``nbody_tpu_torch/csrc`` at first use
(one nvcc per source, all at once), then runs twenty-five phases, each
printing one line and stopping the script with a non-zero exit on failure:

  1. device: the card, its power limit, TF32 off for matmul and cuDNN;
  2. build: compile and load the kernels;
  3. K2 (plain pairwise) against its plain torch twin on the card, at one
     source chunk and at 40000 sources (several chunks, the last ragged),
     at eps > 0 and at eps = 0 with coincident rows; sampled targets
     bitwise equal to the full call's rows, and two calls bitwise equal;
  4. K1 (Newton-3 pairwise) against its plain torch twin on the card, at
     whole and ragged 256-wide tiles and at eps = 0;
  5. the direct-sum path through the CLI: the disc at N = 65536 (65535 + the
     star) for 25 steps on ``brute-pallas``, which must go through K1, and
     at N = 2048 (2047 + the star), which must go through K2; energy drift,
     finiteness, and the final state's forces against the K2 oracle; and
     above 262144 (299999 + the star, 5 steps), K2 at K = N every step,
     its final forces against the plain sum in float64;
  6. times: K1, K2 and their twins with CUDA events (K2 full at 65536 and
     on the 301056-row run's final state, on 1024 targets of the 65536
     disc, as the 4096-row oracle of a 2^20 state, and at 2048, where the
     profiler's device time is printed beside the host-paced wrapper
     time), and steps/s of the CLI run through the kernels and
     through the plain torch engine;
  7. K3 (group force, unmasked and block-dual masked) against its plain
     twin: hand-built slabs of every row species, eps = 0 with coincident
     pairs, bitwise-inert padding tiles, B and S off the kernel's 128-row
     grid, a mask of target tiles finer than a block at eps = 0, and a few
     groups of the slabs that the 1M and 100k walks assemble (the 100k one
     with its real mask);
  8. K4 (quadrupole slab) against its plain twin: the 1M walk's
     accepted-node slab, the 100k walk's block-dual rows, and an eps = 0
     scene at 1e-3 scale; and K4's f32 1/r against the twin's float64
     rsqrt over every positive normal float (mismatches, largest in ulps);
  9. the Barnes-Hut path through the CLI: the flagship configuration (the
     disc at N = 100000 + the star, 100 steps, exact energy) and the 1M
     bench run (N = 1048575 + the star, 10 steps, ``--energy``, which
     resolves to the tree estimator) on ``bh``.  Each run must go through
     its kernels; the 1M drift must be finite and below 5e-3; on its final
     state the walk drops nothing, two force calls are bitwise equal, and
     the forces of 4096 sampled alive rows meet the accuracy envelope
     against the K2 oracle;
 10. times: K3 and K4 beside their twins and bounds at the shapes of both
     runs, steps/s of both runs, and one 1M force call split by phase;
 11. K5 (each group's Newton-3 self square, ``near_sym``) against its plain
     twin: hand-built groups with masked source masses, eps = 0 with
     coincident rows, and the whole calls (every group) that the 1M and
     100k ``near_sym`` walks make, each group held on its own, and those
     against the plain sum in float64; momentum within each group;
 12. K6 (the norm-trick all-pairs kernel of ``brute-pallas-mxu``) against
     its plain twin on the Morton-sorted disc at N = 2048 and 65536;
 13. the ``near_sym`` path through ``Simulation(engine="bh",
     engine_options={"near_sym": True})``: the 1M bench run (10 steps) and
     the 100k flagship (100 steps, exact energy).  Each must launch K5
     every step; on its final state the walk statistics equal a plain bh
     call's, the forces match it to f32 summation order (median and worst
     row) and the K2 oracle within phase 9's envelope, and two calls are
     bitwise equal;
 14. the ``brute-pallas-mxu`` path through the CLI: the disc at N = 65536
     for 25 steps, K6 every step, energy drift, and the forces on the
     initial and the final state against a float64 direct sum (and the K2
     oracle, printed) within 4x the JAX kernel's own error on those states
     (tests/torch_mxu_bound.py);
 15. times: K5 at the 1M and 100k shapes, K3 on the 1M ``near_sym`` slab,
     K6 at 65536, each beside its twin; steps/s with and without
     ``near_sym`` at both sizes; one 1M ``near_sym`` force call split by
     phase;
 16. the tree potential (``bh_potential``, plain torch on the card) on the
     100k and 2^20 discs against the exact pair PE (f32 row tiles summed in
     float64): the relative difference within 3e-3 and 5e-3, the walk
     counters, both times; the calls enqueue with no host sync and two are
     bitwise equal;
 17. the compensated stepper: (a) the two-body orbit of
     tests/test_compensated.py, 10000 steps through K2, plain and
     compensated against the float64 native oracle (compensated below 0.2x
     plain); (b) ``--compensated`` on the 65536 disc (K1; drift below 1e-5,
     steps/s beside plain); (c) ``--compensated --energy`` on the 2^20 disc
     (K3, K4; its final forces in phase 9's envelope; steps/s beside
     plain); (d) a run saved, loaded and continued equals the whole run
     bitwise; (e) one step under an elementwise force is bitwise the CPU's;
 18. momentum, angular momentum and centre of mass over the 65536 K1 run
     within a bound from f32 rounding; the trajectory recorder on 20 bh
     steps of the 100k disc; ``--profile``'s trace holds K1;
 19. the density-adaptive path (``adaptive_phase``): the bench's Plummer
     spheres at 2^20 (box widths 40 and 10) and 131072 (width 40) through
     ``Simulation(engine="auto")``, which must resolve the deep, tight-box
     and mid-N stacks; 4096 sampled rows of each initial state within p99
     5e-2 of the K2 oracle; 5 steps each with K3 and K4 every step; on
     each final state no accept or build drop, refined-near rows taken,
     two force calls bitwise equal, the sampled error printed; K3 and K4
     against their twins on the real adaptive
     slabs; ``--adaptive --energy`` through the CLI; one deep force call
     split by phase, the refined build apart;
 20. the visualizer (``vis_phase``): ``VisServer`` on the 1M ``bh`` disc,
     driven over HTTP: the paused payloads (positions bitwise the
     decimated state), at least 12 steps unpaused with positions and boxes
     polled meanwhile, well-formed boxes, rewind through /api/control,
     ``stop()``; K3 and K4 from the handler thread's ``aux()`` bitwise the
     step's own force call and against their twins; ``Simulation.compile``
     at 1M; the deep stack's refined levels in ``aux()``; ``flops_of`` of
     one step equal to ``bound``'s pair counts (K1 at 65536, K3 + K4 at
     1M);
 21. the single-chip Barnes-Hut variants (``reuse_phase``): walk reuse
     (``--walk-every 4``) at 2^20 and on the 100k flagship through the CLI,
     ``bh-lazy`` at 2^20, a 2D state (the 2D disc at 262144) on ``bh``,
     and ``delta_onepass``, sliding windows, ``quad_leaf`` and ``fb_quad``
     on one 2^20 force call each: K3 and K4 on every path and against
     their twins on the new slabs (2D rows with z = 0, cached slabs with
     stale ids in zero-mass rows), the bh envelope against the K2 oracle,
     one host read a step on the stateful engines, steps/s beside plain
     ``bh`` and a full and a cached step's kernel launches;
 22. the sharded path (``sharded_phase``) at world size 1 over NCCL:
     ``ShardedSimulation`` on ``allgather`` and ``ring`` (the 65536 disc,
     K2) and on ``bh`` (the domain decomposition) and ``bh-replicated``
     (the 2^20 disc, K3 and K4): each force call against the single-chip
     engine's on the same state, without a host sync; K3 and K4 against
     their twins on each strategy's slabs; the sharded exact
     energy, drift, the bh envelope against the K2 oracle, steps/s beside
     the single-chip engines.
 23. the rest of the sharded path (``refined_domain_phase``) at world size
     1 over NCCL: the refined domain route on the 2^20 Plummer deep stack
     (``profile="adaptive"`` on strategy ``bh``: one force call against the
     single-chip adaptive ``bh_accel``, the initial state's sampled p99,
     K3 and K4 every step and against their twins on the refined domain
     slab, no build drop, no host sync, steps/s beside phase 19's); the
     wide row format forced on (``WIDE_N`` lowered) for one domain force
     call on the 2^20 disc against the narrow call, K3 on the wide slab;
     and ``torch.distributed.checkpoint`` round trips of the sphere's
     ``ShardedSimulation`` and of a compensated ``Simulation``;
 24. the build's double-float prefix table (``prefix_phase``): the kernel
     against the exact sums beside its twin at 100096 and 2^20 rows (within
     twice the twin's error, two calls bitwise equal), both timed, and one
     100k ``bh`` step's three tables and launches with the twin and with the
     kernel;
 25. the collect walk kernel (``walk_phase``): bitwise its twin at 100k and
     on profile 'domain' with far budgets, both timed at the 100k tier and
     at 2^23 rows a card beside its bound, and one 100k ``bh`` step's
     launch, launches and steps/s with the twin and with the kernel.

Every kernel's line in the ``kernels`` JSON carries its least time on the
card for the work of the timed call (``bound_ms``, from the operation and
byte counts below and the H100 SXM's published rates) and ``library_ms``:
null, as no single PyTorch call computes a softened-gravity sum.  The line
before the last is the card's name and power limit as nvidia-smi reports
them; the last line is the result JSON.
"""

import dataclasses
import json
import math
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SOURCE = "nbody_tpu_torch/csrc/pairwise.cu"
SOURCE_BH = "nbody_tpu_torch/csrc/group_force.cu"
SOURCE_MXU = "nbody_tpu_torch/csrc/pairwise_mxu.cu"
SOURCE_PS = "nbody_tpu_torch/csrc/prefix_scan.cu"
SOURCE_CW = "nbody_tpu_torch/csrc/collect_walk.cu"
G, EPS = 1.0, 0.02  # the main-path settings (the CLI defaults)

# H100 SXM peaks (NVIDIA's data sheet): FP32 outside the tensor cores, HBM,
# and the MUFU rsqrt (16 a clock on each of 132 SMs at the 1.98 GHz boost)
FP32_PER_S = 67e12
BYTES_PER_S = 3.35e12
RSQRT_PER_S = 132 * 16 * 1.98e9
# FP32 operations a pair of each kernel family ("pair" K2/K3, "sym" K1/K5,
# "quad" K4, "mxu" K6) come from the package's table
# (nbody_tpu_torch/ops/work.py PAIR_OPS), which flops_of counts with too


def require(ok, msg):
    if not ok:
        raise SystemExit(f"chip_smoke FAILED: {msg}")


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return "; ".join(l.strip() for l in out.stdout.splitlines() if l.strip())


def rel_err(got, ref) -> float:
    """max-row |got - ref| over the mean row |ref| (the metric of
    tests/test_pallas_kernels.py)."""
    return float((got - ref).norm(dim=1).max() / ref.norm(dim=1).mean())


def rows_err(got, ref) -> float:
    """rel_err over [G, B, 3] group outputs."""
    return rel_err(got.reshape(-1, 3), ref.reshape(-1, 3))


def pair_ops(kind) -> int:
    """FP32 operations a pair of a kernel family (the package's table)."""
    from nbody_tpu_torch.ops.work import PAIR_OPS

    return PAIR_OPS[kind]


def bound(pairs, kind, nbytes, rsqrts=None):
    """The least time the card could take (ms) and what sets it: the
    larger of the operations (``pairs`` x ``pair_ops(kind)``) over their peak
    rate (FP32, or the rsqrts on the MUFU where those take longer) and the
    bytes over the memory rate (each input read once, each output written
    once)."""
    rsqrts = pairs if rsqrts is None else rsqrts
    t_ops = max(pairs * pair_ops(kind) / FP32_PER_S, rsqrts / RSQRT_PER_S)
    t_bytes = nbytes / BYTES_PER_S
    if t_ops >= t_bytes:
        return t_ops * 1e3, "operations"
    return t_bytes * 1e3, "bytes"


def nnz(x) -> int:
    return int((x != 0).sum())


def k3_pairs(tgt8, slab, tile, mask):
    """K3 needs each target against each massive slab row outside the
    source tiles its mask entry skips."""
    Gs, B = tgt8.shape[:2]
    S = slab.shape[1]
    nz = (slab[..., 3] != 0).reshape(Gs, S // tile, tile).sum(-1)
    if mask is None:
        return B * int(nz.sum())
    return (B // mask.shape[1]) * int(
        ((~mask.bool()).to(nz.dtype) * nz[:, None, :]).sum())


def k3_bound(tgt8, slab, tile, mask):
    Gs, B = tgt8.shape[:2]
    return bound(k3_pairs(tgt8, slab, tile, mask), "pair",
                 Gs * B * 24 + Gs * slab.shape[1] * 16
                 + (0 if mask is None else mask.numel()))


def k4_pairs(tgt8, qslab):
    return tgt8.shape[1] * nnz(qslab[..., 3])


def k4_bound(tgt8, qslab):
    Gs, B = tgt8.shape[:2]
    return bound(k4_pairs(tgt8, qslab), "quad",
                 Gs * B * 24 + qslab.shape[1] * Gs * 40)


def ms(fn, reps):
    """Mean time of ``fn`` over ``reps`` back-to-back calls after one warm
    call (ms, CUDA events)."""
    import torch

    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def device_ms(fn, reps):
    """Device time of one call (ms): torch.profiler's sum over the kernels
    ``reps`` calls launch, over ``reps``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = 0.0
    for ev in prof.key_averages():
        t = getattr(ev, "self_device_time_total", None)
        us += getattr(ev, "self_cuda_time_total", 0.0) if t is None else t
    require(us > 0, "torch.profiler saw no device time")
    return us / 1e3 / reps


def split_call(run):
    """One force call ``run()`` split at its phase marks by the span
    recorder (``nbody_tpu_torch/utils/profiling.py``: each phase's ms on
    the card's timeline, a name's phases summed); the second of two calls
    is the one kept."""
    import torch
    from nbody_tpu_torch.utils import profiling

    was = profiling.SPANS.on, profiling.SPANS.every
    profiling.SPANS.enable()
    try:
        for _ in range(2):
            with profiling.annotate("call", "cuda"):
                run()
            torch.cuda.synchronize()
            rec = profiling.SPANS.resolve()[-1]
    finally:
        profiling.SPANS.on, profiling.SPANS.every = was
    split = {}
    for name, parent, _, _, ms, _ in rec["spans"][1:]:
        if parent == 0:
            split[name] = round(split.get(name, 0.0) + ms, 3)
    split["total"] = round(sum(split.values()), 3)
    return split


def record_calls(run, names=("group_force", "quad_force"), module=None):
    """Run ``run()`` with the kernel wrappers ``names`` of ``module``
    (ops/group_force by default) spied on: returns {name: [(args, kwargs),
    ...]}, the slabs the walk gave each kernel."""
    import torch
    from nbody_tpu_torch.ops import group_force

    gf = group_force if module is None else module
    calls = {k: [] for k in names}
    orig = {k: getattr(gf, k) for k in names}

    def spy(name):
        def call(*a, **kw):
            calls[name].append((a, kw))
            return orig[name](*a, **kw)
        return call

    try:
        for k in names:
            setattr(gf, k, spy(k))
        run()
    finally:
        for k, fn in orig.items():
            setattr(gf, k, fn)
    torch.cuda.synchronize()
    return calls


def sampled_error(pos, m_eff, alive, acc, seed=0):
    """|da| / max(|a|, median |a|) on 4096 sampled alive rows against the
    K2 oracle (the bench's measure): (median, p99)."""
    import numpy as np
    import torch
    from nbody_tpu_torch.ops import pairwise as pw

    rows = torch.as_tensor(np.sort(np.random.default_rng(seed).choice(
        np.nonzero(alive.cpu().numpy())[0], 4096, replace=False)),
        device=pos.device)
    oracle = pw.pairwise_acc_targets(pos[rows], pos, m_eff, G, EPS)
    rn = oracle.norm(dim=1)
    err = ((acc[rows] - oracle).norm(dim=1)
           / torch.clamp(rn, min=float(rn.median()))).cpu().numpy()
    return float(np.median(err)), float(np.percentile(err, 99))


# phase 19: the bench's adaptive scenes (bench.py:168-224: Plummer spheres
# of seed 0, |pos| <= 20 kept, dt 3e-2, eps 0.02, theta^2 1), the stack
# engine='auto' must resolve, and the JAX package's own sampled p99_typ
# there (VALIDATION.md sections 19-20; a TPU reading, for comparison only)
ADAPTIVE_RUNS = (
    ("1M deep w40", 1 << 20, 40.0, "ADAPTIVE_OVERRIDES", 0.0268),
    ("1M tight w10", 1 << 20, 10.0, "ADAPTIVE_TIGHT_OVERRIDES", 0.0402),
    ("131k mid-N w40", 131072, 40.0, "ADAPTIVE_MIDN_OVERRIDES", 0.0065),
)
STEPS_ADAPTIVE = 5


def adaptive_phase():
    """Phase 19, the density-adaptive path on the card.  (a, b) each of
    ADAPTIVE_RUNS through ``Simulation(engine="auto")``: the resolved stack,
    4096 sampled rows of the initial state against the K2 oracle within
    p99 5e-2 (the state of the JAX package's readings); 5 steps with K3
    and K4 launched every step; on the final state no accept or build
    drop, refined-near rows taken, two force calls bitwise equal, the
    sampled error (printed: the deep stack leaves its envelope at some
    steps, in both packages) beside the fast profile's, force calls/s,
    and (e) K3 and K4
    against their twins on a few groups of the real adaptive slabs (the
    group with the most refined-near rows among them), with their times
    and bounds.  (c) ``--adaptive --energy`` on the 2^20 sphere through the
    CLI.  (d) one deep force call split at the phase marks, the refined
    build apart.  Returns the kernel launches and readings for the kernels
    line."""
    import numpy as np
    import torch
    from nbody_tpu_torch import Simulation, cli
    from nbody_tpu_torch.ops import group_force as gf
    from nbody_tpu_torch.ops import traversal as tt
    from nbody_tpu_torch.scenes import plummer_sphere

    out = {"launches": {}, "k3_abs": 0.0, "k4_abs": 0.0}
    parts = []
    for label, n, width, stack, jax_p99 in ADAPTIVE_RUNS:
        pos, vel, mass = plummer_sphere(n, seed=0)
        keep = np.all(np.abs(pos) <= 20.0, axis=1)
        sim = Simulation(pos[keep], vel[keep], mass[keep], engine="auto",
                         capacity=n, bounds_width=width, device="cuda",
                         dt=3e-2, g_soft=EPS, theta2=1.0)
        want = dict(profile="adaptive", **getattr(tt, stack))
        require(sim.engine_options == want,
                f"{label}: engine='auto' resolved {sim.engine_options}")
        over = {k: v for k, v in want.items() if k != "profile"}
        cfg = tt.BHConfig.auto_for(sim.state.capacity, **over)
        # the envelope on the initial state, where the JAX package's
        # readings were taken (bench.py:196-222)
        st0 = sim.state
        m0 = st0.effective_mass()
        acc0, _ = tt.bh_accel(st0.pos, m0, sim.settings.bounds,
                              sim.settings.theta2, sim.settings.g,
                              sim.settings.g_soft, cfg)
        med0, p99_0 = sampled_error(st0.pos, m0, st0.alive, acc0)
        require(p99_0 < 5e-2, f"{label}: sampled p99_typ {p99_0:.4f} on "
                f"the initial state (median {med0:.3e})")
        del st0, m0, acc0
        sim.run(1)  # warm: the allocator's first sizes
        sim.block_until_ready()
        sim.reset()
        gf.reset_launch_counts()
        t0 = time.perf_counter()
        sim.run(STEPS_ADAPTIVE)
        sim.block_until_ready()
        rate = STEPS_ADAPTIVE / (time.perf_counter() - t0)
        counts = gf.launch_counts()
        out["launches"][label] = counts
        out.setdefault("rates", {})[label] = rate
        k3_runs = counts["group_force"] + counts["group_force_masked"]
        k4_per = 2 if cfg.block_dual else 1
        require(k3_runs >= STEPS_ADAPTIVE
                and counts["quad_force"] >= k4_per * STEPS_ADAPTIVE,
                f"{label}: launches {counts} in {STEPS_ADAPTIVE} steps")

        st, prm = sim.state, sim.settings
        require(bool(torch.isfinite(st.pos).all()
                     & torch.isfinite(st.vel).all()),
                f"{label}: final state is not finite")
        m_eff = st.effective_mass()

        def call(c=cfg, **kw):
            return tt.bh_accel(st.pos, m_eff, prm.bounds, prm.theta2, prm.g,
                               prm.g_soft, c, **kw)

        res = {}
        calls = record_calls(lambda: res.update(first=call()))
        acc, stats = res["first"]
        require(torch.equal(acc, call()[0]),
                f"{label}: two force calls differ")
        require(bool(torch.isfinite(acc).all()), f"{label}: not finite")
        walk = {k: int(stats[k].sum()) for k in (
            "accept_dropped", "frontier_fallback", "near_fallback",
            "fb_spill", "refine_near_totals", "refine_build_dropped")}
        require(walk["accept_dropped"] == 0
                and walk["refine_build_dropped"] == 0
                and walk["refine_near_totals"] > 0,
                f"{label}: walk counters {walk}")
        # printed, not held: the deep stack's frontier cap overflows on
        # the core group at some steps (PERF.md section 6)
        med, p99 = sampled_error(st.pos, m_eff, st.alive, acc)
        acc_f, stats_f = call(tt.BHConfig.auto_for(st.capacity))
        med_f, p99_f = sampled_error(st.pos, m_eff, st.alive, acc_f)
        calls_ms = ms(call, 3)

        # (e) the kernels on the real adaptive slabs
        rnt = stats["refine_near_totals"]
        (a3, k3), = calls["group_force"]
        G_ = a3[0].shape[0]
        sel = sorted({0, G_ // 2, G_ - 1, int(rnt.argmax())})
        e3, abs3 = k3_check(*pick(a3, k3, sel), f"{label} slab")
        k3_ms = ms(lambda: gf.group_force(*a3, **k3), 5)
        k3_bnd = k3_bound(a3[0], a3[1], k3["tile"], k3["mask"])
        kparts = [f"K3 {tuple(a3[0].shape)} x {tuple(a3[1].shape)}"
                  + ("" if k3["mask"] is None else
                     f" mask {tuple(k3['mask'].shape)} "
                     f"({int(k3['mask'].sum())} set)")
                  + f", groups {sel}: {e3:.2e}, {k3_ms:.3f} ms (bound "
                  f"{k3_bnd[0]:.3f})"]
        for i, (a4, k4) in enumerate(calls["quad_force"]):
            dual = cfg.block_dual and i == 0
            rows = (list(range(0, a4[0].shape[0],
                               max(1, a4[0].shape[0] // 8))) if dual
                    else sel)
            e4, abs4 = k4_check(*pick(a4, k4, rows), f"{label} K4 {i}")
            k4_ms = ms(lambda: gf.quad_force(*a4, **k4), 5)
            kparts.append(f"K4 {'dual rows' if dual else 'accepted'} "
                          f"{tuple(a4[0].shape)} x {tuple(a4[1].shape)}: "
                          f"{e4:.2e}, {k4_ms:.3f} ms (bound "
                          f"{k4_bound(a4[0], a4[1])[0]:.4f})")
            out["k4_abs"] = max(out["k4_abs"], abs4)
        out["k3_abs"] = max(out["k3_abs"], abs3)
        del calls
        parts.append(
            f"{label} ({int(keep.sum())} in the box, capacity "
            f"{st.capacity}, ml{cfg.max_level}+R{cfg.refine_levels} t"
            f"{cfg.refine_threshold}, group {cfg.group_size}, block_dual "
            f"{cfg.block_dual}): {STEPS_ADAPTIVE} steps launches {counts}, "
            f"{rate:.3f} steps/s; initial state p99_typ {p99_0:.4f} median "
            f"{med0:.3e} (JAX's TPU reading {jax_p99}); final state: {walk},"
            f" p99_typ {p99:.4f} median {med:.3e} (fast profile p99 "
            f"{p99_f:.4f} median {med_f:.3e}), {1e3 / calls_ms:.3f} "
            f"force calls/s ({calls_ms:.1f} ms), two calls bitwise equal; "
            + "; ".join(kparts))
        if label.startswith("1M deep"):
            # (d) one deep force call split at its phase marks
            out["split"] = split_call(call)
            # the refined tree potential on the same state beside the
            # fast-profile estimator --energy uses (the JAX package's too)
            u_ad, _ = tt.bh_potential(st.pos, m_eff, prm.bounds, prm.theta2,
                                      prm.g, prm.g_soft, cfg)
            u_f, _ = tt.bh_potential(st.pos, m_eff, prm.bounds, prm.theta2,
                                     prm.g, prm.g_soft, tt.BHConfig.auto_for(
                                         st.capacity, multipole="mono",
                                         fb_cap=2048))
            require(math.isfinite(float(u_ad)), "refined potential")
            out["potential"] = (float(u_ad), float(u_f))
        del sim, st, acc, acc_f

    # (c) the CLI's --adaptive on the 2^20 sphere
    gf.reset_launch_counts()
    r = cli.main(["--scene", "plummer", "-n", str(1 << 20), "--box-width",
                  "40", "--engine", "bh", "--adaptive", "--steps",
                  str(STEPS_ADAPTIVE), "--energy", "--json", "--device",
                  "cuda"])
    counts = gf.launch_counts()
    out["launches"]["CLI"] = counts
    require(counts["group_force"] >= 2 * STEPS_ADAPTIVE
            and counts["quad_force"] >= 2 * STEPS_ADAPTIVE,
            f"--adaptive: launches {counts}")
    require(math.isfinite(r["energy_drift"]),
            f"--adaptive: drift {r['energy_drift']}")
    u_ad, u_f = out["potential"]
    parts.append(
        f"CLI --adaptive, 2^20 sphere w40, {STEPS_ADAPTIVE} steps: launches "
        f"{counts} (warm run included), {r['steps_per_second']:.3f} steps/s"
        f", drift {r['energy_drift']:.3e} ({r['energy_method']}); refined "
        f"tree potential on the deep state {u_ad:.7e} (fast estimator "
        f"{u_f:.7e}, {abs(u_ad - u_f) / abs(u_f):.2e} apart); one deep "
        f"force call (ms): {json.dumps(out['split'])}, "
        f"{1e3 / out['split']['total']:.3f} force calls/s")
    print("[19 adaptive] " + " | ".join(parts), flush=True)
    return out


# phase 20: the visualizer at the bh main path's full width (the JAX
# package's done criterion for it was python -m nbody_tpu.vis --n 1000000)
VIS_N = 1048575  # + the star: 2^20 rows
VIS_MAX_POINTS = 100_000
VIS_MIN_STEPS = 12
VIS_WAIT_S = 120.0
FLOPS_BRUTE_N = 65535  # + the star: the 65536 brute-pallas run (K1)
ADAPTIVE_N = 1 << 20


def k1_pairs(pos, mass) -> int:
    """K1 needs every unordered pair with a massive member once."""
    n, nm = pos.shape[0], nnz(mass)
    return nm * (nm - 1) // 2 + nm * (n - nm)


def spy_kernels(run):
    """``run()`` with K3 and K4 spied on, in whichever thread calls them:
    {name: [(args, kwargs, output, (start, end) CUDA events)]}."""
    import torch
    from nbody_tpu_torch.ops import group_force as gf

    calls = {"group_force": [], "quad_force": []}
    orig = {k: getattr(gf, k) for k in calls}

    def spy(name):
        def call(*a, **kw):
            ev = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
            ev[0].record()
            res = orig[name](*a, **kw)
            ev[1].record()
            calls[name].append((a, kw, res, ev))
            return res
        return call

    try:
        for k in calls:
            setattr(gf, k, spy(k))
        run()
    finally:
        for k, fn in orig.items():
            setattr(gf, k, fn)
    torch.cuda.synchronize()
    return calls


def vis_phase():
    """Phase 20, the visualizer on the card, through the HTTP surface the
    browser uses.  (a) Boot ``VisServer`` in-process on the 1,048,575 +
    star disc on ``bh`` (dt 3e-2, eps 0.02, theta^2 1, f32, 100000 points,
    port 0).  (b) Paused: /api/meta's n_alive and point_stride,
    /api/positions under 1.5 MB and bitwise the state's decimated rows,
    / serves the page.  (c) Unpaused: at least 12 steps within a time
    limit, then /api/positions and /api/boxes timed while it steps.  (d)
    The boxes are 7-f32 records, at most 20000, min < max, depth fraction
    in [0, 1]; ``aux()``'s walk counters finite, nothing dropped.  (e)
    Paused, 3 steps forward and 3 back through /api/control: elapsed back
    within 1e-6 relative.  One /api/boxes poll with K3 and K4 spied on in
    the handler thread: their device times inside one ``aux()``, their
    outputs bitwise the step's own force call's on the same state (main
    thread), and a few groups against their twins.  (f) ``stop()`` leaves
    no stepping thread; K3 and K4 were launched every step.  (g)
    ``Simulation.compile(10)`` on a fresh 1M run leaves the state and the
    reset target bitwise unchanged; the first timed step after it within
    2x the median of the next 5.  (h) ``aux()`` on the 2^20 Plummer sphere's
    deep stack renders more than 8 levels.  (i) ``flops_of`` of one step
    on the 65536 ``brute-pallas`` run and on the 1M ``bh`` run: the kernel
    part equals ``bound``'s pair count for K1, and for K3 + K4, on the
    shapes the step gave them.  Returns the launches and readings for the
    kernels line."""
    import urllib.request

    import numpy as np
    import torch
    from nbody_tpu_torch import Simulation
    from nbody_tpu_torch.ops import group_force as gf
    from nbody_tpu_torch.ops import pairwise as pw
    from nbody_tpu_torch.scenes import plummer_sphere, self_gravitating_disc
    from nbody_tpu_torch.utils.profiling import flops_of
    from nbody_tpu_torch.vis.server import VisServer

    def bh_sim(n):
        return Simulation(*self_gravitating_disc(n, seed=0), engine="bh",
                          device="cuda", dt=3e-2, g_soft=EPS, theta2=1.0)

    out = {}
    t_boot = time.perf_counter()
    sim = bh_sim(VIS_N)
    gf.reset_launch_counts()
    srv = VisServer(sim, port=0, max_points=VIS_MAX_POINTS)
    httpd = srv.serve(block=False)
    base = f"http://127.0.0.1:{httpd.server_address[1]}"

    def get(path):
        t0 = time.perf_counter()
        data = urllib.request.urlopen(base + path, timeout=300).read()
        return data, (time.perf_counter() - t0) * 1e3

    def post(body):
        req = urllib.request.Request(base + "/api/control",
                                     data=json.dumps(body).encode(),
                                     method="POST")
        return json.loads(urllib.request.urlopen(req, timeout=300).read())

    def wait_steps(n, what):
        deadline = time.perf_counter() + VIS_WAIT_S
        while srv.loop.steps_done < n:
            require(srv.loop.is_alive() and time.perf_counter() < deadline,
                    f"vis {what}: {srv.loop.steps_done} of {n} steps in "
                    f"{VIS_WAIT_S:.0f} s (loop error {srv.loop.error!r})")
            time.sleep(0.01)

    try:
        # (a, b) boot, paused checks
        meta = json.loads(get("/api/meta")[0])
        boot_s = time.perf_counter() - t_boot
        stride = -(-sim.state.capacity // VIS_MAX_POINTS)
        require(meta["n_alive"] == VIS_N + 1
                and meta["point_stride"] == stride,
                f"vis /api/meta at boot: {meta}")
        st = sim.state
        want = st.pos[::stride][st.alive[::stride]].cpu().numpy().tobytes()
        paused = [get("/api/positions") for _ in range(5)]
        blob = paused[-1][0]
        require(len(blob) < 1.5e6 and all(b == want for b, _ in paused),
                f"vis /api/positions: {len(blob)} bytes, bitwise the "
                f"decimated state: {blob == want}")
        html = get("/")[0]
        require(html.startswith(b"<!DOCTYPE html>")
                and b"/api/positions" in html, "vis / does not serve the page")
        # (c) stepping
        require(post({"cmd": "pause"})["paused"] is False, "vis unpause")
        wait_steps(VIS_MIN_STEPS, "stepping")
        # the loop's step time (an EMA) with no payload polled meanwhile,
        # then after the polls, which share the card and the interpreter
        quiet = json.loads(get("/api/meta")[0])
        stepping = [get("/api/positions")[1] for _ in range(5)]
        boxes = [get("/api/boxes") for _ in range(3)]
        meta = json.loads(get("/api/meta")[0])
        # (d) the boxes
        rec = np.frombuffer(boxes[-1][0], np.float32)
        require(rec.size > 0 and rec.size % 7 == 0,
                f"vis /api/boxes: {rec.size} floats")
        rec = rec.reshape(-1, 7)
        require(rec.shape[0] <= srv.max_boxes
                and bool(np.all(rec[:, 0:3] < rec[:, 3:6]))
                and 0.0 <= rec[:, 6].min() and rec[:, 6].max() <= 1.0,
                f"vis boxes: {rec.shape[0]} records, malformed")
        # (e) rewind, paused
        require(post({"cmd": "pause"})["paused"] is True, "vis pause")
        with srv.loop.lock:  # the frame in flight ends first
            e0, n0 = sim.elapsed, srv.loop.steps_done
        post({"cmd": "step", "k": 3})
        wait_steps(n0 + 3, "3 steps forward")
        e3 = sim.elapsed
        post({"cmd": "step", "k": -3})
        wait_steps(n0 + 6, "3 steps back")
        with srv.loop.lock:
            e_back = sim.elapsed
        require(e3 > e0 and abs(e_back - e0) <= 1e-6 * abs(e0),
                f"vis rewind: elapsed {e0!r} -> {e3!r} -> {e_back!r}")
        # one poll's aux() from the handler thread, K3 and K4 spied on
        t0 = time.perf_counter()
        aux_calls = spy_kernels(lambda: out.update(poll=get("/api/boxes")))
        aux_poll_ms = (time.perf_counter() - t0) * 1e3
        aux = sim.aux()
    finally:
        srv.stop()
    require(not srv.loop.is_alive(), "vis: a SimLoop thread outlived stop()")
    require(srv.loop.error is None, f"vis loop error {srv.loop.error!r}")
    launches = gf.launch_counts()
    steps = srv.loop.steps_done
    require(launches["group_force"] + launches["group_force_masked"] >= steps
            and launches["quad_force"] >= steps,
            f"vis: {steps} steps launched {launches}")
    walk = {k: v for k, v in aux.items() if k != "tree_boxes"}
    require(all(math.isfinite(v) for v in walk.values())
            and walk["accept_dropped"] == 0, f"vis aux counters {walk}")
    out["launches"] = launches

    # the aux() kernels against the step's own force call on the same state
    # and against their twins
    st = sim.state
    step_calls = spy_kernels(lambda: sim.engine.force(
        st.pos, st.effective_mass(), sim.settings))
    parts, k_ms = [], {}
    for name, check in (("group_force", k3_check), ("quad_force", k4_check)):
        require(len(aux_calls[name]) == len(step_calls[name]) >= 1,
                f"vis {name}: {len(aux_calls[name])} calls in aux(), "
                f"{len(step_calls[name])} in a step")
        for (a, kw, res, ev), (_, _, res_s, _) in zip(aux_calls[name],
                                                      step_calls[name]):
            require(torch.equal(res, res_s), f"vis {name}: aux() and the "
                    "step's force call differ on the same state")
            # three spread groups and the one with the most massive rows
            G_ = a[0].shape[0]
            busiest = int((a[1][..., 3] != 0).sum(dim=1).argmax())
            e, abs_ = check(*pick(a, kw, sorted({0, G_ // 2, G_ - 1,
                                                 busiest})),
                            f"vis aux {name}")
            out[f"{name}_abs"] = max(out.get(f"{name}_abs", 0.0), abs_)
            k_ms[name] = k_ms.get(name, 0.0) + ev[0].elapsed_time(ev[1])
            parts.append(f"{name} {tuple(a[0].shape)} x {tuple(a[1].shape)}"
                         f" vs plain {e:.2e}")
    n_rec = len(out["poll"][0]) // 28
    del srv, sim, st, aux_calls, step_calls

    # (g) compile at 1M, (i) flops_of of one 1M bh step
    sim = bh_sim(VIS_N)
    snap = {k: getattr(sim.state, k).clone()
            for k in ("pos", "vel", "acc", "time")}
    initial = sim._initial
    t0 = time.perf_counter()
    require(sim.compile(10) is sim, "compile did not return the Simulation")
    compile_s = time.perf_counter() - t0
    require(sim._initial is initial
            and all(torch.equal(getattr(sim.state, k), v)
                    and torch.equal(getattr(initial, k), v)
                    for k, v in snap.items()),
            "compile changed the state or the reset target")
    step_ms = []
    for _ in range(6):
        t0 = time.perf_counter()
        sim.step()
        sim.block_until_ready()
        step_ms.append((time.perf_counter() - t0) * 1e3)
    med = float(np.median(step_ms[1:]))
    require(step_ms[0] <= 2 * med, f"first step after compile "
            f"{step_ms[0]:.1f} ms, median of the next 5 {med:.1f} ms")
    fl = {}
    calls = record_calls(lambda: fl.update(bh=flops_of(sim.run, 1)))
    want_bh = (sum(k3_pairs(a[0], a[1], kw["tile"], kw["mask"])
                   for a, kw in calls["group_force"]) * pair_ops("pair")
               + sum(k4_pairs(a[0], a[1]) for a, kw in calls["quad_force"])
               * pair_ops("quad"))
    kf = fl["bh"]["kernel_flops"]
    got_bh = sum(kf.get(k, 0) for k in ("group_force", "group_force_masked",
                                        "quad_force"))
    require(got_bh == want_bh, f"flops_of K3 + K4 {got_bh} vs bound's "
            f"{want_bh} ({kf})")
    del sim, calls

    # (i) flops_of of one step on the 65536 brute-pallas run
    sim = Simulation(*self_gravitating_disc(FLOPS_BRUTE_N, seed=0),
                     engine="brute-pallas", device="cuda", dt=3e-2,
                     g_soft=EPS)
    calls = record_calls(lambda: fl.update(k1=flops_of(sim.run, 1)),
                         names=("pairwise_acc_sym",), module=pw)
    want_k1 = sum(k1_pairs(a[0], a[1])
                  for a, _ in calls["pairwise_acc_sym"]) * pair_ops("sym")
    got_k1 = fl["k1"]["kernel_flops"]
    require(len(calls["pairwise_acc_sym"]) == 1
            and got_k1 == {"pairwise_acc_sym": want_k1},
            f"flops_of K1 {got_k1} vs bound's {want_k1}")
    del sim, calls

    # (h) the refined levels' boxes on the deep stack (phase 19's sphere)
    pos, vel, mass = plummer_sphere(ADAPTIVE_N, seed=0)
    keep = np.all(np.abs(pos) <= 20.0, axis=1)
    sim = Simulation(pos[keep], vel[keep], mass[keep], engine="auto",
                     capacity=ADAPTIVE_N, bounds_width=40.0, device="cuda",
                     dt=3e-2, g_soft=EPS, theta2=1.0)
    t0 = time.perf_counter()
    deep = sim.aux()
    deep_ms = (time.perf_counter() - t0) * 1e3
    levels = [n for *_, n in deep["tree_boxes"]]
    require(sum(n > 0 for n in levels) > 8 and deep["accept_dropped"] == 0,
            f"deep-stack boxes: per-level counts {levels}, {deep}")
    del sim

    print(f"[20 visualizer] {nvidia_smi()} | the {VIS_N + 1}-row bh disc: "
          f"boot {boot_s:.2f} s; {steps} steps seen; step_time_ms "
          f"{quiet['step_time_ms']} unpolled ({quiet['steps']} steps, fps "
          f"{quiet['fps']}), {meta['step_time_ms']} after the polls below "
          f"({meta['steps']} steps, fps {meta['fps']}); /api/positions "
          f"{len(blob) / 1e6:.3f} MB, bitwise the decimated state, "
          f"paused {np.median([t for _, t in paused]):.1f} ms, stepping "
          f"{np.median(stepping):.1f} ms (median of 5); /api/boxes stepping "
          f"{np.median([t for _, t in boxes]):.1f} ms (median of 3), "
          f"paused {aux_poll_ms:.1f} ms, {n_rec} records; K3 "
          f"{k_ms['group_force']:.3f} ms + K4 {k_ms['quad_force']:.3f} ms "
          f"inside one aux(), bitwise the step's; " + ", ".join(parts)
          + f"; aux counters {walk}; rewind +3/-3: elapsed {e0!r} -> "
          f"{e_back!r}; launches {launches} | compile(10) at {VIS_N + 1} "
          f"{compile_s:.2f} s, state and reset target unchanged, steps "
          f"after it (ms) {[round(t, 1) for t in step_ms]} | deep-stack "
          f"aux() {deep_ms:.0f} ms, boxes per level {levels} | flops_of "
          f"one step: {FLOPS_BRUTE_N + 1} brute-pallas K1 "
          f"{got_k1['pairwise_acc_sym']:.4e}"
          f" = bound's, total {fl['k1']['flops']:.4e}, "
          f"{fl['k1']['bytes_accessed']} B; {VIS_N + 1} bh K3 + K4 "
          f"{got_bh:.4e} = "
          f"bound's, total {fl['bh']['flops']:.4e}, "
          f"{fl['bh']['bytes_accessed']} B", flush=True)
    return out


# phase 21: walk reuse, bh-lazy, 2D states and the BH options off the
# default path, at the main path's widths
REUSE_N = 1048575  # + the star: 2^20 rows
REUSE_EVERY = 4
REUSE_STEPS = 12
LAZY_STEPS = 10
FLAGSHIP_N = 100000  # + the star
FLAGSHIP_STEPS = 100
DISC2D_N = 262144
DISC2D_STEPS = 10
# a 2D config that drops nothing, held if the auto preset drops nodes on
# the 2D disc (the walk budgets of the dense profile)
DISC2D_FALLBACK = dict(accept_cap=4096, frontier_cap=4096)


def busiest(slab) -> int:
    """The group of a slab [G, S, 8 or 16] with the most massive rows."""
    return int((slab[..., 3] != 0).sum(1).argmax())


def launches_in(run):
    """(kernel launches through the runtime API, kernels on the card) of
    ``run()``, read once with torch.profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    host = card = 0
    for e in prof.key_averages():
        if e.key in ("cudaLaunchKernel", "cuLaunchKernel",
                     "cudaLaunchKernelExC"):
            host += e.count
        if str(getattr(e, "device_type", "")).endswith("CUDA"):
            card += e.count
    return host, card


def spy_engine(fn_name, run):
    """``run()`` with the engines' ``fn_name`` (``bh_accel_reuse`` or
    ``bh_accel_lazy``) spied on: the stats dict of every call."""
    from nbody_tpu_torch.engines import barnes_hut as ebh

    seen = []
    orig = getattr(ebh, fn_name)

    def spy(*a, **kw):
        res = orig(*a, **kw)
        seen.append(res[1])
        return res

    setattr(ebh, fn_name, spy)
    try:
        out = run()
    finally:
        setattr(ebh, fn_name, orig)
    return out, seen


def reuse_phase():
    """Phase 21, the single-chip Barnes-Hut variants on the card.  (a) walk
    reuse at 2^20 through the CLI (``--walk-every 4``, 12 steps,
    ``--energy``): the full walks (3 unless the moved-fraction guard
    fires), K3 and K4 every step, one counted host read a step, the drift
    finite and below 5e-3; on the final state the engine's own cached call
    within the bh envelope against the K2 oracle, and at the positions of
    a full walk the cached call equal to it (1e-6, bitwise printed);
    steps/s beside plain ``bh``.  (b) ``bh-lazy`` at 2^20, 10 steps: the
    rebuilds, the final state's forces in the envelope, ``refresh_octree``
    at unchanged positions equal to a fresh build (integer tables exactly,
    masses and COMs to 1e-6); steps/s.  (c) walk reuse on the 100k
    flagship (100 steps, exact energy): drift below 1e-3, the launches of
    a full and of a cached step (torch.profiler), steps/s beside plain
    ``bh``.  (d) a 2D state (the 2D disc at 262144) on ``bh`` through
    ``Simulation``: 10 steps, K3 and K4 with z = 0 rows every step, no
    walk drop, sampled forces against the K2 oracle, K3 and K4 against
    their twins on a group of the 2D slabs.  (e) one 2^20 ``bh`` force
    call each with ``delta_onepass`` (bitwise the default), sliding
    windows (interior groups bitwise, boundary groups in the envelope),
    ``quad_leaf`` and ``quad_leaf`` + ``fb_quad`` (in the envelope), with
    their times.  Returns the launches and readings for the kernels
    line."""
    import numpy as np
    import torch
    from nbody_tpu_torch import Simulation, cli
    from nbody_tpu_torch.ops import group_force as gf
    from nbody_tpu_torch.ops import pairwise as pw
    from nbody_tpu_torch.ops import traversal as tt
    from nbody_tpu_torch.ops import tree as ttree
    from nbody_tpu_torch.ops import _build
    from nbody_tpu_torch.scenes import disc_2d, self_gravitating_disc

    out = {"launches": {}, "k3_abs": 0.0, "k4_abs": 0.0}
    parts = []
    common = dict(dt=3e-2, g_soft=EPS, theta2=1.0)

    def cli_run(label, argv, spied=None):
        """A CLI run with its final state saved: (result, launches, spied
        stats, the final state as a Simulation of ``engine_options``)."""
        ckpt_dir = tempfile.TemporaryDirectory(prefix="chip_smoke_",
                                               dir=_build.BUILD_DIR)
        ckpt = os.path.join(ckpt_dir.name, "state.pkl")
        gf.reset_launch_counts()
        tt.reset_host_reads()
        run = lambda: cli.main([*argv, "--json", "--device", "cuda",
                                "--save", ckpt])
        r, seen = spy_engine(spied, run) if spied else (run(), [])
        counts = gf.launch_counts()
        out["launches"][label] = counts
        nums = [v for v in r.values() if isinstance(v, float)]
        require(all(map(math.isfinite, nums)), f"{label}: {r}")
        return r, counts, seen, dict(tt.HOST_READS), ckpt, ckpt_dir

    def envelope(label, st, acc, dim=3):
        """The bh envelope against the K2 oracle on 4096 sampled alive
        rows (2D rows as z = 0)."""
        pos, a = st.pos, acc
        if dim == 2:
            pos = torch.nn.functional.pad(pos, (0, 1))
            a = torch.nn.functional.pad(acc, (0, 1))
        med, p99 = sampled_error(pos, st.effective_mass(), st.alive, a)
        require(med < 2e-3 and p99 < 5e-2,
                f"{label}: sampled median {med:.3e}, p99 {p99:.3e}")
        return med, p99

    # (a) walk reuse at 2^20 through the CLI, plain bh beside it
    steps_total = 2 * REUSE_STEPS  # the CLI's warm run, then the timed one
    r, counts, seen, reads, ckpt, ckpt_dir = cli_run(
        "1M walk-every", ["-n", str(REUSE_N), "--engine", "bh",
                          "--walk-every", str(REUSE_EVERY), "--steps",
                          str(REUSE_STEPS), "--energy"], "bh_accel_reuse")
    timed = seen[-REUSE_STEPS:]
    flags = [s["full_walk"] for s in timed]
    # the rule: a walk every REUSE_EVERY steps of age, and whenever more
    # than half the particles left their cells (the engine's default 0.5)
    want, age = [], 0
    for s in timed:
        want.append(int(age % REUSE_EVERY == 0 or s["moved_frac"] > 0.5))
        age = 1 if want[-1] else age + 1
    guard = [i for i, s in enumerate(timed) if s["moved_frac"] > 0.5]
    require(len(seen) == steps_total, f"1M reuse: {len(seen)} force calls")
    require(flags == want, f"1M reuse: full walks {flags}, rule {want}")
    if not guard:
        require(sum(flags) == REUSE_STEPS // REUSE_EVERY,
                f"1M reuse: full walks {flags}")
    require(counts["group_force"] >= steps_total
            and counts["quad_force"] >= steps_total,
            f"1M reuse: launches {counts}")
    require(reads["moved_frac"] == steps_total,
            f"1M reuse: {reads} host reads in {steps_total} steps")
    require(r["energy_drift"] < 5e-3, f"1M reuse drift {r['energy_drift']}")
    sim = Simulation(*self_gravitating_disc(REUSE_N, seed=0), engine="bh",
                     engine_options=dict(walk_every=REUSE_EVERY),
                     device="cuda", **common).load(ckpt)
    ckpt_dir.cleanup()
    sim.run(2)  # a full walk at the loaded state, then a cached step
    st, prm = sim.state, sim.settings
    tree, topo, age = sim._carry
    m = st.effective_mass()
    cfg = tt.BHConfig.auto_for(st.capacity)
    acc, stats, *_ = tt.bh_accel_reuse(st.pos, m, prm.bounds, prm.theta2,
                                       prm.g, prm.g_soft, tree, topo, age,
                                       cfg, REUSE_EVERY)
    require(stats["full_walk"] == 0, f"1M reuse: age {age} walked")
    med_a, p99_a = envelope("1M reuse cached call", st, acc)
    # at the positions of a full walk, the cached call is the full one
    b0 = prm.bounds.centered()
    pos_c = st.pos - prm.bounds.center
    t_full = ttree.build_octree(pos_c, m, b0, cfg.max_level,
                                **tt._build_args(cfg))
    a_full, _, topo_f = tt.traverse_tree(t_full, b0, prm.theta2, prm.g,
                                         prm.g_soft, cfg, st.capacity,
                                         return_topo=True)
    t_ref = ttree.refresh_octree(t_full, pos_c, m, quad=True,
                                 quad_leaf=cfg.quad_leaf)
    calls = record_calls(lambda: out.update(cached=tt.traverse_tree_cached(
        t_ref, topo_f, prm.theta2, prm.g, prm.g_soft, cfg, st.capacity)))
    a_cached = out.pop("cached")[0]
    e_static = rel_err(a_cached, a_full)
    require(e_static < 1e-6, f"1M cached vs full at static positions: "
            f"{e_static:.3e}")
    bitwise = torch.equal(a_cached, a_full)
    (a3, k3), = calls["group_force"]
    stale = int(((a3[1][..., 3] == 0) & (a3[1][..., 4] != 0)).sum())
    e3, abs3 = k3_check(*pick(a3, k3, [0, a3[0].shape[0] // 2]),
                        "cached 1M slab")
    (a4, k4), = calls["quad_force"]
    e4, abs4 = k4_check(*pick(a4, k4, [busiest(a4[1])]), "cached 1M slab")
    out["k3_abs"] = max(out["k3_abs"], abs3)
    out["k4_abs"] = max(out["k4_abs"], abs4)
    t_cached_ms = ms(lambda: tt.traverse_tree_cached(
        t_ref, topo_f, prm.theta2, prm.g, prm.g_soft, cfg, st.capacity), 3)
    t_full_ms = ms(lambda: tt.bh_accel(st.pos, m, prm.bounds, prm.theta2,
                                       prm.g, prm.g_soft, cfg), 3)
    del sim, st, tree, topo, t_full, t_ref, topo_f, calls, a3, a4
    gf.reset_launch_counts()
    r_bh = cli.main(["-n", str(REUSE_N), "--engine", "bh", "--steps",
                     str(REUSE_STEPS), "--json", "--device", "cuda"])
    out["launches"]["1M bh beside"] = gf.launch_counts()
    parts.append(
        f"(a) 2^20 --walk-every {REUSE_EVERY}, {REUSE_STEPS} steps: full "
        f"walks {sum(flags)} at steps {[i for i, f in enumerate(flags) if f]}"
        f" (guard fired at {guard}), launches {counts} and {steps_total} "
        f"host reads in {steps_total} steps (warm run included), "
        f"{r['steps_per_second']:.3f} steps/s (plain bh "
        f"{r_bh['steps_per_second']:.3f}), drift {r['energy_drift']:.3e} "
        f"({r['energy_method']}); final state's cached call vs K2 median "
        f"{med_a:.3e} p99 {p99_a:.3e}; at a full walk's positions cached vs "
        f"full {e_static:.2e} (bitwise {bitwise}), {t_cached_ms:.2f} ms "
        f"cached against {t_full_ms:.2f} ms build + walk + eval; cached "
        f"slab {stale} zero-mass rows with stale ids, K3 {e3:.2e}, K4 "
        f"{e4:.2e} vs twins")

    # (b) bh-lazy at 2^20
    r, counts, seen, reads, ckpt, ckpt_dir = cli_run(
        "1M bh-lazy", ["-n", str(REUSE_N), "--engine", "bh-lazy", "--steps",
                       str(LAZY_STEPS)], "bh_accel_lazy")
    rebuilds = [i for i, s in enumerate(seen[-LAZY_STEPS:]) if s["rebuilt"]]
    fracs = [s["moved_frac"] for s in seen[-LAZY_STEPS:]]
    require(counts["group_force"] >= 2 * LAZY_STEPS
            and counts["quad_force"] >= 2 * LAZY_STEPS,
            f"1M bh-lazy: launches {counts}")
    require(reads["moved_frac"] == 2 * LAZY_STEPS,
            f"1M bh-lazy: {reads} host reads")
    sim = Simulation(*self_gravitating_disc(REUSE_N, seed=0),
                     engine="bh-lazy", device="cuda", **common).load(ckpt)
    ckpt_dir.cleanup()
    sim.run(2)  # refreshed steps over the loaded state's tree
    st, prm = sim.state, sim.settings
    m = st.effective_mass()
    acc, carry = sim.engine.force_carry(st.pos, m, prm, sim._carry)
    med_b, p99_b = envelope("1M bh-lazy", st, acc)
    pos_c = st.pos - prm.bounds.center
    t0_ = ttree.build_octree(pos_c, m, prm.bounds.centered(), cfg.max_level,
                             quad=True, quad_leaf=cfg.quad_leaf)
    t1_ = ttree.refresh_octree(t0_, pos_c, m, quad_leaf=cfg.quad_leaf)
    for name in ("order", "code_s", "leaf_starts"):
        require(torch.equal(getattr(t0_, name), getattr(t1_, name)),
                f"refresh {name}")
    worst = 0.0
    for a, b in zip(t0_.level_table, t1_.level_table):
        require(torch.equal(a[:, 4:], b[:, 4:]), "refresh ranges")
        mm = a[:, 0].abs().clamp_min(1e-30)
        worst = max(worst, float(((a[:, :4] - b[:, :4]).abs()
                                  / mm[:, None]).max()))
    require(worst < 1e-6, f"refresh vs build: {worst:.3e}")
    refresh_bitwise = all(torch.equal(a, b) for a, b in
                          zip(t0_.level_table, t1_.level_table))
    del sim, st, carry, t0_, t1_
    parts.append(
        f"(b) 2^20 bh-lazy, {LAZY_STEPS} steps: rebuilds at steps "
        f"{rebuilds}, moved fractions {[round(f, 4) for f in fracs]}, "
        f"launches {counts}, {r['steps_per_second']:.3f} steps/s (plain bh "
        f"{r_bh['steps_per_second']:.3f}); final state vs K2 median "
        f"{med_b:.3e} p99 {p99_b:.3e}; refresh at unchanged positions vs a "
        f"fresh build: integer tables equal, statistics {worst:.1e} "
        f"(bitwise {refresh_bitwise})")

    # (c) walk reuse on the 100k flagship, plain bh beside it
    r, counts, seen, reads, ckpt, ckpt_dir = cli_run(
        "100k walk-every", ["-n", str(FLAGSHIP_N), "--engine", "bh",
                            "--walk-every", str(REUSE_EVERY), "--steps",
                            str(FLAGSHIP_STEPS), "--energy",
                            "--energy-exact"], "bh_accel_reuse")
    ckpt_dir.cleanup()
    full_c = sum(s["full_walk"] for s in seen[-FLAGSHIP_STEPS:])
    require(r["energy_drift"] < 1e-3, f"100k reuse drift {r['energy_drift']}")
    require(counts["group_force_masked"] >= 2 * FLAGSHIP_STEPS
            and counts["quad_force"] >= 4 * FLAGSHIP_STEPS,
            f"100k reuse: launches {counts}")
    gf.reset_launch_counts()
    r_bh = cli.main(["-n", str(FLAGSHIP_N), "--engine", "bh", "--steps",
                     str(FLAGSHIP_STEPS), "--json", "--device", "cuda"])
    out["launches"]["100k bh beside"] = gf.launch_counts()
    sim = Simulation(*self_gravitating_disc(FLAGSHIP_N, seed=0),
                     engine="bh", engine_options=dict(walk_every=REUSE_EVERY),
                     device="cuda", **common)
    sim.run(REUSE_EVERY)  # warm; the next step walks, the one after not
    sim.block_until_ready()
    require(sim._carry[2] == REUSE_EVERY, f"age {sim._carry[2]}")
    l_full = launches_in(sim.step)
    l_cached = launches_in(sim.step)
    plain = Simulation(*self_gravitating_disc(FLAGSHIP_N, seed=0),
                       engine="bh", device="cuda", **common)
    plain.run(1)
    l_plain = launches_in(plain.step)
    del sim, plain
    parts.append(
        f"(c) 100k --walk-every {REUSE_EVERY}, {FLAGSHIP_STEPS} steps: "
        f"{full_c} full walks, launches {counts}, "
        f"{r['steps_per_second']:.3f} steps/s (plain bh "
        f"{r_bh['steps_per_second']:.3f}), drift {r['energy_drift']:.3e} "
        f"({r['energy_method']}); kernel launches (runtime calls, kernels "
        f"on the card) a step: full {l_full}, cached {l_cached}, plain bh "
        f"{l_plain}")

    # (d) a 2D state on bh
    pos2, vel2, mass2 = disc_2d(DISC2D_N, seed=0)
    kw2 = dict(engine="bh", bounds_center=(0.0, 0.0), bounds_width=10.0,
               device="cuda", **common)
    sim = Simulation(pos2, vel2, mass2, **kw2)
    st = sim.state
    cfg2 = dataclasses.replace(tt.BHConfig.auto_for(st.capacity), dim=2)
    _, s0 = tt.bh_accel(st.pos, st.effective_mass(), sim.settings.bounds,
                        1.0, 1.0, EPS, cfg2)
    walk0 = {k: int(s0[k]) for k in ("accept_dropped", "frontier_fallback",
                                     "near_fallback", "fb_spill")}
    held = "auto preset"
    if walk0["accept_dropped"]:
        held = f"auto preset + {DISC2D_FALLBACK} (auto dropped: {walk0})"
        sim = Simulation(pos2, vel2, mass2, engine_options=DISC2D_FALLBACK,
                         **kw2)
        cfg2 = dataclasses.replace(cfg2, **DISC2D_FALLBACK)
    sim.run(1)
    sim.block_until_ready()
    sim.reset()
    gf.reset_launch_counts()
    t0 = time.perf_counter()
    sim.run(DISC2D_STEPS)
    sim.block_until_ready()
    rate2 = DISC2D_STEPS / (time.perf_counter() - t0)
    counts = gf.launch_counts()
    out["launches"]["2D 262144"] = counts
    k3_2d = counts["group_force"] + counts["group_force_masked"]
    require(k3_2d >= DISC2D_STEPS and counts["quad_force"] >= DISC2D_STEPS,
            f"2D: launches {counts}")
    st, prm = sim.state, sim.settings
    m = st.effective_mass()
    res = {}
    calls = record_calls(lambda: res.update(r=tt.bh_accel(
        st.pos, m, prm.bounds, prm.theta2, prm.g, prm.g_soft, cfg2)))
    acc, s2 = res["r"]
    walk2 = {k: int(s2[k]) for k in ("accept_dropped", "frontier_fallback",
                                     "near_fallback", "fb_spill")}
    require(walk2["accept_dropped"] == 0, f"2D walk {walk2}")
    require(acc.shape == st.pos.shape and st.pos.shape[1] == 2, "2D shapes")
    z = max(float(a[0][..., 2].abs().max()) + float(a[1][..., 2].abs().max())
            for c in calls.values() for a, _k in c)
    require(z == 0.0, f"2D: K3/K4 rows with z != 0 ({z})")
    med_d, p99_d = envelope("2D 262144", st, acc, dim=2)
    (a3, k3), *_ = calls["group_force"]
    e3, abs3 = k3_check(*pick(a3, k3, [a3[0].shape[0] // 2]), "2D slab")
    a4, k4 = calls["quad_force"][-1]
    e4, abs4 = k4_check(*pick(a4, k4, [busiest(a4[1])]), "2D slab")
    out["k3_abs"] = max(out["k3_abs"], abs3)
    out["k4_abs"] = max(out["k4_abs"], abs4)
    del sim, st, calls, a3, a4
    parts.append(
        f"(d) 2D disc {DISC2D_N} on bh ({held}; group {cfg2.group_size}, "
        f"block_dual {cfg2.block_dual}), {DISC2D_STEPS} steps: launches "
        f"{counts}, {rate2:.3f} steps/s; final state: {walk2}, vs K2 (z = 0"
        f" rows) median {med_d:.3e} p99 {p99_d:.3e}; K3 {e3:.2e}, K4 "
        f"{e4:.2e} vs twins on a group of the 2D slabs (z column all 0)")

    # (e) the options on one 2^20 bh force call each
    pos, vel, mass = self_gravitating_disc(REUSE_N, seed=0)
    sim = Simulation(pos, vel, mass, engine="bh", device="cuda", **common)
    st, prm = sim.state, sim.settings
    m = st.effective_mass()
    cfg = tt.BHConfig.auto_for(st.capacity)

    def call(**over):
        c = dataclasses.replace(cfg, **over)
        return tt.bh_accel(st.pos, m, prm.bounds, prm.theta2, prm.g,
                           prm.g_soft, c)[0]

    a0 = call()
    readings = [f"default {ms(call, 3):.2f} ms, median/p99 "
                "{:.3e}/{:.3e}".format(*envelope("default", st, a0))]
    a1 = call(delta_onepass=True)
    require(torch.equal(a0, a1), "delta_onepass changed the forces")
    readings.append(f"delta_onepass bitwise equal, "
                    f"{ms(lambda: call(delta_onepass=True), 3):.2f} ms")
    a2 = call(sliding_window=True)
    order = ttree.build_octree(st.pos - prm.bounds.center, m,
                               prm.bounds.centered(), cfg.max_level).order
    B = cfg.group_size
    edge = torch.zeros(st.capacity, dtype=torch.bool, device=st.pos.device)
    edge[order[:B]] = True
    edge[order[-B:]] = True
    require(torch.equal(a2[~edge], a0[~edge]),
            "sliding_window changed an interior group")
    rows = torch.nonzero(edge & st.alive).squeeze(1)
    oracle = pw.pairwise_acc_targets(st.pos[rows], st.pos, m, G, EPS)
    rn = oracle.norm(dim=1)
    err = ((a2[rows] - oracle).norm(dim=1)
           / torch.clamp(rn, min=float(rn.median()))).cpu().numpy()
    med_e, p99_e = float(np.median(err)), float(np.percentile(err, 99))
    require(med_e < 2e-3 and p99_e < 5e-2,
            f"sliding boundary groups: median {med_e:.3e} p99 {p99_e:.3e}")
    readings.append(
        f"sliding_window interior groups bitwise equal, boundary groups "
        f"({rows.numel()} rows, all of them vs K2) median {med_e:.3e} p99 "
        f"{p99_e:.3e}, "
        f"{ms(lambda: call(sliding_window=True), 3):.2f} ms")
    for over in (dict(quad_leaf=True), dict(quad_leaf=True, fb_quad=True)):
        a = call(**over)
        med, p99 = envelope(str(over), st, a)
        readings.append(f"{over} median {med:.3e} p99 {p99:.3e}, "
                        f"{ms(lambda: call(**over), 3):.2f} ms")
    # the same two sums in float64 (plain torch on the card): whether the
    # fallback quadrupole's tail comes from the f32 rounding or the
    # expansion itself
    b64 = dataclasses.replace(prm.bounds, center=prm.bounds.center.double(),
                              half_width=prm.bounds.half_width.double())
    for over in (dict(quad_leaf=True), dict(quad_leaf=True, fb_quad=True)):
        c = dataclasses.replace(cfg, eval_mode="xla", **over)
        a = tt.bh_accel(st.pos.double(), m.double(), b64, prm.theta2, prm.g,
                        prm.g_soft, c)[0].float()
        med, p99 = sampled_error(st.pos, m, st.alive, a)
        readings.append(f"{over} in float64 median {med:.3e} p99 {p99:.3e}")
    del sim, st, a0, a1, a2, a
    parts.append("(e) one 2^20 bh force call: " + "; ".join(readings))
    print(f"[21 reuse, lazy, 2D, options] {nvidia_smi()} | "
          + " | ".join(parts), flush=True)
    return out


# phase 22: the sharded path at world size 1 over NCCL, at the main paths'
# sizes: the direct-sum disc and the 2^20 Barnes-Hut disc
SHARD_BRUTE_N = 65535  # + the star
SHARD_BRUTE_STEPS = 25
SHARD_BH_N = 1048575  # + the star: 2^20 rows
SHARD_BH_STEPS = 10


def sharded_phase():
    """Phase 22, ``nbody_tpu_torch.parallel`` on the card: a one-rank NCCL
    group (the card holds one rank; NCCL refuses two ranks on one GPU).
    (a) the 65535 + star disc on ``allgather`` and ``ring``, 25 steps each:
    K2 every step, one force call within 1e-4 of the single-chip
    ``brute-pallas`` force (K1) on the same state, the sharded exact
    energy within 1e-6 of the single-chip exact energy, drift below 1e-5,
    steps/s beside ``brute-pallas``.  (b) the 1048575 + star disc on
    ``bh`` (the domain decomposition) and ``bh-replicated``, 10 steps each:
    K3 and K4 every step, one force call against the single-chip ``bh``
    force on the same state (the reading printed, held to 1e-5: at world
    size 1 the window lies inside the shard and the walks are the same),
    K3 and K4 against their plain twins on the slabs each strategy builds
    (the domain slab carries the capped far rows) and K3's time there
    beside its bound, the final state against the K2 oracle within the bh
    envelope, drift through the tree estimator finite and below 5e-3,
    steps/s beside plain ``bh``, and one ``bh`` (domain) force call split
    at its phase marks beside plain ``bh``'s.  Every sharded force call enqueues without a
    host sync (``torch.cuda.set_sync_debug_mode("error")``).  Returns the launches of
    the runs and the readings for the kernels line."""
    import torch
    import torch.distributed as dist
    from nbody_tpu_torch import Simulation
    from nbody_tpu_torch.core.energy import total_energy
    from nbody_tpu_torch.ops import group_force as gf
    from nbody_tpu_torch.ops import pairwise as pw
    from nbody_tpu_torch.ops import traversal as tt
    from nbody_tpu_torch.parallel import ShardedSimulation
    from nbody_tpu_torch.parallel.domain import domain_accel
    from nbody_tpu_torch.parallel.sharded import make_sharded_force
    from nbody_tpu_torch.scenes import self_gravitating_disc

    out = {"k2": 0, "k3": 0, "k4": 0, "k3_abs": 0.0, "k4_abs": 0.0}
    parts = []
    common = dict(dt=3e-2, g_soft=EPS, theta2=1.0, device="cuda")

    def timed(sim, steps):
        sim.compile(1)
        t0 = time.perf_counter()
        sim.run(steps)
        sim.block_until_ready()
        return steps / (time.perf_counter() - t0)

    def no_sync_force(sim, strategy):
        """One sharded force call on the current state, refused any host
        sync."""
        st = sim.state
        force = make_sharded_force(sim.mesh, strategy,
                                   bh_config=sim._bh_config)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            acc = force(st.pos, st.effective_mass(), sim.settings)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        return acc

    # (a) the direct sums
    pos, vel, mass = self_gravitating_disc(SHARD_BRUTE_N, seed=0)
    single = Simulation(pos, vel, mass, engine="brute-pallas", **common)
    rate_single = timed(single, SHARD_BRUTE_STEPS)
    e_single = single.energy("exact")
    single.reset()
    for strategy in ("allgather", "ring"):
        sim = ShardedSimulation(pos, vel, mass, engine="brute-pallas",
                                strategy=strategy, n_devices=1, **common)
        require(sim.mesh.world == 1 and dist.get_backend() == "nccl",
                f"{strategy}: mesh {sim.mesh}, backend {dist.get_backend()}")
        st = sim.state
        require(st.capacity == single.state.capacity, "brute capacities")
        m = st.effective_mass()
        acc = no_sync_force(sim, strategy)
        ref = single.engine.force(st.pos, m, single.settings)
        e_force = rel_err(acc, ref)
        require(e_force < 1e-4, f"{strategy} vs brute-pallas: {e_force:.3e}")
        e0 = sim.energy()
        e_rel = abs(e0 - e_single) / abs(e_single)
        require(e_rel < 1e-6, f"{strategy} energy {e0} vs {e_single}")
        pw.reset_launch_counts()
        rate = timed(sim, SHARD_BRUTE_STEPS)
        k2 = pw.launch_counts()["pairwise_acc_targets"]
        require(k2 >= SHARD_BRUTE_STEPS, f"{strategy}: K2 launched {k2}x")
        out["k2"] += k2
        drift = abs((sim.energy() - e0) / e0)
        require(drift < 1e-5, f"{strategy}: drift {drift:.3e}")
        parts.append(
            f"(a) {strategy} at {st.capacity}: K2 {k2}x in "
            f"{SHARD_BRUTE_STEPS + 1} steps, {rate:.3f} steps/s (brute-pallas"
            f" {rate_single:.3f}), force vs brute-pallas (K1) {e_force:.2e}, "
            f"energy vs single-chip {e_rel:.1e}, drift {drift:.3e}")
        del sim, st, acc, ref
    del single

    # (b) Barnes-Hut at 2^20
    pos, vel, mass = self_gravitating_disc(SHARD_BH_N, seed=0)
    plain = Simulation(pos, vel, mass, engine="bh", **common)
    rate_plain = timed(plain, SHARD_BH_STEPS)
    plain.reset()
    for strategy in ("bh", "bh-replicated"):
        sim = ShardedSimulation(pos, vel, mass, engine="bh",
                                strategy=strategy, n_devices=1, **common)
        st = sim.state
        require(st.capacity == plain.state.capacity, "bh capacities")
        m = st.effective_mass()
        got = {}
        calls = record_calls(lambda: got.update(
            acc=no_sync_force(sim, strategy)))
        acc = got.pop("acc")
        ref = plain.engine.force(st.pos, m, plain.settings)
        e_force = rel_err(acc, ref)
        require(e_force < 1e-5, f"{strategy} vs bh: {e_force:.3e}")
        bitwise = torch.equal(acc, ref)
        # K3 and K4 against their twins on the slabs this strategy builds
        # (the domain slab: window, near rows and the capped far rows)
        a3, k3 = calls["group_force"][0]
        a4, k4 = calls["quad_force"][0]
        e3, abs3 = k3_check(*pick(a3, k3, [0, a3[0].shape[0] // 2]),
                            f"{strategy} slab")
        e4, abs4 = k4_check(*pick(a4, k4, [busiest(a4[1])]),
                            f"{strategy} slab")
        out["k3_abs"] = max(out["k3_abs"], abs3)
        out["k4_abs"] = max(out["k4_abs"], abs4)
        k3_ms = ms(lambda: gf.group_force(*a3, **k3), 5)
        k3_bnd = k3_bound(a3[0], a3[1], k3["tile"], k3["mask"])
        slabs = (f"K3 {len(calls['group_force'])}x on slab "
                 f"{tuple(a3[0].shape)} x {tuple(a3[1].shape)}: vs plain "
                 f"{e3:.2e}, {k3_ms:.3f} ms (bound {k3_bnd[0]:.3f} ms); K4 "
                 f"{len(calls['quad_force'])}x on {tuple(a4[1].shape)}: "
                 f"vs plain {e4:.2e}")
        del calls, a3, k3, a4, k4
        split = ""
        if strategy == "bh":
            prm, cfg = sim.settings, sim._bh_config
            d_split = split_call(lambda: domain_accel(
                st.pos, m, prm.bounds, prm.theta2, prm.g, prm.g_soft, cfg,
                sim.mesh))
            b_split = split_call(lambda: tt.bh_accel(
                st.pos, m, prm.bounds, prm.theta2, prm.g, prm.g_soft, cfg))
            split = (f"; one force call split (ms): domain {d_split} "
                     f"against bh {b_split}")
        e0 = float(total_energy(st, sim.settings, method="bh"))
        gf.reset_launch_counts()
        tt.reset_host_reads()
        rate = timed(sim, SHARD_BH_STEPS)
        counts = gf.launch_counts()
        require(counts["group_force"] >= SHARD_BH_STEPS
                and counts["quad_force"] >= SHARD_BH_STEPS,
                f"{strategy}: launches {counts}")
        require(tt.HOST_READS["moved_frac"] == 0, f"{strategy}: host reads")
        out["k3"] += counts["group_force"]
        out["k4"] += counts["quad_force"]
        st = sim.state
        m = st.effective_mass()
        require(bool(torch.isfinite(st.pos).all()), f"{strategy}: not finite")
        acc = make_sharded_force(sim.mesh, strategy,
                                 bh_config=sim._bh_config)(st.pos, m,
                                                           sim.settings)
        med, p99 = sampled_error(st.pos, m, st.alive, acc)
        require(med < 2e-3 and p99 < 5e-2,
                f"{strategy}: sampled median {med:.3e}, p99 {p99:.3e}")
        e1 = float(total_energy(st, sim.settings, method="bh"))
        drift = abs((e1 - e0) / e0)
        require(math.isfinite(drift) and drift < 5e-3,
                f"{strategy}: drift {drift}")
        parts.append(
            f"(b) {strategy} at {st.capacity}: launches {counts} in "
            f"{SHARD_BH_STEPS + 1} steps, {rate:.3f} steps/s (plain bh "
            f"{rate_plain:.3f}), force vs single-chip bh {e_force:.2e} "
            f"(bitwise {bitwise}), final state vs K2 median {med:.3e} p99 "
            f"{p99:.3e}, drift {drift:.3e} (tree estimator); {slabs}{split}")
        del sim, st, acc, ref
    del plain
    dist.destroy_process_group()
    print(f"[22 sharded, world size 1] {nvidia_smi()} | " + " | ".join(parts),
          flush=True)
    return out


# phase 23: the refined domain route, the wide rows and the checkpoints of
# the sharded path, at world size 1 over NCCL
WIDE_N_FORCED = 1  # ops/tree.py WIDE_N lowered: every run takes wide rows
DCP_STEPS = 4
COMP_N = 65535  # + the star: the compensated round trip


def dir_bytes(path) -> int:
    """The bytes of the files under a directory."""
    return sum(os.path.getsize(os.path.join(d, f))
               for d, _, files in os.walk(path) for f in files)


def refined_domain_phase(single_rate=None):
    """Phase 23, on a one-rank NCCL group.  (a) ``ADAPTIVE_RUNS[0]``, the
    2^20 Plummer sphere at width 40, through ``ShardedSimulation(engine=
    "bh", strategy="bh", engine_options={"profile": "adaptive"})``: the
    resolved deep stack, one force call within 1e-5 of the single-chip
    adaptive ``bh_accel`` on the same state (enqueued without a host
    sync), its sampled p99 below 5e-2 against the K2 oracle, no refined
    cell dropped by the build, K3 and K4 against their twins on the refined
    domain slab (the group with the most refined-near rows among those
    held), then 5 steps with K3 and K4 every step, steps/s beside phase
    19's single-chip adaptive run (``single_rate``; measured here when
    None).  (c) the sphere's ``ShardedSimulation`` saved (the default
    format, a ``torch.distributed.checkpoint`` directory), run 4 steps and
    loaded: positions and ``elapsed`` bitwise, and it steps on; a
    compensated 65535 + star ``Simulation`` the same with
    ``format="orbax"``, its low words bitwise.  (b) ``WIDE_N`` lowered so
    the 1048575 + star disc takes the wide rows: one domain force call
    within rtol 1e-6 of the narrow call with the same walk counters, K3 on
    the wide slab against its twin.  Returns the launches and readings for
    the kernels line."""
    import shutil

    import numpy as np
    import torch
    import torch.distributed as dist
    from nbody_tpu_torch import Simulation
    from nbody_tpu_torch.ops import group_force as gf
    from nbody_tpu_torch.ops import traversal as tt
    from nbody_tpu_torch.ops import tree as ttree
    from nbody_tpu_torch.parallel import ShardedSimulation
    from nbody_tpu_torch.parallel.domain import domain_accel
    from nbody_tpu_torch.scenes import plummer_sphere, self_gravitating_disc

    out = {"k3": 0, "k4": 0, "k3_abs": 0.0, "k4_abs": 0.0}
    parts = []
    common = dict(dt=3e-2, g_soft=EPS, theta2=1.0, device="cuda")

    def force(sim, cfg):
        """One domain force call on the current state, refused any host
        sync: (acc, stats)."""
        st, prm = sim.state, sim.settings
        m = st.effective_mass()
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            res = domain_accel(st.pos, m, prm.bounds, prm.theta2, prm.g,
                               prm.g_soft, cfg, sim.mesh)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        return res

    # (a) the refined domain route on the deep stack
    label, n, width, stack, _jax_p99 = ADAPTIVE_RUNS[0]
    pos, vel, mass = plummer_sphere(n, seed=0)
    keep = np.all(np.abs(pos) <= 20.0, axis=1)
    pos, vel, mass = pos[keep], vel[keep], mass[keep]
    sim = ShardedSimulation(pos, vel, mass, engine="bh", strategy="bh",
                            n_devices=1, capacity=n, bounds_width=width,
                            engine_options={"profile": "adaptive"}, **common)
    cfg = sim._bh_config
    require(sim.mesh.world == 1 and dist.get_backend() == "nccl"
            and sim.strategy == "bh", f"{label}: {sim.mesh}, {sim.strategy}")
    require(all(getattr(cfg, k) == v
                for k, v in getattr(tt, stack).items()),
            f"{label}: profile='adaptive' resolved {cfg}")
    st, prm = sim.state, sim.settings
    m0 = st.effective_mass()
    res = {}
    calls = record_calls(lambda: res.update(d=force(sim, cfg)))
    acc, stats = res["d"]
    ref, rstats = tt.bh_accel(st.pos, m0, prm.bounds, prm.theta2, prm.g,
                              prm.g_soft, cfg)
    e_force = rel_err(acc, ref)
    require(e_force < 1e-5, f"{label}: domain vs bh_accel {e_force:.3e}")
    walk = {k: int(stats[k].sum()) for k in (
        "accept_dropped", "near_fallback", "fb_spill", "refine_near_totals",
        "refine_far_totals", "refine_build_dropped")}
    require(walk["refine_build_dropped"] == 0 and walk["accept_dropped"] == 0
            and walk["refine_near_totals"] > 0, f"{label}: walk {walk}")
    single_rnt = int(rstats["refine_near_totals"].sum())
    med0, p99_0 = sampled_error(st.pos, m0, st.alive, acc)
    require(p99_0 < 5e-2, f"{label}: sampled p99_typ {p99_0:.4f}")
    rnt = stats["refine_near_totals"]
    (a3, k3), = calls["group_force"]
    G_ = a3[0].shape[0]
    sel = sorted({0, G_ // 2, G_ - 1, int(rnt.argmax())})
    e3, abs3 = k3_check(*pick(a3, k3, sel), f"{label} refined domain slab")
    k3_ms = ms(lambda: gf.group_force(*a3, **k3), 5)
    k3_bnd = k3_bound(a3[0], a3[1], k3["tile"], k3["mask"])
    a4, k4 = calls["quad_force"][0]
    e4, abs4 = k4_check(*pick(a4, k4, sel), f"{label} refined domain slab")
    out["k3_abs"], out["k4_abs"] = abs3, abs4
    parts.append(
        f"(a) {label} on strategy bh ({int(keep.sum())} in the box, "
        f"capacity {st.capacity}, ml{cfg.max_level}+R{cfg.refine_levels}): "
        f"force vs single-chip adaptive bh_accel {e_force:.2e}, no host "
        f"sync; initial state p99_typ {p99_0:.4f} median {med0:.3e}; walk "
        f"{walk} (single-chip refined-near rows {single_rnt}); K3 {tuple(a3[0].shape)} x {tuple(a3[1].shape)}, groups "
        f"{sel}: vs plain {e3:.2e}, {k3_ms:.3f} ms (bound {k3_bnd[0]:.3f});"
        f" K4 {tuple(a4[1].shape)}: vs plain {e4:.2e}")
    del calls, res, ref, a3, k3, a4, k4, acc, stats, rstats
    gf.reset_launch_counts()
    sim.compile(1)
    t0 = time.perf_counter()
    sim.run(STEPS_ADAPTIVE)
    sim.block_until_ready()
    rate = STEPS_ADAPTIVE / (time.perf_counter() - t0)
    counts = gf.launch_counts()
    require(counts["group_force"] + counts["group_force_masked"]
            >= STEPS_ADAPTIVE + 1
            and counts["quad_force"] >= STEPS_ADAPTIVE + 1,
            f"{label}: launches {counts} in {STEPS_ADAPTIVE + 1} steps")
    out["k3"] += counts["group_force"]
    out["k4"] += counts["quad_force"]
    require(bool(torch.isfinite(sim.state.pos).all()), f"{label}: not finite")
    if single_rate is None:
        single = Simulation(pos, vel, mass, engine="bh", capacity=n,
                            bounds_width=width, engine_options=dict(
                                profile="adaptive", **getattr(tt, stack)),
                            **common)
        single.compile(1)
        t0 = time.perf_counter()
        single.run(STEPS_ADAPTIVE)
        single.block_until_ready()
        single_rate = STEPS_ADAPTIVE / (time.perf_counter() - t0)
        del single
    parts[-1] += (f"; {STEPS_ADAPTIVE} steps (+1 warm) launches {counts}, "
                  f"{rate:.3f} steps/s (single-chip adaptive "
                  f"{single_rate:.3f})")

    # (c) the checkpoint round trips (this sphere's sharded run first)
    tmp = tempfile.mkdtemp(prefix="nbody_dcp_")
    try:
        path = os.path.join(tmp, "sharded")
        want = sim.state.pos.clone()
        t_want = sim.elapsed
        t0 = time.perf_counter()
        sim.save(path)
        save_s = time.perf_counter() - t0
        nbytes = dir_bytes(path)
        sim.run(DCP_STEPS)
        t0 = time.perf_counter()
        sim.load(path)
        sim.block_until_ready()
        load_s = time.perf_counter() - t0
        require(torch.equal(sim.state.pos, want) and sim.elapsed == t_want,
                "sharded checkpoint: state not restored bitwise")
        sim.run(1)
        sim.block_until_ready()
        require(bool(torch.isfinite(sim.state.pos).all())
                and sim.elapsed > t_want, "sharded checkpoint: no step")
        # a second save over the first: the first pays the one-time costs
        # (the NCCL communicator of DCP's collectives among them)
        t0 = time.perf_counter()
        sim.save(path)
        save2_s = time.perf_counter() - t0
        dcp_part = (f"(c) {label} ShardedSimulation.save (default "
                    f"format): {nbytes} bytes in {save_s:.3f} s (a second "
                    f"save {save2_s:.3f} s), load {load_s:.3f} s, positions"
                    f" and elapsed bitwise after {DCP_STEPS} steps, steps "
                    "on")
        del sim, want
        cpos, cvel, cmass = self_gravitating_disc(COMP_N, seed=0)
        comp = Simulation(cpos, cvel, cmass, engine="brute-pallas",
                          compensated=True, **common)
        comp.run(3)
        cpath = os.path.join(tmp, "compensated")
        want = (comp.state.pos.clone(), comp.state.vel.clone(),
                *(x.clone() for x in comp._lo))
        t_want = comp.elapsed
        t0 = time.perf_counter()
        comp.save(cpath, format="orbax")
        csave_s = time.perf_counter() - t0
        cbytes = dir_bytes(cpath)
        comp.run(DCP_STEPS)
        t0 = time.perf_counter()
        comp.load(cpath, format="orbax")
        comp.block_until_ready()
        cload_s = time.perf_counter() - t0
        got = (comp.state.pos, comp.state.vel, *comp._lo)
        require(all(torch.equal(a, b) for a, b in zip(got, want))
                and comp.elapsed == t_want,
                "compensated checkpoint: state or low words not bitwise")
        comp.run(1)
        require(comp.elapsed > t_want, "compensated checkpoint: no step")
        dcp_part += (f"; compensated Simulation at {comp.state.capacity} "
                     f"(brute-pallas) format='orbax': {cbytes} bytes in "
                     f"{csave_s:.3f} s, load {cload_s:.3f} s, positions, "
                     f"velocities and low words bitwise")
        del comp
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    # (b) the wide rows forced on, one call on the 2^20 disc
    pos, vel, mass = self_gravitating_disc(SHARD_BH_N, seed=0)
    sim = ShardedSimulation(pos, vel, mass, engine="bh", n_devices=1,
                            **common)
    cfg = sim._bh_config
    narrow, n_stats = force(sim, cfg)
    old = ttree.WIDE_N
    ttree.WIDE_N = WIDE_N_FORCED
    try:
        res = {}
        calls = record_calls(lambda: res.update(w=force(sim, cfg)))
    finally:
        ttree.WIDE_N = old
    wide, w_stats = res.pop("w")
    keys = ("accept_dropped", "frontier_fallback", "near_fallback",
            "fb_spill")
    cnt_n = [int(n_stats[k]) for k in keys]
    cnt_w = [int(w_stats[k]) for k in keys]
    require(cnt_n == cnt_w and torch.equal(n_stats["near_totals"],
                                           w_stats["near_totals"]),
            f"wide counters {cnt_w} vs narrow {cnt_n}")
    scale = float(narrow.abs().max())
    d_wide = float((wide - narrow).abs().max())
    require(bool(((wide - narrow).abs()
                  <= 1e-6 * narrow.abs() + 1e-6 * scale).all()),
            f"wide vs narrow: max |diff| {d_wide:.3e} of {scale:.3e}")
    (a3, k3), = calls["group_force"]
    # every massive slab row carries the retired -1, every target -2
    require(bool(((a3[1][..., 4] == -1.0) | (a3[1][..., 3] == 0.0)).all()
                 and (a3[0][..., 4] == -2.0).all()),
            "the wide slab keeps an index column")
    e3w, abs3w = k3_check(*pick(a3, k3, [0, a3[0].shape[0] // 2]),
                          "wide domain slab")
    out["k3_abs"] = max(out["k3_abs"], abs3w)
    parts.append(
        f"(b) wide rows (WIDE_N = {WIDE_N_FORCED}) on the 2^20 disc: one "
        f"domain call vs narrow max |diff| {d_wide:.3e} (largest row "
        f"{scale:.3e}, bitwise {torch.equal(wide, narrow)}), counters "
        f"{cnt_w} equal; K3 on the wide slab {tuple(a3[0].shape)} x "
        f"{tuple(a3[1].shape)} vs plain {e3w:.2e}")
    parts.append(dcp_part)
    del sim, calls, res, a3, k3, wide, narrow
    dist.destroy_process_group()
    print(f"[23 refined domain, wide rows, checkpoints] {nvidia_smi()} | "
          + " | ".join(parts), flush=True)
    return out


# phase 24: the Barnes-Hut build's double-float prefix table
# (csrc/prefix_scan.cu), the one kernel of the port with no Pallas
# counterpart (the JAX package's lax.associative_scan), at the 100k and 2^20
# builds' sizes

PREFIX_ROWS = (100096, 1 << 20)
PREFIX_STEP_N = 100000


def prefix_phase():
    """(a) The table kernel against the exact sums beside its twin
    (tests/torch_prefix_cases.py: seeded values on a grid that makes every
    partial's error an exact integer) at 100096 and 2^20 rows, K = 4 and 3
    in f32, and 100096 x 4 in f64: within twice the twin's own error, two calls
    bitwise equal.  (b) Kernel and twin at [rows, 4] f32 with CUDA events,
    beside the kernel's bytes bound (each input byte read once, each table
    byte written once).  (c) One ``bh`` step of the 100k disc: its
    ``prefix_table`` calls, and its launches (torch.profiler: runtime API,
    card) with the twin swapped into the build and with the kernel; steps/s
    of both, alternating."""
    import numpy as np
    import torch

    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from torch_prefix_cases import DF_UNIT, exact_error, prefix_case

    from nbody_tpu_torch import Simulation
    from nbody_tpu_torch.ops import prefix_scan as ps
    from nbody_tpu_torch.ops import tree
    from nbody_tpu_torch.scenes import self_gravitating_disc

    dev = torch.device("cuda", 0)
    parts, worst = [], 0.0
    cases = [(n, k, np.float32) for n in PREFIX_ROWS for k in (4, 3)]
    cases.append((PREFIX_ROWS[0], 4, np.float64))
    for n, k, dt in cases:
        v, s = prefix_case(n, k, dt, seed=n + k)
        x = torch.from_numpy(v).to(dev)
        got = ps.prefix_table(x)
        torch.cuda.synchronize()
        require(torch.equal(got, ps.prefix_table(x)),
                f"prefix table {n} x {k}: two calls differ")
        twin = exact_error(v, s, ps.prefix_table_plain(x).cpu().numpy())
        err = exact_error(v, s, got.cpu().numpy())
        ratio = err / max(twin, DF_UNIT[dt])
        require(ratio <= 2.0, f"prefix table {n} x {k} {dt.__name__}: "
                f"{err:.3e} against the twin's {twin:.3e}")
        worst = max(worst, err) if dt == np.float32 else worst
        parts.append(f"{n}x{k} {dt.__name__} {err:.2e} (twin {twin:.2e})")

    times = {}
    for n in PREFIX_ROWS:
        x = torch.from_numpy(prefix_case(n, 4, np.float32)[0]).to(dev)
        kernel = ms(lambda: ps.prefix_table(x), 200)
        plain = ms(lambda: ps.prefix_table_plain(x), 20)
        card = device_ms(lambda: ps.prefix_table(x), 20)
        launched = launches_in(lambda: ps.prefix_table(x))
        bnd = ((n * 4 + (n + 1) * 8) * 4 / BYTES_PER_S * 1e3, "bytes")
        times[n] = (kernel, plain, bnd)
        parts.append(f"[{n}, 4] f32 kernel {kernel:.4f} ms host-paced, "
                     f"{card:.4f} ms on the card (launches: {launched}), "
                     f"twin {plain:.3f} ms, bound {bnd[0]:.4f} ms")

    pos, vel, mass = self_gravitating_disc(PREFIX_STEP_N, seed=0)
    sim = Simulation(pos, vel, mass, engine="bh", device="cuda")
    sim.run(2)
    ps.reset_launch_counts()
    sim.run(1)
    torch.cuda.synchronize()
    calls = ps.launch_counts()["prefix_table"]
    require(calls == 3, f"a 100k bh step made {calls} prefix_table calls")
    kernel_launches = launches_in(lambda: sim.run(1))
    rates = {"twin": [], "kernel": []}
    try:
        tree.prefix_table = ps.prefix_table_plain
        sim.run(1)
        twin_launches = launches_in(lambda: sim.run(1))
        for name in ("kernel", "twin", "twin", "kernel"):
            tree.prefix_table = (ps.prefix_table if name == "kernel"
                                 else ps.prefix_table_plain)
            sim.run(2)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            sim.run(40)
            torch.cuda.synchronize()
            rates[name].append(round(40 / (time.perf_counter() - t0), 2))
    finally:
        tree.prefix_table = ps.prefix_table
    require(kernel_launches[1] < twin_launches[1] - 450,
            f"a 100k bh step launched {kernel_launches} with the kernel, "
            f"{twin_launches} with the twin")
    parts.append(f"one 100k bh step: {calls} tables, launches (runtime, card)"
                 f" {twin_launches} with the twin, {kernel_launches} with "
                 f"the kernel; steps/s twin {rates['twin']}, kernel "
                 f"{rates['kernel']}")
    print("[24 prefix table] " + " | ".join(parts), flush=True)
    kernel, plain, bnd = times[PREFIX_ROWS[0]]
    return {"launches": calls, "err": worst, "ms": kernel, "plain_ms": plain,
            "bound": bnd}


# phase 25: the Barnes-Hut collect walk's dense levels (csrc/collect_walk.cu),
# a kernel with no Pallas counterpart (the JAX package's walk is jnp), at the
# 100k tier and at profile 'domain''s 2^23 rows a card

WALK_STEP_N = 100000
WALK_DOMAIN_N = 1 << 23
#: FP32 instructions a box test of the walk (|com - c| - h clamped at 0 on
#: three axes, their squares summed, the minimum), none of them a
#: multiply-add: at 128 a clock on each of 132 SMs, half the FMA rate
WALK_BOX_INSTR = 18
FP32_INSTR_PER_S = FP32_PER_S / 2


def walk_tests(args):
    """(cells the twin's walk tests against the boxes, bytes the kernel
    must move: a table row a visited cell, the outputs once) for the
    dense-walk arguments ``args``, read off one twin call."""
    import torch

    from nbody_tpu_torch.ops import traversal as tt

    seen = []
    cover = tt._cover

    def spy(delta, pending, occupied, *a):
        covered = cover(delta, pending, occupied, *a)
        seen.append(((occupied & ~covered).sum(), occupied.sum()))
        return covered

    tt._cover = spy
    try:
        st = tt._collect_dense(*args)
    finally:
        tt._cover = cover
    tested = int(sum(t for t, _ in seen))
    visited = int(sum(v for _, v in seen))
    out = sum(t.numel() * t.element_size() for t in st.values()
              if isinstance(t, torch.Tensor))
    return tested, visited * 32 + out


def walk_device_ms(args, reps=20):
    """Device time of one walk kernel launch (ms): ``reps`` launches of
    the packed arguments enqueued behind a sleeping kernel, so the CUDA
    events around them time the card alone, not the host's enqueue."""
    import ctypes

    import torch

    from nbody_tpu_torch.ops import _build
    from nbody_tpu_torch.ops import collect_walk as cw
    from nbody_tpu_torch.ops.pairwise import _stream

    lib = _build.load_library()
    p, smem, _st, _keep = cw.pack(*args)
    dbl = int(args[6].dtype == torch.float64)
    stream = _stream(args[6].device)
    lib.nbody_group_collect(ctypes.byref(p), dbl, smem, stream)
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(100_000_000)  # ~50 ms: the host enqueues meanwhile
    a.record()
    for _ in range(reps):
        rc = lib.nbody_group_collect(ctypes.byref(p), dbl, smem, stream)
        require(rc == 0, f"group_collect: CUDA error {rc}")
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def walk_phase():
    """(a) The collect walk kernel against its plain twin on the card, bit
    for bit, on tests/torch_walk_cases.py's 100k disc and profile 'domain'
    (wide rows, accept_offset, local and far budgets) at 2^18 rows.  (b)
    Kernel and twin with CUDA events at the 100k tier and at profile
    'domain''s 2^23 rows a card (the domain route at world size 1 with the
    wide rows forced on), the kernel's device time (``walk_device_ms``)
    beside its bound (the box tests' FP32 instructions, the bytes).  (c) One 100k ``bh`` step:
    one kernel launch, and its launches (torch.profiler: runtime API,
    card) and steps/s with the twin swapped in and with the kernel,
    alternating."""
    import torch

    sys.path.insert(0, os.path.join(ROOT, "tests"))
    import torch_walk_cases as wc

    from nbody_tpu_torch import Simulation
    from nbody_tpu_torch.ops import collect_walk as cw
    from nbody_tpu_torch.ops import traversal as tt
    from nbody_tpu_torch.scenes import self_gravitating_disc

    dev = torch.device("cuda", 0)
    parts = []
    for name in ("100k", "domain-far"):
        args = wc.case(name, dev, card=True)
        bad = wc.mismatches(cw.group_collect(*args), tt._collect_dense(*args),
                            args[5])
        torch.cuda.synchronize()
        require(not bad, f"walk kernel {name}: {bad} differ from the twin")
        parts.append(f"{name} bitwise the twin")

    times = {}
    for tier, args in (
            ("100k", wc.case("100k", dev, card=True)),
            ("domain 2^23", wc.domain_args(
                WALK_DOMAIN_N, tt.BHConfig.auto_for(WALK_DOMAIN_N,
                                                    profile="domain"), dev))):
        kernel = ms(lambda: cw.group_collect(*args), 20)
        card = walk_device_ms(args)
        plain = ms(lambda: tt._collect_dense(*args), 2)
        tested, nbytes = walk_tests(args)
        cfg = args[4]
        bnd = max((tested * cfg.subgroups * WALK_BOX_INSTR
                   / FP32_INSTR_PER_S * 1e3, "box tests"),
                  (nbytes / BYTES_PER_S * 1e3, "bytes"))
        times[tier] = (kernel, plain, bnd, card)
        parts.append(
            f"{tier} [{args[6].shape[0]} groups x {cfg.subgroups} boxes, "
            f"{tested} cells tested]: kernel {kernel:.4f} ms host-paced, "
            f"{card:.4f} ms on the card, twin {plain:.2f} ms, bound "
            f"{bnd[0]:.4f} ms ({bnd[1]})")
        del args

    pos, vel, mass = self_gravitating_disc(WALK_STEP_N, seed=0)
    sim = Simulation(pos, vel, mass, engine="bh", device="cuda")
    sim.run(2)
    cw.reset_launch_counts()
    sim.run(1)
    torch.cuda.synchronize()
    calls = cw.launch_counts()["group_collect"]
    require(calls == 1, f"a 100k bh step made {calls} walk kernel launches")
    kernel_launches = launches_in(lambda: sim.run(1))
    rates = {"twin": [], "kernel": []}
    real = cw.group_collect
    try:
        cw.group_collect = tt._collect_dense
        sim.run(1)
        twin_launches = launches_in(lambda: sim.run(1))
        for name in ("kernel", "twin", "twin", "kernel"):
            cw.group_collect = real if name == "kernel" else tt._collect_dense
            sim.run(2)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            sim.run(40)
            torch.cuda.synchronize()
            rates[name].append(round(40 / (time.perf_counter() - t0), 2))
    finally:
        cw.group_collect = real
    require(kernel_launches[1] < twin_launches[1] - 400,
            f"a 100k bh step launched {kernel_launches} with the kernel, "
            f"{twin_launches} with the twin")
    parts.append(f"one 100k bh step: {calls} walk launch, launches (runtime,"
                 f" card) {twin_launches} with the twin, {kernel_launches} "
                 f"with the kernel; steps/s twin {rates['twin']}, kernel "
                 f"{rates['kernel']}")
    print("[25 collect walk] " + " | ".join(parts), flush=True)
    kernel, plain, bnd, _card = times["100k"]
    return {"launches": calls, "ms": kernel, "plain_ms": plain, "bound": bnd,
            "times": times}


def pick(args, kw, groups):
    """A kernel call restricted to a few groups (all of them for the
    block-dual rows, whose 'groups' are target tiles)."""
    import torch

    sel = torch.as_tensor(groups, device=args[0].device)
    a = tuple(t[sel].contiguous() if torch.is_tensor(t) else t
              for t in args)
    k = {key: (v[sel].contiguous() if torch.is_tensor(v) else v)
         for key, v in kw.items()}
    return a, k


def k3_check(args, kw, label, bound=1e-5):
    """K3 on a call's arguments against its plain twin (max row over mean
    row), finite, two calls bitwise equal.  Returns (error, max |diff|)."""
    import torch
    from nbody_tpu_torch.ops import group_force as gf

    got = gf.group_force(*args, **kw)
    torch.cuda.synchronize()
    ref = gf.group_force_plain(*args, **kw)
    require(bool(torch.isfinite(got).all()), f"K3 {label}: not finite")
    e = rows_err(got, ref)
    require(e < bound, f"K3 {label} vs plain: {e:.3e}")
    require(torch.equal(got, gf.group_force(*args, **kw)),
            f"K3 {label}: two calls differ")
    return e, float((got - ref).abs().max())


def k4_check(args, kw, label):
    """K4 as k3_check, held to 5e-5."""
    import torch
    from nbody_tpu_torch.ops import group_force as gf

    got = gf.quad_force(*args, **kw)
    torch.cuda.synchronize()
    ref = gf.quad_force_plain(*args, **kw)
    require(bool(torch.isfinite(got).all()), f"K4 {label}: not finite")
    e = rows_err(got, ref)
    require(e < 5e-5, f"K4 {label} vs plain: {e:.3e}")
    require(torch.equal(got, gf.quad_force(*args, **kw)),
            f"K4 {label}: two calls differ")
    return e, float((got - ref).abs().max())


def species_slab(np, G, B, S, seed):
    """A hand-built K3 slab with every row species (tests/
    test_torch_group_force.py): the group's own particles (self-pairs),
    gathered rows, monopole rows (idx -1) and zero-mass padding."""
    rng = np.random.default_rng(seed)
    tgt8 = np.zeros((G, B, 8), np.float32)
    tgt8[:, :, :3] = rng.standard_normal((G, B, 3))
    tgt8[:, :, 3] = rng.uniform(0.5, 1.5, (G, B))
    tgt8[:, :, 4] = np.arange(G * B).reshape(G, B)
    slab = np.zeros((G, S, 8), np.float32)
    slab[:, :, :3] = rng.standard_normal((G, S, 3))
    slab[:, :, 3] = rng.uniform(0.5, 1.5, (G, S))
    slab[:, :, 4] = rng.integers(G * B, 2 * G * B, (G, S))
    slab[:, :B] = tgt8[:, :min(B, S)]
    slab[:, -64:, 4] = -1.0
    slab[:, 300:340] = 0.0
    return tgt8, slab


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from nbody_tpu_torch import Simulation, cli
    from nbody_tpu_torch.core import diagnostics as diag
    from nbody_tpu_torch.core import energy as core_energy
    from nbody_tpu_torch.core import stepper
    from nbody_tpu_torch.core.state import ParticleState, SimParams
    from nbody_tpu_torch.engines import get_engine
    from nbody_tpu_torch.ops import _build
    from nbody_tpu_torch.ops import group_force as gf
    from nbody_tpu_torch.ops import pairwise as pw
    from nbody_tpu_torch.ops import traversal as tt
    from nbody_tpu_torch.ops.traversal import BHConfig, bh_accel
    from nbody_tpu_torch.scenes import self_gravitating_disc
    from nbody_tpu_torch.utils import native

    dev = torch.device("cuda", 0)

    # -- 1. device ---------------------------------------------------------
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = nvidia_smi()
    # the port runs no cuDNN; switching its TF32 off too leaves no reduced-
    # precision path in the process
    torch.backends.cudnn.allow_tf32 = False
    require(not torch.backends.cuda.matmul.allow_tf32
            and torch.get_float32_matmul_precision() == "highest",
            "TF32 matmul is on")
    require(not torch.backends.cudnn.allow_tf32, "TF32 cuDNN is on")
    print(f"[1 device] {kind} x{count} | nvidia-smi: {smi} | torch "
          f"{torch.__version__} cuda {torch.version.cuda} | TF32 off "
          "(matmul, cudnn)", flush=True)

    # -- 2. build ----------------------------------------------------------
    t0 = time.perf_counter()
    _build.load_library()
    build_s = time.perf_counter() - t0
    log = (_build.BUILD_DIR / "build.log")
    ptxas = ([l.strip() for l in log.read_text().splitlines()
              if "registers" in l] if log.exists() else [])
    print(f"[2 build] {_build.library_path().name} in {build_s:.2f} s | "
          + " | ".join(ptxas), flush=True)

    def disc(n, capacity, kill):
        pos, vel, mass = self_gravitating_disc(n, seed=7)
        st = ParticleState.create(pos, vel, mass, capacity=capacity,
                                  device=dev)
        alive = st.alive.clone()
        alive[1:1 + kill] = False  # dead particles keep zero mass
        return st.pos, torch.where(alive, st.mass, 0.0), alive

    # -- 3. K2 -------------------------------------------------------------
    pos, m, alive = disc(2000, 2048, kill=37)
    got = pw.pairwise_acc(pos, m, G, EPS)
    ref = pw.pairwise_acc_plain(pos, m, G, EPS)
    e_k2 = rel_err(got, ref)
    k2_abs = float((got - ref).abs().max())
    require(e_k2 < 1e-4, f"K2 vs plain at 2048, eps {EPS}: {e_k2:.3e}")
    got0 = pw.pairwise_acc(pos, m, G, 0.0)
    ref0 = pw.pairwise_acc_plain(pos, m, G, 0.0)
    require(bool(torch.isfinite(got0).all()), "K2 at eps 0 is not finite")
    row = ((got0 - ref0).norm(dim=1) / ref0.norm(dim=1).clamp_min(1e-30))
    e_k2_0 = float(row[alive].max())
    require(e_k2_0 < 1e-3, f"K2 vs plain at eps 0 (alive rows): {e_k2_0:.3e}")
    idx = torch.as_tensor(
        np.random.default_rng(3).choice(2048, 1024, replace=False),
        device=dev)
    tgt = pw.pairwise_acc_targets(pos[idx], pos, m, G, EPS)
    require(torch.equal(tgt, got[idx]), "K2 targets are not bitwise the "
            "matching rows of the full call")
    # 40000 sources make several source chunks, the last one ragged
    # (pw.targets_launch): sampled targets must still be bitwise the full
    # call's rows, at eps > 0 and at eps = 0 with coincident rows
    chunk, splits = pw.targets_launch(40000)
    parts = []
    for g_soft in (EPS, 0.0):
        pos, m, alive = disc(39999, 40000, kill=37)
        if g_soft == 0.0:
            pos = pos.clone()
            pos[200:205] = pos[100]  # r^2 == 0 takes the guard
        got = pw.pairwise_acc(pos, m, G, g_soft)
        ref = pw.pairwise_acc_plain(pos, m, G, g_soft)
        require(bool(torch.isfinite(got).all()),
                f"K2 at 40000, eps {g_soft}: not finite")
        if g_soft == 0.0:
            row = ((got - ref).norm(dim=1) / ref.norm(dim=1).clamp_min(1e-30))
            e = float(row[alive].max())
            require(e < 1e-3, f"K2 vs plain at 40000, eps 0 (alive rows): "
                    f"{e:.3e}")
        else:
            e = rel_err(got, ref)
            require(e < 1e-4, f"K2 vs plain at 40000, eps {EPS}: {e:.3e}")
        require(torch.equal(got, pw.pairwise_acc(pos, m, G, g_soft)),
                f"K2 is not bit-reproducible at 40000, eps {g_soft}")
        for k in (1, 129, 1000, 4096, 70000):  # 70000: two batches
            idx = torch.as_tensor(
                np.random.default_rng(k).choice(40000, k, replace=k > 40000),
                device=dev)
            require(torch.equal(pw.pairwise_acc_targets(pos[idx], pos, m, G,
                                                        g_soft), got[idx]),
                    f"K2: {k} sampled targets at 40000, eps {g_soft}, are "
                    "not bitwise the full call's rows")
        what = "per alive row" if g_soft == 0.0 else "rel err"
        parts.append(f"eps {g_soft} {what} {e:.3e}")
    print(f"[3 K2] capacity 2048, 37 dead: rel err {e_k2:.3e} (eps {EPS}), "
          f"{e_k2_0:.3e} per alive row (eps 0); 1024 sampled targets "
          f"bitwise equal to the full rows | capacity 40000, 37 dead, "
          f"{splits} source chunks of {chunk} (the last "
          f"{40000 - (splits - 1) * chunk}): " + ", ".join(parts)
          + "; 1, 129, 1000, 4096 and 70000 sampled targets bitwise equal "
          "to the full rows; two calls bitwise equal", flush=True)

    # -- 4. K1 -------------------------------------------------------------
    # 8192 and 65536 fill whole 256-wide tiles; 5000 leaves a ragged one;
    # eps 0 (with coincident particles) goes through the guarded instance
    # and is held per alive row, as K2 is in phase 3
    k1_abs, parts = None, []
    for cap, kill, g_soft in ((8192, 0, EPS), (8192, 37, EPS),
                              (65536, 0, EPS), (65536, 37, EPS),
                              (5000, 11, EPS), (5000, 11, 0.0)):
        pos, m, alive = disc(cap - 1, cap, kill)
        if g_soft == 0.0:
            pos = pos.clone()
            pos[200:205] = pos[100]  # r^2 == 0 takes the guard
        got = pw.pairwise_acc_sym(pos, m, G, g_soft)
        ref = pw.pairwise_acc_sym_plain(pos, m, G, g_soft)
        require(bool(torch.isfinite(got).all()),
                f"K1 at {cap}, eps {g_soft}: not finite")
        if g_soft == 0.0:
            row = ((got - ref).norm(dim=1)
                   / ref.norm(dim=1).clamp_min(1e-30))
            e = float(row[alive].max())
            require(e < 1e-3, f"K1 vs plain at {cap}, eps 0 (alive rows): "
                    f"{e:.3e}")
        else:
            e = rel_err(got, ref)
            require(e < 1e-4, f"K1 vs plain at {cap}, {kill} dead: {e:.3e}")
        net = (got * m[:, None]).sum(dim=0).abs().max()
        scale = (got.abs() * m[:, None]).sum()
        require(float(net) < 1e-5 * float(scale),
                f"K1 momentum at {cap}: {float(net):.3e} vs "
                f"{float(scale):.3e}")
        require(torch.equal(got, pw.pairwise_acc_sym(pos, m, G, g_soft)),
                f"K1 is not bit-reproducible at {cap}")
        if cap == 65536 and kill == 0:
            k1_abs = float((got - ref).abs().max())
        what = "per alive row" if g_soft == 0.0 else "rel err"
        parts.append(f"{cap}/{kill} dead eps {g_soft} {what} {e:.3e} "
                     f"(|sum m a| / sum m|a| {float(net) / float(scale):.1e})")
    print(f"[4 K1] tile {_build.load_library().nbody_sym_tile()}; vs plain: "
          + ", ".join(parts) + "; two calls bitwise equal", flush=True)

    # -- 5. main path ------------------------------------------------------
    ckpt_dir = tempfile.TemporaryDirectory(prefix="chip_smoke_",
                                           dir=_build.BUILD_DIR)
    ckpt = os.path.join(ckpt_dir.name, "state.pkl")
    base = ["--engine", "brute-pallas", "--steps", "25", "--energy",
            "--energy-exact", "--json", "--device", "cuda"]
    pw.reset_launch_counts()
    big = cli.main(["-n", "65535", *base, "--save", ckpt])
    after_big = pw.launch_counts()
    small = cli.main(["-n", "2047", *base])
    launches = pw.launch_counts()
    k1_runs = after_big["pairwise_acc_sym"]
    k2_runs = (launches["pairwise_acc_targets"]
               - after_big["pairwise_acc_targets"])
    require(k1_runs >= 25, f"the 65536 run launched K1 {k1_runs} times")
    require(k2_runs >= 25, f"the 2048 run launched K2 {k2_runs} times")
    for r in (big, small):
        nums = [r["elapsed_s"], r["steps_per_second"], r["energy_initial"],
                r["energy_final"], r["energy_drift"]]
        require(all(map(math.isfinite, nums)), f"non-finite result {r}")
        require(0 < r["n_alive"] <= r["n"] + 1, f"n_alive {r['n_alive']}")
        require(r["energy_drift"] < 1e-5,
                f"energy drift {r['energy_drift']:.3e} at n {r['n']}")
    pos, vel, mass = self_gravitating_disc(65535, seed=0)
    sim = Simulation(pos, vel, mass, engine="brute-pallas", device="cuda",
                     dt=3e-2, g_soft=EPS).load(ckpt)
    ckpt_dir.cleanup()
    sim.update_forces()
    st = sim.state
    require(bool(torch.isfinite(st.pos).all() & torch.isfinite(st.vel).all()),
            "final state is not finite")
    alive_idx = np.nonzero(st.alive.cpu().numpy())[0]
    sample = torch.as_tensor(
        np.random.default_rng(0).choice(alive_idx, 1024, replace=False),
        device=dev)
    oracle = pw.pairwise_acc_targets(st.pos[sample], st.pos,
                                     st.effective_mass(), G, EPS)
    e_or = rel_err(st.acc[sample], oracle)
    require(e_or < 1e-4, f"update_forces vs K2 oracle: {e_or:.3e}")
    # above 262144 brute-pallas is K2 at K = N: 299999 + the star, 5 steps
    ckpt_dir = tempfile.TemporaryDirectory(prefix="chip_smoke_",
                                           dir=_build.BUILD_DIR)
    ckpt = os.path.join(ckpt_dir.name, "state.pkl")
    pw.reset_launch_counts()
    huge = cli.main(["-n", "299999", "--engine", "brute-pallas", "--steps",
                     "5", "--json", "--device", "cuda", "--save", ckpt])
    k2_huge_runs = pw.launch_counts()["pairwise_acc_targets"]
    require(k2_huge_runs >= 5, f"the 300000 run launched K2 {k2_huge_runs} "
            "times")
    require(all(math.isfinite(v) for v in huge.values()
                if isinstance(v, float)), f"non-finite result {huge}")
    pos, vel, mass = self_gravitating_disc(299999, seed=0)
    sim = Simulation(pos, vel, mass, engine="brute-pallas", device="cuda",
                     dt=3e-2, g_soft=EPS).load(ckpt)
    ckpt_dir.cleanup()
    sim.update_forces()
    st = sim.state
    require(bool(torch.isfinite(st.pos).all() & torch.isfinite(st.vel).all()
                 & torch.isfinite(st.acc).all()),
            "300000: final state is not finite")
    alive_idx = np.nonzero(st.alive.cpu().numpy())[0]
    sample = torch.as_tensor(
        np.random.default_rng(0).choice(alive_idx, 1024, replace=False),
        device=dev)
    exact = pw.pairwise_acc_targets_plain(
        st.pos[sample].double(), st.pos.double(),
        st.effective_mass().double(), G, EPS, tile=256)
    e_huge = rel_err(st.acc[sample].double(), exact)
    require(e_huge < 1e-4, f"300000: final forces vs the float64 plain sum "
            f"(1024 alive rows): {e_huge:.3e}")
    huge_in = (st.pos, st.effective_mass())
    print(f"[5 main path] n 65536: K1 launched {k1_runs}x, drift "
          f"{big['energy_drift']:.3e}, n_alive {big['n_alive']}, "
          f"update_forces vs K2 oracle (1024 rows) {e_or:.3e} | n 2048: K2 "
          f"launched {k2_runs}x, drift {small['energy_drift']:.3e}, n_alive "
          f"{small['n_alive']} | n {st.capacity} (299999 + star), 5 steps: "
          f"K2 launched {k2_huge_runs}x, {huge['steps_per_second']:.2f} "
          f"steps/s, n_alive {huge['n_alive']}, final forces vs float64 "
          f"plain (1024 alive rows) {e_huge:.3e}", flush=True)

    # -- 6. times ----------------------------------------------------------
    def pair(kernel, plain, reps_k, reps_p):
        """plain, kernel, kernel, plain; the mean of each side."""
        p1 = ms(plain, reps_p)
        k1 = ms(kernel, reps_k)
        k2 = ms(kernel, reps_k)
        p2 = ms(plain, reps_p)
        return (k1 + k2) / 2, (p1 + p2) / 2

    pos, m, _ = disc(65535, 65536, 0)
    k1_ms, k1_plain = pair(lambda: pw.pairwise_acc_sym(pos, m, G, EPS),
                           lambda: pw.pairwise_acc_sym_plain(pos, m, G, EPS),
                           20, 3)
    k2_full_ms, k2_full_plain = pair(
        lambda: pw.pairwise_acc(pos, m, G, EPS),
        lambda: pw.pairwise_acc_plain(pos, m, G, EPS), 20, 1)
    tpos = pos[:1024].contiguous()
    k2_or_ms, k2_or_plain = pair(
        lambda: pw.pairwise_acc_targets(tpos, pos, m, G, EPS),
        lambda: pw.pairwise_acc_targets_plain(tpos, pos, m, G, EPS), 20, 5)
    # the bh checks' oracle: 4096 alive rows against the 2^20 disc
    p20, m20, alive20 = disc(1048575, 1048576, 0)
    t20 = p20[torch.as_tensor(np.sort(np.random.default_rng(0).choice(
        np.nonzero(alive20.cpu().numpy())[0], 4096, replace=False)),
        device=dev)].contiguous()
    got = pw.pairwise_acc_targets(t20, p20, m20, G, EPS)
    ref = pw.pairwise_acc_targets_plain(t20, p20, m20, G, EPS, tile=256)
    e_o20 = rel_err(got, ref)
    k2_o20_abs = float((got - ref).abs().max())
    require(e_o20 < 1e-4, f"K2 vs plain at 4096 x 2^20: {e_o20:.3e}")
    # the oracle's own error, against the plain sum in float64
    ref = pw.pairwise_acc_targets_plain(t20.double(), p20.double(),
                                        m20.double(), G, EPS, tile=128)
    e_o20_64 = rel_err(got.double(), ref)
    require(e_o20_64 < 1e-4, f"K2 vs float64 at 4096 x 2^20: {e_o20_64:.3e}")
    k2_o20_ms, k2_o20_plain = pair(
        lambda: pw.pairwise_acc_targets(t20, p20, m20, G, EPS),
        lambda: pw.pairwise_acc_targets_plain(t20, p20, m20, G, EPS,
                                              tile=256), 10, 1)
    # brute-pallas above 262144: the 301056-row run's final state, K = N
    p30, m30 = huge_in
    got = pw.pairwise_acc(p30, m30, G, EPS)
    ref = pw.pairwise_acc_plain(p30, m30, G, EPS)
    e_30 = rel_err(got, ref)
    k2_30_abs = float((got - ref).abs().max())
    require(e_30 < 1e-4, f"K2 vs plain at K = N = {p30.shape[0]}: "
            f"{e_30:.3e}")
    del got, ref
    k2_30_ms, k2_30_plain = pair(
        lambda: pw.pairwise_acc(p30, m30, G, EPS),
        lambda: pw.pairwise_acc_plain(p30, m30, G, EPS), 5, 1)
    pos2, m2, _ = disc(2047, 2048, 0)
    k2_ms, k2_plain = pair(lambda: pw.pairwise_acc(pos2, m2, G, EPS),
                           lambda: pw.pairwise_acc_plain(pos2, m2, G, EPS),
                           200, 50)
    # the back-to-back wrapper calls at 2048 run at the host's pace: the
    # device time of a call is the profiler's sum over its kernels
    k2_dev_ms = device_ms(lambda: pw.pairwise_acc(pos2, m2, G, EPS), 200)
    # bounds of the timed calls: K1 needs every pair with a massive member
    # once, K2 every (target, massive source) pair; K2 reads 12 bytes a
    # target and 16 a source, and writes 12 a target
    n1, nm = pos.shape[0], nnz(m)
    k1_bound = bound(k1_pairs(pos, m), "sym", 28 * n1)
    k2_bound = bound(pos2.shape[0] * nnz(m2), "pair",
                     28 * pos2.shape[0])
    k2_full_bound = bound(n1 * nm, "pair", 28 * n1)
    k2_30_bound = bound(p30.shape[0] * nnz(m30), "pair",
                        28 * p30.shape[0])
    k2_or_bound = bound(1024 * nm, "pair", 24 * 1024 + 16 * n1)
    k2_o20_bound = bound(4096 * nnz(m20), "pair",
                         24 * 4096 + 16 * p20.shape[0])
    steps = {}
    for engine in ("brute", "brute-pallas", "brute-pallas", "brute"):
        r = cli.main(["-n", "65535", "--engine", engine, "--steps", "25",
                      "--json", "--device", "cuda"])
        steps.setdefault(engine, []).append(r["steps_per_second"])
    smi = nvidia_smi()
    print(f"[6 times] {smi} | K1 @65536 {k1_ms:.4f} ms (plain {k1_plain:.3f}"
          f" ms, bound {k1_bound[0]:.4f} ms) | K2 @2048 {k2_ms:.4f} ms, "
          f"device {k2_dev_ms:.5f} ms (plain {k2_plain:.4f} ms, bound "
          f"{k2_bound[0]:.5f} ms) | K2 full @65536 {k2_full_ms:.4f} ms (plain "
          f"{k2_full_plain:.1f} ms, bound {k2_full_bound[0]:.4f} ms) | K2 full "
          f"@{p30.shape[0]} {k2_30_ms:.3f} ms (plain {k2_30_plain:.1f} ms, "
          f"bound {k2_30_bound[0]:.3f} ms, rel err {e_30:.2e}) | K2 1024 "
          f"targets x 65536 {k2_or_ms:.4f} ms (plain {k2_or_plain:.3f} ms, "
          f"bound {k2_or_bound[0]:.5f} ms) | K2 4096 targets x 2^20 "
          f"{k2_o20_ms:.4f} ms (plain {k2_o20_plain:.1f} ms, bound "
          f"{k2_o20_bound[0]:.4f} ms; rel err {e_o20:.2e}, vs float64 "
          f"{e_o20_64:.2e}) | steps/s @65536,"
          f" 25-step CLI run: brute-pallas {steps['brute-pallas']} "
          f"brute (plain torch) {steps['brute']}", flush=True)

    # -- 7. K3 ------------------------------------------------------------
    def bh_state(n):
        """The disc at n + the star on the card, as the CLI builds it."""
        pos, vel, mass = self_gravitating_disc(n, seed=0)
        st = ParticleState.create(pos, vel, mass, device=dev)
        params = SimParams.create(dt=3e-2, g_soft=EPS, theta2=1.0,
                                  device=dev)
        return st, params

    def walk_calls(n, **over):
        """One bh force call at the CLI's configuration for n (with the
        BHConfig fields ``over``), recording the kernel wrappers' arguments:
        the slabs the walk assembles."""
        st, params = bh_state(n)
        return record_calls(
            lambda: bh_accel(st.pos, st.effective_mass(), params.bounds,
                             params.theta2, params.g, params.g_soft,
                             BHConfig.auto_for(st.capacity, **over)),
            names=("group_force", "quad_force", "group_self_force"))

    calls_1m = walk_calls(1048575)
    calls_100k = walk_calls(100000)
    require(len(calls_1m["group_force"]) == 1
            and calls_1m["group_force"][0][1]["mask"] is None,
            "the 1M walk did not make one unmasked K3 call")
    require(len(calls_100k["group_force"]) == 1
            and calls_100k["group_force"][0][1]["mask"] is not None,
            "the 100k walk did not make one masked K3 call")

    parts = []
    t8, sl = species_slab(np, 3, 128, 512, 11)
    tt8, tsl = (torch.from_numpy(a).to(dev) for a in (t8, sl))
    e, _ = k3_check((tt8, tsl, G, EPS), dict(tile=128, mask=None), "species")
    parts.append(f"species {e:.2e}")
    padded = torch.cat([tsl, torch.zeros((3, 256, 8), device=dev)], dim=1)
    require(torch.equal(gf.group_force(tt8, tsl, G, EPS, tile=128),
                        gf.group_force(tt8, padded, G, EPS, tile=128)),
            "K3: zero-mass padding tiles changed the result")
    t8, sl = species_slab(np, 2, 1024, 512, 3)
    mask = torch.as_tensor(np.random.default_rng(4).random((2, 2, 4)) < 0.5,
                           device=dev)
    e, _ = k3_check((torch.from_numpy(t8).to(dev),
                     torch.from_numpy(sl).to(dev), G, EPS),
                    dict(tile=128, mask=mask), "species masked")
    parts.append(f"species masked {e:.2e}")
    line = np.zeros((1, 128, 8), np.float32)
    line[0, :, :3] = np.linspace(0.1, 1.0, 128)[:, None] * [[1.0, 0.5, -0.3]]
    line[0, :, 3] = 1.0
    line[0, :, 4] = np.arange(128)
    tl = torch.from_numpy(line).to(dev)
    e, _ = k3_check((tl, tl.clone(), G, 0.0), dict(tile=128, mask=None),
                    "eps 0 coincident")
    parts.append(f"eps 0 coincident {e:.2e}")
    # B and S that are not multiples of a block's 128 targets and of a
    # stage's 128 rows; a mask of 4-row target tiles (finer than a block)
    # at eps 0, the guarded masked instance
    t8, sl = species_slab(np, 3, 1000, 640, 5)
    e, _ = k3_check((torch.from_numpy(t8).to(dev),
                     torch.from_numpy(sl).to(dev), G, EPS),
                    dict(tile=128, mask=None), "ragged B")
    parts.append(f"B 1000 x S 640 {e:.2e}")
    t8, sl = species_slab(np, 2, 1024, 512, 6)
    mask = torch.as_tensor(np.random.default_rng(7).random((2, 256, 4))
                           < 0.5, device=dev)
    e, _ = k3_check((torch.from_numpy(t8).to(dev),
                     torch.from_numpy(sl).to(dev), G, 0.0),
                    dict(tile=128, mask=mask), "TI 4 mask, eps 0")
    parts.append(f"mask of 4-row target tiles at eps 0 {e:.2e}")
    a, k = calls_1m["group_force"][0]
    sel_1m = [0, 1, a[0].shape[0] // 2, a[0].shape[0] - 1]
    e, k3_abs = k3_check(*pick(a, k, sel_1m), "1M slab")
    shape_1m = f"{tuple(a[0].shape)} x {tuple(a[1].shape)}"
    parts.append(f"1M walk slab {shape_1m}, groups {sel_1m}: {e:.2e}")
    a, k = calls_100k["group_force"][0]
    sel_100k = [0, 1, a[0].shape[0] // 2, a[0].shape[0] - 1]
    e, k3m_abs = k3_check(*pick(a, k, sel_100k), "100k slab + mask")
    n_masked = int(k["mask"].sum())
    parts.append(f"100k walk slab {tuple(a[1].shape)} with its mask "
                 f"{tuple(k['mask'].shape)} ({n_masked} set), groups "
                 f"{sel_100k}: {e:.2e}")
    print("[7 K3] rel err vs plain: " + "; ".join(parts)
          + "; padding tiles bitwise inert; every check's two calls "
          "bitwise equal", flush=True)

    # -- 8. K4 ------------------------------------------------------------
    parts = []
    require(len(calls_1m["quad_force"]) == 1
            and len(calls_100k["quad_force"]) == 2,
            "unexpected K4 calls: "
            f"{len(calls_1m['quad_force'])} (1M), "
            f"{len(calls_100k['quad_force'])} (100k)")
    a, k = calls_1m["quad_force"][0]
    e, k4_abs = k4_check(*pick(a, k, sel_1m), "1M accepted nodes")
    parts.append(f"1M accepted-node slab {tuple(a[1].shape)}, groups "
                 f"{sel_1m}: {e:.2e}")
    a, k = calls_100k["quad_force"][0]  # block-dual rows come first
    rows = list(range(0, a[0].shape[0], max(1, a[0].shape[0] // 8)))
    e, _ = k4_check(*pick(a, k, rows), "100k dual rows")
    parts.append(f"100k dual rows {tuple(a[1].shape)}, {len(rows)} target "
                 f"tiles: {e:.2e}")
    rng = np.random.default_rng(3)
    q8 = np.zeros((2, 128, 8), np.float32)
    q8[:, :, :3] = rng.standard_normal((2, 128, 3)) * 1e-3
    qr = np.zeros((2, 256, 16), np.float32)
    qr[:, :, :3] = rng.standard_normal((2, 256, 3)) * 1e-3
    qr[:, :, 3] = rng.uniform(0.5, 1.5, (2, 256))
    qr[:, :, 4:10] = rng.standard_normal((2, 256, 6)) * 1e-6
    qr[:, 100:120] = 0.0
    e, _ = k4_check((torch.from_numpy(q8).to(dev),
                     torch.from_numpy(qr).to(dev), G, 0.0), dict(tile=128),
                    "eps 0 small scale")
    parts.append(f"eps 0 at 1e-3 scale: {e:.2e}")
    t0 = time.perf_counter()
    bad, ulps = gf.quad_rsqrt_sweep(dev)
    sweep_s = time.perf_counter() - t0
    require(ulps <= 1, f"K4's 1/r differs from the float64 rsqrt by {ulps} "
            f"ulps ({bad} floats)")
    print("[8 K4] rel err vs plain: " + "; ".join(parts)
          + "; two calls bitwise equal | 1/r vs (float)rsqrt((double)x) "
          f"over all {0x7f800000 - 0x00800000} positive normal floats: "
          f"{bad} mismatches, largest {ulps} ulp ({sweep_s:.3f} s)",
          flush=True)

    # -- 9. the bh main path ------------------------------------------------
    # the 1M run's --energy resolves to the tree estimator (capacity above
    # 262144): a drift figure that may be estimator bias below ~1e-4
    runs = [("100k", 100000, 100, ["--energy", "--energy-exact"]),
            ("1M", 1048575, 10, ["--energy"])]
    # sampled force error |da| / max(|a|, median |a|) against the K2 oracle,
    # held to the envelope of tests/test_barnes_hut.py: median 2e-3, p99
    # 5e-2 (the 1M run reads a median of ~1.7e-3; PERF.md section 2)
    median_bound = 2e-3
    bh_launches = {}
    bh_results = {}
    parts = []

    def bh_final_check(label, n, ckpt):
        """The final state of a bh CLI run (its checkpoint): finite, the
        walk drops nothing, two force calls bitwise equal, and the forces
        of 4096 sampled alive rows within the envelope against the K2
        oracle.  Returns (state, walk counters, median, p99, K2
        launches)."""
        pos, vel, mass = self_gravitating_disc(n, seed=0)
        sim = Simulation(pos, vel, mass, engine="bh", device="cuda",
                         dt=3e-2, g_soft=EPS).load(ckpt)
        st, params = sim.state, sim.settings
        require(bool(torch.isfinite(st.pos).all()
                     & torch.isfinite(st.vel).all()),
                f"{label}: final state is not finite")
        m_eff = st.effective_mass()
        cfg = BHConfig.auto_for(st.capacity)
        acc, stats = bh_accel(st.pos, m_eff, params.bounds, params.theta2,
                              params.g, params.g_soft, cfg)
        acc2, _ = bh_accel(st.pos, m_eff, params.bounds, params.theta2,
                           params.g, params.g_soft, cfg)
        require(torch.equal(acc, acc2), f"{label}: two bh force calls differ")
        require(bool(torch.isfinite(acc).all()), f"{label}: forces not finite")
        four = {k: int(stats[k]) for k in ("accept_dropped",
                                           "frontier_fallback",
                                           "near_fallback", "fb_spill")}
        require(four["accept_dropped"] == 0, f"{label}: walk stats {four}")
        pw.reset_launch_counts()
        med, p99 = sampled_error(st.pos, m_eff, st.alive, acc)
        k2_checks = pw.launch_counts()["pairwise_acc_targets"]
        require(med < median_bound and p99 < 5e-2,
                f"{label}: sampled force error median {med:.3e}, p99 "
                f"{p99:.3e}")
        return st, four, med, p99, k2_checks

    for label, n, steps, extra in runs:
        ckpt_dir = tempfile.TemporaryDirectory(prefix="chip_smoke_",
                                               dir=_build.BUILD_DIR)
        ckpt = os.path.join(ckpt_dir.name, "state.pkl")
        gf.reset_launch_counts()
        r = cli.main(["-n", str(n), "--engine", "bh", "--steps", str(steps),
                      *extra, "--json", "--device", "cuda", "--save", ckpt])
        counts = gf.launch_counts()
        bh_launches[label] = counts
        bh_results[label] = r
        if label == "100k":
            require(counts["group_force_masked"] >= steps,
                    f"100k: masked K3 launched {counts}")
            require(counts["quad_force"] >= 2 * steps,
                    f"100k: K4 launched {counts}")
            require(r["energy_drift"] < 1e-3,
                    f"100k energy drift {r['energy_drift']:.3e}")
        else:
            require(counts["group_force"] >= steps,
                    f"1M: unmasked K3 launched {counts}")
            require(counts["quad_force"] >= steps,
                    f"1M: K4 launched {counts}")
            require(r["energy_method"] == "bh",
                    f"1M: --energy resolved to {r['energy_method']}")
            require(r["energy_drift"] < 5e-3,
                    f"1M energy drift (tree estimator) {r['energy_drift']:.3e}")
        nums = [v for v in r.values() if isinstance(v, float)]
        require(all(map(math.isfinite, nums)), f"non-finite result {r}")
        st, four, med, p99, k2_checks = bh_final_check(label, n, ckpt)
        ckpt_dir.cleanup()
        drift = (f", drift {r['energy_drift']:.3e} ({r['energy_method']})"
                 if "energy_drift" in r else "")
        parts.append(
            f"{label} ({r['n']} + star, {steps} steps, capacity "
            f"{st.capacity}): launches {counts}, {r['steps_per_second']:.2f}"
            f" steps/s, n_alive {r['n_alive']}{drift}; final state: "
            f"{four}, forces vs K2 oracle (4096 rows) median {med:.3e} p99 "
            f"{p99:.3e}, two calls bitwise equal")
    print("[9 bh main path] " + " | ".join(parts), flush=True)

    # -- 10. times ----------------------------------------------------------
    def k4_rows(qslab):
        """Source rows K4 evaluates for each target (every 128-row stage
        up to its last massive row, rounded up to the kernel's unroll
        width), over the massive rows its bound counts."""
        unroll = _build.load_library().nbody_k4_unroll()
        Gs, A = qslab.shape[:2]
        m = (qslab[..., 3] != 0).to(torch.int32)
        m = torch.nn.functional.pad(m, (0, (-A) % 128)).reshape(Gs, -1, 128)
        last = torch.where(m != 0, torch.arange(128, device=m.device),
                           -1).amax(-1) + 1
        rows_ = torch.clamp(-(-last // unroll) * unroll, max=128)
        return f"{int(rows_.sum())}/{nnz(qslab[..., 3])} rows evaluated/massive"

    a, k = calls_1m["group_force"][0]
    k3_ms, k3_plain = pair(lambda: gf.group_force(*a, **k),
                           lambda: gf.group_force_plain(*a, **k), 10, 1)
    k3_bnd = k3_bound(a[0], a[1], k["tile"], k["mask"])
    a, k = calls_100k["group_force"][0]
    k3m_ms, k3m_plain = pair(lambda: gf.group_force(*a, **k),
                             lambda: gf.group_force_plain(*a, **k), 20, 2)
    k3m_bnd = k3_bound(a[0], a[1], k["tile"], k["mask"])
    a, k = calls_1m["quad_force"][0]
    k4_ms, k4_plain = pair(lambda: gf.quad_force(*a, **k),
                           lambda: gf.quad_force_plain(*a, **k), 10, 1)
    k4_bnd = k4_bound(a[0], a[1])
    k4_ev = k4_rows(a[1])
    a, k = calls_100k["quad_force"][0]
    k4d_ms, k4d_plain = pair(lambda: gf.quad_force(*a, **k),
                             lambda: gf.quad_force_plain(*a, **k), 20, 2)
    k4d_bnd = k4_bound(a[0], a[1])
    k4d_ev = k4_rows(a[1])
    a, k = calls_100k["quad_force"][1]
    k4a_ms, k4a_plain = pair(lambda: gf.quad_force(*a, **k),
                             lambda: gf.quad_force_plain(*a, **k), 20, 2)
    k4a_bnd = k4_bound(a[0], a[1])
    k4a_ev = k4_rows(a[1])

    def force_split(n, **over):
        """One bh force call at n, split at the phase marks (ms)."""
        st, params = bh_state(n)
        cfg = BHConfig.auto_for(st.capacity, **over)
        m_eff = st.effective_mass()
        return split_call(lambda: bh_accel(
            st.pos, m_eff, params.bounds, params.theta2, params.g,
            params.g_soft, cfg))

    split = force_split(1048575)
    smi = nvidia_smi()
    print(f"[10 times] {smi} | K3 unmasked @1M shapes {shape_1m}: "
          f"{k3_ms:.3f} ms (plain {k3_plain:.1f} ms, bound {k3_bnd[0]:.3f} "
          f"ms) | K3 masked @100k shapes: {k3m_ms:.3f} ms (plain "
          f"{k3m_plain:.1f} ms, bound {k3m_bnd[0]:.4f} ms) | K4 @1M "
          f"accepted nodes: {k4_ms:.3f} ms (plain {k4_plain:.1f} ms, bound "
          f"{k4_bnd[0]:.3f} ms; {k4_ev}) | K4 "
          f"@100k dual rows: {k4d_ms:.4f} ms (plain {k4d_plain:.2f} ms, "
          f"bound {k4d_bnd[0]:.4f} ms; {k4d_ev}), accepted nodes: "
          f"{k4a_ms:.3f} ms (plain {k4a_plain:.1f} ms, bound "
          f"{k4a_bnd[0]:.4f} ms; {k4a_ev}) | "
          f"steps/s: 100k {bh_results['100k']['steps_per_second']:.3f}, 1M "
          f"{bh_results['1M']['steps_per_second']:.3f} | one 1M force call "
          f"(ms): {json.dumps(split)}", flush=True)

    # -- 11. K5 -------------------------------------------------------------
    sym_over = dict(near_sym=True)
    sym_1m = walk_calls(1048575, **sym_over)
    sym_100k = walk_calls(100000, **sym_over)
    for label, calls in (("1M", sym_1m), ("100k", sym_100k)):
        require(len(calls["group_self_force"]) == 1,
                f"the {label} near_sym walk made "
                f"{len(calls['group_self_force'])} K5 calls")

    def self_square_case(Gs, B, masked, seed):
        """Hand-built groups (tests/torch_slabs.py): unit-scale rows, a
        share ``masked`` of the source masses zeroed."""
        rng = np.random.default_rng(seed)
        t8 = np.zeros((Gs, B, 8), np.float32)
        t8[..., :3] = rng.normal(scale=3.0, size=(Gs, B, 3))
        t8[..., 3] = rng.uniform(0.5, 1.5, (Gs, B))
        t8[..., 4] = np.arange(Gs * B).reshape(Gs, B)
        ms_ = np.where(rng.uniform(size=(Gs, B)) >= masked, t8[..., 3], 0.0)
        return t8, ms_.astype(np.float32)

    def group_err(got, ref):
        """rel_err group by group, the worst group: one wrong group cannot
        hide among the rest, and the group holding the star (rows near it
        pull many times the call's mean |a|) is measured against its own
        scale."""
        num = (got.double() - ref.double()).norm(dim=2).amax(dim=1)
        den = ref.double().norm(dim=2).mean(dim=1).clamp_min(1e-300)
        return float((num / den).max())

    def k5_check(t8, msrc, g, g_soft, label, exact=False):
        got = gf.group_self_force(t8, msrc, g, g_soft)
        torch.cuda.synchronize()
        ref = gf.group_self_force_plain(t8, msrc, g, g_soft)
        require(bool(torch.isfinite(got).all()), f"K5 {label}: not finite")
        e_grp = group_err(got, ref)
        require(e_grp < 3e-5, f"K5 {label} vs plain, worst group: "
                f"{e_grp:.3e}")
        note = ""
        if exact:
            # both against the plain sum in float64: the kernel's error is
            # of the f32 rounding class, like the twin's
            ex = gf.group_self_force_plain(t8.double(), msrc.double(), g,
                                           g_soft)
            e64, p64 = group_err(got, ex), group_err(ref, ex)
            require(e64 < 3e-5, f"K5 {label} vs float64, worst group: "
                    f"{e64:.3e} (plain f32 {p64:.3e})")
            note = f", vs float64 {e64:.2e} (plain f32 {p64:.2e})"
        net = (got.double() * msrc[..., None]).sum(dim=1).abs().amax(dim=1)
        scale = (got.double().abs() * msrc[..., None]).sum(dim=(1, 2))
        mom = float((net / scale.clamp_min(1e-300)).max())
        require(mom < 1e-5, f"K5 {label}: momentum {mom:.3e}")
        require(torch.equal(got, gf.group_self_force(t8, msrc, g, g_soft)),
                f"K5 {label}: two calls differ")
        return e_grp, float((got - ref).abs().max()), mom, note

    parts = []
    for Gs, B, masked, g_soft in ((4, 2048, 0.3, EPS), (3, 1000, 0.0, EPS),
                                  (2, 512, 0.2, 0.0)):
        t8, ms_ = self_square_case(Gs, B, masked, seed=B)
        if g_soft == 0.0:
            t8[:, 100:110, :3] = t8[:, 50:51, :3]  # coincident rows
        e, _, mom, _ = k5_check(torch.from_numpy(t8).to(dev),
                                torch.from_numpy(ms_).to(dev), G, g_soft,
                                f"{Gs}x{B} masked {masked} eps {g_soft}")
        parts.append(f"{Gs}x{B} masked {masked} eps {g_soft}: {e:.2e} "
                     f"(momentum {mom:.1e})")
    k5_abs = None
    for label, calls in (("1M", sym_1m), ("100k", sym_100k)):
        # the whole call the walk made: every group, as the path gives it
        a, _ = calls["group_self_force"][0]
        e, err_abs, mom, note = k5_check(*a, f"{label} walk call",
                                         exact=True)
        k5_abs = err_abs if label == "1M" else k5_abs
        parts.append(f"{label} walk call {tuple(a[0].shape)} ({nnz(a[1])} "
                     f"of {a[1].numel()} weights set): {e:.2e}{note} "
                     f"(momentum {mom:.1e})")
    print("[11 K5] rel err vs plain, worst group: " + "; ".join(parts)
          + "; every check's two calls bitwise equal", flush=True)

    # -- 12. K6 -------------------------------------------------------------
    def sorted_disc(n, capacity):
        """The CLI's disc (seed 0) in the order brute-pallas-mxu gives K6."""
        p_, v_, m_ = self_gravitating_disc(n, seed=0)
        st = ParticleState.create(p_, v_, m_, capacity=capacity, device=dev)
        params = SimParams.create(dt=3e-2, g_soft=EPS, device=dev)
        me = st.effective_mass()
        order = pw.mxu_order(st.pos, me, params.bounds)
        return st.pos[order].contiguous(), me[order].contiguous()

    parts = []
    for n, cap in ((2047, 2048), (65535, 65536)):
        ps, ms_ = sorted_disc(n, cap)
        got = pw.pairwise_acc_mxu(ps, ms_, G, EPS)
        torch.cuda.synchronize()
        ref = pw.pairwise_acc_mxu_plain(ps, ms_, G, EPS)
        require(bool(torch.isfinite(got).all()), f"K6 at {cap}: not finite")
        e = rel_err(got, ref)
        rn = ref.norm(dim=1)
        med = float(((got - ref).norm(dim=1)
                     / rn.clamp_min(float(rn.median()))).median())
        # the kernel forms r^2 with the twin's roundings (csrc/
        # pairwise_mxu.cu); what differs is the summation order, which the
        # fold A - (p - c) sum s magnifies far from the anchor
        require(e < 1e-3 and med < 1e-5,
                f"K6 vs plain at {cap}: {e:.3e} (median row {med:.2e})")
        require(torch.equal(got, pw.pairwise_acc_mxu(ps, ms_, G, EPS)),
                f"K6 at {cap}: two calls differ")
        if cap == 65536:
            k6_abs = float((got - ref).abs().max())
            k6_in = (ps, ms_)
        parts.append(f"{cap}: {e:.3e} (median row {med:.2e})")
    print("[12 K6] rel err vs plain on the sorted disc, tiles "
          f"{pw.mxu_tiles(65536)}, launch (threads, source splits) "
          f"{pw.mxu_launch(65536, *pw.mxu_tiles(65536))}: " + "; ".join(parts)
          + "; two calls bitwise equal", flush=True)

    # -- 13. the near_sym path -----------------------------------------------
    def sim_run(n, steps, opts, energy=False):
        """A bh Simulation of the disc at n + the star on the card, at the
        CLI's settings: one warm run, then the timed run of ``steps`` from
        the same state (as the CLI times).  Returns (sim, steps/s, drift or
        None)."""
        p_, v_, m_ = self_gravitating_disc(n, seed=0)
        sim = Simulation(p_, v_, m_, engine="bh", engine_options=opts,
                         device="cuda", dt=3e-2, g_soft=EPS, theta2=1.0)
        e0 = sim.energy(method="exact") if energy else None
        sim.run(steps)
        sim.block_until_ready()
        sim.reset()
        t0 = time.perf_counter()
        sim.run(steps)
        sim.block_until_ready()
        rate = steps / (time.perf_counter() - t0)
        drift = (abs((sim.energy(method="exact") - e0) / e0) if energy
                 else None)
        return sim, rate, drift

    sym_launches, parts = {}, []
    for label, n, steps, energy in (("1M", 1048575, 10, False),
                                    ("100k", 100000, 100, True)):
        gf.reset_launch_counts()
        sim, rate, drift = sim_run(n, steps, sym_over, energy)
        counts = gf.launch_counts()
        sym_launches[label] = counts
        require(counts["group_self_force"] >= steps,
                f"{label} near_sym: K5 launched {counts}")
        if energy:
            require(drift < 1e-3, f"{label} near_sym drift {drift:.3e}")
        st, params = sim.state, sim.settings
        require(bool(torch.isfinite(st.pos).all()
                     & torch.isfinite(st.vel).all()),
                f"{label} near_sym: final state is not finite")
        m_eff = st.effective_mass()
        args = (st.pos, m_eff, params.bounds, params.theta2, params.g,
                params.g_soft)
        acc, stats = bh_accel(*args, BHConfig.auto_for(st.capacity,
                                                       **sym_over))
        acc2, _ = bh_accel(*args, BHConfig.auto_for(st.capacity, **sym_over))
        base, bstats = bh_accel(*args, BHConfig.auto_for(st.capacity))
        require(torch.equal(acc, acc2), f"{label} near_sym: two calls differ")
        four = {k: int(stats[k]) for k in ("accept_dropped",
                                           "frontier_fallback",
                                           "near_fallback", "fb_spill")}
        bfour = {k: int(bstats[k]) for k in four}
        require(four == bfour, f"{label} near_sym walk {four} vs bh {bfour}")
        require(four["accept_dropped"] == 0, f"{label}: walk stats {four}")
        alive = st.alive
        rn = base.norm(dim=1)
        rel = ((acc - base).norm(dim=1) / rn.clamp_min(1e-30))[alive]
        rel_med, rel_max = float(rel.median()), float(rel.max())
        # tests/test_near_sym.py:64-65: the same force set in another f32
        # summation order; the worst row cancels, so its bound is looser
        require(rel_med < 1e-5 and rel_max < 5e-3,
                f"{label} near_sym vs bh: median rel {rel_med:.3e}, max "
                f"{rel_max:.3e}")
        med, p99 = sampled_error(st.pos, m_eff, alive, acc)
        require(med < median_bound and p99 < 5e-2,
                f"{label} near_sym: sampled force error median {med:.3e}, "
                f"p99 {p99:.3e}")
        drift_s = f", drift {drift:.3e}" if energy else ""
        parts.append(
            f"{label} ({n} + star, {steps} steps, capacity {st.capacity}): "
            f"launches {counts}, {rate:.2f} steps/s{drift_s}; final state: "
            f"walk {four} = bh's, vs bh median rel {rel_med:.2e} (max "
            f"{rel_max:.2e}), vs K2 oracle (4096 rows) median "
            f"{med:.3e} p99 {p99:.3e}, two calls bitwise equal")
    print("[13 near_sym path] " + " | ".join(parts), flush=True)

    # -- 14. the brute-pallas-mxu path --------------------------------------
    # tests/torch_mxu_bound.py: the JAX kernel on this run's disc and on the
    # disc after 25 steps (of the JAX package's brute engine), 1024 sampled
    # rows against a float64 direct sum.  The port's kernel rounds in its
    # own way (its twin reads 0.9-1.7x the JAX kernel's error on the 2048
    # disc) and its 25-step state differs from JAX's by f32 rounding, so
    # each figure, taken against the same float64 sum, is held to 4x the
    # JAX kernel's.  The K2 oracle (an f32 sum) is printed beside it.
    jax_mxu = {0: {"max_row": 2.5493e-4, "median": 7.1731e-7,
                   "p99": 2.5246e-5},
               25: {"max_row": 5.9030e-5, "median": 6.9718e-7,
                    "p99": 1.4891e-5}}
    mxu_bound = {k: {q: 4 * v for q, v in d.items()} for k, d in
                 jax_mxu.items()}

    def force_errors(got, ref):
        """max-row |d| / mean-row |ref|, and the median and p99 of
        |d| / max(|ref|, median |ref|) per row."""
        rn = ref.norm(dim=1)
        err = ((got - ref).norm(dim=1)
               / torch.clamp(rn, min=float(rn.median()))).cpu().numpy()
        return {"max_row": rel_err(got, ref), "median": float(np.median(err)),
                "p99": float(np.percentile(err, 99))}

    def mxu_errors(sim):
        """K6's forces on the sim's state, on the bound script's 1024
        sampled alive rows, against a float64 direct sum; and the K2
        oracle's against the same sum."""
        sim.update_forces()
        st = sim.state
        alive_idx = np.nonzero(st.alive.cpu().numpy())[0]
        rows = torch.as_tensor(np.random.default_rng(0).choice(
            alive_idx, 1024, replace=False), device=dev)
        m_eff = st.effective_mass()
        exact = pw.pairwise_acc_targets_plain(
            st.pos[rows].double(), st.pos.double(), m_eff.double(), G,
            float(np.float32(EPS)), tile=256)
        oracle = pw.pairwise_acc_targets(st.pos[rows], st.pos, m_eff, G, EPS)
        return (force_errors(st.acc[rows].double(), exact),
                force_errors(st.acc[rows], oracle),
                force_errors(oracle.double(), exact))

    ckpt_dir = tempfile.TemporaryDirectory(prefix="chip_smoke_",
                                           dir=_build.BUILD_DIR)
    ckpt = os.path.join(ckpt_dir.name, "state.pkl")
    pw.reset_launch_counts()
    mxu = cli.main(["-n", "65535", "--engine", "brute-pallas-mxu", "--steps",
                    "25", "--energy", "--energy-exact", "--json", "--device",
                    "cuda", "--save", ckpt])
    mxu_launches = pw.launch_counts()
    require(mxu_launches["pairwise_acc_mxu"] >= 25,
            f"the mxu run launched {mxu_launches}")
    nums = [v for v in mxu.values() if isinstance(v, float)]
    require(all(map(math.isfinite, nums)), f"non-finite result {mxu}")
    require(mxu["energy_drift"] < 1e-5,
            f"mxu energy drift {mxu['energy_drift']:.3e}")
    p_, v_, m_ = self_gravitating_disc(65535, seed=0)
    parts = []
    for k in (0, 25):
        sim = Simulation(p_, v_, m_, engine="brute-pallas-mxu",
                         device="cuda", dt=3e-2, g_soft=EPS)
        if k:
            sim.load(ckpt)
        got_err, vs_k2, k2_err = mxu_errors(sim)
        require(all(got_err[q] < mxu_bound[k][q] for q in got_err),
                f"mxu forces after {k} steps vs float64 {got_err}, bound "
                f"{mxu_bound[k]}")
        fmt = lambda d: ", ".join(f"{q} {v:.3e}" for q, v in d.items())
        parts.append(
            f"after {k} steps vs float64: " + ", ".join(
                f"{q} {v:.3e} (JAX {jax_mxu[k][q]:.3e})"
                for q, v in got_err.items())
            + f"; vs K2 oracle: {fmt(vs_k2)}; K2 vs float64: {fmt(k2_err)}")
    ckpt_dir.cleanup()
    print(f"[14 mxu path] n 65536, 25 steps: K6 launched "
          f"{mxu_launches['pairwise_acc_mxu']}x, "
          f"{mxu['steps_per_second']:.2f} steps/s, drift "
          f"{mxu['energy_drift']:.3e}, n_alive {mxu['n_alive']}; forces on "
          "1024 rows (bound 4x JAX's): " + " | ".join(parts), flush=True)

    # -- 15. times ----------------------------------------------------------
    def k5_bound(tgt8, msrc):
        """Each unordered pair with a massive member, once."""
        Gs, B = msrc.shape
        ng = (msrc != 0).sum(dim=1).double()
        pairs = float((ng * (ng - 1) / 2 + ng * (B - ng)).sum())
        return bound(pairs, "sym", Gs * B * 28)

    a, _ = sym_1m["group_self_force"][0]
    k5_ms, k5_plain = pair(lambda: gf.group_self_force(*a),
                           lambda: gf.group_self_force_plain(*a), 10, 1)
    k5_bnd = k5_bound(a[0], a[1])
    shape_k5 = tuple(a[0].shape)
    a, _ = sym_100k["group_self_force"][0]
    k5s_ms, k5s_plain = pair(lambda: gf.group_self_force(*a),
                             lambda: gf.group_self_force_plain(*a), 20, 2)
    k5s_bnd = k5_bound(a[0], a[1])
    a, k = sym_1m["group_force"][0]
    k3s_ms, k3s_plain = pair(lambda: gf.group_force(*a, **k),
                             lambda: gf.group_force_plain(*a, **k), 20, 2)
    k3s_bnd = k3_bound(a[0], a[1], k["tile"], k["mask"])
    shape_k3s = f"{tuple(a[0].shape)} x {tuple(a[1].shape)}"
    ps, ms_ = k6_in
    k6_ms, k6_plain = pair(lambda: pw.pairwise_acc_mxu(ps, ms_, G, EPS),
                           lambda: pw.pairwise_acc_mxu_plain(ps, ms_, G, EPS),
                           20, 1)
    k6_bnd = bound(ps.shape[0] * nnz(ms_), "mxu", 28 * ps.shape[0])
    rates = {}
    for label, n, steps in (("1M", 1048575, 10), ("100k", 100000, 100)):
        for opts in ({}, sym_over, sym_over, {}):
            _, rate, _ = sim_run(n, steps, opts)
            rates.setdefault((label, bool(opts)), []).append(rate)
    split_sym = force_split(1048575, **sym_over)
    smi = nvidia_smi()
    rate_s = " | ".join(
        f"{label}: bh {[round(r, 3) for r in rates[(label, False)]]}, "
        f"near_sym {[round(r, 3) for r in rates[(label, True)]]}"
        for label in ("1M", "100k"))
    print(f"[15 times] {smi} | K5 @1M shapes {shape_k5}: {k5_ms:.3f} ms "
          f"(plain {k5_plain:.1f} ms, bound {k5_bnd[0]:.3f} ms) | K5 @100k "
          f"shapes: {k5s_ms:.3f} ms (plain {k5s_plain:.1f} ms, bound "
          f"{k5s_bnd[0]:.3f} ms) | K3 on the 1M near_sym slab {shape_k3s}: "
          f"{k3s_ms:.3f} ms (plain {k3s_plain:.1f} ms, bound "
          f"{k3s_bnd[0]:.3f} ms) | K6 @65536: {k6_ms:.4f} ms (plain "
          f"{k6_plain:.1f} ms, bound {k6_bnd[0]:.4f} ms) | steps/s (bh, "
          f"near_sym, near_sym, bh): {rate_s} | one 1M near_sym force call "
          f"(ms): {json.dumps(split_sym)}", flush=True)

    # -- 16. the tree potential ----------------------------------------------
    def exact_pe64(st, params, tile=512):
        """The exact pair PE (ms, value): the port's f32 row tiles, each
        against the rows after it (every unordered pair once), the tile
        sums added in float64."""
        pos, m = st.pos, st.effective_mass()
        n = pos.shape[0]
        ids = torch.arange(tile, device=dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        total = torch.zeros((), dtype=torch.float64, device=dev)
        for s0 in range(0, n, tile):
            e = min(s0 + tile, n)
            total += core_energy._pe_row_tile(
                pos[s0:e], m[s0:e], ids[:e - s0], pos[s0:], m[s0:],
                params.g, params.eps2).double()
        value = float(total)
        return (time.perf_counter() - t0) * 1e3, value

    def phi_call(st, params):
        cfg = BHConfig.auto_for(st.capacity, multipole="mono", fb_cap=2048)
        return tt.bh_potential(st.pos, st.effective_mass(), params.bounds,
                               params.theta2, params.g, params.g_soft, cfg)

    parts = []
    for label, n, limit in (("100k", 100000, 3e-3), ("2^20", 1048575, 5e-3)):
        st, params = bh_state(n)
        phi_call(st, params)  # warm
        torch.cuda.synchronize()
        # enqueued without a host sync; the scalar is the only thing read
        torch.cuda.set_sync_debug_mode("error")
        try:
            u1, stats = phi_call(st, params)
            u2, _ = phi_call(st, params)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        require(u1.is_cuda and all(v.is_cuda for v in stats.values()),
                f"phi {label}: the result left the card")
        require(torch.equal(u1, u2), f"phi {label}: two calls differ")
        reps = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            u_bh = float(phi_call(st, params)[0])
            reps.append((time.perf_counter() - t0) * 1e3)
        require(u_bh == float(u1), f"phi {label}: a timed call differs")
        pe_ms, u_ex = exact_pe64(st, params)
        rel = abs(u_bh - u_ex) / abs(u_ex)
        four = {k: int(v) for k, v in stats.items()}
        require(math.isfinite(u_bh) and rel < limit,
                f"phi {label}: U {u_bh:.9e} vs exact {u_ex:.9e}: rel "
                f"{rel:.3e} (limit {limit:.0e}); walk {four}")
        parts.append(f"{label} (capacity {st.capacity}): U_bh {u_bh:.9e}, "
                     f"exact (f64 tile sum) {u_ex:.9e}, rel {rel:.3e} (limit "
                     f"{limit:.0e}), walk {four}; estimator "
                     f"{[round(t, 2) for t in reps]} ms, exact PE "
                     f"{pe_ms:.1f} ms")
    smi = nvidia_smi()
    print(f"[16 tree potential] {smi} | " + " | ".join(parts)
          + "; no host sync in the calls, two calls bitwise equal",
          flush=True)

    # -- 17. the compensated stepper ----------------------------------------
    parts = []
    # (a) tests/test_compensated.py's two-body circular orbit: eps 0, dt
    # 1e-3, 10000 steps on brute-pallas (K2 every step, capacity 128),
    # plain and compensated, each against the float64 oracle at the same
    # (f32-rounded) dt
    p2 = np.array([[-0.5, 0.0, 0.0], [0.5, 0.0, 0.0]])
    v2 = np.array([[0.0, -0.5, 0.0], [0.0, 0.5, 0.0]])
    m2 = np.array([0.5, 0.5])
    st = ParticleState.create(p2, v2, m2, device=dev)
    params = SimParams.create(dt=1e-3, g_soft=0.0, bounds_width=10.0,
                              device=dev)
    force = get_engine("brute-pallas").force
    pw.reset_launch_counts()
    out_p = stepper.make_run(force)(st, params, 10_000)
    out_c, _ = stepper.make_run_comp(force)(st, stepper.init_comp(st),
                                            params, 10_000)
    orbit_k2 = pw.launch_counts()["pairwise_acc_targets"]
    require(orbit_k2 >= 20_000, f"the orbit runs launched K2 {orbit_k2}x")
    t0 = time.perf_counter()
    ref, _, _ = native.oracle_run(p2, v2, m2, method="brute", steps=10_000,
                                  dt=params.dt, g_soft=0.0)
    oracle_s = time.perf_counter() - t0
    err_p = float(np.abs(out_p.pos[:2].double().cpu().numpy() - ref).max())
    err_c = float(np.abs(out_c.pos[:2].double().cpu().numpy() - ref).max())
    require(err_c < 0.2 * err_p, f"orbit vs the float64 oracle: compensated "
            f"{err_c:.3e}, plain {err_p:.3e}")
    # what the compensated orbit reads when the force is the float64 pair
    # sum rounded to f32 (no kernel): the floor K2's f32 force sets
    out_c64, _ = stepper.make_run_comp(
        lambda p, m, prm: pw.pairwise_acc_plain(
            p.double(), m.double(), prm.g, prm.g_soft).float())(
        st, stepper.init_comp(st), params, 10_000)
    err_c64 = float(np.abs(out_c64.pos[:2].double().cpu().numpy()
                           - ref).max())
    parts.append(f"(a) orbit, 10000 steps, K2 launched {orbit_k2}x: max "
                 f"|pos - oracle| plain {err_p:.3e}, compensated {err_c:.3e} "
                 f"({err_c / err_p:.3f}x; oracle build + run "
                 f"{oracle_s:.2f} s); compensated with the float64 force "
                 f"rounded to f32 {err_c64:.3e}")

    # (b) the 65536 direct sum through the CLI, K1 every step; then plain,
    # compensated, compensated, plain without energies for the rates
    base = ["-n", "65535", "--engine", "brute-pallas", "--steps", "25",
            "--json", "--device", "cuda"]
    pw.reset_launch_counts()
    comp65 = cli.main([*base, "--compensated", "--energy", "--energy-exact"])
    comp65_k1 = pw.launch_counts()["pairwise_acc_sym"]
    require(comp65_k1 >= 25, f"the compensated 65536 run launched K1 "
            f"{comp65_k1}x")
    require(math.isfinite(comp65["energy_drift"])
            and comp65["energy_drift"] < 1e-5,
            f"compensated 65536 drift {comp65['energy_drift']:.3e}")
    rates65 = {}
    for comp in (False, True, True, False):
        r = cli.main([*base, *(["--compensated"] if comp else [])])
        rates65.setdefault(comp, []).append(r["steps_per_second"])
    parts.append(f"(b) 65536, 25 steps: K1 launched {comp65_k1}x, drift "
                 f"compensated {comp65['energy_drift']:.3e} (plain, phase 5: "
                 f"{big['energy_drift']:.3e}); steps/s plain "
                 f"{[round(x, 2) for x in rates65[False]]}, compensated "
                 f"{[round(x, 2) for x in rates65[True]]}")

    # (c) the 2^20 bh run, compensated, with the tree-estimator energy
    ckpt_dir = tempfile.TemporaryDirectory(prefix="chip_smoke_",
                                           dir=_build.BUILD_DIR)
    ckpt = os.path.join(ckpt_dir.name, "state.pkl")
    base = ["-n", "1048575", "--engine", "bh", "--steps", "10", "--json",
            "--device", "cuda"]
    gf.reset_launch_counts()
    comp1m = cli.main([*base, "--compensated", "--energy", "--save", ckpt])
    comp1m_counts = gf.launch_counts()
    require(comp1m_counts["group_force"] >= 10
            and comp1m_counts["quad_force"] >= 10,
            f"the compensated 1M run launched {comp1m_counts}")
    require(comp1m["energy_method"] == "bh"
            and math.isfinite(comp1m["energy_drift"])
            and comp1m["energy_drift"] < 5e-3,
            f"compensated 1M energy {comp1m}")
    _, four, med, p99, _ = bh_final_check("compensated 1M", 1048575, ckpt)
    ckpt_dir.cleanup()
    parts.append(f"(c) 2^20 bh, 10 steps: launches {comp1m_counts}, drift "
                 f"{comp1m['energy_drift']:.3e} (tree estimator; plain, phase "
                 f"9: {bh_results['1M']['energy_drift']:.3e}); final state "
                 f"{four}, forces vs K2 oracle median {med:.3e} p99 "
                 f"{p99:.3e}")
    # the TwoSum's cost on the bh runs: plain, compensated, compensated,
    # plain, without energies (65536 in (b))
    rates_bh = {}
    for label, n, steps in (("100k", 100000, 100), ("2^20", 1048575, 10)):
        for comp in (False, True, True, False):
            r = cli.main(["-n", str(n), "--engine", "bh", "--steps",
                          str(steps), "--json", "--device", "cuda",
                          *(["--compensated"] if comp else [])])
            rates_bh.setdefault((label, comp), []).append(
                round(r["steps_per_second"], 3))
    parts.append("TwoSum cost, bh steps/s (plain, compensated, compensated, "
                 "plain): " + "; ".join(
                     f"{label} plain {rates_bh[(label, False)]}, compensated "
                     f"{rates_bh[(label, True)]}"
                     for label in ("100k", "2^20")))

    # (d) a compensated run saved mid-way, loaded and continued equals the
    # uninterrupted run bitwise (K1 is bit-reproducible)
    p65, v65, m65 = self_gravitating_disc(65535, seed=0)

    def comp_sim():
        return Simulation(p65, v65, m65, engine="brute-pallas",
                          device="cuda", dt=3e-2, g_soft=EPS,
                          compensated=True)

    whole = comp_sim()
    whole.run(10)
    half = comp_sim()
    half.run(5)
    ckpt_dir = tempfile.TemporaryDirectory(prefix="chip_smoke_",
                                           dir=_build.BUILD_DIR)
    ckpt = os.path.join(ckpt_dir.name, "state.pkl")
    half.save(ckpt)
    resumed = comp_sim().load(ckpt)
    ckpt_dir.cleanup()
    resumed.run(5)
    for a, b, what in ((whole.state.pos, resumed.state.pos, "pos"),
                       (whole.state.vel, resumed.state.vel, "vel"),
                       (whole._lo[0], resumed._lo[0], "pos_lo"),
                       (whole._lo[1], resumed._lo[1], "vel_lo")):
        require(torch.equal(a, b), f"resumed compensated run: {what} differs")
    lo_max = float(whole._lo[0].abs().max())
    require(lo_max > 0.0, "the compensated run's low words stayed zero")
    parts.append(f"(d) 65536, 5 + save/load + 5 steps bitwise equal to 10 "
                 f"(pos, vel and both low words; max |pos_lo| {lo_max:.2e})")

    # (e) one compensated step under an elementwise force: card == CPU
    words = []
    for d in (dev, torch.device("cpu")):
        st = ParticleState.create(p65, v65, m65, device=d)
        params = SimParams.create(dt=3e-2, bounds_width=3.0, device=d)
        lo = tuple(torch.full_like(st.pos, 1e-9) for _ in range(2))
        s1, l1 = stepper.make_step_comp(lambda p, m, prm: -p)(st, lo, params)
        words.append([t.cpu() for t in (s1.pos, s1.vel, s1.alive, *l1)])
    require(all(torch.equal(a, b) for a, b in zip(*words)),
            "one compensated step: card and CPU differ")
    parts.append(f"(e) one step under -pos, 65536 rows "
                 f"({int(words[0][2].sum())} alive after the cull): card "
                 "and CPU bitwise equal")
    smi = nvidia_smi()
    print(f"[17 compensated] {smi} | " + " | ".join(parts), flush=True)

    # -- 18. diagnostics and the profiler -----------------------------------
    parts = []
    # momentum, angular momentum and centre of mass over the 65536 K1 run,
    # evaluated on float64 copies of the f32 states (the change of the
    # state, not the rounding of the sums), against a bound from f32
    # rounding (PERF.md section 2): per step, with u = 2^-24 and gamma =
    # 515 (K1's longest addition chain, 256 rows and 256 tile partials, and
    # the pair term's three roundings),
    #   |dP| <= sqrt3 u (2 sum m|v| + (gamma + 2) dt A)
    #   |dL| <= sqrt3 u (4 sum m|r||v| + R (gamma + 2) dt A)
    #   |dC - P0 T / M| <= (2 sqrt3 u sum m|r| + bound_P T) / M
    # where A = sum_i m_i sum_j m_j |r_ij| / (r_ij^2 + eps^2)^1.5 (every
    # pair force's size, both directions), R the largest |r|, T the run's
    # time
    u = 2.0 ** -24
    gamma = 515

    def as64(st):
        return dataclasses.replace(
            st, pos=st.pos.double(), vel=st.vel.double(),
            mass=st.mass.double(), acc=st.acc.double(),
            time=st.time.double())

    def pair_force_sum(pos, m, eps2, tile=1024):
        pos, m = pos.double(), m.double()
        total = torch.zeros((), dtype=torch.float64, device=dev)
        for s0 in range(0, pos.shape[0], tile):
            d = pos[None, :, :] - pos[s0:s0 + tile, None, :]
            r2 = (d * d).sum(-1)
            w = torch.where(r2 > 0, (r2 + eps2) ** -1.5, 0.0)
            total += (m[s0:s0 + tile, None] * m[None, :] * r2.sqrt()
                      * w).sum()
        return float(total)

    sim = Simulation(p65, v65, m65, engine="brute-pallas", device="cuda",
                     dt=3e-2, g_soft=EPS)
    s0 = sim.state
    d0 = diag.diagnostics(s0, sim.settings)
    q0 = {k: f(as64(s0)) for k, f in (("P", diag.momentum),
                                       ("L", diag.angular_momentum),
                                       ("C", diag.center_of_mass))}
    m = s0.effective_mass().double()
    vn, rn = s0.vel.double().norm(dim=1), s0.pos.double().norm(dim=1)
    mass_tot = float(m.sum())
    sum_mv, sum_mrv = float((m * vn).sum()), float((m * rn * vn).sum())
    sum_mr, r_max = float((m * rn).sum()), float(rn[s0.alive].max())
    a_sum = pair_force_sum(s0.pos, s0.effective_mass(), sim.settings.eps2)
    dt_, steps = sim.settings.dt, 25
    pw.reset_launch_counts()
    sim.run(steps)
    diag_k1 = pw.launch_counts()["pairwise_acc_sym"]
    require(diag_k1 >= steps, f"the diagnostics run launched K1 {diag_k1}x")
    s1 = sim.state
    require(int(s1.n_alive()) == int(s0.n_alive()),
            "a particle left the box during the diagnostics run")
    d1 = diag.diagnostics(s1, sim.settings)
    require(all(bool(torch.isfinite(v).all()) for v in d1.values()),
            "diagnostics not finite")
    q1 = {k: f(as64(s1)) for k, f in (("P", diag.momentum),
                                       ("L", diag.angular_momentum),
                                       ("C", diag.center_of_mass))}
    t_run = steps * dt_
    s3 = math.sqrt(3.0)
    b_p = steps * s3 * u * (2 * sum_mv + (gamma + 2) * dt_ * a_sum)
    b_l = steps * s3 * u * (4 * sum_mrv + r_max * (gamma + 2) * dt_ * a_sum)
    b_c = (steps * 2 * s3 * u * sum_mr + b_p * t_run) / mass_tot
    dp = float((q1["P"] - q0["P"]).norm())
    dl = float((q1["L"] - q0["L"]).norm())
    dc = float((q1["C"] - q0["C"] - q0["P"] * t_run / mass_tot).norm())
    for what, got, lim in (("momentum", dp, b_p), ("angular momentum", dl,
                                                   b_l),
                           ("centre of mass", dc, b_c)):
        require(got <= lim, f"{what} changed by {got:.3e} over the 65536 "
                f"run (bound {lim:.3e})")
    parts.append(
        f"65536 K1 run, 25 steps (K1 launched {diag_k1}x): |dP| {dp:.3e} "
        f"(bound {b_p:.3e}; sum m|v| {sum_mv:.4e}), |dL| {dl:.3e} (bound "
        f"{b_l:.3e}; sum m|r||v| {sum_mrv:.4e}), |dC - P0 T/M| {dc:.3e} "
        f"(bound {b_c:.3e}); f32 diagnostics: |P| "
        f"{float(d0['momentum'].norm()):.3e} -> "
        f"{float(d1['momentum'].norm()):.3e}, E {float(d0['energy']):.9e} -> "
        f"{float(d1['energy']):.9e}")

    # make_recorder on the card: 20 bh steps of the 100k disc, every 10
    st, params = bh_state(100000)
    gf.reset_launch_counts()
    record = diag.make_recorder(get_engine("bh").force, every=10,
                                with_energy=True)
    final, traj = record(st, params, 20)
    rec_counts = gf.launch_counts()
    require(rec_counts["group_force_masked"] >= 20,
            f"the recorder's bh steps launched {rec_counts}")
    cap = st.capacity
    shapes = {k: tuple(v.shape) for k, v in traj.items()}
    require(shapes == {"pos": (2, cap, 3), "vel": (2, cap, 3), "time": (2,),
                       "n_alive": (2,), "kinetic": (2,), "potential": (2,)},
            f"recorder shapes {shapes}")
    require(torch.equal(traj["pos"][-1], final.pos)
            and torch.equal(traj["vel"][-1], final.vel),
            "the recorder's last snapshot is not the final state")
    require(all(bool(torch.isfinite(v).all()) for v in traj.values()),
            "recorder snapshot not finite")
    parts.append(f"recorder, 100k bh, 20 steps every 10: shapes {shapes}, "
                 f"launches {rec_counts}, last snapshot == final state, "
                 f"times {traj['time'].tolist()}")

    # --profile on the 65536 brute-pallas run: K1 in the trace
    prof_dir = tempfile.TemporaryDirectory(prefix="chip_smoke_prof_",
                                           dir=_build.BUILD_DIR)
    cli.main(["-n", "65535", "--engine", "brute-pallas", "--steps", "25",
              "--json", "--device", "cuda", "--profile", prof_dir.name])
    traces = [f for f in os.listdir(prof_dir.name) if f.endswith(".json")]
    require(len(traces) == 1, f"--profile wrote {traces}")
    path = os.path.join(prof_dir.name, traces[0])
    with open(path) as f:
        names = {e.get("name", "") for e in json.load(f)["traceEvents"]}
    k1_events = sorted(n for n in names if "acc_sym_tiles_kernel" in n)
    trace_mb = os.path.getsize(path) / 1e6
    prof_dir.cleanup()
    require(k1_events, "the --profile trace holds no K1 kernel event")
    parts.append(f"--profile: one trace ({trace_mb:.1f} MB, {len(names)} "
                 f"event names) holding {k1_events[0][:60]}")
    print("[18 diagnostics, profiler] " + " | ".join(parts), flush=True)

    # -- 19. the adaptive path --------------------------------------------
    adaptive = adaptive_phase()

    # -- 20. the visualizer -------------------------------------------------
    vis = vis_phase()

    # -- 21. walk reuse, bh-lazy, 2D states, the BH options -----------------
    reuse = reuse_phase()

    # -- 22. the sharded path -----------------------------------------------
    sharded = sharded_phase()

    # -- 23. the refined domain route, wide rows, checkpoints ---------------
    refined = refined_domain_phase(adaptive["rates"][ADAPTIVE_RUNS[0][0]])

    # -- 24. the build's prefix table kernel --------------------------------
    prefix = prefix_phase()

    # -- 25. the collect walk kernel ----------------------------------------
    walk = walk_phase()
    smi = nvidia_smi()

    # the main paths' launches: phases 9, 19, 20, 21, 22 and 23 (each run
    # read alone)
    bh_runs = [*bh_launches.values(), *adaptive["launches"].values(),
               vis["launches"], *reuse["launches"].values()]
    k4_launches = (sum(c["quad_force"] for c in bh_runs) + sharded["k4"]
                   + refined["k4"])
    def entry(name, source, replaces, launches_, err, ms_, plain_ms, bnd):
        # no single PyTorch call computes a softened-gravity sum
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": launches_,
                "max_abs_err": err, "ms": ms_, "plain_ms": plain_ms,
                "bound_ms": bnd[0], "bound_by": bnd[1], "library_ms": None}

    kernels = [
        entry("K1 pairwise_acc_sym", SOURCE, "nbody_tpu/ops/pairwise.py:280",
              launches["pairwise_acc_sym"], k1_abs, k1_ms, k1_plain,
              k1_bound),
        entry("K2 pairwise_acc_targets", SOURCE,
              "nbody_tpu/ops/pairwise.py:86",
              launches["pairwise_acc_targets"] + sharded["k2"],
              k2_abs, k2_ms, k2_plain, k2_bound),
        # brute-pallas above 262144: launches are phase 5's 301056-row run
        entry(f"K2 pairwise_acc_targets (brute-pallas, K = N = "
              f"{p30.shape[0]})", SOURCE, "nbody_tpu/ops/pairwise.py:86",
              k2_huge_runs, k2_30_abs, k2_30_ms, k2_30_plain, k2_30_bound),
        # the oracle of the bh checks: launches are the 1M check's call
        entry("K2 pairwise_acc_targets (sampled oracle, 4096 x 2^20)",
              SOURCE, "nbody_tpu/ops/pairwise.py:86", k2_checks, k2_o20_abs,
              k2_o20_ms, k2_o20_plain, k2_o20_bound),
        entry("K3 group_force (unmasked, 1M shapes)", SOURCE_BH,
              "nbody_tpu/ops/group_force.py:423",
              sum(c["group_force"] for c in bh_runs) + sharded["k3"]
              + refined["k3"],
              max(k3_abs, adaptive["k3_abs"], vis["group_force_abs"],
                  reuse["k3_abs"], sharded["k3_abs"], refined["k3_abs"]),
              k3_ms, k3_plain, k3_bnd),
        entry("K3 group_force (block-dual masked, 100k shapes)", SOURCE_BH,
              "nbody_tpu/ops/group_force.py:423",
              sum(c["group_force_masked"] for c in bh_runs),
              max(k3m_abs, adaptive["k3_abs"], reuse["k3_abs"]), k3m_ms,
              k3m_plain, k3m_bnd),
        entry("K4 quad_force (1M accepted nodes)", SOURCE_BH,
              "nbody_tpu/ops/group_force.py:362", k4_launches,
              max(k4_abs, adaptive["k4_abs"], vis["quad_force_abs"],
                  reuse["k4_abs"], sharded["k4_abs"], refined["k4_abs"]),
              k4_ms, k4_plain, k4_bnd),
        entry("K5 group_self_force (near_sym, 1M shapes)", SOURCE,
              "nbody_tpu/ops/group_force.py:250",
              sum(c["group_self_force"] for c in sym_launches.values()),
              k5_abs, k5_ms, k5_plain, k5_bnd),
        entry("K6 pairwise_acc_mxu (brute-pallas-mxu, N = 65536)",
              SOURCE_MXU, "nbody_tpu/ops/pairwise.py:462",
              mxu_launches["pairwise_acc_mxu"], k6_abs, k6_ms, k6_plain,
              k6_bnd),
        # no Pallas kernel: the JAX package's lax.associative_scan; its
        # error is the largest over the prefix of |values| (f32), and
        # torch.cumsum is no library counterpart (no TwoSum)
        entry("prefix_table (the 100k build's [100096, 4] f32 table)",
              SOURCE_PS, "nbody_tpu/ops/tree.py:235", prefix["launches"],
              prefix["err"], prefix["ms"], prefix["plain_ms"],
              prefix["bound"]),
        # no Pallas kernel: the JAX package's collect walk is jnp; its
        # outputs equal the twin's bit for bit (error 0)
        entry("group_collect (the 100k walk, 25 groups)", SOURCE_CW,
              "nbody_tpu/ops/traversal.py:1124", walk["launches"], 0.0,
              walk["ms"], walk["plain_ms"], walk["bound"]),
    ]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
