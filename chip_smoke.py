#!/usr/bin/env python3
"""On-card smoke test of the PyTorch / CUDA port (``nbody_tpu_torch``).

    python3 chip_smoke.py

Needs one NVIDIA GPU (Hopper: the kernels are built for sm_90a) and the CUDA
toolkit.  It builds the kernels from ``nbody_tpu_torch/csrc`` at first use
(one nvcc per source, all at once), then runs ten phases, each printing one
line and stopping the script with a non-zero exit on failure:

  1. device: the card, its power limit, TF32 off for matmul and cuDNN;
  2. build: compile and load the kernels;
  3. K2 (plain pairwise) against its plain torch twin on the card;
  4. K1 (Newton-3 pairwise) against its plain torch twin on the card;
  5. the direct-sum path through the CLI: the disc at N = 65536 (65535 + the
     star) for 25 steps on ``brute-pallas``, which must go through K1, and
     at N = 2048 (2047 + the star), which must go through K2; energy drift,
     finiteness, and the final state's forces against the K2 oracle;
  6. times: K1, K2 and their twins with CUDA events, and steps/s of the
     CLI run through the kernels and through the plain torch engine;
  7. K3 (group force, unmasked and block-dual masked) against its plain
     twin: hand-built slabs of every row species, eps = 0 with coincident
     pairs, bitwise-inert padding tiles, and a few groups of the slabs that
     the 1M and 100k walks assemble (the 100k one with its real mask);
  8. K4 (quadrupole slab) against its plain twin: the 1M walk's
     accepted-node slab, the 100k walk's block-dual rows, and an eps = 0
     scene at 1e-3 scale;
  9. the Barnes-Hut path through the CLI: the flagship configuration (the
     disc at N = 100000 + the star, 100 steps, exact energy) and the 1M
     bench run (N = 1048575 + the star, 10 steps) on ``bh``.  Each run must
     go through its kernels; on its final state the walk drops nothing,
     two force calls are bitwise equal, and the forces of 4096 sampled
     alive rows meet the accuracy envelope against the K2 oracle;
 10. times: K3 and K4 beside their twins at the shapes of both runs,
     steps/s of both runs, and one 1M force call split by phase.

The line before the last is the card's name and power limit as nvidia-smi
reports them; the last line is the result JSON.
"""

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
G, EPS = 1.0, 0.02  # the main-path settings (the CLI defaults)


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
    from nbody_tpu_torch.core.state import ParticleState, SimParams
    from nbody_tpu_torch.ops import _build
    from nbody_tpu_torch.ops import group_force as gf
    from nbody_tpu_torch.ops import pairwise as pw
    from nbody_tpu_torch.ops.traversal import BHConfig, bh_accel
    from nbody_tpu_torch.scenes import self_gravitating_disc

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
    print(f"[3 K2] capacity 2048, 37 dead: rel err {e_k2:.3e} (eps {EPS}), "
          f"{e_k2_0:.3e} per alive row (eps 0); 1024 sampled targets "
          "bitwise equal to the full rows", flush=True)

    # -- 4. K1 -------------------------------------------------------------
    k1_abs, parts = None, []
    for cap in (8192, 65536):
        for kill in (0, 37):
            pos, m, _ = disc(cap - 1, cap, kill)
            got = pw.pairwise_acc_sym(pos, m, G, EPS)
            ref = pw.pairwise_acc_sym_plain(pos, m, G, EPS)
            e = rel_err(got, ref)
            require(e < 1e-4, f"K1 vs plain at {cap}, {kill} dead: {e:.3e}")
            net = (got * m[:, None]).sum(dim=0).abs().max()
            scale = (got.abs() * m[:, None]).sum()
            require(float(net) < 1e-5 * float(scale),
                    f"K1 momentum at {cap}: {float(net):.3e} vs "
                    f"{float(scale):.3e}")
            require(torch.equal(got, pw.pairwise_acc_sym(pos, m, G, EPS)),
                    f"K1 is not bit-reproducible at {cap}")
            if cap == 65536 and kill == 0:
                k1_abs = float((got - ref).abs().max())
            parts.append(f"{cap}/{kill} dead {e:.3e} (|sum m a| / sum m|a| "
                         f"{float(net) / float(scale):.1e})")
    print("[4 K1] rel err vs plain: " + ", ".join(parts)
          + "; two calls bitwise equal", flush=True)

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
    pick = torch.as_tensor(
        np.random.default_rng(0).choice(alive_idx, 1024, replace=False),
        device=dev)
    oracle = pw.pairwise_acc_targets(st.pos[pick], st.pos,
                                     st.effective_mass(), G, EPS)
    e_or = rel_err(st.acc[pick], oracle)
    require(e_or < 1e-4, f"update_forces vs K2 oracle: {e_or:.3e}")
    print(f"[5 main path] n 65536: K1 launched {k1_runs}x, drift "
          f"{big['energy_drift']:.3e}, n_alive {big['n_alive']}, "
          f"update_forces vs K2 oracle (1024 rows) {e_or:.3e} | n 2048: K2 "
          f"launched {k2_runs}x, drift {small['energy_drift']:.3e}, n_alive "
          f"{small['n_alive']}", flush=True)

    # -- 6. times ----------------------------------------------------------
    def ms(fn, reps):
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
    k2_full_ms = ms(lambda: pw.pairwise_acc(pos, m, G, EPS), 20)
    tpos = pos[:1024].contiguous()
    k2_or_ms, k2_or_plain = pair(
        lambda: pw.pairwise_acc_targets(tpos, pos, m, G, EPS),
        lambda: pw.pairwise_acc_targets_plain(tpos, pos, m, G, EPS), 20, 5)
    pos2, m2, _ = disc(2047, 2048, 0)
    k2_ms, k2_plain = pair(lambda: pw.pairwise_acc(pos2, m2, G, EPS),
                           lambda: pw.pairwise_acc_plain(pos2, m2, G, EPS),
                           200, 50)
    steps = {}
    for engine in ("brute", "brute-pallas", "brute-pallas", "brute"):
        r = cli.main(["-n", "65535", "--engine", engine, "--steps", "25",
                      "--json", "--device", "cuda"])
        steps.setdefault(engine, []).append(r["steps_per_second"])
    smi = nvidia_smi()
    print(f"[6 times] {smi} | K1 @65536 {k1_ms:.4f} ms (plain {k1_plain:.3f}"
          f" ms) | K2 @2048 {k2_ms:.4f} ms (plain {k2_plain:.4f} ms) | K2 "
          f"full @65536 {k2_full_ms:.4f} ms | K2 1024 targets x 65536 "
          f"{k2_or_ms:.4f} ms (plain {k2_or_plain:.3f} ms) | steps/s @65536,"
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

    def walk_calls(n):
        """One bh force call at the CLI's configuration for n, recording
        the kernel wrappers' arguments: the slabs the walk assembles."""
        st, params = bh_state(n)
        calls = {"group_force": [], "quad_force": []}
        orig = {k: getattr(gf, k) for k in calls}

        def spy(name):
            def call(*a, **kw):
                calls[name].append((a, kw))
                return orig[name](*a, **kw)
            return call

        try:
            for k in calls:
                setattr(gf, k, spy(k))
            bh_accel(st.pos, st.effective_mass(), params.bounds,
                     params.theta2, params.g, params.g_soft,
                     BHConfig.auto_for(st.capacity))
        finally:
            for k, fn in orig.items():
                setattr(gf, k, fn)
        torch.cuda.synchronize()
        return calls

    def pick(args, kw, groups):
        """The call restricted to a few groups (all of them for the
        block-dual rows, whose 'groups' are target tiles)."""
        sel = torch.as_tensor(groups, device=dev)
        a = tuple(t[sel].contiguous() if torch.is_tensor(t) else t
                  for t in args)
        k = {key: (v[sel].contiguous() if torch.is_tensor(v) else v)
             for key, v in kw.items()}
        return a, k

    calls_1m = walk_calls(1048575)
    calls_100k = walk_calls(100000)
    require(len(calls_1m["group_force"]) == 1
            and calls_1m["group_force"][0][1]["mask"] is None,
            "the 1M walk did not make one unmasked K3 call")
    require(len(calls_100k["group_force"]) == 1
            and calls_100k["group_force"][0][1]["mask"] is not None,
            "the 100k walk did not make one masked K3 call")

    def k3_check(args, kw, label, bound=1e-5):
        got = gf.group_force(*args, **kw)
        torch.cuda.synchronize()
        ref = gf.group_force_plain(*args, **kw)
        require(bool(torch.isfinite(got).all()), f"K3 {label}: not finite")
        e = rows_err(got, ref)
        require(e < bound, f"K3 {label} vs plain: {e:.3e}")
        require(torch.equal(got, gf.group_force(*args, **kw)),
                f"K3 {label}: two calls differ")
        return e, float((got - ref).abs().max())

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
    def k4_check(args, kw, label):
        got = gf.quad_force(*args, **kw)
        torch.cuda.synchronize()
        ref = gf.quad_force_plain(*args, **kw)
        require(bool(torch.isfinite(got).all()), f"K4 {label}: not finite")
        e = rows_err(got, ref)
        require(e < 5e-5, f"K4 {label} vs plain: {e:.3e}")
        require(torch.equal(got, gf.quad_force(*args, **kw)),
                f"K4 {label}: two calls differ")
        return e, float((got - ref).abs().max())

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
    print("[8 K4] rel err vs plain: " + "; ".join(parts)
          + "; two calls bitwise equal", flush=True)

    # -- 9. the bh main path ------------------------------------------------
    runs = [("100k", 100000, 100, ["--energy", "--energy-exact"]),
            ("1M", 1048575, 10, [])]
    # sampled force error |da| / max(|a|, median |a|) against the K2 oracle:
    # the envelope of tests/test_barnes_hut.py is median 2e-3, p99 5e-2.
    # At the 1M tier (window pad 512, near cap 512) the algorithm itself
    # reads a median of 2.35e-3 on the bench's initial state: the JAX
    # package's XLA eval and this port agree there to five digits (PERF.md),
    # so the 1M run's median is held to 3e-3.
    median_bound = {"100k": 2e-3, "1M": 3e-3}
    bh_launches = {}
    bh_results = {}
    parts = []
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
        nums = [v for v in r.values() if isinstance(v, float)]
        require(all(map(math.isfinite, nums)), f"non-finite result {r}")
        pos, vel, mass = self_gravitating_disc(n, seed=0)
        sim = Simulation(pos, vel, mass, engine="bh", device="cuda",
                         dt=3e-2, g_soft=EPS).load(ckpt)
        ckpt_dir.cleanup()
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
        alive_idx = np.nonzero(st.alive.cpu().numpy())[0]
        rows = torch.as_tensor(np.sort(np.random.default_rng(0).choice(
            alive_idx, 4096, replace=False)), device=dev)
        oracle = pw.pairwise_acc_targets(st.pos[rows], st.pos, m_eff, G, EPS)
        rn = oracle.norm(dim=1)
        err = ((acc[rows] - oracle).norm(dim=1)
               / torch.clamp(rn, min=float(rn.median()))).cpu().numpy()
        med, p99 = float(np.median(err)), float(np.percentile(err, 99))
        require(med < median_bound[label] and p99 < 5e-2,
                f"{label}: sampled force error median {med:.3e}, p99 "
                f"{p99:.3e}")
        drift = (f", drift {r['energy_drift']:.3e}" if "energy_drift" in r
                 else "")
        parts.append(
            f"{label} ({r['n']} + star, {steps} steps, capacity "
            f"{st.capacity}): launches {counts}, {r['steps_per_second']:.2f}"
            f" steps/s, n_alive {r['n_alive']}{drift}; final state: "
            f"{four}, forces vs K2 oracle (4096 rows) median {med:.3e} p99 "
            f"{p99:.3e}, two calls bitwise equal")
    print("[9 bh main path] " + " | ".join(parts), flush=True)

    # -- 10. times ----------------------------------------------------------
    a, k = calls_1m["group_force"][0]
    k3_ms, k3_plain = pair(lambda: gf.group_force(*a, **k),
                           lambda: gf.group_force_plain(*a, **k), 10, 1)
    a, k = calls_100k["group_force"][0]
    k3m_ms, k3m_plain = pair(lambda: gf.group_force(*a, **k),
                             lambda: gf.group_force_plain(*a, **k), 20, 2)
    a, k = calls_1m["quad_force"][0]
    k4_ms, k4_plain = pair(lambda: gf.quad_force(*a, **k),
                           lambda: gf.quad_force_plain(*a, **k), 10, 1)
    a, k = calls_100k["quad_force"][0]
    k4d_ms, k4d_plain = pair(lambda: gf.quad_force(*a, **k),
                             lambda: gf.quad_force_plain(*a, **k), 20, 2)
    a, k = calls_100k["quad_force"][1]
    k4a_ms, k4a_plain = pair(lambda: gf.quad_force(*a, **k),
                             lambda: gf.quad_force_plain(*a, **k), 20, 2)

    # one 1M force call, split at the phase marks with CUDA events
    st, params = bh_state(1048575)
    cfg = BHConfig.auto_for(st.capacity)
    m_eff = st.effective_mass()
    split = {}
    for _ in range(2):  # the second call is the one kept
        events = []

        def mark(name, events=events):
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            events.append((name, ev))

        mark("start")
        bh_accel(st.pos, m_eff, params.bounds, params.theta2, params.g,
                 params.g_soft, cfg, mark=mark)
        torch.cuda.synchronize()
        split = {name: round(events[i - 1][1].elapsed_time(ev), 3)
                 for i, (name, ev) in enumerate(events) if i}
    split["total"] = round(sum(split.values()), 3)
    smi = nvidia_smi()
    print(f"[10 times] {smi} | K3 unmasked @1M shapes {shape_1m}: "
          f"{k3_ms:.3f} ms (plain {k3_plain:.1f} ms) | K3 masked @100k "
          f"shapes: {k3m_ms:.3f} ms (plain {k3m_plain:.1f} ms) | K4 @1M "
          f"accepted nodes: {k4_ms:.3f} ms (plain {k4_plain:.1f} ms) | K4 "
          f"@100k dual rows: {k4d_ms:.4f} ms (plain {k4d_plain:.2f} ms), "
          f"accepted nodes: {k4a_ms:.3f} ms (plain {k4a_plain:.1f} ms) | "
          f"steps/s: 100k {bh_results['100k']['steps_per_second']:.3f}, 1M "
          f"{bh_results['1M']['steps_per_second']:.3f} | one 1M force call "
          f"(ms): {json.dumps(split)}", flush=True)

    k4_launches = sum(c["quad_force"] for c in bh_launches.values())
    kernels = [
        {"name": "K1 pairwise_acc_sym", "route": "cuda", "source": SOURCE,
         "replaces": "nbody_tpu/ops/pairwise.py:280",
         "launches": launches["pairwise_acc_sym"], "max_abs_err": k1_abs,
         "ms": k1_ms, "plain_ms": k1_plain},
        {"name": "K2 pairwise_acc_targets", "route": "cuda", "source": SOURCE,
         "replaces": "nbody_tpu/ops/pairwise.py:86",
         "launches": launches["pairwise_acc_targets"], "max_abs_err": k2_abs,
         "ms": k2_ms, "plain_ms": k2_plain},
        {"name": "K3 group_force (unmasked, 1M shapes)", "route": "cuda",
         "source": SOURCE_BH, "replaces": "nbody_tpu/ops/group_force.py:423",
         "launches": bh_launches["1M"]["group_force"]
         + bh_launches["100k"]["group_force"], "max_abs_err": k3_abs,
         "ms": k3_ms, "plain_ms": k3_plain},
        {"name": "K3 group_force (block-dual masked, 100k shapes)",
         "route": "cuda", "source": SOURCE_BH,
         "replaces": "nbody_tpu/ops/group_force.py:423",
         "launches": bh_launches["100k"]["group_force_masked"]
         + bh_launches["1M"]["group_force_masked"], "max_abs_err": k3m_abs,
         "ms": k3m_ms, "plain_ms": k3m_plain},
        {"name": "K4 quad_force (1M accepted nodes)", "route": "cuda",
         "source": SOURCE_BH, "replaces": "nbody_tpu/ops/group_force.py:362",
         "launches": k4_launches, "max_abs_err": k4_abs, "ms": k4_ms,
         "plain_ms": k4_plain},
    ]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
