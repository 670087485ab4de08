"""Headless CLI (the counterpart of ``nbody_tpu/cli.py``): the same flags,
output lines and JSON keys, plus ``--device {cuda,cpu}``.

Example:
    python -m nbody_tpu_torch -n 65535 --engine brute-pallas --steps 25 \
        --energy --energy-exact --json --device cuda

    python -m nbody_tpu_torch -n 1048575 --engine bh --steps 10 --json \
        --device cuda

    python -m nbody_tpu_torch -n 65535 --engine brute-pallas --steps 25 \
        --compensated --energy --energy-exact --profile prof --device cuda

    python -m nbody_tpu_torch --scene plummer -n 1048576 --box-width 40 \
        --engine bh --adaptive --steps 5 --energy --json --device cuda

    python -m nbody_tpu_torch -n 1048575 --engine bh --walk-every 4 \
        --steps 12 --energy --json --device cuda

    torchrun --nproc-per-node 4 -m nbody_tpu_torch -n 1048575 \
        --engine bh --devices 4 --steps 10 --json

``--profile DIR`` switches the span recorder on for the timed loop: the
Chrome trace in DIR shows each step's phases, and the JSON result gives
each span's median ms a step under ``spans``.

``--devices N`` (N > 1) runs ``ShardedSimulation`` on a process group of
world size N: one the caller initialized, or one from ``torchrun``'s
environment.  Every rank runs the same command; rank 0 prints.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import time

import torch

from nbody_tpu_torch.api import Simulation, resolve_auto_engine
from nbody_tpu_torch.engines import ENGINES
from nbody_tpu_torch.ops.traversal import (
    DENSE_OVERRIDES,
    resolve_adaptive_overrides,
)
from nbody_tpu_torch.scenes import SCENES
from nbody_tpu_torch.utils import profiling


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="nbody_tpu_torch",
        description="N-body benchmark runner on PyTorch (CUDA kernels on an "
        "NVIDIA GPU, plain torch on the CPU)",
    )
    p.add_argument("-n", "--num-points", type=int, default=10000,
                   help="disc particle count")
    p.add_argument("--steps", type=int, default=1000, help="number of steps")
    p.add_argument("--engine", default="auto",
                   choices=["auto"] + sorted(ENGINES),
                   help="force engine; 'auto' picks the direct sum up to "
                   "N = 60000 and bh above it")
    p.add_argument("--scene", default="disc", choices=sorted(SCENES))
    p.add_argument("--integrator", default="leapfrog")
    p.add_argument("--dt", type=float, default=3e-2, help="timestep")
    p.add_argument("--g", type=float, default=1.0)
    p.add_argument("--g-soft", type=float, default=0.02, help="softening")
    p.add_argument("--theta2", type=float, default=1.0,
                   help="BH opening angle^2")
    p.add_argument("--box-width", type=float, default=10.0)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--f64", action="store_true",
                   help="run in float64 (plain torch engines only: the CUDA "
                   "kernels take float32)")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="cuda runs on the GPU or fails; cpu runs plain torch")
    p.add_argument("--cpu", action="store_true",
                   help="the JAX package's flag: same as --device cpu")
    p.add_argument("--energy", action="store_true",
                   help="report initial/final total energy and drift")
    p.add_argument("--energy-exact", action="store_true",
                   help="use the exact O(N^2) pair potential for --energy")
    p.add_argument("--chunk", type=int, default=0,
                   help="steps per run() call (0 = all in one call)")
    p.add_argument("--json", action="store_true", help="emit one JSON line")
    p.add_argument("--save", metavar="PATH", default=None,
                   help="checkpoint the final state to PATH: a pickle the "
                   "JAX package also reads, or with --devices N > 1 a "
                   "torch.distributed.checkpoint directory (the JAX "
                   "package's orbax default); the JSON names the format")
    p.add_argument("--devices", type=int, default=0,
                   help="shard particles over this many ranks, one a card "
                   "(0 or 1 = single device; N > 1 needs a process group of "
                   "world size N, e.g. from torchrun --nproc-per-node N)")
    p.add_argument("--profile", metavar="DIR", default=None,
                   help="write a torch.profiler Chrome trace of the timed "
                   "loop, with the span recorder's phases, into DIR (and "
                   "each span's median ms a step under 'spans' in --json)")
    p.add_argument("--accurate", action="store_true",
                   help="BH accuracy profile: window pad 2048 (bh engines "
                   "only)")
    p.add_argument("--dense", action="store_true",
                   help="BH steep-core profile: depth-8 leaf grid and doubled "
                   "walk budgets (bh engines only)")
    p.add_argument("--adaptive", action="store_true",
                   help="BH density-adaptive profile: refined levels below "
                   "the leaf grid, the deep, tight-box or mid-N stack "
                   "resolved from the scene's leaf occupancy (bh/bh-deep "
                   "only)")
    p.add_argument("--refine", type=int, default=0, metavar="R",
                   help="BH density-adaptive depth: up to R refined levels "
                   "below the leaf grid for dense cells "
                   "(BHConfig.refine_levels; bh/bh-deep only)")
    p.add_argument("--walk-every", type=int, default=1, metavar="K",
                   help="BH walk reuse: run the tree walk every K steps, "
                   "evaluating the frozen walk topology at the current "
                   "positions in between (bh/bh-deep only; 1 = walk every "
                   "step)")
    p.add_argument("--compensated", action="store_true",
                   help="double-float (TwoSum) position/velocity updates: "
                   "closes most of the f32 energy-drift gap to float64")
    return p


def _adaptive_options(args, pos, bounds_center) -> dict:
    """The engine fields of --adaptive and --refine, with the JAX
    package's checks and messages (``nbody_tpu/cli.py:145-175``):
    --adaptive takes the stack resolved from this scene's leaf occupancy,
    and a --refine R after it overrides the refined depth."""
    opts = {}
    for flag, on in (("--adaptive", args.adaptive),
                     ("--refine", args.refine)):
        if not on:
            continue
        if not args.engine.startswith("bh") or args.engine == "bh-lazy":
            raise SystemExit(f"{flag} applies to bh/bh-deep only")
        if args.walk_every > 1:
            raise SystemExit(f"{flag} and --walk-every are exclusive "
                             "(refined rows have no cached-topology route)")
    if args.adaptive:
        if args.dense:
            raise SystemExit("--adaptive and --dense are exclusive "
                             "steep-core profiles (adaptive supersedes "
                             "dense where a single chip suffices)")
        ov = resolve_adaptive_overrides(pos, bounds_center, args.box_width)
        opts.update(ov)
        print("[nbody-tpu] --adaptive resolved to the "
              + ("deep" if ov["max_level"] == 7 else "tight-box")
              + f" stack (max_level={ov['max_level']}, "
              f"refine_levels={ov['refine_levels']})")
    if args.refine:
        opts.update(refine_levels=args.refine)
    return opts


def _process_group(n: int, device) -> bool:
    """Make sure a process group of world size ``n`` is initialized: the
    caller's, or one from ``torchrun``'s environment (returns True when
    this call made it).  Anything else exits naming the launcher."""
    import torch.distributed as dist

    from nbody_tpu_torch.parallel.mesh import GROUP_TIMEOUT, backend_for

    hint = f"run it as torchrun --nproc-per-node {n} -m nbody_tpu_torch ..."
    made = False
    if not dist.is_initialized():
        if "WORLD_SIZE" not in os.environ or "RANK" not in os.environ:
            raise SystemExit(f"--devices {n} needs a process group of world "
                             f"size {n} and none is initialized; {hint}")
        dist.init_process_group(backend_for(device), timeout=GROUP_TIMEOUT)
        made = True
    if dist.get_world_size() != n:
        raise SystemExit(f"--devices {n} but the process group has world "
                         f"size {dist.get_world_size()}; {hint}")
    return made


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    device = "cpu" if args.cpu else args.device
    dtype = torch.float64 if args.f64 else torch.float32
    sharded = args.devices > 1

    eng_opts = {}
    for flag, on, opts in (("--accurate", args.accurate, dict(window_pad=2048)),
                           ("--dense", args.dense, DENSE_OVERRIDES)):
        if on:
            if not args.engine.startswith("bh"):
                raise SystemExit(f"{flag} applies to bh engines only")
            eng_opts.update(opts)

    pos, vel, mass = SCENES[args.scene](args.num_points, seed=args.seed)
    # one box for the adaptive resolver and the Simulation: the CLI's
    # scenes are centred at the origin
    bounds_center = (0.0, 0.0, 0.0)
    if sharded and args.engine == "auto":
        # ShardedSimulation has no auto mode: the crossover is applied here
        args.engine = resolve_auto_engine(len(mass), device)
    eng_opts.update(_adaptive_options(args, pos, bounds_center))
    if args.walk_every > 1:
        if not args.engine.startswith("bh") or args.engine == "bh-lazy":
            raise SystemExit("--walk-every applies to bh/bh-deep only")
        if sharded:
            raise SystemExit("--walk-every is single-device only")
        eng_opts.update(walk_every=args.walk_every)
    common = dict(integrator=args.integrator, bounds_center=bounds_center,
                  bounds_width=args.box_width, dtype=dtype, device=device,
                  dt=args.dt, g=args.g, g_soft=args.g_soft,
                  theta2=args.theta2, engine_options=eng_opts or None)
    made_group = False
    if sharded:
        from nbody_tpu_torch.parallel import ShardedSimulation

        if args.compensated:
            raise SystemExit(
                "--compensated is single-device only (use --devices 1)")
        made_group = _process_group(args.devices, device)
        sim = ShardedSimulation(pos, vel, mass, engine=args.engine,
                                n_devices=args.devices, **common)
        engine_name, run_device = args.engine, sim.mesh.device
        printer = print if sim.mesh.rank == 0 else (lambda *a, **k: None)
    else:
        sim = Simulation(pos, vel, mass, engine=args.engine,
                         compensated=args.compensated, **common)
        engine_name, run_device, printer = sim.engine.name, sim.device, print
    try:
        return _timed_run(args, sim, engine_name, run_device, printer)
    finally:
        if made_group:
            import torch.distributed as dist

            dist.destroy_process_group()


def _timed_run(args, sim, engine_name, run_device, printer) -> dict:
    """Energy, the warm run and the timed run of ``sim``; ``printer``
    prints (a no-op on every rank but 0 of a sharded run)."""
    e_method = "exact" if args.energy_exact else "auto"
    e0 = sim.energy(method=e_method) if args.energy else None

    # warm-execute one chunk, then rewind: on the card the first run pays
    # the kernel build and load and the allocator's warm-up, which must not
    # land in the timed window
    chunk = args.chunk or args.steps
    sim.run(min(chunk, args.steps))
    sim.block_until_ready()
    sim.reset()

    if not args.json:
        printer("Running simulation without rendering...")

    prof = contextlib.nullcontext()
    if args.profile:
        prof = profiling.trace(args.profile)

    with prof:
        since = time.time_ns()
        start = time.perf_counter()
        remaining = args.steps
        while remaining > 0:
            k = min(chunk, remaining)
            sim.run(k)
            remaining -= k
        sim.block_until_ready()
        elapsed = time.perf_counter() - start

    steps_per_second = args.steps / elapsed
    result = {
        "engine": engine_name,
        "n": args.num_points,
        "steps": args.steps,
        "elapsed_s": elapsed,
        "steps_per_second": steps_per_second,
        "n_alive": sim.n_alive,
        "device": (torch.cuda.get_device_name(run_device)
                   if run_device.type == "cuda" else "cpu"),
    }
    if args.profile:
        # each span's median ms a step, on the card's timeline there
        result["spans"] = profiling.span_medians(
            [r for r in profiling.SPANS.resolve()
             if r["spans"][0][2] >= since])
    if args.energy:
        e1 = sim.energy(method=e_method)
        result.update(energy_initial=e0, energy_final=e1,
                      energy_drift=abs((e1 - e0) / e0) if e0 else float("nan"),
                      energy_method=sim.energy_method(e_method))
    if args.save:
        # each class's default format, as in the JAX package: the sharded
        # run writes a directory, the single-device run a pickle
        sharded = args.devices > 1
        fmt = "orbax" if sharded else "pickle"
        sim.save(args.save, format=fmt)
        result.update(checkpoint=args.save, checkpoint_format=(
            "torch.distributed.checkpoint" if sharded else "pickle"))
    if args.json:
        printer(json.dumps(result))
    else:
        printer(f"Elapsed: {elapsed:.3f}s")
        printer(f"Performance: {steps_per_second:.2f} steps/second")
        if args.energy:
            note = ("" if result["energy_method"] == "exact" else
                    " [tree estimator: drifts <~1e-4 may be estimator "
                    "bias — use --energy-exact to measure drift]")
            printer(f"Energy: {e0:.9e} -> {result['energy_final']:.9e} "
                  f"(|drift| {result['energy_drift']:.3e}, "
                  f"{result['energy_method']}){note}")
    return result


if __name__ == "__main__":
    main()
