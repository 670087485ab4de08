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

The flag of the path that is not ported yet (``--devices``, sharding) is
accepted by the parser so that a command line of the JAX package reads the
same, and exits with a message.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import time

import torch

from nbody_tpu_torch.api import Simulation
from nbody_tpu_torch.engines import ENGINES
from nbody_tpu_torch.ops.traversal import (
    DENSE_OVERRIDES,
    resolve_adaptive_overrides,
)
from nbody_tpu_torch.scenes import SCENES


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
                   help="checkpoint the final state to PATH (a pickle the "
                   "JAX package also reads)")
    # not yet ported: accepted, then rejected in main() with a message
    p.add_argument("--devices", type=int, default=0,
                   help="not yet ported (sharding over several devices)")
    p.add_argument("--profile", metavar="DIR", default=None,
                   help="write a torch.profiler Chrome trace of the timed "
                   "loop into DIR")
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


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    if args.devices > 1:
        raise SystemExit("--devices (sharding over several devices) is not "
                         "yet ported to nbody_tpu_torch (ROADMAP.md, queue 1, "
                         "item 17)")
    device = "cpu" if args.cpu else args.device
    dtype = torch.float64 if args.f64 else torch.float32

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
    eng_opts.update(_adaptive_options(args, pos, bounds_center))
    if args.walk_every > 1:
        if not args.engine.startswith("bh") or args.engine == "bh-lazy":
            raise SystemExit("--walk-every applies to bh/bh-deep only")
        eng_opts.update(walk_every=args.walk_every)
    sim = Simulation(
        pos, vel, mass,
        engine=args.engine,
        integrator=args.integrator,
        bounds_center=bounds_center,
        bounds_width=args.box_width,
        dtype=dtype,
        device=device,
        dt=args.dt, g=args.g, g_soft=args.g_soft, theta2=args.theta2,
        compensated=args.compensated,
        engine_options=eng_opts or None,
    )

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
        print("Running simulation without rendering...")

    prof = contextlib.nullcontext()
    if args.profile:
        from nbody_tpu_torch.utils.profiling import trace

        prof = trace(args.profile)

    with prof:
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
        "engine": sim.engine.name,
        "n": args.num_points,
        "steps": args.steps,
        "elapsed_s": elapsed,
        "steps_per_second": steps_per_second,
        "n_alive": sim.n_alive,
        "device": (torch.cuda.get_device_name(sim.device)
                   if sim.device.type == "cuda" else "cpu"),
    }
    if args.energy:
        e1 = sim.energy(method=e_method)
        result.update(energy_initial=e0, energy_final=e1,
                      energy_drift=abs((e1 - e0) / e0) if e0 else float("nan"),
                      energy_method=sim.energy_method(e_method))
    if args.save:
        sim.save(args.save)
        result["checkpoint"] = args.save
    if args.json:
        print(json.dumps(result))
    else:
        print(f"Elapsed: {elapsed:.3f}s")
        print(f"Performance: {steps_per_second:.2f} steps/second")
        if args.energy:
            note = ("" if result["energy_method"] == "exact" else
                    " [tree estimator: drifts <~1e-4 may be estimator "
                    "bias — use --energy-exact to measure drift]")
            print(f"Energy: {e0:.9e} -> {result['energy_final']:.9e} "
                  f"(|drift| {result['energy_drift']:.3e}, "
                  f"{result['energy_method']}){note}")
    return result


if __name__ == "__main__":
    main()
