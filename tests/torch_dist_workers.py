"""Rank workers of the sharded-path tests (tests/test_torch_sharded.py,
tests/test_torch_domain.py).

``spawn(world, tmp_path, cases)`` starts ``world`` fresh interpreters that
run this file: each joins a gloo process group on a ``file://`` store under
``tmp_path`` (no TCP port, so parallel test workers never collide), with one
intra-op thread and a collective timeout of ``GROUP_TIMEOUT``, runs the
cases in order and pickles its results to ``tmp_path``.  A case is a
function of this module by name with keyword arguments; every rank runs
every case, as every process runs the same program under ``torchrun``.

This module imports torch and the port only, never jax: a spawned rank
does not load JAX.  The tests hold the results against the JAX package in
the pytest process.
"""

from __future__ import annotations

import contextlib
import dataclasses
import io
import os
import pickle
import subprocess
import sys
from datetime import timedelta

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GROUP_TIMEOUT = timedelta(seconds=120)
#: the shape of tests/test_sharded.py's run_pair
COMMON = dict(dt=3e-2, g_soft=0.02, theta2=1.0, bounds_width=10.0)


def spawn(world: int, tmp_path, cases, timeout: float = 600.0):
    """Run ``cases`` [(name, fn, kwargs)] on ``world`` ranks; returns one
    {name: result} dict a rank.  Raises with the ranks' output if any
    rank fails or the run outlasts ``timeout`` seconds."""
    tmp = str(tmp_path)
    spec = os.path.join(tmp, f"spec{world}.pkl")
    with open(spec, "wb") as f:
        pickle.dump({"world": world,
                     "store": os.path.join(tmp, f"store{world}"),
                     "cases": cases}, f)
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    procs = []
    for r in range(world):
        log = open(os.path.join(tmp, f"rank{world}_{r}.log"), "w+")
        procs.append((subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), spec, str(r)],
            stdout=log, stderr=subprocess.STDOUT, env=env, cwd=ROOT), log))
    failed = []
    try:
        for r, (p, log) in enumerate(procs):
            try:
                rc = p.wait(timeout=timeout)
            except subprocess.TimeoutExpired:
                rc = "timeout"
            if rc != 0:
                log.seek(0)
                failed.append(f"rank {r} exited {rc}:\n{log.read()[-4000:]}")
    finally:
        for p, log in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
            log.close()
    if failed:
        raise RuntimeError("\n".join(failed))
    out = []
    for r in range(world):
        with open(os.path.join(tmp, f"result{world}_{r}.pkl"), "rb") as f:
            out.append(pickle.load(f))
    return out


def _sim(engine="brute", strategy=None, n=500, capacity=1024, seed=0,
         dtype=torch.float64, opts=None, **kw):
    from nbody_tpu_torch.parallel import ShardedSimulation
    from nbody_tpu_torch.scenes import self_gravitating_disc

    pos, vel, mass = self_gravitating_disc(n, seed=seed)
    args = dict(engine=engine, n_devices=torch.distributed.get_world_size(),
                dtype=dtype, capacity=capacity, device="cpu",
                engine_options=opts, **COMMON)
    if strategy:
        args["strategy"] = strategy
    args.update(kw)
    return ShardedSimulation(pos, vel, mass, **args)


def cluster_scene(n=1024, n_cluster=600, seed=7):
    """tests/test_domain.py's straddling-cell scene: a tight cluster of
    ``n_cluster`` points (one leaf cell at max_level 3, whose sorted range
    spans several shards) in a uniform box: (pos, vel, mass), numpy."""
    rng = np.random.default_rng(seed)
    cluster = 0.05 * rng.standard_normal((n_cluster, 3)) + 1.0
    rest = rng.uniform(-4.0, 4.0, (n - n_cluster, 3))
    pos = np.concatenate([cluster, rest])
    mass = rng.uniform(0.5, 1.5, (n,))
    return pos, np.zeros_like(pos), mass


#: the settings of each scene (the cluster's are tests/test_domain.py's)
SCENE_PARAMS = {"disc": COMMON,
                "cluster": dict(g_soft=0.05, theta2=1.0, bounds_width=10.0)}


def _state(n, capacity, seed, kill=None, dtype=torch.float64, scene="disc"):
    """The scene as a CPU state (the disc by default) with particles [a, b)
    of ``kill`` dead: (state, params)."""
    from nbody_tpu_torch.core.state import ParticleState, SimParams
    from nbody_tpu_torch.scenes import self_gravitating_disc

    if scene == "cluster":
        pos, vel, mass = cluster_scene(n, seed=seed)
    else:
        pos, vel, mass = self_gravitating_disc(n, seed=seed)
    st = ParticleState.create(pos, vel, mass, capacity=capacity,
                              dtype=dtype, device="cpu")
    if kill:
        alive = st.alive.clone()
        alive[kill[0]:kill[1]] = False
        st = dataclasses.replace(st, alive=alive)
    params = SimParams.create(dtype=dtype, device="cpu",
                              **SCENE_PARAMS[scene])
    return st, params


@contextlib.contextmanager
def _wide_n(value):
    """ops/tree.py's WIDE_N lowered to ``value`` (None: as it is)."""
    from nbody_tpu_torch.ops import tree

    old = tree.WIDE_N
    if value is not None:
        tree.WIDE_N = value
    try:
        yield
    finally:
        tree.WIDE_N = old


def _my(t, mesh):
    n = t.shape[0] // mesh.world
    return t[mesh.rank * n:(mesh.rank + 1) * n]


def run_steps(steps=10, **sim_kw):
    """Positions of the alive particles after ``steps`` steps, n_alive."""
    sim = _sim(**sim_kw)
    sim.run(steps)
    return {"pos": sim.get_points()[0], "n_alive": sim.n_alive}


def energy(steps=3, **sim_kw):
    """The sharded energy before and after ``steps`` steps."""
    sim = _sim(**sim_kw)
    e0 = sim.energy()
    sim.run(steps)
    return [e0, sim.energy()]


def ring_route(n=256, seed=0):
    from nbody_tpu_torch.parallel.domain import _ring_route
    from nbody_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(device="cpu")
    rng = np.random.default_rng(seed)
    rows = torch.as_tensor(rng.standard_normal((n, 4)), dtype=torch.float32)
    perm = torch.as_tensor(rng.permutation(n))
    return _ring_route(_my(rows, mesh), _my(perm, mesh), mesh).numpy()


def dist_gather(n=256, r=64, seed=1):
    from nbody_tpu_torch.parallel.domain import _dist_gather
    from nbody_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(device="cpu")
    rng = np.random.default_rng(seed)
    rows = torch.as_tensor(rng.standard_normal((n, 4)), dtype=torch.float32)
    idx = torch.as_tensor(rng.integers(0, n, (mesh.world * r,)))
    return _dist_gather(_my(rows, mesh), _my(idx, mesh), mesh).numpy()


def domain_tree(n=500, capacity=1024, seed=2, level=4, halo=64, kill=None,
                **refine):
    """This rank's sorted rows, halo slab and leaf table, and with
    ``refine`` (build_domain_tree's refine_* arguments) the refined
    tables, slot maps and stats."""
    from nbody_tpu_torch.parallel.domain import build_domain_tree
    from nbody_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(device="cpu")
    st, params = _state(n, capacity, seed, kill)
    t = build_domain_tree(_my(st.pos, mesh), _my(st.effective_mass(), mesh),
                          params.bounds, level, mesh, halo, **refine)
    out = {"rows_s": t.rows_s.numpy(), "ext8": t.ext8.numpy(),
           "leaf": t.level_table[level].numpy()}
    if refine:
        out.update(refine_tables=[x.numpy() for x in t.refine_tables],
                   refine_slot_leaf=t.refine_slot_leaf.numpy(),
                   refine_child_slot=[x.numpy()
                                      for x in t.refine_child_slot],
                   refine_stats=t.refine_stats.numpy())
    return out


def domain_accel(cfg, n=500, capacity=2048, seed=0, kill=None,
                 dtype="float64", scene="disc", wide_n=None):
    """This rank's domain forces and walk statistics, in ``dtype``, with
    ops/tree.py's WIDE_N lowered to ``wide_n`` (the wide row format at a
    small N)."""
    from nbody_tpu_torch.ops.traversal import BHConfig
    from nbody_tpu_torch.parallel.domain import domain_accel as accel
    from nbody_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(device="cpu")
    st, p = _state(n, capacity, seed, kill, getattr(torch, dtype), scene)
    with _wide_n(wide_n):
        acc, stats = accel(_my(st.pos, mesh), _my(st.effective_mass(), mesh),
                           p.bounds, p.theta2, p.g, p.g_soft,
                           BHConfig(**cfg), mesh)
    return {"acc": acc.numpy(),
            **{k: v.numpy() for k, v in stats.items()}}


def disc_force(n=4095, wide_n=None, seed=0):
    """The float32 disc of ``n`` + star on ``ShardedSimulation(strategy=
    "bh")`` at its own preset: this rank's shard (positions and effective
    masses) and its domain force on the initial state, with ops/tree.py's
    WIDE_N lowered to ``wide_n`` (the wide row format at a small N)."""
    from nbody_tpu_torch.parallel.domain import domain_accel as accel

    with _wide_n(wide_n):
        sim = _sim(engine="bh", strategy="bh", n=n, capacity=None,
                   seed=seed, dtype=torch.float32)
        st, p, cfg = sim.state, sim.settings, sim._bh_config
        m = st.effective_mass()
        acc, _stats = accel(st.pos, m, p.bounds, p.theta2, p.g, p.g_soft,
                            cfg, sim.mesh)
    return {"pos": st.pos.numpy(), "mass": m.numpy(), "acc": acc.numpy()}


def domain_spans(n=1000):
    """One step of the domain route with the span recorder off, then one
    with it on, every torch.distributed call of the second counted from
    the tensors it was given: the records and the byte counter after each,
    and the bytes the calls sent by kind (the ring algorithm's, from the
    arguments)."""
    import torch.distributed as dist

    from nbody_tpu_torch.ops import work
    from nbody_tpu_torch.utils import profiling

    opts = dict(max_level=4, group_size=128, subgroups=8, window_pad=32,
                near_particle_cap=512, near_cell_cap=512, start_level=1,
                chunk_groups=1, block_dual=True)
    sim = _sim(engine="bh", strategy="bh", n=n, capacity=1024, seed=0,
               opts=opts)
    w = dist.get_world_size()
    calls = {}

    def count(kind, nbytes):
        c = calls.setdefault(kind, {"bytes": 0, "calls": 0})
        c["bytes"] += nbytes
        c["calls"] += 1

    size = lambda t: t.numel() * t.element_size()
    spies = {
        "all_gather_into_tensor": lambda out, x, **k: count(
            "all_gather", size(x) * (w - 1)),
        "all_reduce": lambda x, **k: count("psum",
                                           2 * size(x) * (w - 1) // w),
        "reduce_scatter_tensor": lambda out, x, **k: count(
            "psum_scatter", size(out) * (w - 1)),
        "batch_isend_irecv": lambda ops: count("ring_shift", sum(
            size(o.tensor) for o in ops if o.op is dist.isend)),
    }
    originals = {k: getattr(dist, k) for k in spies}

    def spy(name):
        def call(*a, **k):
            spies[name](*a, **k)
            return originals[name](*a, **k)
        return call

    out = {}
    profiling.SPANS.clear()
    work.reset_tally()
    sim.run(1)
    out["off"] = (len(profiling.RECORDS), dict(work.SENT))
    for k in spies:
        setattr(dist, k, spy(k))
    profiling.SPANS.enable()
    try:
        sim.run(1)
    finally:
        profiling.SPANS.disable()
        for k, f in originals.items():
            setattr(dist, k, f)
    out["records"] = profiling.SPANS.resolve()
    out["sent"] = {k: dict(v) for k, v in work.SENT.items()}
    out["calls"] = calls
    profiling.SPANS.clear()
    work.reset_tally()
    return out


def octree_sharded(n=500, capacity=1024, seed=2, level=4, **refine):
    """The replicated tree of build_octree_sharded (rank 0's copy)."""
    from nbody_tpu_torch.ops.tree import build_octree_sharded
    from nbody_tpu_torch.parallel import collectives as coll
    from nbody_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(device="cpu")
    st, p = _state(n, capacity, seed)
    m = st.effective_mass()
    pos_l, m_l = _my(st.pos, mesh), _my(m, mesh)
    t = build_octree_sharded(pos_l, m_l, coll.all_gather(pos_l, mesh),
                             coll.all_gather(m_l, mesh), p.bounds, level,
                             mesh, quad=True, **refine)
    out = {k: getattr(t, k).numpy()
           for k in ("order", "code_s", "leaf_starts", "pos_s", "all_quad")}
    out["level_table"] = [x.numpy() for x in t.level_table]
    if refine:
        out["refine_tables"] = [x.numpy() for x in t.refine_tables]
        out["refine_slot_leaf"] = t.refine_slot_leaf.numpy()
        out["refine_stats"] = t.refine_stats.numpy()
    return out


def surface():
    """ShardedSimulation's surface (tests/test_sharded.py's cases): settings
    and reset, add/remove, the pickle round trip, aux, the bh presets."""
    import tempfile

    from nbody_tpu_torch.ops.traversal import BHConfig, DENSE_OVERRIDES

    out = {}
    sim = _sim(n=300, seed=1, capacity=None)
    sim.run(3)
    out["ran"] = sim.elapsed
    sim.set_settings(dt=1e-3)
    sim.step()
    out["dt"] = sim.settings.dt
    sim.reset()
    out["reset"] = (sim.elapsed, sim.n_alive)

    sim = _sim(n=100, seed=5, capacity=256)
    n0 = sim.n_alive
    sim.add_point([0.5, 0.5, 0.0], [0.0, 0.0, 0.0], 1e-3)
    pts = sim.get_points()
    out["added"] = (n0, sim.n_alive, pts[0][-1].tolist(), float(pts[3][-1]))
    sim.remove_point(0)
    out["removed"] = (sim.n_alive, sim.get_points()[0][0].tolist())
    sim.run(2)
    out["after"] = (sim.elapsed, sim.state.pos.shape[0])

    sim = _sim(n=200, seed=6, capacity=None)
    sim.run(3)
    want, t = sim.get_points()[0], sim.elapsed
    d = os.environ.get("SHARED_TMP") or tempfile.gettempdir()
    path = os.path.join(d, "ck.pkl")
    sim.save(path, format="pickle")
    sim.run(4)
    sim.load(path, format="pickle")
    out["roundtrip"] = (np.array_equal(sim.get_points()[0], want),
                        sim.elapsed == t, path)
    sim.run(1)
    # the default format: a torch.distributed.checkpoint directory
    want, t = sim.get_points()[0], sim.elapsed
    sim.save(path + ".dcp")
    sim.run(4)
    sim.load(path + ".dcp")
    out["orbax"] = (np.array_equal(sim.get_points()[0], want),
                    sim.elapsed == t, os.path.isdir(path + ".dcp"))

    opts = dict(max_level=4, group_size=128, subgroups=8, window_pad=32,
                near_particle_cap=512, near_cell_cap=256, start_level=1)
    sim = _sim(engine="bh", n=300, seed=7, capacity=1024, opts=opts)
    aux = sim.aux()
    out["aux"] = {"boxes": [b[:2] for b in aux["tree_boxes"]],
                  "counts": [b[2] for b in aux["tree_boxes"]],
                  **{k: v for k, v in aux.items() if k != "tree_boxes"}}

    f32 = dict(dtype=torch.float32, capacity=None)
    sim = _sim(engine="bh", n=2000, seed=3, **f32)
    out["auto"] = dataclasses.asdict(sim._bh_config)
    sim.run(2)
    out["auto_finite"] = bool(np.isfinite(sim.get_points()[0]).all())
    out["accurate_pad"] = _sim(engine="bh", n=2000, seed=3,
                               opts=dict(profile="accurate"),
                               **f32)._bh_config.window_pad
    dense = [_sim(engine="bh", n=2000, seed=3, opts=o, **f32)._bh_config
             for o in (dict(profile="dense"),
                       dict(profile="dense", group_size=128, subgroups=8,
                            chunk_groups=1, window_pad=64, start_level=1))]
    out["dense"] = [{k: getattr(c, k) for k in DENSE_OVERRIDES}
                    for c in dense]
    errors = {}
    for label, kw in (("brute-bh", dict(engine="brute", strategy="bh")),
                      ("adaptive-ring",
                       dict(engine="bh", strategy="ring",
                            opts=dict(profile="adaptive"))),
                      ("lazy", dict(engine="bh-lazy"))):
        try:
            _sim(n=2000, seed=3, **f32, **kw)
        except (ValueError, NotImplementedError) as e:
            errors[label] = (type(e).__name__, str(e))
    out["errors"] = errors
    sim = _sim(engine="bh", n=2000, seed=3, opts=dict(profile="adaptive"),
               **f32)
    out["adaptive_domain"] = (sim.strategy,
                              dataclasses.asdict(sim._bh_config))
    return out


def dcp_save(path, n=200, seed=6):
    """A ShardedSimulation saved to the directory ``path`` (the default
    format), run 4 steps and loaded back: the points and time it saved,
    whether the load gave them back bitwise, and whether it steps on."""
    sim = _sim(n=n, seed=seed, capacity=None)
    sim.run(3)
    pts, t = sim.get_points()[0], sim.elapsed
    sim.save(path)
    sim.run(4)
    sim.load(path)
    back = (np.array_equal(sim.get_points()[0], pts), sim.elapsed == t)
    sim.run(1)
    return {"pos": pts, "elapsed": t, "back": back,
            "steps_on": bool(np.isfinite(sim.get_points()[0]).all())
            and sim.elapsed > t}


def dcp_load(path, n=200, seed=9):
    """A ShardedSimulation of another scene loaded from the directory
    ``path`` (written at another world size): its points, time, and one
    more step."""
    sim = _sim(n=n, seed=seed, capacity=None)
    sim.load(path)
    out = {"pos": sim.get_points()[0], "elapsed": sim.elapsed,
           "capacity": sim.state.capacity}
    sim.run(1)
    out["steps_on"] = (bool(np.isfinite(sim.get_points()[0]).all())
                       and sim.elapsed > out["elapsed"])
    return out


def cli(argv):
    """The CLI's printed lines on this rank and its result."""
    from nbody_tpu_torch import cli as tcli

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        res = tcli.main(argv)
    return {"stdout": buf.getvalue(), "result": res}


def main(spec_path: str, rank: int):
    import torch.distributed as dist

    torch.set_num_threads(1)
    with open(spec_path, "rb") as f:
        spec = pickle.load(f)
    dist.init_process_group("gloo", init_method=f"file://{spec['store']}",
                            rank=rank, world_size=spec["world"],
                            timeout=GROUP_TIMEOUT)
    os.environ["SHARED_TMP"] = os.path.dirname(spec_path)
    try:
        out = {name: globals()[fn](**kw) for name, fn, kw in spec["cases"]}
    finally:
        dist.destroy_process_group()
    tmp = os.path.dirname(spec_path)
    with open(os.path.join(tmp, f"result{spec['world']}_{rank}.pkl"),
              "wb") as f:
        pickle.dump(out, f)


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]))
