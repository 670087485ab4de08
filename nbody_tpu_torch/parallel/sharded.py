"""Multi-rank particle sharding: the step loop over ``torch.distributed``
(the counterpart of ``nbody_tpu/parallel/sharded.py``).

Each rank is one process holding its contiguous shard of the particle
arrays; the step (half drift, cull, force, kick and half drift) runs on the
shard, and only the force exchanges data.  Strategies:

  * ``allgather``: the positions and masses gathered once a step, each
    rank's rows summed against all of them;
  * ``ring``: the source shards passed around the ring, ``world`` hops,
    each adding its partial sums (O(N / world) memory);
  * ``bh``: Barnes-Hut over the Morton-range domain decomposition
    (``parallel/domain.py``), O(N / world + halo) a rank;
  * ``bh-replicated``: Barnes-Hut over the replicated tree of
    ``build_octree_sharded``, each rank walking its slice of the groups.

The direct sums on the card are kernel K2 (``ops/pairwise.py``
``pairwise_acc_targets``): a self or coincident pair adds exactly 0 there,
which is the JAX package's self-pair rule by global id (a test holds the
two equal, at eps = 0 with coincident points too).  On the CPU they are
the JAX package's id-masked tiled sum, the port's ``engines/brute_force.py``
contraction.  The Barnes-Hut strategies run K3 and K4 on the card.
"""

from __future__ import annotations

import dataclasses
import os
import pickle
from typing import Optional

import numpy as np
import torch

from nbody_tpu_torch.api import _check_format
from nbody_tpu_torch.core.state import ParticleState, SimParams
from nbody_tpu_torch.core.stepper import make_run, make_step
from nbody_tpu_torch.engines.brute_force import _accumulate, _pairwise_s
from nbody_tpu_torch.ops import pairwise as pw
from nbody_tpu_torch.ops.traversal import (
    DENSE_OVERRIDES,
    DOMAIN_MIN_N,
    DOMAIN_OVERRIDES,
    BHConfig,
    fit_chunks,
    resolve_adaptive_overrides,
    traverse_tree,
)
from nbody_tpu_torch.ops.tree import build_octree_sharded
from nbody_tpu_torch.parallel import collectives as coll
from nbody_tpu_torch.parallel.domain import domain_accel
from nbody_tpu_torch.parallel.mesh import PARTICLE_AXIS, make_mesh
from nbody_tpu_torch.utils import checkpoint

#: the per-particle arrays a checkpoint directory holds sharded
_SHARDED = frozenset(f"state.{k}" for k in ("pos", "vel", "acc", "mass",
                                            "alive"))

def _local_rows_vs_sources(pos_rows, row_ids, pos_src, mass_src, src_ids,
                           params: SimParams, tile: int = 1024):
    """Acceleration of ``pos_rows`` by (``pos_src``, ``mass_src``), the
    diagonal masked by global ids (``sharded.py:37``).  CUDA tensors go to
    K2, whose d = 0 rule drops the same self pairs; CPU tensors take the
    JAX package's id-masked sum over row tiles."""
    if pos_rows.is_cuda:
        return pw.pairwise_acc_targets(pos_rows, pos_src, mass_src, params.g,
                                       params.g_soft)
    n = pos_rows.shape[0]
    t = tile if n % tile == 0 else (128 if n % 128 == 0 else n)
    return torch.cat([
        _accumulate(_pairwise_s(pos_rows[s:s + t], pos_src, mass_src,
                                params.eps2, row_ids[s:s + t], src_ids),
                    pos_src, pos_rows[s:s + t], params.g)
        for s in range(0, n, t)])


def _ids(owner: int, n: int, device):
    """The global ids of rank ``owner``'s shard of ``n`` rows."""
    return owner * n + torch.arange(n, device=device)


def bh_profile(strategy: str, n_dev: int, n: int) -> str:
    """The ``BHConfig.auto_for`` profile a ``bh`` engine takes on ``n_dev``
    ranks holding ``n`` rows when the caller names none: 'domain' on the
    domain route (every strategy but 'bh-replicated') over several ranks
    from ``DOMAIN_MIN_N`` rows, where the wide rows begin and the JAX
    package's tiers leave ``bh``'s envelope on the disc (a port
    divergence); 'fast' otherwise."""
    domain = strategy != "bh-replicated" and n_dev > 1 and n >= DOMAIN_MIN_N
    return "domain" if domain else "fast"


def make_sharded_force(mesh, strategy: str = "allgather", tile: int = 1024,
                       bh_config: BHConfig = None):
    """``force(pos, mass_eff, params) -> acc`` on this rank's shard for a
    strategy (``sharded.py:85-177``)."""
    my, n_dev = mesh.rank, mesh.world
    cfg = bh_config or BHConfig()

    def allgather(pos, mass, params):
        n = pos.shape[0]
        pos_all = coll.all_gather(pos, mesh)
        mass_all = coll.all_gather(mass, mesh)
        return _local_rows_vs_sources(
            pos, _ids(my, n, pos.device), pos_all, mass_all,
            torch.arange(n_dev * n, device=pos.device), params, tile)

    def ring(pos, mass, params):
        n = pos.shape[0]
        rows = _ids(my, n, pos.device)
        acc = torch.zeros_like(pos)
        src_pos, src_mass = pos, mass
        for k in range(n_dev):
            owner = (my - k) % n_dev
            acc = acc + _local_rows_vs_sources(
                pos, rows, src_pos, src_mass,
                _ids(owner, n, pos.device), params, tile)
            if k < n_dev - 1:
                src_pos, src_mass = coll.ring_shift([src_pos, src_mass], mesh)
        return acc

    def bh(pos, mass, params):
        acc, _stats = domain_accel(pos, mass, params.bounds, params.theta2,
                                   params.g, params.g_soft, cfg, mesh)
        return acc

    def bh_replicated(pos, mass, params):
        # grid frame before the gather (the build's f32 sums stay bounded
        # by the half-width)
        b0 = params.bounds.centered()
        pos_c = pos - params.bounds.center
        pos_all = coll.all_gather(pos_c, mesh)
        mass_all = coll.all_gather(mass, mesh)
        n_tot, n = pos_all.shape[0], pos.shape[0]
        c = cfg
        cg_fit = fit_chunks(c.chunk_groups, n_tot // c.group_size, n_dev)
        if cg_fit != c.chunk_groups:
            c = dataclasses.replace(c, chunk_groups=cg_fit)
        tree = build_octree_sharded(
            pos_c, mass, pos_all, mass_all, b0, c.max_level, mesh, dim=c.dim,
            quad=c.multipole == "quad", quad_leaf=c.quad_leaf,
            refine_levels=c.refine_levels, refine_cap=c.refine_cap,
            refine_threshold=c.refine_threshold_resolved)
        n_chunks = n_tot // (c.group_size * c.chunk_groups)
        acc_slice, _stats = traverse_tree(
            tree, b0, params.theta2, params.g, params.g_soft, c, n_tot,
            chunk_range=(my * (n_chunks // n_dev),), n_shards=n_dev)
        # gather the sorted slices and un-permute by sorting on the order
        acc_sorted = coll.all_gather(acc_slice, mesh)
        acc_full = acc_sorted[torch.argsort(tree.order)]
        return acc_full[my * n:(my + 1) * n, :pos.shape[1]]

    forces = {"allgather": allgather, "ring": ring, "bh": bh,
              "bh-replicated": bh_replicated}
    if strategy not in forces:
        raise ValueError(f"unknown strategy {strategy!r}")
    return forces[strategy]


def make_sharded_step(mesh, integrator="leapfrog", strategy="allgather",
                      tile=1024, bh_config=None):
    """``step(state, params, dt=None) -> state`` on this rank's shard
    (``sharded.py:54``): the single-chip step sequence around the
    strategy's force."""
    return make_step(make_sharded_force(mesh, strategy, tile, bh_config),
                     integrator)


def make_sharded_run(mesh, integrator="leapfrog", strategy="allgather",
                     tile=1024, bh_config=None):
    """``run(state, params, n_steps, dt=None) -> state``: ``n_steps``
    sharded steps enqueued back to back."""
    return make_run(make_sharded_force(mesh, strategy, tile, bh_config),
                    integrator)


def make_sharded_energy(mesh, tile: int = 1024):
    """``energy(state, params) -> 0-d tensor``, the total energy over the
    mesh (``sharded.py:229``): the kinetic energy a local sum, the softened
    pair potential streamed around the ring with each unordered pair
    counted once by global-id order, merged by ``psum``.  Plain torch on
    either device, as JAX computes it outside any kernel."""
    my, n_dev = mesh.rank, mesh.world

    def energy(state: ParticleState, params: SimParams):
        n = state.pos.shape[0]
        dev = state.pos.device
        m = torch.where(state.alive, state.mass, torch.zeros_like(state.mass))
        ke = 0.5 * (m * (state.vel * state.vel).sum(dim=-1)).sum()
        eps2 = params.eps2
        rows = _ids(my, n, dev)
        t = tile if n % tile == 0 else (128 if n % 128 == 0 else n)

        def pe_vs(src_pos, src_m, src_ids):
            parts = []
            for s in range(0, n, t):
                d = state.pos[s:s + t, None, :] - src_pos[None, :, :]
                r2 = (d * d).sum(dim=-1) + eps2
                take = (src_ids[None, :] > rows[s:s + t, None]) & (r2 > 0.0)
                inv_r = torch.rsqrt(torch.where(take, r2, 1.0))
                pm = m[s:s + t, None] * src_m[None, :]
                parts.append(-params.g * torch.where(take, pm * inv_r,
                                                     0.0).sum())
            return torch.stack(parts).sum()

        pe = torch.zeros((), dtype=state.pos.dtype, device=dev)
        src_pos, src_m = state.pos, m
        for k in range(n_dev):
            pe = pe + pe_vs(src_pos, src_m, _ids((my - k) % n_dev, n,
                                                 dev))
            if k < n_dev - 1:
                src_pos, src_m = coll.ring_shift([src_pos, src_m], mesh)
        return coll.psum(ke + pe, mesh)

    return energy


def _shard(a, mesh, device):
    """This rank's contiguous block of a host array [cap, ...]."""
    n = a.shape[0] // mesh.world
    return a[mesh.rank * n:(mesh.rank + 1) * n].to(device)


class ShardedSimulation:
    """Multi-rank counterpart of ``Simulation`` (``sharded.py:290``): the
    same surface, the particle arrays sharded over the ranks of the process
    group.  Every rank constructs it with the same global arrays and calls
    the same methods (each may run a collective); ``state`` is this rank's
    shard.

    ``n_devices`` must be the group's world size (None: whatever it is);
    with no group initialized, 1 or None makes a one-rank group.
    ``device="cuda"`` puts each rank's shard on ``cuda:{local rank}``.
    ``engine_options`` holds ``BHConfig``'s fields and ``profile``; the
    domain route's default profile is ``bh_profile``'s."""

    def __init__(self, pos, vel, mass, *, engine: str = "brute",
                 integrator: str = "leapfrog",
                 n_devices: Optional[int] = None,
                 strategy: str = "allgather", bounds_center=(0.0, 0.0, 0.0),
                 bounds_width: float = 10.0, dtype=torch.float32,
                 capacity: Optional[int] = None, device="cuda",
                 engine_options: Optional[dict] = None, **settings):
        self.mesh = make_mesh(n_devices, device)
        n_dev = self.mesh.shape[PARTICLE_AXIS]

        bh_config = None
        if engine == "bh-lazy":
            raise NotImplementedError(
                "sharded bh-lazy is not supported; use engine='bh' "
                "(full rebuild each step) on the mesh")
        if engine in ("bh", "bh-deep"):
            opts = dict(engine_options or {})
            profile = opts.pop("profile", None) or bh_profile(
                strategy, n_dev, max(len(mass), capacity or 0))
            adaptive = bool(profile == "adaptive"
                            or opts.get("refine_levels"))
            if (profile == "adaptive"
                    and not any(k in opts
                                for k in ("max_level", "refine_levels"))):
                opts.update(resolve_adaptive_overrides(
                    pos, bounds_center, bounds_width))
            if adaptive and strategy not in ("bh", "bh-replicated",
                                             "allgather"):
                raise ValueError(
                    f"strategy {strategy!r} has no density-adaptive route; "
                    "use strategy='bh' (domain) or 'bh-replicated'")
            if not any(k in opts
                       for k in ("group_size", "subgroups", "chunk_groups")):
                bh_config = BHConfig.auto_for(-(-len(mass) // n_dev),
                                              profile=profile, **opts)
            else:
                if profile == "accurate":
                    opts.setdefault("window_pad", 2048)
                elif profile in ("dense", "domain"):
                    stack = (DENSE_OVERRIDES if profile == "dense"
                             else DOMAIN_OVERRIDES)
                    for k, v in stack.items():
                        opts.setdefault(k, v)
                bh_config = BHConfig(**opts)
            if strategy not in ("bh", "bh-replicated"):
                strategy = "bh"
            pad_multiple = (bh_config.group_size * bh_config.chunk_groups
                            * n_dev)
        elif engine in ("brute", "brute-pallas"):
            if strategy not in ("allgather", "ring"):
                raise ValueError(
                    f"strategy {strategy!r} requires engine='bh'/'bh-deep'; "
                    f"brute engines take 'allgather' or 'ring'")
            pad_multiple = 128 * n_dev
        else:
            raise NotImplementedError(f"sharded engine {engine!r}")

        full = ParticleState.create(pos, vel, mass, capacity=capacity,
                                    pad_multiple=pad_multiple, dtype=dtype,
                                    device="cpu")
        if full.capacity % n_dev:
            raise ValueError(f"capacity {full.capacity} does not split over "
                             f"{n_dev} ranks")
        self._state = self._take_shard(full)
        self._params = SimParams.create(
            bounds_center=bounds_center, bounds_width=bounds_width,
            dtype=dtype, device=self.mesh.device, **settings)
        self._engine_name = engine
        self._engine_options = engine_options
        self._bh_config = bh_config
        self.strategy = strategy
        self._energy = None
        self._step = make_sharded_step(self.mesh, integrator, strategy,
                                       bh_config=bh_config)
        self._run = make_sharded_run(self.mesh, integrator, strategy,
                                     bh_config=bh_config)
        self._initial = self._state

    def _take_shard(self, full: ParticleState) -> ParticleState:
        dev = self.mesh.device
        return ParticleState(
            pos=_shard(full.pos, self.mesh, dev),
            vel=_shard(full.vel, self.mesh, dev),
            acc=_shard(full.acc, self.mesh, dev),
            mass=_shard(full.mass, self.mesh, dev),
            alive=_shard(full.alive, self.mesh, dev),
            time=full.time.to(dev))

    def _gathered(self) -> ParticleState:
        """The whole state on every rank (a collective)."""
        st = self._state
        g = lambda t: coll.all_gather(t, self.mesh)
        return ParticleState(pos=g(st.pos), vel=g(st.vel), acc=g(st.acc),
                             mass=g(st.mass), alive=g(st.alive),
                             time=st.time)

    # -- lifecycle and stepping ---------------------------------------------

    def init(self):
        self._state = dataclasses.replace(
            self._state, time=torch.zeros_like(self._state.time))
        self._initial = self._state

    def reset(self):
        self._state = self._initial

    def step(self):
        self._state = self._step(self._state, self._params)

    def step_by(self, dt):
        self._state = self._step(self._state, self._params, dt)

    def run(self, n_steps: int, dt=None):
        self._state = self._run(self._state, self._params, n_steps, dt)
        return self._state

    def compile(self, n_steps: int, dt=None):
        """Take the one-time costs (the kernels' build and load, the
        allocator's warm-up) out of a later timed window: one step of the
        configured strategy executed and thrown away, as
        ``Simulation.compile`` does (eager torch has nothing to lower).
        Returns ``self``."""
        self._step(self._state, self._params, dt)
        self.block_until_ready()
        return self

    def block_until_ready(self):
        if self.mesh.device.type == "cuda":
            torch.cuda.synchronize(self.mesh.device)
        return self

    # -- state and settings --------------------------------------------------

    @property
    def state(self) -> ParticleState:
        """This rank's shard."""
        return self._state

    @property
    def settings(self) -> SimParams:
        return self._params

    def set_settings(self, **kw):
        self._params = self._params.replace(**kw)
        return self

    @property
    def n_alive(self) -> int:
        return int(coll.psum(self._state.n_alive(), self.mesh))

    @property
    def elapsed(self) -> float:
        return float(self._state.time)

    def get_points(self):
        """(pos, vel, acc, mass) of the alive particles of every rank, in
        global order, as numpy arrays (a collective)."""
        return self._gathered().get_points()

    def energy(self, method: str = "auto") -> float:
        """The exact total energy over the mesh (``make_sharded_energy``):
        'auto' resolves to 'exact' here, as in the JAX package."""
        if method not in ("auto", "exact"):
            raise ValueError(
                f"sharded energy is exact-only, got method={method!r}")
        if self._energy is None:
            self._energy = make_sharded_energy(self.mesh)
        return float(self._energy(self._state, self._params))

    def energy_method(self, method: str = "auto") -> str:
        return "exact"

    # -- particles (each a collective; the owner rank writes) ----------------

    def _global_alive(self) -> np.ndarray:
        return coll.all_gather(self._state.alive, self.mesh).cpu().numpy()

    def _write(self, i: int, **values):
        """Set global slot ``i`` of the named arrays on its owner rank."""
        n = self._state.capacity
        if i // n != self.mesh.rank:
            return
        st = self._state
        out = {}
        for k, v in values.items():
            a = getattr(st, k).clone()
            a[i % n] = torch.as_tensor(v, dtype=a.dtype)
            out[k] = a
        self._state = dataclasses.replace(st, **out)

    def add_point(self, pos, vel, mass):
        """Occupy the first dead slot of the whole mesh."""
        free = np.nonzero(~self._global_alive())[0]
        if len(free) == 0:
            raise ValueError("state is at capacity; rebuild with a larger "
                             "capacity to add points")
        self._write(int(free[0]), pos=pos, vel=vel, acc=0.0, mass=mass,
                    alive=True)
        return self

    def remove_point(self, index: int):
        """Kill the index-th alive particle of the whole mesh."""
        i = int(np.nonzero(self._global_alive())[0][index])
        self._write(i, alive=False, mass=0.0)
        return self

    # -- inspection ----------------------------------------------------------

    def aux(self) -> dict:
        """The engine's inspection data (tree boxes and walk counters of the
        bh engines) on the gathered state, computed on every rank."""
        from nbody_tpu_torch.engines import get_engine

        eng = get_engine(self._engine_name, **(self._engine_options or {}))
        if eng.aux is None:
            return {}
        st = self._gathered()
        return eng.aux(st.pos, st.effective_mass(), self._params)

    # -- checkpointing -------------------------------------------------------

    def save(self, path: str, format: str = "orbax"):
        """``format='orbax'``: every rank writes its shard into a
        ``torch.distributed.checkpoint`` directory (``utils/checkpoint.py``:
        the per-particle arrays as ``Shard(0)`` DTensors, the time and the
        params replicated), no gather.  ``format='pickle'``: rank 0 writes
        the gathered state as the JAX package's sharded pickle payload;
        every rank returns once it is written."""
        _check_format(format)
        if format == "orbax":
            st = self._state
            checkpoint.save(
                {"state": {f.name: getattr(st, f.name)
                           for f in dataclasses.fields(st)},
                 "params": self._params.to_numpy()},
                path, self.mesh, _SHARDED)
            return
        full = self._gathered()
        if self.mesh.rank == 0:
            with open(path, "wb") as f:
                pickle.dump({"state": full.to_numpy(),
                             "params": self._params.to_numpy()}, f)
        coll.psum(torch.zeros((), device=self.mesh.device), self.mesh)

    def load(self, path: str, format: str = "orbax"):
        """``format='orbax'``: every rank restores its shard of the current
        world size straight from the directory (a checkpoint of any world
        size whose capacity splits over this one).  ``format='pickle'``:
        every rank reads the pickle and takes its shard.  The restored
        point becomes the ``reset`` target."""
        _check_format(format)
        dev = self.mesh.device
        if format == "orbax":
            payload = checkpoint.load(path, self.mesh, _SHARDED)
            st = {k: v.to(dev) for k, v in payload["state"].items()}
            self._state = ParticleState(**st)
        else:
            with open(os.fspath(path), "rb") as f:
                payload = pickle.load(f)
            full = ParticleState.from_numpy(payload["state"], "cpu")
            if full.capacity % self.mesh.world:
                raise ValueError(f"capacity {full.capacity} does not split "
                                 f"over {self.mesh.world} ranks")
            self._state = self._take_shard(full)
        self._params = SimParams.from_numpy(
            {k: np.asarray(v) for k, v in payload["params"].items()}, dev)
        self._initial = self._state
        return self
