"""The port's domain decomposition (``nbody_tpu_torch/parallel/domain.py``)
against the JAX package's ``nbody_tpu/parallel/domain.py`` on the CPU.

The port runs in 4 spawned gloo ranks (``tests/torch_dist_workers.py``, one
spawn for the module); the JAX side here under ``shard_map`` on 4 of
``tests/conftest.py``'s virtual devices.  With 4 ranks, ranks 1 and 2 have
halos on both sides.  Inputs follow tests/test_domain.py.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import torch_dist_workers as workers
from torch_parity import one_intra_op_thread  # noqa: F401  (autouse)
from nbody_tpu.core.state import ParticleState as JaxState
from nbody_tpu.core.state import SimParams as JaxParams
from nbody_tpu.ops.traversal import BHConfig as JaxBHConfig
from nbody_tpu.parallel import domain as jdomain
from nbody_tpu.parallel.mesh import PARTICLE_AXIS, make_mesh
from nbody_tpu.scenes import self_gravitating_disc
from nbody_tpu_torch.ops import tree as ttree
from nbody_tpu_torch.ops.traversal import BHConfig
from nbody_tpu_torch.parallel import ShardedSimulation
from nbody_tpu_torch.parallel.domain import domain_accel

AXIS = PARTICLE_AXIS
WORLD = 4
# tests/test_domain.py's small config: the 128 + 2 * 32 window fits the
# 512-row shards of capacity 2048
SMALL = dict(max_level=4, group_size=128, subgroups=8, window_pad=32,
             accept_cap=1024, near_cell_cap=512, near_particle_cap=512,
             far_particle_cap=256, far_cell_cap=128, start_level=1,
             chunk_groups=1)
# the seam case: every rank's shard full of alive rows and a halo of one
# group, so leaf cells Morton-far from a group's slice reach the far list
SEAM = dict(SMALL, window_pad=0)
TREES = {"alive": dict(n=1000, capacity=1024, seed=2, level=4, halo=64),
         "dead": dict(n=400, capacity=2048, seed=3, level=4, halo=64,
                      kill=(5, 105))}
ACCELS = {"alive": dict(cfg=SMALL, n=500, capacity=2048, seed=0),
          "dead": dict(cfg=SMALL, n=400, capacity=2048, seed=3,
                       kill=(5, 105)),
          "seam": dict(cfg=SEAM, n=1000, capacity=1024, seed=0)}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    cases = [("route", "ring_route", {}), ("gather", "dist_gather", {})]
    cases += [(f"tree_{k}", "domain_tree", kw) for k, kw in TREES.items()]
    cases += [(f"accel_{k}", "domain_accel", kw) for k, kw in ACCELS.items()]
    return workers.spawn(WORLD, tmp_path_factory.mktemp("domain"), cases)


def _jax_state(n, capacity, seed, kill=None, **_kw):
    pos, vel, mass = self_gravitating_disc(n, seed=seed)
    st = JaxState.create(pos, vel, mass, capacity=capacity, dtype=jnp.float64)
    if kill:
        st = dataclasses.replace(
            st, alive=st.alive.at[kill[0]:kill[1]].set(False))
    params = JaxParams.create(dtype=jnp.float64, **workers.COMMON)
    return st, params


def _shard_map(body, out_specs, *arrays):
    sm = jax.shard_map(body, mesh=make_mesh(WORLD),
                       in_specs=tuple(P(AXIS) for _ in arrays),
                       out_specs=out_specs, check_vma=False)
    return jax.jit(sm)(*arrays)


def test_ring_route_and_dist_gather_match_local_gathers(ranks):
    """Rows delivered to arbitrary global slots, and rows fetched at
    arbitrary global indices, across 4 ranks (tests/test_domain.py:44-75)."""
    rng = np.random.default_rng(0)
    rows = rng.standard_normal((256, 4)).astype(np.float32)
    want = np.zeros_like(rows)
    want[rng.permutation(256)] = rows
    np.testing.assert_array_equal(
        np.concatenate([r["route"] for r in ranks]), want)
    rng = np.random.default_rng(1)
    rows = rng.standard_normal((256, 4)).astype(np.float32)
    idx = rng.integers(0, 256, (WORLD * 64,))
    np.testing.assert_array_equal(
        np.concatenate([r["gather"] for r in ranks]), rows[idx])


@pytest.mark.parametrize("case", list(TREES))
def test_domain_tree_matches_jax_and_build_octree(ranks, case):
    """The routed sorted permutation and codes, the halo slabs and the leaf
    ranges exactly the JAX package's build_domain_tree and the port's
    single-chip build_octree; leaf mass and COM to 1e-12."""
    kw = TREES[case]
    st, params = _jax_state(**kw)
    m = st.effective_mass()
    level, halo = kw["level"], kw["halo"]

    def body(p_loc, m_loc):
        t = jdomain.build_domain_tree(p_loc, m_loc, params.bounds, level,
                                      AXIS, WORLD, halo)
        return t.rows_s, t.ext8, t.level_table[level]

    j_rows, j_ext, j_leaf = _shard_map(body, (P(AXIS), P(AXIS), P()),
                                       st.pos, m)
    rows = np.concatenate([r[f"tree_{case}"]["rows_s"] for r in ranks])
    ext = np.concatenate([r[f"tree_{case}"]["ext8"] for r in ranks])
    np.testing.assert_array_equal(rows, np.asarray(j_rows))
    np.testing.assert_array_equal(ext, np.asarray(j_ext))
    tst, tp = workers._state(kw["n"], kw["capacity"], kw["seed"],
                             kw.get("kill"))
    ref = ttree.build_octree(tst.pos, tst.effective_mass(), tp.bounds, level)
    np.testing.assert_array_equal(rows[:, 4].astype(np.int64),
                                  ref.order.numpy())
    np.testing.assert_array_equal(rows[:, 5].astype(np.int64),
                                  ref.code_s.numpy())
    j_leaf = np.asarray(j_leaf)
    for r in ranks:
        leaf = r[f"tree_{case}"]["leaf"]
        np.testing.assert_array_equal(leaf[:, 4:], j_leaf[:, 4:])
        np.testing.assert_array_equal(leaf[:, 4:],
                                      ref.level_table[level][:, 4:].numpy())
        np.testing.assert_allclose(leaf[:, 0], j_leaf[:, 0], rtol=1e-12,
                                   atol=1e-14)
        occ = leaf[:, 0] > 0
        com = leaf[occ, 1:4] / leaf[occ, :1]
        np.testing.assert_allclose(com, j_leaf[occ, 1:4] / j_leaf[occ, :1],
                                   rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("case", list(ACCELS))
def test_domain_accel_matches_jax(ranks, case, monkeypatch):
    """domain_accel on 4 ranks against the JAX package's: forces to
    rtol 1e-9 / atol 1e-12 on alive rows, and per rank the walk's
    fallbacks and spills, the near and the far totals exactly (the seam
    case fetches far rows by request/reply)."""
    kw = ACCELS[case]
    st, params = _jax_state(**kw)
    m = st.effective_mass()
    far = []
    orig = jdomain._expand_ranges

    def spy(*a, **k):  # the second call of a trace expands the far list
        out = orig(*a, **k)
        far.append(out[2])
        return out

    monkeypatch.setattr(jdomain, "_expand_ranges", spy)

    def body(p_loc, m_loc):
        far.clear()
        acc, s = jdomain.domain_accel(p_loc, m_loc, params.bounds,
                                      params.theta2, params.g, params.g_soft,
                                      JaxBHConfig(**kw["cfg"]), AXIS, WORLD)
        counts = jnp.stack([s["accept_dropped"], s["frontier_fallback"],
                            s["near_fallback"], s["fb_spill"]])
        return acc, counts[None], s["near_totals"], far[1]

    acc, counts, ntot, ftot = _shard_map(body, (P(AXIS),) * 4, st.pos, m)
    counts, ntot, ftot = (np.asarray(x) for x in (counts, ntot, ftot))
    G = ntot.shape[0] // WORLD
    got = [r[f"accel_{case}"] for r in ranks]
    for k, r in enumerate(got):
        assert [int(r[n]) for n in ("accept_dropped", "frontier_fallback",
                                    "near_fallback", "fb_spill")] \
            == counts[k].tolist()
        np.testing.assert_array_equal(r["near_totals"],
                                      ntot[k * G:(k + 1) * G])
        np.testing.assert_array_equal(r["far_totals"],
                                      ftot[k * G:(k + 1) * G])
    if case == "seam":
        assert sum(int(r["far_totals"].sum()) for r in got) > 0
    alive = np.asarray(m) > 0
    np.testing.assert_allclose(
        np.concatenate([r["acc"] for r in got])[alive],
        np.asarray(acc)[alive], rtol=1e-9, atol=1e-12)


def test_adaptive_on_the_domain_strategy_is_refused():
    """profile='adaptive' or refine_levels on strategy 'bh' (the domain)
    raise naming ROADMAP item 17e; the replicated strategy carries
    refine_levels, and domain_accel refuses a refined config itself."""
    pos, vel, mass = self_gravitating_disc(2000, seed=3)
    kw = dict(engine="bh", n_devices=1, device="cpu", **workers.COMMON)
    for opts in (dict(profile="adaptive"), dict(refine_levels=1)):
        with pytest.raises(NotImplementedError, match="item 17e"):
            ShardedSimulation(pos, vel, mass, engine_options=opts, **kw)
    sim = ShardedSimulation(pos, vel, mass, strategy="bh-replicated",
                            engine_options=dict(refine_levels=1), **kw)
    assert sim._bh_config.refine_levels == 1
    st = sim.state
    with pytest.raises(NotImplementedError, match="item 17e"):
        domain_accel(st.pos, st.effective_mass(), sim.settings.bounds, 1.0,
                     1.0, 0.02, BHConfig(refine_levels=1), sim.mesh)


def test_window_pad_beyond_the_shard_raises():
    pos, vel, mass = self_gravitating_disc(100, seed=0)
    sim = ShardedSimulation(pos, vel, mass, engine="bh", n_devices=1,
                            device="cpu", engine_options=dict(
                                SMALL, window_pad=256), **workers.COMMON)
    st = sim.state
    with pytest.raises(ValueError, match="exceeds the per-chip shard"):
        domain_accel(st.pos[:128], st.effective_mass()[:128],
                     sim.settings.bounds, 1.0, 1.0, 0.02,
                     BHConfig(**dict(SMALL, window_pad=256)), sim.mesh)
    assert torch.isfinite(sim.state.pos).all()
