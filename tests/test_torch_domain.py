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

import torch_collect_emulator as emulator
import torch_dist_workers as workers
import torch_walk_cases as walk_cases
from torch_parity import one_intra_op_thread  # noqa: F401  (autouse)
from nbody_tpu.core.state import ParticleState as JaxState
from nbody_tpu.core.state import SimParams as JaxParams
from nbody_tpu.ops.traversal import BHConfig as JaxBHConfig
from nbody_tpu.parallel import domain as jdomain
from nbody_tpu.parallel.mesh import PARTICLE_AXIS, make_mesh
from nbody_tpu.scenes import self_gravitating_disc
from nbody_tpu_torch.ops import traversal as tt
from nbody_tpu_torch.ops import tree as ttree
from nbody_tpu_torch.ops.traversal import (
    DOMAIN_MIN_N,
    DOMAIN_OVERRIDES,
    BHConfig,
    bh_accel,
)
from nbody_tpu_torch.parallel import ShardedSimulation
from nbody_tpu_torch.parallel.sharded import bh_profile
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
# a refined stack on the full disc: leaf cells above 16 rows refine two
# levels, some refined ranges lie outside a rank's halo slab (the
# refined-far list) and one flagged cell straddles a rank boundary
REFINED = dict(SMALL, refine_levels=2, refine_cap=64, refine_threshold=16,
               refine_frontier=256, refine_near_cell_cap=256,
               refine_near_particle_cap=512, refine_far_cell_cap=64,
               refine_far_particle_cap=256)
# tests/test_domain.py's straddling-cell stack on its cluster scene
STRADDLE = dict(max_level=3, group_size=128, subgroups=8, window_pad=32,
                frontier_cap=512, accept_cap=512, near_cell_cap=256,
                near_particle_cap=512, far_cell_cap=64, far_particle_cap=256,
                start_level=1, chunk_groups=1, refine_levels=2,
                refine_cap=64, refine_threshold=64, refine_frontier=128,
                refine_near_cell_cap=128, refine_near_particle_cap=512,
                refine_far_cell_cap=64, refine_far_particle_cap=256)
# tests/test_domain.py's wide-format stacks (d-form eval), in float32
WIDE = dict(max_level=4, group_size=128, subgroups=8, window_pad=32,
            accept_cap=1024, near_cell_cap=512, near_particle_cap=512,
            far_particle_cap=256, far_cell_cap=128, start_level=1,
            chunk_groups=1, fb_cap=64, mxu_blocks=False)
WIDE_PRESSURE = dict(WIDE, accept_cap=64, near_cell_cap=16,
                     near_particle_cap=64, far_particle_cap=64,
                     far_cell_cap=16, fb_cap=256)
WIDE_RUNS = {"wide": dict(cfg=WIDE, n=700, capacity=2048, seed=1,
                          dtype="float32"),
             "pressure": dict(cfg=WIDE_PRESSURE, n=700, capacity=2048,
                              seed=2, dtype="float32")}
TREES = {"alive": dict(n=1000, capacity=1024, seed=2, level=4, halo=64),
         "dead": dict(n=400, capacity=2048, seed=3, level=4, halo=64,
                      kill=(5, 105))}
REFINED_TREE = dict(n=1000, capacity=1024, seed=2, level=4, halo=64,
                    refine_levels=2, refine_cap=64, refine_threshold=16)
# the 4095 + star disc at ShardedSimulation's own preset, narrow and with
# the wide rows forced on: its 8192 padded rows give each rank one group of
# 2048 and a window capped to the shard
DISC_ROWS = {"narrow": None, "wide": 1}
ACCELS = {"alive": dict(cfg=SMALL, n=500, capacity=2048, seed=0),
          "dead": dict(cfg=SMALL, n=400, capacity=2048, seed=3,
                       kill=(5, 105)),
          "seam": dict(cfg=SEAM, n=1000, capacity=1024, seed=0),
          "refined": dict(cfg=REFINED, n=1000, capacity=1024, seed=0),
          "straddle": dict(cfg=STRADDLE, n=1024, capacity=1024, seed=7,
                           scene="cluster")}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    cases = [("route", "ring_route", {}), ("gather", "dist_gather", {})]
    cases += [(f"tree_{k}", "domain_tree", kw) for k, kw in TREES.items()]
    cases.append(("tree_refined", "domain_tree", REFINED_TREE))
    cases += [(f"accel_{k}", "domain_accel", kw) for k, kw in ACCELS.items()]
    for k, kw in WIDE_RUNS.items():
        cases += [(f"narrow_{k}", "domain_accel", kw),
                  (f"wide_{k}", "domain_accel", dict(kw, wide_n=1))]
    cases += [(f"disc_{k}", "disc_force", dict(wide_n=w))
              for k, w in DISC_ROWS.items()]
    cases.append(("spans", "domain_spans", {}))
    return workers.spawn(WORLD, tmp_path_factory.mktemp("domain"), cases)


def _jax_state(n, capacity, seed, kill=None, scene="disc",
               dtype="float64", **_kw):
    if scene == "cluster":
        pos, vel, mass = workers.cluster_scene(n, seed=seed)
    else:
        pos, vel, mass = self_gravitating_disc(n, seed=seed)
    st = JaxState.create(pos, vel, mass, capacity=capacity,
                         dtype=getattr(jnp, dtype))
    if kill:
        st = dataclasses.replace(
            st, alive=st.alive.at[kill[0]:kill[1]].set(False))
    params = JaxParams.create(dtype=getattr(jnp, dtype),
                              **workers.SCENE_PARAMS[scene])
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


_REFINE_KEYS = ("refine_near_totals", "refine_far_totals")


def _jax_domain_accel(kw, monkeypatch):
    """The JAX package's domain_accel on the inputs of a worker case:
    (alive mask, acc, the four counters [WORLD, 4], near totals, far
    totals, and the refined totals and build drops where refined)."""
    st, params = _jax_state(**kw)
    m = st.effective_mass()
    cfg = JaxBHConfig(**kw["cfg"])
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
                                      cfg, AXIS, WORLD)
        counts = jnp.stack([s["accept_dropped"], s["frontier_fallback"],
                            s["near_fallback"], s["fb_spill"]])
        refined = ()
        if cfg.refine_levels:
            refined = (*(s[k] for k in _REFINE_KEYS),
                       s["refine_build_dropped"][None])
        return (acc, counts[None], s["near_totals"], far[1], *refined)

    n_out = 4 + (3 if cfg.refine_levels else 0)
    out = _shard_map(body, (P(AXIS),) * n_out, st.pos, m)
    return (np.asarray(m) > 0, *(np.asarray(x) for x in out))


@pytest.mark.parametrize("case", list(ACCELS))
def test_domain_accel_matches_jax(ranks, case, monkeypatch):
    """domain_accel on 4 ranks against the JAX package's: forces to
    rtol 1e-9 / atol 1e-12 on alive rows, and per rank the walk's
    fallbacks and spills, the near and the far totals exactly (the seam
    case fetches far rows by request/reply).  Refined stacks: the refined
    near and far totals a group and the build's drops exactly too; the
    refined-far list fires, and a flagged cell that straddles a rank
    boundary is left unrefined and counted (refine_build_dropped >= 1,
    tests/test_domain.py:506)."""
    alive, acc, counts, ntot, ftot, *refined = _jax_domain_accel(
        ACCELS[case], monkeypatch)
    G = ntot.shape[0] // WORLD
    got = [r[f"accel_{case}"] for r in ranks]
    for k, r in enumerate(got):
        mine = slice(k * G, (k + 1) * G)
        assert [int(r[n]) for n in ("accept_dropped", "frontier_fallback",
                                    "near_fallback", "fb_spill")] \
            == counts[k].tolist()
        np.testing.assert_array_equal(r["near_totals"], ntot[mine])
        np.testing.assert_array_equal(r["far_totals"], ftot[mine])
        if refined:
            for key, want in zip(_REFINE_KEYS, refined):
                np.testing.assert_array_equal(r[key], want[mine])
            assert int(r["refine_build_dropped"]) == int(refined[2][k])
    if case == "seam":
        assert sum(int(r["far_totals"].sum()) for r in got) > 0
    if case == "refined":
        assert sum(int(r["refine_far_totals"].sum()) for r in got) > 0
        assert sum(int(r["refine_near_totals"].sum()) for r in got) > 0
    if case == "straddle":
        assert int(got[0]["refine_build_dropped"]) >= 1
    np.testing.assert_allclose(
        np.concatenate([r["acc"] for r in got])[alive], acc[alive],
        rtol=1e-9, atol=1e-12)


def test_refined_domain_tree_matches_jax(ranks):
    """The refined domain build on 4 ranks against the JAX package's
    build_domain_tree(refine_levels=2): the deep-sorted rows, halo slabs,
    slot maps, child maps and stats exactly, the refined ranges exactly
    and their mass and m·pos to 1e-12; the deep order is the single-chip
    refined build's (ties by original index); and each flagged leaf's
    refined children sum to the domain's leaf statistics."""
    kw = REFINED_TREE
    st, params = _jax_state(**kw)
    m = st.effective_mass()
    level, halo = kw["level"], kw["halo"]
    refine = {k: v for k, v in kw.items() if k.startswith("refine")}

    def body(p_loc, m_loc):
        t = jdomain.build_domain_tree(p_loc, m_loc, params.bounds, level,
                                      AXIS, WORLD, halo, **refine)
        return (t.rows_s, t.ext8, t.level_table[level], t.refine_stats,
                t.refine_slot_leaf, *t.refine_tables, *t.refine_child_slot)

    R = refine["refine_levels"]
    out = [np.asarray(x) for x in _shard_map(
        body, (P(AXIS), P(AXIS)) + (P(),) * (2 * R + 2), st.pos, m)]
    j_rows, j_ext, j_leaf, j_stats, j_slot = out[:5]
    j_tables, j_child = out[5:5 + R], out[5 + R:]
    got = [r["tree_refined"] for r in ranks]
    np.testing.assert_array_equal(
        np.concatenate([r["rows_s"] for r in got]), j_rows)
    np.testing.assert_array_equal(
        np.concatenate([r["ext8"] for r in got]), j_ext)
    tst, tp = workers._state(kw["n"], kw["capacity"], kw["seed"])
    ref = ttree.build_octree(tst.pos, tst.effective_mass(), tp.bounds, level,
                             **refine)
    # outside the leaf cells that straddle a rank boundary (only piecewise
    # deep-sorted, so left unrefined) the order is the single-chip one
    starts = ref.leaf_starts.numpy().astype(np.int64)
    n_loc = kw["capacity"] // WORLD
    keep = np.ones(kw["capacity"], bool)
    for a, b in zip(starts[:-1], starts[1:]):
        if b > a and a // n_loc != (b - 1) // n_loc:
            keep[a:b] = False
    assert 0 < keep.sum() < keep.size
    np.testing.assert_array_equal(j_rows[keep, 4].astype(np.int64),
                                  ref.order.numpy()[keep])
    for r in got:
        assert r["refine_stats"][0] > 0
        np.testing.assert_array_equal(r["refine_stats"], j_stats)
        np.testing.assert_array_equal(r["refine_slot_leaf"], j_slot)
        for a, b in zip(r["refine_child_slot"], j_child):
            np.testing.assert_array_equal(a, b)
        for a, b in zip(r["refine_tables"], j_tables):
            np.testing.assert_array_equal(a[:, 4:], b[:, 4:])
            np.testing.assert_allclose(a[:, :4], b[:, :4], rtol=1e-12,
                                       atol=1e-14)
        # children of each flagged leaf against the leaf's own statistics
        leaf = r["leaf"]
        kids = r["refine_tables"][0].reshape(-1, 8, 8)
        flagged = np.nonzero(r["refine_slot_leaf"] >= 0)[0]
        sums = kids[r["refine_slot_leaf"][flagged], :, :4].sum(axis=1)
        np.testing.assert_allclose(sums, leaf[flagged, :4], rtol=1e-12,
                                   atol=1e-14)
        np.testing.assert_array_equal(kids[r["refine_slot_leaf"][flagged],
                                           0, 4], leaf[flagged, 4])


def test_wide_decode_roundtrip():
    """The wide hi/lo range encoding is exact for starts and ends up to
    2^31 and the JAX package's bit for bit; at small values it decodes as
    the narrow tables do (tests/test_domain.py:311)."""
    from nbody_tpu.ops import tree as jtree

    counts = np.asarray([0, 3, (1 << 24) + 5, 7, (1 << 26) - 1, 0, 2, 1],
                        np.int32)
    mpos = np.zeros((8, 3), np.float32)
    _m, _p, tables = ttree._pyramid_tables(
        torch.as_tensor(counts.astype(np.float32)), torch.as_tensor(mpos),
        torch.as_tensor(counts), 1, 8, torch.float32, wide=True)
    _m, _p, jtables, _s = jtree._pyramid_tables(
        jnp.asarray(counts.astype(np.float32)), jnp.asarray(mpos),
        jnp.asarray(counts), 1, 8, jnp.float32, wide=True)
    ends = np.cumsum(counts.astype(np.int64))
    cs, ce = ttree.decode_ranges(tables[1], True)
    np.testing.assert_array_equal(cs.numpy().astype(np.int64),
                                  ends - counts)
    np.testing.assert_array_equal(ce.numpy().astype(np.int64), ends)
    for a, b in zip(tables, jtables):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    small = torch.as_tensor([1, 2, 3, 4, 0, 0, 5, 6], dtype=torch.float32)
    args = (small, torch.as_tensor(mpos), small, 1, 8, torch.float32)
    narrow = ttree._pyramid_tables(*args, wide=False)[2]
    wide = ttree._pyramid_tables(*args, wide=True)[2]
    for lvl in range(2):
        for a, b in zip(ttree.decode_ranges(narrow[lvl], False),
                        ttree.decode_ranges(wide[lvl], True)):
            assert torch.equal(a, b)


@pytest.mark.parametrize("case", list(WIDE_RUNS))
def test_domain_accel_wide_matches_narrow_and_jax(ranks, case, monkeypatch):
    """The wide row format forced on at a small N (WIDE_N lowered to 1 in
    both packages, tests/test_domain.py:348-443), float32 on 4 ranks: the
    hi/lo ranges, the Morton-prefix fallback containment, the retired
    index columns and the (rank, slot) return route give the narrow
    call's forces within rtol 1e-6 (atol 1e-6 of the largest row), with
    the walk's counters and near and far totals equal; the counters equal
    the JAX package's wide call's exactly and the forces are within 1e-5
    of its largest row (float32 sums in a different order).  The pressure
    case's tiny caps send cells to the fallback slab."""
    from nbody_tpu.ops import tree as jtree

    keys = ("accept_dropped", "frontier_fallback", "near_fallback",
            "fb_spill", "near_totals", "far_totals")
    narrow = [r[f"narrow_{case}"] for r in ranks]
    wide = [r[f"wide_{case}"] for r in ranks]
    for n_, w_ in zip(narrow, wide):
        for k in keys:
            np.testing.assert_array_equal(w_[k], n_[k])
    if case == "pressure":
        assert sum(int(r["near_fallback"]) for r in narrow) > 0
    kw = WIDE_RUNS[case]
    monkeypatch.setattr(jtree, "WIDE_N", 1)
    alive, acc, counts, ntot, ftot = _jax_domain_accel(kw, monkeypatch)
    a_n = np.concatenate([r["acc"] for r in narrow])[alive]
    a_w = np.concatenate([r["acc"] for r in wide])[alive]
    scale = np.abs(a_n).max()
    np.testing.assert_allclose(a_w, a_n, rtol=1e-6, atol=1e-6 * scale)
    G = ntot.shape[0] // WORLD
    for k, r in enumerate(wide):
        assert [int(r[n]) for n in keys[:4]] == counts[k].tolist()
        np.testing.assert_array_equal(r["near_totals"],
                                      ntot[k * G:(k + 1) * G])
        np.testing.assert_array_equal(r["far_totals"],
                                      ftot[k * G:(k + 1) * G])
    assert np.abs(a_w - acc[alive]).max() < 1e-5 * scale


def test_adaptive_on_the_domain_strategy_is_refused():
    """The name is kept from before the refined domain route was ported:
    profile='adaptive' and refine_levels now run on strategy 'bh' (the
    domain) at world size 1, where the domain walk is the single-chip
    walk: the force call equals the single-chip refined bh_accel's, and
    the JAX package's ValueErrors for the wide row format with
    refine_levels and with walk reuse keep JAX's texts."""
    from nbody_tpu.ops import traversal as jt
    from nbody_tpu_torch.ops import traversal as tt

    pos, vel, mass = self_gravitating_disc(2000, seed=3)
    kw = dict(engine="bh", n_devices=1, device="cpu", dtype=torch.float64,
              **workers.COMMON)
    sim = ShardedSimulation(pos, vel, mass, engine_options=dict(
        profile="adaptive"), **kw)
    assert sim.strategy == "bh" and sim._bh_config.refine_levels > 0
    sim = ShardedSimulation(pos, vel, mass,
                            engine_options=dict(REFINED, window_pad=64),
                            **kw)
    assert sim.strategy == "bh"
    st, prm, cfg = sim.state, sim.settings, sim._bh_config
    m = st.effective_mass()
    acc, stats = domain_accel(st.pos, m, prm.bounds, prm.theta2, prm.g,
                              prm.g_soft, cfg, sim.mesh)
    ref, rstats = tt.bh_accel(st.pos, m, prm.bounds, prm.theta2, prm.g,
                              prm.g_soft, cfg)
    assert int(stats["refine_near_totals"].sum()) > 0
    for k in ("refine_near_totals", "refine_build_dropped",
              "near_fallback"):
        assert torch.equal(stats[k], rstats[k]), k
    assert int(stats["refine_far_totals"].sum()) == 0
    np.testing.assert_allclose(acc.numpy(), ref.numpy(), rtol=1e-12,
                               atol=1e-12)
    sim.run(2)
    assert torch.isfinite(sim.state.pos).all()
    for cls in (BHConfig, jt.BHConfig):
        with pytest.raises(ValueError, match="does not support the wide row "
                           "format"):
            cls(refine_levels=1, wide=True)
    with pytest.raises(ValueError) as want:
        jt.traverse_tree_cached(None, None, 1.0, 1.0, 0.02,
                                jt.BHConfig(wide=True), 8)
    tree = ttree.build_octree(st.pos, m, prm.bounds, 4)
    with pytest.raises(ValueError) as got:
        tt.traverse_tree_cached(tree, None, 1.0, 1.0, 0.02,
                                BHConfig(wide=True), 8)
    assert str(got.value) == str(want.value)


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


def _exact_f64(pos, mass, eps, block: int = 1024):
    """The softened sum at every row over every row, in float64 plain
    torch, ``block`` targets a pass: [N, 3] (a row adds nothing to itself,
    d = 0)."""
    pos = torch.as_tensor(pos, dtype=torch.float64)
    mass = torch.as_tensor(mass, dtype=torch.float64)
    out = []
    for i in range(0, pos.shape[0], block):
        d = pos[None, :, :] - pos[i:i + block, None, :]
        w = mass[None, :] * ((d * d).sum(-1) + eps * eps) ** -1.5
        out.append((w[..., None] * d).sum(1))
    return torch.cat(out)


@pytest.mark.parametrize("case", list(DISC_ROWS))
def test_domain_force_on_the_disc_keeps_the_envelope(ranks, case):
    """ShardedSimulation(strategy="bh") on the 4095 + star disc at its own
    preset on 4 ranks, float32, narrow and with the wide rows forced on:
    every alive row's force against the exact float64 sum reads within
    bh's stated envelope, p99 under 5e-2 and p50 under 2e-3 of
    |a - a_exact| / max(|a_exact|, median).  The shard (2048 rows, one
    group) is shorter than the preset's window (2048 + 2 x 2048), which a
    window that kept the preset's pad left without its own group (p99
    ~1.15 before the port centred it)."""
    got = [r[f"disc_{case}"] for r in ranks]
    pos = np.concatenate([r["pos"] for r in got]).astype(np.float64)
    mass = np.concatenate([r["mass"] for r in got]).astype(np.float64)
    acc = np.concatenate([r["acc"] for r in got]).astype(np.float64)
    alive = mass > 0
    assert alive.sum() == 4096
    ref = _exact_f64(pos[alive], mass[alive],
                     workers.COMMON["g_soft"]).numpy()
    rn = np.linalg.norm(ref, axis=1)
    e = (np.linalg.norm(acc[alive] - ref, axis=1)
         / np.maximum(rn, np.median(rn)))
    assert np.quantile(e, 0.99) < 5e-2
    assert np.quantile(e, 0.5) < 2e-3


def test_domain_step_records_collectives_and_their_bytes(ranks):
    """A domain step at world size 4 with the span recorder on: under the
    force span the route's phases in order (build, walk, fb, assembly+dual,
    K3, K4 dual, K4, route, as traverse_tree marks them) and one
    "collective" span a torch.distributed call, each inside the force span
    and in the phase that holds it; the byte counter ops/work.py SENT is,
    kind by kind, what the calls were given (the ring algorithm's bytes).
    With the recorder off the same step recorded nothing."""
    for k, r in enumerate(ranks):
        out = r["spans"]
        assert out["off"] == (0, {})
        assert out["sent"] == out["calls"]
        assert set(out["sent"]) == {"all_gather", "psum", "psum_scatter",
                                    "ring_shift"}
        rec, = out["records"]
        spans = rec["spans"]
        force = next(i for i, s in enumerate(spans) if s[0] == "force")
        under = [s for s in spans if s[1] == force]
        phases = [s[0] for s in under if s[5]]
        assert phases == ["build", "walk", "fb", "assembly+dual", "K3",
                          "K4 dual", "K4", "route"]
        coll = [s for s in under if s[0] == "collective"]
        assert not any(s[5] for s in coll)
        assert len(coll) == sum(c["calls"] for c in out["calls"].values())
        f0, f1 = spans[force][2], spans[force][3]
        marks = [s for s in under if s[5]]
        for s in coll:
            assert f0 <= s[2] <= s[3] <= f1
            # the phase that holds it: marks tile the force span
            assert any(m[2] <= s[2] and s[3] <= m[3] for m in marks)
        held = {m[0] for m in marks
                if any(m[2] <= s[2] and s[3] <= m[3] for s in coll)}
        assert {"build", "assembly+dual", "route"} <= held


def test_accept_offset_opens_the_cells_the_star_drags():
    """``BHConfig.accept_offset`` (Barnes' modified accept test, a
    divergence from the JAX package) on the domain route at world size 1
    and on the single-card walk (``bh_accel``, the replicated route's),
    float64, the 8191 + star disc on a small level-5 stack: the star pulls
    the COM of its cells to their corner, and the plain test accepts those
    cells beside disc rows they reach (largest row 0.082 of the exact
    sum); with the COM's offset from the cell's centre taken off the
    distance they are opened (largest row under 1e-2, p99 under 3e-3) on
    both routes."""
    pos, vel, mass = self_gravitating_disc(8191, seed=5)
    opts = dict(max_level=5, group_size=128, subgroups=8, window_pad=32,
                near_particle_cap=4096, near_cell_cap=1024, start_level=1,
                chunk_groups=1, frontier_cap=4096, accept_cap=4096,
                fb_cap=512)
    kw = dict(engine="bh", n_devices=1, device="cpu", dtype=torch.float64,
              **workers.COMMON)
    worst = {}
    for offset in (False, True):
        sim = ShardedSimulation(pos, vel, mass, strategy="bh",
                                engine_options=dict(opts,
                                                    accept_offset=offset),
                                **kw)
        cfg = sim._bh_config
        assert cfg.accept_offset is offset
        st, p = sim.state, sim.settings
        m = st.effective_mass()
        alive = (m > 0).numpy()
        ref = _exact_f64(st.pos.numpy()[alive], m.numpy()[alive],
                         workers.COMMON["g_soft"]).numpy()
        rn = np.linalg.norm(ref, axis=1)
        acc, _ = domain_accel(st.pos, m, p.bounds, p.theta2, p.g, p.g_soft,
                              cfg, sim.mesh)
        single, _ = bh_accel(st.pos, m, p.bounds, p.theta2, p.g, p.g_soft,
                             cfg)
        for route, a in (("domain", acc), ("single", single)):
            e = (np.linalg.norm(a.numpy()[alive] - ref, axis=1)
                 / np.maximum(rn, np.median(rn)))
            worst[route, offset] = (np.quantile(e, 0.99), e.max())
    for route in ("domain", "single"):
        assert worst[route, False][1] > 5e-2
        assert worst[route, True][1] < 1e-2 and worst[route, True][0] < 3e-3


def test_the_domain_profile_is_the_wide_domain_routes_default():
    """Profile 'domain' (``DOMAIN_OVERRIDES``, the port's tier for the
    domain route's wide rows) is what ``ShardedSimulation``'s domain route
    takes by default from 2^24 rows on more than one rank, and what a
    caller names; the replicated route, one rank and fewer rows keep
    'fast', the JAX package's tiers."""
    n = DOMAIN_MIN_N
    assert bh_profile("bh", 4, n) == "domain"
    assert bh_profile("allgather", 2, 2 * n) == "domain"
    assert bh_profile("bh", 4, n - 1) == "fast"
    assert bh_profile("bh", 1, 2 * n) == "fast"
    assert bh_profile("bh-replicated", 4, 2 * n) == "fast"
    cfg = BHConfig.auto_for(1 << 23, profile="domain")
    assert cfg == BHConfig.auto_for(1 << 23, **DOMAIN_OVERRIDES)
    assert (cfg.max_level, cfg.window_pad, cfg.frontier_cap, cfg.accept_cap,
            cfg.fb_cap, cfg.near_particle_cap, cfg.near_cell_cap,
            cfg.far_particle_cap, cfg.accept_offset, cfg.group_size,
            cfg.chunk_groups) == (
        8, 16384, 16384, 8192, 512, 131072, 4096, 16384, True, 8192, 8)
    assert not BHConfig.auto_for(1 << 23).accept_offset
    with pytest.raises(ValueError, match="profile must be one of"):
        BHConfig.auto_for(1 << 23, profile="wide")
    # a caller that sizes the groups gets the stack under its fields
    pos, vel, mass = self_gravitating_disc(8191, seed=5)
    sim = ShardedSimulation(pos, vel, mass, engine="bh", strategy="bh",
                            n_devices=1, device="cpu",
                            engine_options=dict(
                                profile="domain", group_size=128,
                                subgroups=8, window_pad=32, chunk_groups=1,
                                max_level=5),
                            **workers.COMMON)
    cfg = sim._bh_config
    assert cfg.accept_offset and cfg.near_particle_cap == 131072
    assert cfg.window_pad == 32 and cfg.max_level == 5


@pytest.mark.parametrize("name", ["domain", "domain-far"])
def test_domain_walk_kernel_arguments_give_the_twins_walk(name):
    """Profile 'domain' on the domain route at world size 1 with the wide
    rows forced on (``WIDE_N`` lowered): the collect walk kernel's packed
    arguments run through its numpy restatement
    (tests/torch_collect_emulator.py) give the plain twin's dense walk bit
    for bit, with the wide range decode, the rank's slab as local bounds
    and accept_offset; with the slab narrowed to the middle half
    ("domain-far") the cells outside it fill the far list."""
    args = walk_cases.case(name, "cpu")
    assert args[4].wide and args[4].accept_offset
    twin = tt._collect_dense(*args)
    got = emulator.collect(*args)
    assert walk_cases.mismatches(got, twin, args[5]) == []
    assert bool(got["far_valid"].any()) is (name == "domain-far")

