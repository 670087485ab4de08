"""The port's sharded path (``nbody_tpu_torch.parallel``) against the JAX
package's on the CPU.

Multi-rank cases run in spawned gloo ranks (``tests/torch_dist_workers.py``,
which imports no jax): one spawn of 2 ranks and one of 4, each running all
its cases, module-scoped.  The JAX side runs here, on ``tests/conftest.py``'s
8 virtual devices, at the same ``n_devices``.  Sizes follow
tests/test_sharded.py's ``run_pair`` (the 500-particle disc, float64).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dist_workers as workers
from torch_parity import jax_fields
from torch_parity import one_intra_op_thread  # noqa: F401  (autouse)
from nbody_tpu import cli as jcli
from nbody_tpu.ops import tree as jtree
from nbody_tpu.parallel.sharded import ShardedSimulation as JaxSharded
from nbody_tpu.scenes import self_gravitating_disc
from nbody_tpu_torch import Simulation
from nbody_tpu_torch.core.state import ParticleState, SimParams
from nbody_tpu_torch.ops import pairwise as pw
from nbody_tpu_torch.ops import tree as ttree
from nbody_tpu_torch.parallel import ShardedSimulation
from nbody_tpu_torch.parallel.sharded import _local_rows_vs_sources

BH_OPTS = dict(max_level=4, group_size=128, subgroups=8, window_pad=64,
               frontier_cap=2048, accept_cap=1024, near_cell_cap=512,
               near_particle_cap=512, start_level=1, chunk_groups=1)
# tests/test_sharded.py's small refined stack
ADA_OPTS = dict(refine_levels=2, refine_cap=64, refine_threshold=16,
                refine_frontier=256, refine_near_cell_cap=512,
                refine_near_particle_cap=1024, refine_far_cell_cap=128,
                refine_far_particle_cap=512, **BH_OPTS)
# profile='adaptive' spelled with the small stack's fields (the resolver
# then keeps them), on the domain strategy
ADA_DOMAIN = dict(ADA_OPTS, profile="adaptive")
# (engine, strategy, steps, capacity, engine options): the domain run at
# 2048 keeps the 128 + 2 * 64 window inside every shard
RUNS = {
    "allgather": ("brute", "allgather", 10, 1024, None),
    "ring": ("brute", "ring", 10, 1024, None),
    "bh": ("bh", "bh", 5, 2048, BH_OPTS),
    "bh-replicated": ("bh", "bh-replicated", 5, 1024, BH_OPTS),
}
TOL = {"allgather": (1e-9, 1e-11), "ring": (1e-9, 1e-11),
       "bh": (1e-8, 1e-10), "bh-replicated": (1e-8, 1e-10)}
CLI_ARGS = ["-n", "300", "--steps", "3", "--engine", "brute", "--devices",
            "2", "--cpu", "--f64", "--json", "--energy"]


def _run_case(strategy, **extra):
    engine, strat, steps, cap, opts = RUNS[strategy]
    kw = dict(engine=engine, strategy=strat, steps=steps, capacity=cap,
              opts=opts)
    kw.update(extra)
    return kw


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """world -> one {case: result} dict a rank.  The 2-rank spawn writes a
    checkpoint directory that the 4-rank spawn, after it, loads."""
    out = {}
    dcp = str(tmp_path_factory.mktemp("dcp") / "two_ranks")
    for world in (2, 4):
        cases = [(s, "run_steps", _run_case(s)) for s in RUNS]
        cases.append(("energy", "energy", dict(n=400, seed=4,
                                               capacity=None)))
        if world == 2:
            cases += [("surface", "surface", {}),
                      ("cli", "cli", dict(argv=CLI_ARGS)),
                      ("cli_save", "cli", dict(argv=[
                          *CLI_ARGS, "--save", dcp + "_cli"])),
                      ("dcp_save", "dcp_save", dict(path=dcp))]
        else:
            cases += [
                ("dcp_load", "dcp_load", dict(path=dcp)),
                ("refined_domain", "run_steps",
                 _run_case("bh", capacity=2048, opts=ADA_DOMAIN)),
                ("refined", "run_steps",
                 _run_case("bh-replicated", capacity=2048, opts=ADA_OPTS)),
                ("tree", "octree_sharded", {}),
                ("tree_refined", "octree_sharded",
                 dict(refine_levels=2, refine_cap=64, refine_threshold=16)),
                ("tree_sparse", "octree_sharded", dict(level=5)),
            ]
        out[world] = workers.spawn(world, tmp_path_factory.mktemp(
            f"ranks{world}"), cases)
    return out


def _jax_run(world, strategy, **over):
    engine, strat, steps, cap, opts = RUNS[strategy]
    opts = over.pop("opts", opts)
    cap = over.pop("capacity", cap)
    pos, vel, mass = self_gravitating_disc(500, seed=0)
    sim = JaxSharded(pos, vel, mass, engine=engine, strategy=strat,
                     n_devices=world, capacity=cap, engine_options=opts,
                     dtype=jnp.float64, **workers.COMMON)
    sim.run(steps)
    return sim.get_points()[0], sim.n_alive


@pytest.mark.parametrize("eps", [0.02, 0.0])
def test_id_masked_sum_equals_k2_rule(eps):
    """The JAX package's id-masked local sum (the CPU path) and K2's rule
    (a self or coincident pair adds exactly 0; its plain twin here) give
    the same forces, at eps = 0 with coincident points too: the card may
    take K2 for the local sums."""
    rng = np.random.default_rng(3)
    pos = torch.as_tensor(rng.standard_normal((256, 3)))
    pos[10] = pos[11]  # coincident pairs, alone and with a third point
    pos[40] = pos[41] = pos[42]
    mass = torch.as_tensor(rng.uniform(0.5, 1.5, 256))
    mass[200:] = 0.0  # dead sources
    params = SimParams.create(g_soft=eps, dtype=torch.float64, device="cpu")
    ids = torch.arange(256)
    rows = slice(64, 192)
    got = _local_rows_vs_sources(pos[rows], ids[rows], pos, mass, ids, params,
                                 tile=64)
    want = pw.pairwise_acc_targets(pos[rows], pos, mass, params.g,
                                   params.g_soft)
    assert torch.isfinite(got).all()
    scale = want.norm(dim=1).mean()
    assert float((got - want).norm(dim=1).max() / scale) < 1e-10


@pytest.mark.parametrize("strategy", list(RUNS))
@pytest.mark.parametrize("world", [2, 4])
def test_sharded_step_matches_jax(ranks, world, strategy):
    """Ten steps (five for Barnes-Hut) of each strategy on gloo ranks equal
    the JAX package's ShardedSimulation at the same n_devices."""
    got = ranks[world][0][strategy]
    want, n_alive = _jax_run(world, strategy)
    assert got["n_alive"] == n_alive
    for r in ranks[world][1:]:
        np.testing.assert_array_equal(r[strategy]["pos"], got["pos"])
    rtol, atol = TOL[strategy]
    np.testing.assert_allclose(got["pos"], want, rtol=rtol, atol=atol)


def test_bh_domain_refined_matches_jax(ranks):
    """profile='adaptive' with refine_levels on the domain strategy 'bh'
    (the refined domain route: the deep re-sort, the refined tables merged
    from their owner ranks, the refined near and far slab rows) on 4 ranks
    against the JAX package's ShardedSimulation, five steps."""
    got = ranks[4][0]["refined_domain"]
    for r in ranks[4][1:]:
        np.testing.assert_array_equal(r["refined_domain"]["pos"], got["pos"])
    want, n_alive = _jax_run(4, "bh", capacity=2048, opts=ADA_DOMAIN)
    assert got["n_alive"] == n_alive
    np.testing.assert_allclose(got["pos"], want, rtol=1e-8, atol=1e-10)


def test_bh_replicated_refined_matches_jax(ranks):
    """refine_levels on bh-replicated: the refined build runs replicated on
    the gathered arrays (4 ranks)."""
    got = ranks[4][0]["refined"]
    want, n_alive = _jax_run(4, "bh-replicated", capacity=2048,
                             opts=ADA_OPTS)
    assert got["n_alive"] == n_alive
    np.testing.assert_allclose(got["pos"], want, rtol=1e-8, atol=1e-10)


@pytest.mark.parametrize("world", [2, 4])
def test_sharded_energy_matches_jax(ranks, world):
    pos, vel, mass = self_gravitating_disc(400, seed=4)
    sim = JaxSharded(pos, vel, mass, engine="brute", n_devices=world,
                     dtype=jnp.float64, **workers.COMMON)
    want = [sim.energy()]
    sim.run(3)
    want.append(sim.energy())
    for r in ranks[world]:
        np.testing.assert_allclose(r["energy"], want, rtol=1e-10)


@pytest.mark.parametrize("refined", [False, True])
def test_octree_sharded_matches_build_octree(ranks, refined):
    """build_octree_sharded on 4 ranks: the order, codes and ranges exactly
    the single-chip build's (the port's and the JAX package's); at 4N >=
    8^L the node tables bit for bit (the single-chip sums, replicated), the
    quadrupoles to the merge's association; refined tables bit for bit."""
    key = "tree_refined" if refined else "tree"
    got = ranks[4][0][key]
    for r in ranks[4][1:]:
        np.testing.assert_array_equal(r[key]["order"], got["order"])
    rkw = (dict(refine_levels=2, refine_cap=64, refine_threshold=16)
           if refined else {})
    st, params = workers._state(500, 1024, 2)
    m = st.effective_mass()
    ref = ttree.build_octree(st.pos, m, params.bounds, 4, quad=True, **rkw)
    jref = jtree.build_octree(jnp.asarray(st.pos.numpy()),
                              jnp.asarray(m.numpy()),
                              _jax_bounds(), 4, quad=True, **rkw)
    for k in ("order", "code_s", "leaf_starts"):
        np.testing.assert_array_equal(got[k], getattr(ref, k).numpy())
        np.testing.assert_array_equal(got[k], np.asarray(getattr(jref, k)))
    np.testing.assert_array_equal(got["pos_s"], ref.pos_s.numpy())
    for a, b in zip(got["level_table"], ref.level_table):
        # 4N >= 8^L: the single-chip sums, replicated, bit for bit
        np.testing.assert_array_equal(a, b.numpy())
    np.testing.assert_allclose(got["all_quad"], ref.all_quad.numpy(),
                               rtol=1e-12, atol=1e-14)
    if refined:
        assert got["refine_stats"][0] > 0
        np.testing.assert_array_equal(got["refine_slot_leaf"],
                                      ref.refine_slot_leaf.numpy())
        np.testing.assert_array_equal(got["refine_stats"],
                                      ref.refine_stats.numpy())
        for a, b in zip(got["refine_tables"], ref.refine_tables):
            np.testing.assert_array_equal(a, b.numpy())


def test_octree_sharded_sparse_regime_matches_build_octree(ranks):
    """Below JAX's dense-regime gate (4N < 8^L: 1024 slots at level 5) the
    mass and m·pos are each rank's segment sums merged by psum: the order,
    codes and ranges exactly the single-chip builds', statistics to
    1e-12."""
    got = ranks[4][0]["tree_sparse"]
    for r in ranks[4][1:]:
        np.testing.assert_array_equal(r["tree_sparse"]["level_table"][-1],
                                      got["level_table"][-1])
    st, params = workers._state(500, 1024, 2)
    m = st.effective_mass()
    ref = ttree.build_octree(st.pos, m, params.bounds, 5, quad=True)
    jref = jtree.build_octree(jnp.asarray(st.pos.numpy()),
                              jnp.asarray(m.numpy()), _jax_bounds(), 5,
                              quad=True)
    assert 4 * 1024 < 8 ** 5
    for k in ("order", "code_s", "leaf_starts"):
        np.testing.assert_array_equal(got[k], getattr(ref, k).numpy())
        np.testing.assert_array_equal(got[k], np.asarray(getattr(jref, k)))
    for a, b, c in zip(got["level_table"], ref.level_table,
                       jref.level_table):
        np.testing.assert_array_equal(a[:, 4:], b[:, 4:].numpy())
        np.testing.assert_allclose(a, b.numpy(), rtol=1e-12, atol=1e-14)
        np.testing.assert_allclose(a, np.asarray(c), rtol=1e-12, atol=1e-14)
    np.testing.assert_allclose(got["all_quad"], ref.all_quad.numpy(),
                               rtol=1e-12, atol=1e-14)


def _jax_bounds():
    from nbody_tpu.core.state import SimParams as JaxParams

    return JaxParams.create(bounds_width=10.0, dtype=jnp.float64).bounds


def test_surface_settings_particles_and_checkpoint(ranks):
    """Settings and reset, add and remove point (the first dead slot and the
    index-th alive particle of the whole mesh), the pickle round trip,
    each as the JAX package's on 2 devices."""
    s = ranks[2][0]["surface"]
    assert s["ran"] > 0 and s["reset"] == (0.0, 301)
    assert s["dt"] == pytest.approx(1e-3)
    pos, vel, mass = self_gravitating_disc(100, seed=5)
    jsim = JaxSharded(pos, vel, mass, engine="brute", n_devices=2,
                      dtype=jnp.float64, capacity=256, **workers.COMMON)
    n0 = jsim.n_alive
    jsim.add_point([0.5, 0.5, 0.0], [0.0, 0.0, 0.0], 1e-3)
    jp = jsim.get_points()
    assert s["added"] == (n0, n0 + 1, jp[0][-1].tolist(), float(jp[3][-1]))
    jsim.remove_point(0)
    assert s["removed"] == (jsim.n_alive, jsim.get_points()[0][0].tolist())
    assert s["after"][0] > 0 and s["after"][1] == 128
    same_pos, same_t, path = s["roundtrip"]
    assert same_pos and same_t
    # the default format, a torch.distributed.checkpoint directory, round
    # trips bitwise too
    assert s["orbax"] == (True, True, True)
    # the port's sharded pickle loads in the JAX package
    jsim = JaxSharded(*self_gravitating_disc(200, seed=6), engine="brute",
                      n_devices=2, dtype=jnp.float64, **workers.COMMON)
    jsim.load(path, format="pickle")
    assert jsim.elapsed == pytest.approx(3 * 3e-2)


def test_surface_aux_tree_boxes(ranks):
    """aux() on the gathered state: the JAX package's sharded boxes and
    counters."""
    got = ranks[2][0]["surface"]["aux"]
    opts = dict(max_level=4, group_size=128, subgroups=8, window_pad=32,
                near_particle_cap=512, near_cell_cap=256, start_level=1)
    pos, vel, mass = self_gravitating_disc(300, seed=7)
    want = JaxSharded(pos, vel, mass, engine="bh", n_devices=2,
                      engine_options=opts, dtype=jnp.float64, capacity=1024,
                      **workers.COMMON).aux()
    assert got["counts"] == [b[2] for b in want["tree_boxes"]]
    for (lo, hi), (wlo, whi, _k) in zip(got["boxes"], want["tree_boxes"]):
        np.testing.assert_allclose(lo, wlo, atol=1e-5)
        np.testing.assert_allclose(hi, whi, atol=1e-5)
    for k, v in want.items():
        if k != "tree_boxes":
            assert got[k] == v, k


def test_surface_bh_presets_and_validation(ranks):
    """The per-rank auto preset, the accurate and dense profiles, and the
    strategy checks, against the JAX package's ShardedSimulation on 2
    devices; bh-lazy raises with JAX's text."""
    s = ranks[2][0]["surface"]
    pos, vel, mass = self_gravitating_disc(2000, seed=3)
    f32 = dict(dtype=jnp.float32, **workers.COMMON)
    want = JaxSharded(pos, vel, mass, engine="bh", n_devices=2, **f32)
    assert jax_fields(s["auto"]) == dataclasses.asdict(want._bh_config)
    assert s["auto_finite"]
    assert s["accurate_pad"] == 2048
    for got, opts in zip(s["dense"], (
            dict(profile="dense"),
            dict(profile="dense", group_size=128, subgroups=8,
                 chunk_groups=1, window_pad=64, start_level=1))):
        c = JaxSharded(pos, vel, mass, engine="bh", n_devices=2,
                       engine_options=opts, **f32)._bh_config
        assert got == {k: getattr(c, k) for k in got}
    # profile='adaptive' runs on the domain strategy with JAX's stack
    jsim = JaxSharded(pos, vel, mass, engine="bh", n_devices=2,
                      engine_options=dict(profile="adaptive"), **f32)
    assert (s["adaptive_domain"][0], jax_fields(s["adaptive_domain"][1])
            ) == ("bh", dataclasses.asdict(jsim._bh_config))
    assert s["adaptive_domain"][1]["refine_levels"] > 0
    errors = s["errors"]
    assert errors["brute-bh"][0] == "ValueError"
    assert "requires engine" in errors["brute-bh"][1]
    assert errors["adaptive-ring"][0] == "ValueError"
    assert "adaptive" in errors["adaptive-ring"][1]
    with pytest.raises(NotImplementedError) as e:
        JaxSharded(pos, vel, mass, engine="bh-lazy", n_devices=2, **f32)
    assert errors["lazy"] == ("NotImplementedError", str(e.value))


def test_cli_save_names_the_format_it_wrote(ranks, tmp_path):
    """--save with --devices 2 writes a torch.distributed.checkpoint
    directory (the sharded class's default, as the JAX package's orbax) and
    says so in its JSON; a single-device --save writes the pickle and says
    that (the JAX CLI reports the same key for both)."""
    import json
    import os

    from nbody_tpu_torch import cli as tcli

    got = json.loads(ranks[2][0]["cli_save"]["stdout"].strip())
    assert got["checkpoint_format"] == "torch.distributed.checkpoint"
    assert os.path.isdir(got["checkpoint"])
    path = str(tmp_path / "one.pkl")
    res = tcli.main(["-n", "100", "--steps", "1", "--engine", "brute",
                     "--cpu", "--json", "--save", path])
    assert res["checkpoint_format"] == "pickle" and os.path.isfile(path)


def test_dcp_checkpoint_round_trips_and_reshards(ranks):
    """save/load's default format on 2 ranks: the state comes back
    bitwise after 4 more steps and the run steps on; the same directory
    loads into 4 ranks bitwise (the capacity split 4 ways), as orbax
    reshards into the current layout."""
    saved = ranks[2][0]["dcp_save"]
    for r in ranks[2]:
        assert r["dcp_save"]["back"] == (True, True)
        assert r["dcp_save"]["steps_on"]
    for r in ranks[4]:
        got = r["dcp_load"]
        np.testing.assert_array_equal(got["pos"], saved["pos"])
        assert got["elapsed"] == saved["elapsed"]
        assert got["capacity"] * 4 == 256 and got["steps_on"]


def test_dcp_checkpoint_at_world_size_one(tmp_path):
    """In process, one rank: the Barnes-Hut domain run saved to a
    directory, run on and loaded back bitwise; the directory holds no
    pickle, and the pickle format stays available."""
    pos, vel, mass = self_gravitating_disc(500, seed=0)
    engine, strat, steps, cap, opts = RUNS["bh"]
    sim = ShardedSimulation(pos, vel, mass, engine=engine, strategy=strat,
                            engine_options=opts, capacity=cap,
                            dtype=torch.float64, device="cpu", n_devices=1,
                            **workers.COMMON)
    sim.run(2)
    want, t = sim.get_points()[0], sim.elapsed
    path = tmp_path / "ck"
    sim.save(str(path))
    assert path.is_dir()
    sim.run(3)
    sim.load(str(path))
    np.testing.assert_array_equal(sim.get_points()[0], want)
    assert sim.elapsed == t
    sim.save(str(tmp_path / "ck.pkl"), format="pickle")
    sim.run(1)
    assert np.isfinite(sim.get_points()[0]).all() and sim.elapsed > t


def test_cli_devices_two_ranks(ranks):
    """--devices 2 on two ranks: rank 0 prints one JSON line with the JAX
    CLI's keys, rank 1 prints nothing; the run matches the JAX CLI's."""
    import json

    out = [r["cli"] for r in ranks[2]]
    assert out[1]["stdout"] == ""
    lines = out[0]["stdout"].strip().splitlines()
    assert len(lines) == 1
    got = json.loads(lines[-1])
    want = jcli.main(CLI_ARGS)
    assert set(want) <= set(got)
    assert got["engine"] == want["engine"] == "brute"
    assert got["n_alive"] == want["n_alive"]
    np.testing.assert_allclose(got["energy_final"], want["energy_final"],
                               rtol=1e-9)
    assert got["energy_method"] == "exact"


@pytest.mark.parametrize("strategy", list(RUNS))
def test_world_size_one_equals_single_chip(strategy):
    """In process, no spawn: every strategy on a one-rank group equals the
    port's single-chip Simulation (the replicated strategy un-permutes
    once, where the JAX package's one-device path would twice)."""
    engine, strat, steps, cap, opts = RUNS[strategy]
    pos, vel, mass = self_gravitating_disc(500, seed=0)
    kw = dict(engine=engine, engine_options=opts, capacity=cap,
              dtype=torch.float64, device="cpu", **workers.COMMON)
    sh = ShardedSimulation(pos, vel, mass, strategy=strat, n_devices=1, **kw)
    si = Simulation(pos, vel, mass, **kw)
    assert sh.mesh.world == 1
    sh.run(steps)
    si.run(steps)
    assert sh.n_alive == si.n_alive
    np.testing.assert_allclose(sh.get_points()[0], si.get_points()[0],
                               rtol=1e-12, atol=1e-14)
    assert sh.energy() == pytest.approx(si.energy(method="exact"), rel=1e-12)


def test_mesh_size_mismatch_names_torchrun():
    """A count of devices the process group cannot give raises, naming the
    launcher."""
    pos, vel, mass = self_gravitating_disc(50, seed=0)
    with pytest.raises(ValueError, match="torchrun --nproc-per-node 3"):
        ShardedSimulation(pos, vel, mass, n_devices=3, device="cpu")


@pytest.mark.parametrize("option", [{}, {"near_sym": True},
                                    {"sliding_window": True}])
def test_traverse_tree_slices_equal_the_whole_walk(option):
    """traverse_tree's sharded mode, shard by shard in one process: the
    sorted slices of 4 shards, un-permuted by sorting on the order, are
    the single-chip call's forces, with near_sym's self square (each
    group's start taken from its shard) and the sliding window's padded
    rows too."""
    from nbody_tpu_torch.ops import traversal as tt

    st, p = workers._state(500, 1024, 0)
    m = st.effective_mass()
    cfg = tt.BHConfig(**dict(BH_OPTS, eval_mode="xla", **option))
    tree = ttree.build_octree(st.pos, m, p.bounds, cfg.max_level, quad=True,
                              quad_leaf=cfg.quad_leaf)
    whole, _ = tt.traverse_tree(tree, p.bounds, p.theta2, p.g, p.g_soft,
                                cfg, 1024)
    n_chunks = 1024 // (cfg.group_size * cfg.chunk_groups)
    slices = [tt.traverse_tree(tree, p.bounds, p.theta2, p.g, p.g_soft, cfg,
                               1024, chunk_range=(k * n_chunks // 4,),
                               n_shards=4)[0] for k in range(4)]
    got = torch.cat(slices)[torch.argsort(tree.order)]
    np.testing.assert_allclose(got.numpy(), whole.numpy(), rtol=1e-12,
                               atol=1e-14)
