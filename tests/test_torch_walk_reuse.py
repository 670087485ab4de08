"""Walk reuse in the port (``traverse_tree(return_topo=True)``,
``traverse_tree_cached``, ``bh_accel_reuse``, ``bh`` with ``walk_every``),
on the configs of ``tests/test_walk_reuse.py``.

The JAX package's cached-topology programs segfault XLA:CPU in full-suite
process state (``tests/test_walk_reuse_isolated.py`` runs them in a child
interpreter), so nothing here compiles them: the port's cached path is held
against the port's full path at static positions, its full walk against the
JAX package's plain ``bh_accel``, and its decisions against their
definition (``refresh_octree`` and the moved fraction are held against the
JAX package's in ``tests/test_torch_lazy.py``)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nbody_tpu.core.state import ParticleState as JaxState
from nbody_tpu.core.state import SimParams as JaxParams
from nbody_tpu.ops import traversal as jt
from nbody_tpu_torch import Simulation
from nbody_tpu_torch.core.state import ParticleState, SimParams
from nbody_tpu_torch.ops import traversal as tt
from nbody_tpu_torch.ops import tree as ttree
from nbody_tpu_torch.scenes import self_gravitating_disc
from test_walk_reuse import OPTS
from torch_parity import jax_fields

CFG = tt.BHConfig(**OPTS)
CFG_MONO = tt.BHConfig(multipole="mono", **OPTS)
CENTER = (0.3, -0.2, 0.1)  # an off-origin box: the carry is grid-frame


def _setup(n, seed, center=(0.0, 0.0, 0.0)):
    pos, vel, mass = self_gravitating_disc(n, seed=seed)
    st = ParticleState.create(pos, vel, mass, dtype=torch.float64,
                              device="cpu")
    params = SimParams.create(g_soft=0.02, theta2=0.5, dtype=torch.float64,
                              bounds_center=center, device="cpu")
    return st, params


def _accel(params, pos, mass, cfg=CFG):
    return tt.bh_accel(pos, mass, params.bounds, params.theta2, params.g,
                       params.g_soft, cfg)


def _reuse(params, pos, mass, tree, topo, age, cfg=CFG, every=2):
    return tt.bh_accel_reuse(pos, mass, params.bounds, params.theta2,
                             params.g, params.g_soft, tree, topo, age, cfg,
                             every)


def _grid_tree(st, params, cfg=CFG):
    b = params.bounds
    return ttree.build_octree(st.pos - b.center, st.effective_mass(),
                              b.centered(), cfg.max_level,
                              **tt._build_args(cfg))


@pytest.mark.parametrize("cfg", [CFG, CFG_MONO], ids=["quad", "mono"])
def test_cached_matches_full_when_static(cfg):
    """At the positions of the walk, the cached-topology eval reproduces
    the full walk (same rows, same fresh values), and the full walk with
    return_topo is the JAX package's bh_accel."""
    st, params = _setup(800, seed=1)
    m = st.effective_mass()
    tree = ttree.build_octree(st.pos, m, params.bounds, cfg.max_level,
                              **tt._build_args(cfg))
    n = st.pos.shape[0]
    a_full, s_full, topo = tt.traverse_tree(
        tree, params.bounds, params.theta2, params.g, params.g_soft, cfg, n,
        return_topo=True)
    tree_r = ttree.refresh_octree(tree, st.pos, m,
                                  quad=cfg.multipole == "quad",
                                  quad_leaf=cfg.quad_leaf)
    a_cached, s_cached = tt.traverse_tree_cached(
        tree_r, topo, params.theta2, params.g, params.g_soft, cfg, n)
    np.testing.assert_allclose(a_cached.numpy(), a_full.numpy(), rtol=1e-12,
                               atol=1e-14)
    assert int(s_cached["dual_tiles"]) == int(s_full["dual_tiles"])
    assert torch.equal(s_cached["near_totals"], s_full["near_totals"])
    jcfg = jt.BHConfig(**dict(jax_fields(cfg), eval_mode="xla"))
    js = JaxState.create(*self_gravitating_disc(800, seed=1),
                         dtype=jnp.float64)
    jp = JaxParams.create(g_soft=0.02, theta2=0.5, dtype=jnp.float64)
    want, _ = jt.bh_accel(js.pos, js.effective_mass(), jp.bounds, jp.theta2,
                          jp.g, jp.g_soft, jcfg)
    want = np.asarray(want)
    np.testing.assert_allclose(a_full.numpy(), want, rtol=0,
                               atol=1e-10 * np.abs(want).max())


def test_cached_matches_full_with_spill_rows():
    """Starved budgets put fallback rows and spills (level -1 in slot 5,
    the true level in slot 7) in the topology; the cached eval re-gathers
    them by slot 7 and still equals the full walk, fb_quad included."""
    cfg = dataclasses.replace(CFG, window_pad=32, near_particle_cap=64,
                              near_cell_cap=16, fb_cap=4, quad_leaf=True,
                              fb_quad=True)
    st, params = _setup(800, seed=1)
    m = st.effective_mass()
    tree = ttree.build_octree(st.pos, m, params.bounds, cfg.max_level,
                              **tt._build_args(cfg))
    n = st.pos.shape[0]
    a_full, stats, topo = tt.traverse_tree(
        tree, params.bounds, params.theta2, params.g, params.g_soft, cfg, n,
        return_topo=True)
    assert int(stats["near_fallback"]) > 0 and int(stats["fb_spill"]) > 0
    assert bool((topo.mono[..., 5] == -1).any())
    tree_r = ttree.refresh_octree(tree, st.pos, m, quad=True, quad_leaf=True)
    a_cached, _ = tt.traverse_tree_cached(
        tree_r, topo, params.theta2, params.g, params.g_soft, cfg, n)
    np.testing.assert_allclose(a_cached.numpy(), a_full.numpy(), rtol=1e-12,
                               atol=1e-14)


def test_empty_topo_has_the_walks_shapes():
    st, params = _setup(800, seed=1)
    tree = _grid_tree(st, params)
    _, _, topo = tt.traverse_tree(tree, params.bounds.centered(),
                                  params.theta2, params.g, params.g_soft, CFG,
                                  st.pos.shape[0], return_topo=True)
    empty = tt.empty_topo(st.pos.shape[0], CFG, torch.float64, "cpu")
    for a, b in zip(topo, empty):
        assert a.shape == b.shape and a.dtype == b.dtype
    assert float(empty.mono.abs().max()) == 0.0


def test_reuse_first_step_full_then_cached_off_origin():
    """Age 0 takes a build and a full walk (= bh_accel); age 1 a cached
    step whose staleness after a small motion stays far inside the walk's
    envelope; both in an off-origin box (the carry is grid-frame)."""
    st, params = _setup(500, seed=2, center=CENTER)
    m = st.effective_mass()
    topo0 = tt.empty_topo(st.pos.shape[0], CFG, torch.float64, "cpu")
    before = dict(tt.HOST_READS)
    acc, stats, tree1, topo1, age = _reuse(params, st.pos, m,
                                           _grid_tree(st, params), topo0, 0)
    assert stats["full_walk"] == 1 and age == 1
    np.testing.assert_allclose(acc.numpy(), _accel(params, st.pos, m)[0]
                               .numpy(), rtol=1e-12, atol=1e-14)
    pos2 = st.pos + 1e-3
    acc2, stats2, _, _, age2 = _reuse(params, pos2, m, tree1, topo1, age)
    assert stats2["full_walk"] == 0 and age2 == 2
    assert tt.HOST_READS["moved_frac"] == before["moved_frac"] + 2
    fresh = _accel(params, pos2, m)[0].numpy()
    err = np.linalg.norm(acc2.numpy() - fresh, axis=1) / np.maximum(
        np.linalg.norm(fresh, axis=1), 1e-30)
    alive = m.numpy() > 0
    assert np.percentile(err[alive], 99) < 2e-2
    assert np.median(err[alive]) < 2e-3


def test_movement_guard_forces_full_walk():
    """A bulk shift of several leaf cells trips the moved-fraction guard
    even when the cadence says 'cached', and restarts the cadence."""
    st, params = _setup(400, seed=3)
    m = st.effective_mass()
    topo0 = tt.empty_topo(st.pos.shape[0], CFG, torch.float64, "cpu")
    _, _, tree1, topo1, age = _reuse(params, st.pos, m,
                                     _grid_tree(st, params), topo0, 0,
                                     every=4)
    shifted = st.pos + torch.tensor([1.0, 0.0, 0.0], dtype=torch.float64)
    _, stats, _, _, age2 = _reuse(params, shifted, m, tree1, topo1, age,
                                  every=4)
    assert stats["full_walk"] == 1 and stats["moved_frac"] > 0.9
    assert age2 == 1


def test_reuse_rejects_unsupported_modes():
    """near_sym and refined rows have no cached route: the JAX texts."""
    st, params = _setup(300, seed=4)
    cfg = dataclasses.replace(CFG, near_sym=True)
    tree = _grid_tree(st, params, cfg)
    topo = tt.empty_topo(st.pos.shape[0], cfg, torch.float64, "cpu")
    with pytest.raises(ValueError, match="walk reuse supports neither"):
        tt.traverse_tree_cached(tree, topo, params.theta2, params.g,
                                params.g_soft, cfg, st.pos.shape[0])
    rcfg = dataclasses.replace(CFG, refine_levels=1, refine_threshold=64)
    rtree = ttree.build_octree(st.pos, st.effective_mass(), params.bounds,
                               rcfg.max_level, refine_levels=1,
                               refine_threshold=64)
    with pytest.raises(ValueError, match="does not support refine_levels"):
        tt.traverse_tree(rtree, params.bounds, params.theta2, params.g,
                         params.g_soft, rcfg, st.pos.shape[0],
                         return_topo=True)


def test_engine_trajectory_and_carry():
    """walk_every=3 for 8 steps tracks the walk-every-step engine (the JAX
    test's criterion), with full walks at ages 0, 3 and 6 (the guard does
    not fire at this motion) and one counted host read a step; compile
    leaves the carry (its age too) as it was, reset restores it, load
    rebuilds it."""
    pos, vel, mass = self_gravitating_disc(400, seed=5)
    common = dict(bounds_width=10.0, dtype=torch.float64, dt=3e-2,
                  g_soft=0.02, theta2=0.5, device="cpu")
    sim = Simulation(pos, vel, mass, engine="bh",
                     engine_options=dict(walk_every=3, **OPTS), **common)
    ref = Simulation(pos, vel, mass, engine="bh", engine_options=OPTS,
                     **common)
    assert sim.engine.stateful and not ref.engine.stateful
    assert sim._carry[2] == 0
    full = []
    reuse = tt.bh_accel_reuse

    def spy(*a, **k):
        out = reuse(*a, **k)
        full.append(out[1]["full_walk"])
        return out

    tt.reset_host_reads()
    import nbody_tpu_torch.engines.barnes_hut as ebh
    orig = ebh.bh_accel_reuse
    ebh.bh_accel_reuse = spy
    try:
        sim.run(8)
    finally:
        ebh.bh_accel_reuse = orig
    assert full == [1, 0, 0, 1, 0, 0, 1, 0]
    assert tt.HOST_READS["moved_frac"] == 8
    ref.run(8)
    assert sim.n_alive == ref.n_alive
    err = np.linalg.norm(sim.get_points()[0] - ref.get_points()[0], axis=1)
    assert np.median(err) < 1e-3
    tree, topo, age = sim._carry
    assert age == 2
    sim.compile(4)
    assert sim._carry[2] == 2 and sim._carry[0] is tree
    assert all(a is b for a, b in zip(sim._carry[1], topo))
    sim.reset()
    assert sim._carry[2] == 0 and sim.elapsed == 0.0
