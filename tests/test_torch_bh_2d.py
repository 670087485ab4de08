"""2D states on the port's Barnes-Hut path (quadtrees, ``BHConfig.dim = 2``)
against the JAX package's, on the 2D disc of ``tests/test_bh_2d.py`` and its
config (``CFG2D``): the 2D Morton codes, the quadtree build, ``bh_accel``
and ``tree_boxes``, and a 2D ``Simulation`` on ``bh``.

Integers are exact (codes, order, leaf starts, every level's ranges, walk
counters); float64 forces agree to 1e-10 of the largest row; the 2D disc
generator of the port (``scenes.disc_2d``) is the test's, bit for bit."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nbody_tpu.api import Simulation as JaxSimulation
from nbody_tpu.core.state import Bounds as JaxBounds
from nbody_tpu.ops import morton as jmorton
from nbody_tpu.ops import traversal as jt
from nbody_tpu.ops import tree as jtree
from nbody_tpu_torch import Simulation
from nbody_tpu_torch.core.state import Bounds
from nbody_tpu_torch.ops import morton as tmorton
from nbody_tpu_torch.ops import traversal as tt
from nbody_tpu_torch.ops import tree as ttree
from nbody_tpu_torch.scenes import disc_2d
from test_bh_2d import CFG2D
from test_bh_2d import disc_2d as jax_disc_2d

STATS = ("accept_dropped", "frontier_fallback", "near_fallback", "fb_spill")
CENTER2 = (0.25, -0.5)  # an off-origin box: the walk runs in the grid frame


def test_disc_2d_is_the_jax_tests_generator():
    for a, b in zip(disc_2d(700, seed=3), jax_disc_2d(700, seed=3)):
        np.testing.assert_array_equal(a, b)


def test_morton2_round_trip_and_codes_match_jax():
    rng = np.random.default_rng(0)
    ix, iy = (rng.integers(0, 1 << 15, 4000) for _ in range(2))
    code = tmorton.encode2(torch.from_numpy(ix), torch.from_numpy(iy))
    want = jmorton.encode2(jnp.asarray(ix, jnp.uint32),
                           jnp.asarray(iy, jnp.uint32))
    np.testing.assert_array_equal(code.numpy(), np.asarray(want))
    jx, jy = tmorton.decode2(code)
    np.testing.assert_array_equal(jx.numpy(), ix)
    np.testing.assert_array_equal(jy.numpy(), iy)
    pos = rng.uniform(-6, 6, (3000, 2)).astype(np.float32)
    tb = Bounds.cube(CENTER2, 10.0, device="cpu")
    jb = JaxBounds.cube(CENTER2, 10.0, dtype=jnp.float32)
    for level in (1, 7, tmorton.MAX_LEVEL_2D):
        codes = tmorton.cell_codes(torch.from_numpy(pos), tb, level)
        np.testing.assert_array_equal(
            codes.numpy(), np.asarray(jmorton.cell_codes(jnp.asarray(pos),
                                                         jb, level)))
        np.testing.assert_array_equal(
            tmorton.cell_centers_from_codes(codes, tb, level, dim=2).numpy(),
            np.asarray(jmorton.cell_centers_from_codes(
                jnp.asarray(codes.numpy()), jb, level, dim=2)))


def _inputs(n=1500, seed=1, dtype="float64", kill=23):
    pos, _, mass = disc_2d(n, seed=seed)
    mass = mass.copy()
    mass[1:1 + kill] = 0.0
    npd = getattr(np, dtype)
    return pos.astype(npd), mass.astype(npd)


@pytest.mark.parametrize("quad_leaf", [False, True])
@pytest.mark.parametrize("refine", [0, 2])
def test_quadtree_build_matches_jax(quad_leaf, refine):
    pos, mass = _inputs()
    kw = dict(max_level=6, dim=2, quad=True, quad_leaf=quad_leaf,
              refine_levels=refine, refine_cap=64, refine_threshold=16)
    ref = jtree.build_octree(jnp.asarray(pos), jnp.asarray(mass),
                             JaxBounds.cube(CENTER2, 10.0,
                                            dtype=jnp.float64), **kw)
    got = ttree.build_octree(torch.from_numpy(pos), torch.from_numpy(mass),
                             Bounds.cube(CENTER2, 10.0, dtype=torch.float64,
                                         device="cpu"), **kw)
    assert got.branch == ref.branch == 4 and got.dim == 2
    assert got.pos_s.shape == (1500, 3)
    assert float(got.pos_s[:, 2].abs().max()) == 0
    for name in ("code_s", "order", "leaf_starts"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(ref, name)))
    for a, b in zip(got.level_table, ref.level_table):
        np.testing.assert_array_equal(a[:, 4:].numpy(), np.asarray(b)[:, 4:])
        np.testing.assert_allclose(a[:, :4].numpy(), np.asarray(b)[:, :4],
                                   rtol=1e-12, atol=1e-14)
    assert got.all_quad.shape == ref.all_quad.shape
    np.testing.assert_allclose(got.all_quad.numpy(), np.asarray(ref.all_quad),
                               rtol=1e-10, atol=1e-14)
    if refine:
        np.testing.assert_array_equal(got.refine_stats.numpy(),
                                      np.asarray(ref.refine_stats))
        np.testing.assert_array_equal(got.refine_slot_leaf.numpy(),
                                      np.asarray(ref.refine_slot_leaf))
        for a, b in zip(got.refine_tables, ref.refine_tables):
            np.testing.assert_array_equal(a[:, 4:6].numpy(),
                                          np.asarray(b)[:, 4:6])


_CASES = {
    "quad": {},
    "mono": dict(multipole="mono"),
    "budgets": dict(near_particle_cap=32, near_cell_cap=8, fb_cap=4,
                    frontier_schedule=(16, 16, 16, 64, 64)),
    "refined": dict(refine_levels=2, refine_cap=64, refine_threshold=16,
                    refine_frontier=256),
}


@pytest.mark.parametrize("case", list(_CASES))
def test_bh_accel_2d_matches_jax_f64(case):
    """The quadtree walk: the same counters and forces to 1e-10, [N, 2]
    rows; the starved budgets take fallback rows and spills, the refined
    case descends 2D refined levels."""
    pos, mass = _inputs()
    over = dict(CFG2D, dim=2, **_CASES[case])
    ref, rstats = jt.bh_accel(jnp.asarray(pos), jnp.asarray(mass),
                              JaxBounds.cube(CENTER2, 10.0, dtype=jnp.float64),
                              0.5, 1.0, 0.02,
                              jt.BHConfig(eval_mode="xla", **over))
    got, stats = tt.bh_accel(torch.from_numpy(pos), torch.from_numpy(mass),
                             Bounds.cube(CENTER2, 10.0, dtype=torch.float64,
                                         device="cpu"),
                             0.5, 1.0, 0.02, tt.BHConfig(**over))
    ref = np.asarray(ref)
    assert got.shape == ref.shape == (1500, 2)
    assert {k: int(stats[k]) for k in STATS} == {k: int(rstats[k])
                                                 for k in STATS}
    if case == "budgets":
        assert min(int(stats[k]) for k in STATS[1:]) > 0
    np.testing.assert_allclose(got.numpy(), ref, rtol=0,
                               atol=1e-10 * np.abs(ref).max())


def test_tree_boxes_2d_match_jax():
    pos, mass = _inputs(dtype="float32")
    jb = JaxBounds.cube(CENTER2, 10.0, dtype=jnp.float32)
    tb = Bounds.cube(CENTER2, 10.0, device="cpu")
    want = jtree.tree_boxes(jtree.build_octree(
        jnp.asarray(pos), jnp.asarray(mass), jb, 6, dim=2), jb, 512)
    got = ttree.tree_boxes(ttree.build_octree(
        torch.from_numpy(pos), torch.from_numpy(mass), tb, 6, dim=2), tb, 512)
    assert len(got) == len(want) == 7
    for (lo, hi, n), (wlo, whi, wn) in zip(got, want):
        assert n == wn and lo.shape == (n, 2)
        np.testing.assert_allclose(lo, np.asarray(wlo), atol=1e-5)
        np.testing.assert_allclose(hi, np.asarray(whi), atol=1e-5)


def test_simulation_2d_bh_matches_jax():
    """A 2D state through Simulation(engine="bh") for five steps, float64:
    the positions track the JAX package's to 1e-10 (XLA contracts the
    leapfrog's multiply-add, an ulp a step) and nothing leaves the box."""
    pos, vel, mass = disc_2d(500, seed=2)
    common = dict(engine="bh", engine_options=CFG2D,
                  bounds_center=(0.0, 0.0), bounds_width=10.0, dt=1e-3,
                  g_soft=0.02, theta2=0.5)
    sim = Simulation(pos, vel, mass, dtype=torch.float64, device="cpu",
                     **common)
    ref = JaxSimulation(pos, vel, mass, dtype=jnp.float64, **common)
    sim.run(5)
    ref.run(5)
    assert sim.n_alive == ref.n_alive == 500
    got, want = sim.get_points()[0], np.asarray(ref.get_points()[0])
    assert got.shape == (500, 2)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-10)
