"""``build_octree`` of the port against the JAX package's on a disc with dead
particles, at max_level 4 (4N >= 8^L: the JAX dense leaf branch) and 7 (the
sparse segment-sum branch; the port takes the prefix path for both).

The integers are exact: Morton order, permutation, leaf starts and every
level table's particle ranges.  The float statistics agree to rtol 1e-6 in
f32 and 1e-12 in f64, scaled per cell by what the cell can hold (mass for
masses, mass x half-width for mass-weighted positions, mass x half-width^2
for second moments): a centred cell's position sum cancels to ~0, so a
ratio to the value itself says nothing."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nbody_tpu.core.state import Bounds as JaxBounds
from nbody_tpu.ops import tree as jtree
from nbody_tpu_torch.core.state import Bounds
from nbody_tpu_torch.ops import tree as ttree
from torch_parity import disc

HALF = 5.0  # box half-width
RTOL = {"float32": 1e-6, "float64": 1e-12}


@pytest.fixture(scope="module", params=[(4, "float32"), (4, "float64"),
                                        (7, "float32"), (7, "float64")],
                ids=lambda p: f"L{p[0]}-{p[1]}")
def trees(request):
    level, dtype = request.param
    st, _, _, _, _ = disc(3000, 4096, kill=37)
    jd = getattr(jnp, dtype)
    pos = np.array(st.pos.astype(jd))
    mass = np.array(st.effective_mass().astype(jd))
    ref = jtree.build_octree(jnp.asarray(pos), jnp.asarray(mass),
                             JaxBounds.cube([0.0, 0.0, 0.0], 10.0, dtype=jd),
                             level, quad=True, quad_leaf=False)
    got = ttree.build_octree(torch.from_numpy(pos), torch.from_numpy(mass),
                             Bounds.cube([0.0, 0.0, 0.0], 10.0,
                                         dtype=getattr(torch, dtype),
                                         device="cpu"),
                             level, quad=True)
    return level, dtype, ref, got


def test_integers_exact(trees):
    level, _, ref, got = trees
    assert (4 * 4096 >= 8 ** level) == (level == 4)
    np.testing.assert_array_equal(got.code_s.numpy(), np.asarray(ref.code_s))
    np.testing.assert_array_equal(got.order.numpy(), np.asarray(ref.order))
    np.testing.assert_array_equal(got.leaf_starts.numpy(),
                                  np.asarray(ref.leaf_starts))
    assert int(got.leaf_starts[-1]) == 3001 - 37  # dead at the tail
    assert len(got.level_table) == level + 1
    for a, b in zip(got.level_table, ref.level_table):
        np.testing.assert_array_equal(a[:, 4:].numpy(), np.asarray(b)[:, 4:])


def test_statistics_close(trees):
    level, dtype, ref, got = trees
    rtol = RTOL[dtype]
    for l in range(level + 1):
        m_ref = np.asarray(ref.level_mass[l], np.float64)
        np.testing.assert_allclose(got.level_mass[l].numpy(), m_ref,
                                   rtol=rtol, atol=0)
        np.testing.assert_array_equal(got.level_table[l][:, 0].numpy(),
                                      got.level_mass[l].numpy())
        scale = m_ref[:, None] * HALF
        d = np.abs(got.level_mpos[l].numpy() - np.asarray(ref.level_mpos[l]))
        assert np.all(d <= rtol * scale), (l, float((d / scale).max()))
    # quadrupole table: levels 0..L-1 concatenated (leaf level not built)
    m_all = np.concatenate([np.asarray(m, np.float64)
                            for m in ref.level_mass[:level]])
    assert got.all_quad.shape == ref.all_quad.shape
    d = np.abs(got.all_quad.numpy() - np.asarray(ref.all_quad))
    scale = m_all[:, None] * HALF * HALF
    assert np.all(d <= rtol * scale), float((d[:, :6] / scale).max())


def test_cell_and_leaf_ranges_exact(trees):
    level, _, ref, got = trees
    for l in (0, 2, level):
        ids = np.arange(8 ** l, dtype=np.int32)
        for a, b in zip(ttree.cell_ranges(got, torch.from_numpy(ids), l),
                        jtree.cell_ranges(ref, jnp.asarray(ids), l)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    ids = np.arange(8 ** level, dtype=np.int32)
    for a, b in zip(ttree.leaf_ranges(got, torch.from_numpy(ids)),
                    jtree.leaf_ranges(ref, jnp.asarray(ids))):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_prefix_scan_keeps_one_particle_leaves_exact():
    """A one-particle leaf far from the origin keeps its position to f32
    rounding: the double-float prefix difference does not inherit
    ~ulp(total) from the large running sums."""
    rng = np.random.default_rng(0)
    pos = rng.uniform(-4.9, 4.9, (20000, 3)).astype(np.float32)
    pos[0] = [4.8, 4.8, 4.8]
    mass = np.ones(20000, np.float32)
    tree = ttree.build_octree(torch.from_numpy(pos), torch.from_numpy(mass),
                              Bounds.cube([0.0, 0.0, 0.0], 10.0,
                                          device="cpu"), 7)
    leaf = int(tree.code_s[(tree.order == 0).nonzero()[0, 0]])
    assert int(tree.leaf_starts[leaf + 1] - tree.leaf_starts[leaf]) == 1
    com = tree.level_mpos[7][leaf] / tree.level_mass[7][leaf]
    np.testing.assert_allclose(com.numpy(), pos[0], rtol=2e-7)
