"""The port's ``tree_boxes`` against the JAX package's, on the same seeded
particles and an off-origin box: a dense tree whose deepest level has more
occupied cells than the 4096 clamp keeps, and a refined tree (a small
Plummer sphere with refine_levels 1 and 2 at a low threshold).

Per level the counts (after the clamp) are exactly equal, and so is the
number of levels; the boxes agree within 1e-6 x the box width (both are
float32 cell centres of the same integer cells)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nbody_tpu.core.state import Bounds as JaxBounds
from nbody_tpu.ops import tree as jtree
from nbody_tpu.scenes import plummer_sphere, uniform_cube
from nbody_tpu_torch.core.state import Bounds
from nbody_tpu_torch.ops import morton
from nbody_tpu_torch.ops import tree as ttree

CENTER, WIDTH = (0.3, -0.2, 0.1), 10.0


def _both(pos, mass, max_level, clamp=4096, **refine):
    jb = JaxBounds.cube(jnp.asarray(CENTER, jnp.float32), WIDTH, jnp.float32)
    tb = Bounds.cube(CENTER, WIDTH, dtype=torch.float32, device="cpu")
    jt = jtree.build_octree(jnp.asarray(pos), jnp.asarray(mass), jb,
                            max_level, **refine)
    tt = ttree.build_octree(torch.from_numpy(pos), torch.from_numpy(mass),
                            tb, max_level, **refine)
    return (jtree.tree_boxes(jt, jb, clamp), ttree.tree_boxes(tt, tb, clamp))


def _assert_equal_boxes(want, got):
    assert len(got) == len(want)
    for l, ((wlo, whi, wn), (lo, hi, n)) in enumerate(zip(want, got)):
        assert isinstance(n, int)
        assert n == wn, f"level {l}: {n} boxes, JAX {wn}"
        assert lo.shape == hi.shape == (n, 3)
        np.testing.assert_allclose(lo, np.asarray(wlo), rtol=0,
                                   atol=1e-6 * WIDTH, err_msg=f"level {l}")
        np.testing.assert_allclose(hi, np.asarray(whi), rtol=0,
                                   atol=1e-6 * WIDTH, err_msg=f"level {l}")


def test_dense_tree_boxes_match_jax_and_clamp():
    pos, _, mass = uniform_cube(8192, width=9.0, seed=3)
    pos = (pos + np.asarray(CENTER)).astype(np.float32)
    mass = mass.astype(np.float32)
    mass[::7] = 0.0  # dead particles occupy no cell
    want, got = _both(pos, mass, max_level=5)
    _assert_equal_boxes(want, got)
    # the deepest level holds more occupied cells than the clamp keeps
    occupied = int(np.count_nonzero(np.asarray(
        jtree.build_octree(jnp.asarray(pos), jnp.asarray(mass),
                           JaxBounds.cube(jnp.asarray(CENTER, jnp.float32),
                                          WIDTH, jnp.float32),
                           5).level_mass[5])))
    assert occupied > 4096 and got[-1][2] == 4096
    # a clamp below a level's count keeps its first cells in id order
    _assert_equal_boxes(*_both(pos, mass, max_level=3, clamp=100))


@pytest.mark.parametrize("refine_levels", [1, 2])
def test_refined_tree_boxes_match_jax(refine_levels):
    pos, _, mass = plummer_sphere(3000, seed=1)
    pos = (pos + np.asarray(CENTER)).astype(np.float32)
    keep = np.all(np.abs(pos - np.asarray(CENTER)) < WIDTH / 2, axis=1)
    mass = np.where(keep, mass, 0.0).astype(np.float32)
    refine = dict(refine_levels=refine_levels, refine_cap=64,
                  refine_threshold=24)
    want, got = _both(pos, mass, max_level=3, **refine)
    assert len(got) == 4 + refine_levels
    assert all(n > 0 for _, _, n in got[4:]), [n for *_, n in got]
    _assert_equal_boxes(want, got)


def test_centers_decode_at_depth_ten():
    """Refined codes reach depth L + R <= MAX_LEVEL_3D = 10 (30 bits):
    ``cell_centers_from_codes`` decodes the extreme cells there."""
    b = Bounds.cube(CENTER, WIDTH, dtype=torch.float64, device="cpu")
    n = 1 << morton.MAX_LEVEL_3D
    axes = torch.tensor([[0, 0, 0], [n - 1, n - 1, n - 1], [n - 1, 0, 5]])
    codes = morton.encode3(axes[:, 0], axes[:, 1], axes[:, 2])
    assert int(codes.max()) == (1 << 30) - 1
    c = morton.cell_centers_from_codes(codes, b, morton.MAX_LEVEL_3D)
    want = (np.asarray(CENTER) - WIDTH / 2
            + (axes.numpy() + 0.5) * WIDTH / n)
    np.testing.assert_allclose(c.numpy(), want, rtol=0, atol=1e-12)
