"""``nbody_tpu_torch.ops.morton`` against ``nbody_tpu.ops.morton``: the codes
and their decodes are bit-equal on the same seeded inputs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nbody_tpu.core.state import Bounds as JaxBounds
from nbody_tpu.ops import morton as jm
from nbody_tpu_torch.core.state import Bounds
from nbody_tpu_torch.ops import morton as tm


def test_encode_decode_bit_equal():
    rng = np.random.default_rng(1)
    ix, iy, iz = (rng.integers(0, 1024, 5000) for _ in range(3))
    ref = np.asarray(jm.encode3(*(jnp.asarray(a, jnp.uint32)
                                  for a in (ix, iy, iz))))
    got = tm.encode3(*(torch.from_numpy(a) for a in (ix, iy, iz)))
    np.testing.assert_array_equal(got.numpy(), ref.astype(np.int64))
    for a, b in zip(tm.decode3(got), jm.decode3(jnp.asarray(ref))):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    for a, b in zip(tm.decode3(got), (ix, iy, iz)):
        np.testing.assert_array_equal(a.numpy(), b)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("level", [1, 4, 7, 10])
def test_cell_codes_and_centers_bit_equal(dtype, level):
    """Points inside, on the faces of and outside the box (clamped to the
    boundary cells) get the JAX package's codes and cell centers."""
    rng = np.random.default_rng(level)
    pos = rng.uniform(-6.0, 6.0, (4000, 3)).astype(dtype)
    pos[:8] = [[5.0, 5.0, 5.0], [-5.0, -5.0, -5.0], [0, 0, 0], [5, -5, 0],
               [0.0, 4.99, -4.99], [7, 7, 7], [-7, 0, 7], [1e-7, -1e-7, 0]]
    jb = JaxBounds.cube([0.25, -0.5, 0.0], 10.0, dtype=getattr(jnp, dtype))
    tb = Bounds.cube([0.25, -0.5, 0.0], 10.0, dtype=getattr(torch, dtype),
                     device="cpu")
    ref = np.asarray(jm.cell_codes(jnp.asarray(pos), jb, level))
    got = tm.cell_codes(torch.from_numpy(pos), tb, level)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), ref)
    c_ref = np.asarray(jm.cell_centers_from_codes(jnp.asarray(ref), jb, level))
    c_got = tm.cell_centers_from_codes(got, tb, level)
    np.testing.assert_array_equal(c_got.numpy(), c_ref)
