"""``force_dense`` / ``force_tiled`` of the port against the JAX package's, on
the same float32 inputs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nbody_tpu.core.state import SimParams as JaxParams
from nbody_tpu.engines import brute_force as jbf
from nbody_tpu_torch.core.state import SimParams
from nbody_tpu_torch.engines import brute_force as bf
from torch_parity import MATMUL_TOL, disc, rel_err


@pytest.mark.parametrize("fn", ["force_dense", "force_tiled"])
@pytest.mark.parametrize("kill", [0, 37])
def test_brute_force_matches_jax(fn, kill):
    _, params, pos, m, _ = disc(500, 512, kill)
    ref = getattr(jbf, fn)(pos.numpy(), m.numpy(), params)
    got = getattr(bf, fn)(pos, m, SimParams.create(dt=3e-2, g_soft=0.02,
                                                   device="cpu"))
    assert rel_err(got, ref) < MATMUL_TOL


@pytest.mark.parametrize("g_soft", [0.0, 0.05])
def test_force_tiled_off_center_box(g_soft):
    """A scene far from the origin: both packages recentre on the bounds
    before the S@P - p_i*S@1 contraction, which would otherwise cancel
    digits; ragged last tile (300 rows, tile 128).  At eps 0 an exactly
    coincident pair gets zero weight.  (At eps > 0 such a pair carries a
    weight m/eps^3 whose cancellation in the contraction leaves ~1e-4 of
    roundoff that differs between the two libraries, so it is left out
    there.)"""
    rng = np.random.default_rng(5)
    center = np.array([300.0, -120.0, 40.0])
    pos = (center + rng.uniform(-2, 2, size=(300, 3))).astype(np.float32)
    if g_soft == 0.0:
        pos[7] = pos[3]  # an exactly coincident pair
    m = rng.uniform(0.5, 1.5, 300).astype(np.float32) / 300
    jp = JaxParams.create(g=0.9, g_soft=g_soft, bounds_center=center,
                          bounds_width=8.0, dtype=jnp.float32)
    tp = SimParams.create(g=0.9, g_soft=g_soft, bounds_center=center,
                          bounds_width=8.0, device="cpu")
    ref = np.asarray(jbf.force_dense(jnp.asarray(pos), jnp.asarray(m), jp))
    got = bf.force_tiled(torch.from_numpy(pos), torch.from_numpy(m), tp,
                         tile=128)
    assert np.all(np.isfinite(got.numpy()))
    assert rel_err(got, ref) < MATMUL_TOL
    dense = bf.force_dense(torch.from_numpy(pos), torch.from_numpy(m), tp)
    assert rel_err(dense, ref) < MATMUL_TOL


def test_brute_force_2d():
    rng = np.random.default_rng(2)
    pos = rng.normal(size=(128, 2)).astype(np.float32)
    m = np.full(128, 1e-2, np.float32)
    jp = JaxParams.create(g_soft=0.05, bounds_center=(0.0, 0.0),
                          bounds_width=20.0, dtype=jnp.float32)
    tp = SimParams.create(g_soft=0.05, bounds_center=(0.0, 0.0),
                          bounds_width=20.0, device="cpu")
    ref = jbf.force_tiled(jnp.asarray(pos), jnp.asarray(m), jp)
    got = bf.force_tiled(torch.from_numpy(pos), torch.from_numpy(m), tp)
    assert got.shape == (128, 2)
    assert rel_err(got, ref) < MATMUL_TOL
