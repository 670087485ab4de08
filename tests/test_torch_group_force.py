"""The plain torch twins of kernels K3 (unmasked and masked) and K4 against
the JAX package's Pallas kernels run in interpret mode, on the hand-built
slabs of tests/test_pallas_kernels.py; and the wrappers' CPU dispatch.  The
CUDA kernels are held against these twins on the card (chip_smoke.py,
tests/test_torch_cuda.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nbody_tpu.ops.group_force import (group_force_pallas,
                                       quad_force_pallas)
from nbody_tpu_torch.ops import group_force as gf
from torch_parity import rel_err
from torch_slabs import quad_case, species_slab


def _pallas_k3(tgt8, slab, g_soft, tile, mask=None):
    return np.asarray(group_force_pallas(
        jnp.asarray(tgt8), jnp.swapaxes(jnp.asarray(slab), 1, 2), 1.0,
        g_soft, tile=tile, interpret=True,
        mask=None if mask is None else jnp.asarray(mask)))


def _twin_k3(tgt8, slab, g_soft, tile, mask=None):
    return gf.group_force(torch.from_numpy(tgt8), torch.from_numpy(slab),
                          1.0, g_soft, tile=tile,
                          mask=None if mask is None else torch.from_numpy(mask)
                          ).numpy()


def test_k3_plain_matches_pallas():
    tgt8, slab = species_slab()
    ref = _pallas_k3(tgt8, slab, 0.02, 128)
    got = _twin_k3(tgt8, slab, 0.02, 128)
    assert rel_err(got.reshape(-1, 3), ref.reshape(-1, 3)) < 1e-5


def test_k3_masked_plain_matches_pallas():
    """B = 1024 gives two 512-row target tiles (fit_target_tile), S = 512
    four 128-wide source tiles: the mask is [G, 2, 4], a random half set."""
    tgt8, slab = species_slab(G=2, B=1024, S=512, seed=3)
    ti = gf.fit_target_tile(1024, 128, 512, 1 << 20)
    assert ti == 512
    mask = np.random.default_rng(4).random((2, 1024 // ti, 4)) < 0.5
    mask[0, 0] = [True, False, True, False]
    ref = _pallas_k3(tgt8, slab, 0.02, 128, mask)
    got = _twin_k3(tgt8, slab, 0.02, 128, mask)
    assert rel_err(got.reshape(-1, 3), ref.reshape(-1, 3)) < 1e-5
    # an all-false mask is the unmasked sum
    none = np.zeros_like(mask)
    np.testing.assert_array_equal(_twin_k3(tgt8, slab, 0.02, 128, none),
                                  _twin_k3(tgt8, slab, 0.02, 128))


def test_k3_padding_tiles_are_inert():
    """Zero-mass padding tiles change no bit (test_pallas_kernels.py:
    219-243)."""
    rng = np.random.default_rng(5)
    G, B, tile = 2, 128, 128
    tgt8 = np.zeros((G, B, 8), np.float32)
    tgt8[:, :, :3] = rng.standard_normal((G, B, 3))
    tgt8[:, :, 4] = np.arange(G * B).reshape(G, B)
    slab = np.zeros((G, tile, 8), np.float32)
    slab[:, :, :3] = rng.standard_normal((G, tile, 3))
    slab[:, :, 3] = 1.0
    slab[:, :, 4] = -1.0
    padded = np.concatenate([slab, np.zeros((G, 2 * tile, 8), np.float32)],
                            axis=1)
    a = _twin_k3(tgt8, slab, 0.02, tile)
    np.testing.assert_array_equal(a, _twin_k3(tgt8, padded, 0.02, tile))
    assert np.any(a != 0.0)
    ref = _pallas_k3(tgt8, slab, 0.02, tile)
    assert rel_err(a.reshape(-1, 3), ref.reshape(-1, 3)) < 1e-5


def test_k3_unsoftened_coincident_pairs():
    """eps = 0, every target has a coincident source (test_pallas_kernels.py:
    323-351): finite, and equal to the Pallas kernel's guarded branch."""
    B = 128
    tgt8 = np.zeros((1, B, 8), np.float32)
    tgt8[0, :, :3] = np.linspace(0.1, 1.0, B)[:, None] * [[1.0, 0.5, -0.3]]
    tgt8[0, :, 3] = 1.0
    tgt8[0, :, 4] = np.arange(B)
    got = _twin_k3(tgt8, tgt8.copy(), 0.0, 128)
    assert np.all(np.isfinite(got))
    ref = _pallas_k3(tgt8, tgt8.copy(), 0.0, 128)
    assert rel_err(got[0], ref[0]) < 1e-5


@pytest.mark.parametrize("scale,g_soft", [(1e-3, 0.0), (1.0, 0.02)])
def test_k4_plain_matches_pallas(scale, g_soft):
    """The small-scale eps = 0 scene of test_pallas_kernels.py:287-320
    (distances far below any absolute r^2 floor) and a softened unit-scale
    one."""
    tgt8, qrows = quad_case(scale, g_soft)
    ref = np.asarray(quad_force_pallas(
        jnp.asarray(tgt8), jnp.swapaxes(jnp.asarray(qrows), 1, 2), 1.0,
        g_soft, tile=128, interpret=True))
    got = gf.quad_force(torch.from_numpy(tgt8), torch.from_numpy(qrows), 1.0,
                        g_soft, tile=128).numpy()
    assert rel_err(got.reshape(-1, 3), ref.reshape(-1, 3)) < 5e-5
    padded = np.concatenate([qrows, np.zeros((2, 256, 16), np.float32)], 1)
    np.testing.assert_array_equal(
        gf.quad_force(torch.from_numpy(tgt8), torch.from_numpy(padded), 1.0,
                      g_soft, tile=128).numpy(), got)


def test_wrappers_check_shapes_and_count_no_cpu_launches():
    tgt8, slab = species_slab(G=1, B=128, S=256)
    t, s = torch.from_numpy(tgt8), torch.from_numpy(slab)
    gf.reset_launch_counts()
    gf.group_force(t, s, 1.0, 0.02, tile=128)
    with pytest.raises(ValueError, match="tile"):
        gf.group_force(t, s, 1.0, 0.02, tile=96)
    with pytest.raises(ValueError, match="mask"):
        gf.group_force(t, s, 1.0, 0.02, tile=128,
                       mask=torch.zeros((1, 1, 3), dtype=torch.bool))
    with pytest.raises(ValueError, match="16"):
        gf.quad_force(t, s, 1.0, 0.02, tile=128)
    assert gf.launch_counts() == {"group_force": 0, "group_force_masked": 0,
                                  "quad_force": 0}
