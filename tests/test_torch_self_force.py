"""The plain torch twin of kernel K5 (each Barnes-Hut group against itself,
``BHConfig.near_sym``) against the JAX package's Pallas kernel
``group_self_force_pallas`` run in interpret mode, and against its XLA
counterpart ``_self_square_eval``; and the wrapper's CPU dispatch.  The CUDA
kernel is held against this twin on the card (chip_smoke.py,
tests/test_torch_cuda.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nbody_tpu.ops.group_force import group_self_force_pallas
from nbody_tpu.ops.traversal import BHConfig as JaxBHConfig
from nbody_tpu.ops.traversal import _self_square_eval as jax_self_square
from nbody_tpu_torch.ops import group_force as gf
from torch_parity import rel_err
from torch_slabs import self_square_case

# f32 against f32 in another summation order: each row adds B = 2048 terms
# as large as m / eps^2 (2.5e3 at eps 0.02) in both directions of the
# kernel; measured 7.4e-6 (Pallas) and 4e-6 (XLA).  A wrong weight or
# sign shows as 1e-1.
TOL = 3e-5


def _pallas(tgt8, msrc, g_soft):
    # tile_i 128 and tile_j 256 give both of the kernel's band classes
    # (bj == band and bj < band) at B = 2048
    return np.asarray(group_self_force_pallas(
        jnp.asarray(tgt8), jnp.asarray(msrc), jnp.float32(1.0),
        jnp.float32(g_soft), tile_i=128, tile_j=256, interpret=True))


def _twin(tgt8, msrc, g_soft):
    return gf.group_self_force(torch.from_numpy(tgt8), torch.from_numpy(msrc),
                               1.0, g_soft).numpy()


@pytest.mark.parametrize("masked", [0.0, 0.3])
def test_k5_plain_matches_pallas(masked):
    """G = 4 groups of B = 2048, a share ``masked`` of the source masses
    zeroed (rows of uncovered cells)."""
    tgt8, msrc = self_square_case(G=4, B=2048, masked=masked)
    ref = _pallas(tgt8, msrc, 0.02)
    got = _twin(tgt8, msrc, 0.02)
    assert rel_err(got.reshape(-1, 3), ref.reshape(-1, 3)) < TOL


def test_k5_plain_matches_xla_self_square():
    tgt8, msrc = self_square_case(G=3, B=512, masked=0.3, seed=9)
    cfg = JaxBHConfig(eval_mode="xla", chunk_groups=1, mxu_blocks=False)
    ref = np.asarray(jax_self_square(jnp.asarray(tgt8), jnp.asarray(msrc),
                                     jnp.float32(1.0), jnp.float32(0.02),
                                     cfg))
    got = _twin(tgt8, msrc, 0.02)
    assert rel_err(got.reshape(-1, 3), ref.reshape(-1, 3)) < TOL


def test_k5_eps0_coincident_rows():
    """eps = 0 with coincident rows: the r^2 == 0 guard keeps every row
    finite and the coincident pairs add nothing."""
    tgt8, msrc = self_square_case(G=2, B=512, masked=0.2, seed=5)
    tgt8[:, 100:110, :3] = tgt8[:, 50:51, :3]
    ref = _pallas(tgt8, msrc, 0.0)
    got = _twin(tgt8, msrc, 0.0)
    assert np.isfinite(got).all()
    assert rel_err(got.reshape(-1, 3), ref.reshape(-1, 3)) < TOL


@pytest.mark.parametrize("masked", [0.0, 0.5])
def test_k5_momentum_within_groups(masked):
    """sum_i msrc_i a_i = 0 within each group (each pair's two terms
    cancel); f32 leaves ~1e-9 of sum_i msrc_i |a_i|."""
    tgt8, msrc = self_square_case(G=3, B=1024, masked=masked, seed=2)
    got = _twin(tgt8, msrc, 0.02).astype(np.float64)
    net = np.abs((got * msrc[..., None]).sum(axis=1)).max(axis=1)
    scale = (np.abs(got) * msrc[..., None]).sum(axis=(1, 2))
    assert (net < 1e-6 * scale).all()


def test_k5_masked_rows_feel_covered_ones():
    """A row with msrc = 0 is no source, yet still feels the covered rows
    (its force is the covered rows' column terms on the card)."""
    tgt8, msrc = self_square_case(G=1, B=256, masked=0.0, seed=4)
    msrc[0, :128] = 0.0
    got = _twin(tgt8, msrc, 0.02)
    assert (np.linalg.norm(got[0, :128], axis=1) > 0).all()
    # and the covered half against the covered half only
    sub = _twin(tgt8[:, 128:].copy(), msrc[:, 128:].copy(), 0.02)
    np.testing.assert_allclose(got[0, 128:], sub[0], rtol=1e-5, atol=1e-6)


def test_k5_wrapper_checks_shapes():
    tgt8, msrc = self_square_case(G=2, B=128, masked=0.0)
    t, m = torch.from_numpy(tgt8), torch.from_numpy(msrc)
    with pytest.raises(ValueError, match=r"\[G, B, 8\]"):
        gf.group_self_force(t[..., :4], m, 1.0, 0.02)
    with pytest.raises(ValueError, match="msrc"):
        gf.group_self_force(t, m[:, :64], 1.0, 0.02)
    gf.reset_launch_counts()
    np.testing.assert_array_equal(
        gf.group_self_force(t, m, 1.0, 0.02).numpy(),
        gf.group_self_force_plain(t, m, 1.0, 0.02).numpy())
    assert gf.launch_counts()["group_self_force"] == 0  # the twin ran
