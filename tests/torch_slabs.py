"""Hand-built K3 / K4 / K5 inputs shared by the port's kernel tests on the
CPU (tests/test_torch_group_force.py and test_torch_self_force.py, against
the JAX package) and on the card (tests/test_torch_cuda.py, which must not
import jax).  The K3 / K4 slabs are those of tests/test_pallas_kernels.py."""

import numpy as np


def species_slab(G=3, B=128, S=512, seed=11):
    """Every row species of an assembled slab (test_pallas_kernels.py:
    172-216): the group's own particles (self-pairs), gathered near rows,
    monopole rows (idx -1) and zero-mass padding with a coincident trap."""
    rng = np.random.default_rng(seed)
    tgt8 = np.zeros((G, B, 8), np.float32)
    tgt8[:, :, :3] = rng.standard_normal((G, B, 3))
    tgt8[:, :, 3] = rng.uniform(0.5, 1.5, (G, B))
    tgt8[:, :, 4] = np.arange(G * B).reshape(G, B)
    slab = np.zeros((G, S, 8), np.float32)
    slab[:, :, :3] = rng.standard_normal((G, S, 3))
    slab[:, :, 3] = rng.uniform(0.5, 1.5, (G, S))
    slab[:, :, 4] = rng.integers(G * B, 2 * G * B, (G, S))
    slab[:, :B] = tgt8[:, :min(B, S)]
    slab[:, -64:, 4] = -1.0
    slab[:, 300:340] = 0.0
    return tgt8, slab


def quad_case(scale, g_soft, seed=3):
    rng = np.random.default_rng(seed)
    G, B, A = 2, 128, 256
    tgt8 = np.zeros((G, B, 8), np.float32)
    tgt8[:, :, :3] = rng.standard_normal((G, B, 3)) * scale
    qrows = np.zeros((G, A, 16), np.float32)
    qrows[:, :, :3] = rng.standard_normal((G, A, 3)) * scale
    qrows[:, :, 3] = rng.uniform(0.5, 1.5, (G, A))
    qrows[:, :, 4:10] = rng.standard_normal((G, A, 6)) * scale * scale
    qrows[:, 100:120] = 0.0
    return tgt8, qrows


def cluster_quad_case(seed=5, G=2, B=128, A=256):
    """Quadrupole rows of real point clusters: each row is the COM, mass and
    traceless Q = sum m (3 d d^T - |d|^2 I) of 8 points within 0.1 of a
    centre 1-3 units from the targets, as accepted nodes are."""
    rng = np.random.default_rng(seed)
    tgt8 = np.zeros((G, B, 8), np.float32)
    tgt8[:, :, :3] = rng.uniform(-0.3, 0.3, (G, B, 3))
    centre = rng.standard_normal((G, A, 3))
    centre *= rng.uniform(1.0, 3.0, (G, A, 1)) / np.linalg.norm(
        centre, axis=-1, keepdims=True)
    pts = centre[:, :, None, :] + rng.uniform(-0.1, 0.1, (G, A, 8, 3))
    m = rng.uniform(0.5, 1.5, (G, A, 8))
    M = m.sum(-1)
    com = (m[..., None] * pts).sum(-2) / M[..., None]
    d = pts - com[:, :, None, :]
    r2 = (d * d).sum(-1)
    qrows = np.zeros((G, A, 16), np.float32)
    qrows[:, :, :3] = com
    qrows[:, :, 3] = M
    for c, (i, j) in enumerate(((0, 0), (1, 1), (2, 2), (0, 1), (0, 2),
                                (1, 2))):
        qrows[:, :, 4 + c] = (m * (3 * d[..., i] * d[..., j]
                                   - (r2 if i == j else 0.0))).sum(-1)
    qrows[:, 100:120] = 0.0
    return tgt8, qrows



def self_square_case(G=4, B=2048, masked=0.3, seed=9):
    """K5 inputs: G groups of B rows (x, y, z, m, idx, 0, 0, 0) at unit-ish
    scale and their source masses msrc, a share ``masked`` of them zeroed
    (rows whose cell the window does not cover)."""
    rng = np.random.default_rng(seed)
    tgt8 = np.zeros((G, B, 8), np.float32)
    tgt8[..., :3] = rng.normal(scale=3.0, size=(G, B, 3))
    tgt8[..., 3] = rng.uniform(0.5, 1.5, (G, B))
    tgt8[..., 4] = np.arange(G * B).reshape(G, B)
    keep = rng.uniform(size=(G, B)) >= masked
    msrc = np.where(keep, tgt8[..., 3], 0.0).astype(np.float32)
    return tgt8, msrc
