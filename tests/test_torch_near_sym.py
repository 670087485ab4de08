"""``BHConfig.near_sym`` in the port against the JAX package: each group's
own square leaves the slab for the self-square eval (K5 on the card), the
window becomes the rim around the group, and the force set stays that of
the plain walk.  The configurations are tests/test_near_sym.py's: an 8k
disc in 16 groups, so the clamped windows at both ends move the group's
offset in its window over the whole [0, 2 * window_pad] range.  The
block-dual case, the kernel-mode glue and the Simulation surface are in
tests/test_torch_near_sym_paths.py."""

import numpy as np
import pytest

from torch_near_sym_cases import (SINGLE_CFG, SYM_CFG, jax_bh, port_bh,
                                  row_rel)


@pytest.mark.parametrize("multipole", ["mono", "quad"])
@pytest.mark.parametrize("kill", [0, 33])
def test_near_sym_matches_jax_f32(multipole, kill):
    """The same walk (statistics equal) and the same forces up to f32
    summation order: median 1e-5 and worst row 5e-3, the bounds that
    tests/test_near_sym.py holds the JAX package's own near_sym to against
    its plain walk (its tail rows are near-cancelling sums)."""
    cfg = dict(SYM_CFG, multipole=multipole, near_sym=True)
    ref, ref_stats, m = jax_bh("float32", cfg, kill=kill)
    got, stats, _ = port_bh("float32", cfg, kill=kill)
    assert stats == ref_stats
    rel = row_rel(got, ref, m)
    assert float(np.median(rel)) < 1e-5
    assert float(rel.max()) < 5e-3


@pytest.mark.parametrize("multipole", ["mono", "quad"])
def test_near_sym_matches_jax_f64(multipole):
    """In float64 the summation order leaves ~1e-14: a missing, doubled or
    rerouted pair would stand out by orders of magnitude."""
    cfg = dict(SYM_CFG, multipole=multipole, near_sym=True)
    ref, ref_stats, m = jax_bh("float64", cfg)
    got, stats, _ = port_bh("float64", cfg)
    assert stats == ref_stats
    assert float(row_rel(got, ref, m).max()) < 1e-10


@pytest.mark.parametrize("multipole", ["mono", "quad"])
@pytest.mark.parametrize("kill", [0, 33])
def test_near_sym_force_set_is_the_plain_walks_f64(multipole, kill):
    """near_sym against the port's own walk without it: the same force set
    (tests/test_near_sym.py:68-81 measured 3.3e-12 at worst in the JAX
    package)."""
    cfg = dict(SYM_CFG, multipole=multipole)
    a0, s0, m = port_bh("float64", cfg, kill=kill)
    a1, s1, _ = port_bh("float64", dict(cfg, near_sym=True), kill=kill)
    assert s1 == s0
    assert float(row_rel(a1, a0, m).max()) < 1e-10


def test_near_sym_unsoftened():
    """g_soft = 0: the r^2 == 0 guard of the self square, end to end."""
    cfg = dict(SYM_CFG, multipole="quad", near_sym=True)
    ref, ref_stats, m = jax_bh("float32", cfg, g_soft=0.0)
    got, stats, _ = port_bh("float32", cfg, g_soft=0.0)
    assert stats == ref_stats
    assert np.isfinite(got).all()
    assert float(np.median(row_rel(got, ref, m))) < 1e-5
    a0, _, _ = port_bh("float32", dict(cfg, near_sym=False), g_soft=0.0)
    assert float(np.median(row_rel(got, a0, m))) < 1e-5


def test_near_sym_single_group_degenerate():
    """n_tot == group_size: the window covers everything, the rim is empty
    (W - B = 0 < 2 * window_pad)."""
    cfg = dict(SINGLE_CFG, multipole="quad")
    inputs = dict(n=500, capacity=512)
    a0, s0, m = port_bh("float64", cfg, **inputs)
    a1, s1, _ = port_bh("float64", dict(cfg, near_sym=True), **inputs)
    ref, ref_stats, _ = jax_bh("float64", dict(cfg, near_sym=True), **inputs)
    assert s1 == s0 == ref_stats
    assert float(row_rel(a1, a0, m).max()) < 1e-10
    assert float(row_rel(a1, ref, m).max()) < 1e-10
