"""The benchmark's frozen copies: the scene generator, bit-equal to the
program's, and the roofline arithmetic on hand-worked shapes."""

import numpy as np
import pytest
import torch

from harness import manifest, roofline

self_gravitating_disc = manifest.plugin("scenes", "disc").make


@pytest.mark.parametrize("seed", [0, 7, 2**31 + 5])
@pytest.mark.parametrize("n", [1, 100, 2047])
def test_the_disc_is_the_programs_bit_for_bit(n, seed):
    from nbody_tpu_torch.scenes import self_gravitating_disc as program

    for a, b in zip(self_gravitating_disc(n, seed=seed),
                    program(n, seed=seed)):
        assert a.dtype == b.dtype and np.array_equal(a, b)


def test_the_ops_table_is_the_programs_at_freezing():
    from nbody_tpu_torch.ops import work

    assert roofline.PAIR_OPS == work.PAIR_OPS
    assert roofline.FP32_PER_S == 67e12 and roofline.BYTES_PER_S == 3.35e12


def test_k3_work_unmasked_by_hand():
    # 2 groups of 4 targets; slabs of 8 rows, 3 and 5 of them massive
    tgt8 = torch.zeros(2, 4, 8)
    slab = torch.zeros(2, 8, 8)
    slab[0, :3, 3] = 1.0
    slab[1, 2:7, 3] = 2.0
    pairs, nbytes = roofline.k3_work(tgt8, slab, 4, None)
    assert pairs == 4 * (3 + 5)
    assert nbytes == 2 * 4 * 24 + 2 * 8 * 16
    t, what = roofline.bound_s(pairs, "pair", nbytes)
    assert what == "bytes" and t == pytest.approx(nbytes / 3.35e12)


def test_k3_work_masked_by_hand():
    # 1 group, 4 targets in 2 target tiles, 8 source rows in 2 tiles of 4
    tgt8 = torch.zeros(1, 4, 8)
    slab = torch.zeros(1, 8, 8)
    slab[0, [0, 1, 5], 3] = 1.0            # 2 massive in tile 0, 1 in tile 1
    mask = torch.tensor([[[False, True],    # target tile 0 skips tile 1
                          [True, False]]])  # target tile 1 skips tile 0
    pairs, nbytes = roofline.k3_work(tgt8, slab, 4, mask)
    assert pairs == 2 * 2 + 2 * 1
    assert nbytes == 4 * 24 + 8 * 16 + 4


def test_bound_is_the_larger_term():
    t, what = roofline.bound_s(10**9, "pair", 10**6)
    assert what == "operations" and t == pytest.approx(18e9 / 67e12)
    t, what = roofline.bound_s(10**9, "quad", 10**6)
    assert t == pytest.approx(49e9 / 67e12)
