"""The exact sum's chunk: 64 targets a pass where their temporaries fit
the budget (the same bits as the sum of 64 a pass it replaced), fewer at
2^25 sources, and the same sums whatever the chunk."""

import numpy as np
import pytest
import torch

from harness import check, reference


def sum_of_64(tgt, src, mass, g, eps, chunk=64):
    """``direct_accel`` as it was before it chose its chunk: 64 targets a
    pass whatever the number of sources."""
    eps2 = torch.as_tensor(eps, dtype=src.dtype, device=src.device) ** 2
    out = torch.empty_like(tgt)
    for i in range(0, tgt.shape[0], chunk):
        d = src[None, :, :] - tgt[i:i + chunk, None, :]
        r2 = (d * d).sum(-1) + eps2
        w = mass[None, :] * torch.rsqrt(r2) ** 3
        out[i:i + chunk] = g * torch.einsum("cn,cnk->ck", w, d)
    return out


def _inputs(n, k, seed=5):
    rng = np.random.default_rng(seed)
    src = torch.as_tensor(rng.uniform(-5, 5, (n, 3)))
    mass = torch.as_tensor(rng.uniform(0, 1e-5, n))
    mass[::7] = 0.0
    return src[:: max(1, n // k)][:k].clone(), src, mass


def test_the_chunk_is_64_at_100001_and_the_sum_bitwise_the_old():
    assert reference.sum_chunk(100001, 8) == 64
    assert reference.sum_chunk(100096, 2) == 64  # the bfloat16 control
    tgt, src, mass = _inputs(100001, 130)
    got = reference.direct_accel(tgt, src, mass, 1.0, 0.02)
    assert torch.equal(got, sum_of_64(tgt, src, mass, 1.0, 0.02))


@pytest.mark.parametrize("n", [2**25 + 1, 2**25 + 2**16])
def test_at_2_25_the_temporaries_stay_under_the_budget(n):
    for itemsize in (8, 2):
        chunk = reference.sum_chunk(n, itemsize)
        assert 1 <= chunk <= 64
        assert reference.sum_bytes(chunk, n, itemsize) <= (
            reference.SUM_BUDGET)
    assert reference.sum_chunk(n, 8) == 1
    assert reference.SUM_BUDGET <= 8 << 30


@pytest.mark.parametrize("budget", [1, 3 * 80 * 3001, 7 * 80 * 3001])
def test_a_small_budget_gives_the_same_sums(budget):
    tgt, src, mass = _inputs(3001, 100, seed=9)
    chunk = reference.sum_chunk(3001, 8, budget)
    assert chunk == max(1, budget // (80 * 3001)) < 64
    got = reference.direct_accel(tgt, src, mass, 1.0, 0.02, budget=budget)
    want = sum_of_64(tgt, src, mass, 1.0, 0.02)
    # to 1e-13 of each row's force: with one target a pass the contraction
    # adds in another order (2.9e-15 of the row's norm read)
    rel = (got - want).norm(dim=1) / want.norm(dim=1)
    assert float(rel.max()) <= 1e-13


def test_the_checks_numbers_are_the_old_sums_bitwise(monkeypatch):
    """A step of the reference's own integrator at 100001 + 95 rows
    judged by ``step_check`` with the chunked sum and with the sum of 64
    a pass: every number the same."""
    rng = np.random.default_rng(3)
    n = 100096
    pos = torch.as_tensor(rng.uniform(-4, 4, (n, 3)), dtype=torch.float32)
    vel = torch.as_tensor(rng.normal(0, 0.1, (n, 3)), dtype=torch.float32)
    mass = torch.full((n,), 2e-6, dtype=torch.float32)
    alive = torch.arange(n) < 100001
    before = {"pos": pos, "vel": vel, "mass": mass, "alive": alive,
              "acc": torch.zeros_like(pos)}
    phys = {"g": 1.0, "eps": 0.02, "dt": 0.03, "center": [0.0, 0.0, 0.0],
            "width": 10.0}
    rows = torch.as_tensor(reference.sample_rows(alive.numpy(), 160, 7, 0))
    after = reference.control_step(before, before["acc"], phys, rows,
                                   dtype=torch.float32)
    new = check.stats(reference.step_check(before, after, phys, rows))
    monkeypatch.setattr(reference, "direct_accel", sum_of_64)
    old = check.stats(reference.step_check(before, after, phys, rows))
    assert new == old and new["force_e_p50"] > 0
