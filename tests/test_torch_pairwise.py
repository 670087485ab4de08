"""The plain torch twins of kernels K1 and K2 against the JAX package's Pallas
kernels run in interpret mode, as tests/test_pallas_kernels.py runs them on
the CPU; and the wrappers' CPU dispatch.  The CUDA kernels themselves are
held against these twins on the card (chip_smoke.py, tests/test_torch_cuda.py).
"""

import inspect

import numpy as np
import pytest
import torch

from nbody_tpu.ops.pairwise import (pairwise_acc_pallas,
                                    pairwise_acc_pallas_sym,
                                    pairwise_acc_pallas_targets)
from nbody_tpu_torch.ops import pairwise as pw
from torch_parity import EPS, G, disc, rel_err


@pytest.mark.parametrize("kill", [0, 37])
def test_k2_plain_matches_pallas(kill):
    _, params, pos, m, _ = disc(500, 512, kill)
    ref = pairwise_acc_pallas(pos.numpy(), m.numpy(), params.g, params.g_soft,
                              tile_i=128, tile_j=128, interpret=True)
    got = pw.pairwise_acc_plain(pos, m, G, EPS)
    # two f32 summation orders: roundoff only
    assert rel_err(got, ref) < 1e-4


@pytest.mark.parametrize("kill", [0, 37])
def test_k1_plain_matches_pallas_sym(kill):
    """capacity 1024 with (128, 256) tiles: dual, band and skipped tiles all
    occur in the Pallas kernel."""
    _, params, pos, m, _ = disc(1000, 1024, kill)
    ref = pairwise_acc_pallas_sym(pos.numpy(), m.numpy(), params.g,
                                  params.g_soft, tile_i=128, tile_j=256,
                                  interpret=True)
    got = pw.pairwise_acc_sym_plain(pos, m, G, EPS)
    assert rel_err(got, ref) < 1e-4


@pytest.mark.parametrize("fn", ["k1", "k2"])
def test_unsoftened_guard(fn):
    """eps = 0: dead particles left at coincident positions, and the star at
    the origin, meet the r2 == 0 guard; forces stay finite and agree per
    alive row (1e-3, the bound the JAX suite uses for this scene: rows whose
    force nearly cancels amplify f32 summation-order noise)."""
    _, params, pos, m, alive = disc(1000, 1024, kill=64, g_soft=0.0)
    if fn == "k1":
        ref = pairwise_acc_pallas_sym(pos.numpy(), m.numpy(), params.g,
                                      params.g_soft, tile_i=128, tile_j=256,
                                      interpret=True)
        got = pw.pairwise_acc_sym_plain(pos, m, G, 0.0).numpy()
    else:
        ref = pairwise_acc_pallas(pos.numpy(), m.numpy(), params.g,
                                  params.g_soft, tile_i=128, tile_j=128,
                                  interpret=True)
        got = pw.pairwise_acc_plain(pos, m, G, 0.0).numpy()
    ref = np.asarray(ref)
    assert np.all(np.isfinite(got))
    rel = np.linalg.norm(got - ref, axis=1) / np.maximum(
        np.linalg.norm(ref, axis=1), 1e-30)
    assert float(rel[alive.numpy()].max()) < 1e-3


def test_k1_plain_momentum_conservation():
    _, _, pos, m, _ = disc(1000, 1024)
    got = pw.pairwise_acc_sym_plain(pos, m, G, EPS)
    net = (got * m[:, None]).sum(dim=0).abs()
    scale = (got.abs() * m[:, None]).sum()
    assert bool((net < 1e-5 * scale).all())


def test_k2_plain_targets_equal_full_rows_bitwise():
    """The sampled-target oracle gives bitwise the rows of the full call,
    in the twin as in the kernel (and in the Pallas kernel)."""
    _, params, pos, m, _ = disc(500, 512)
    idx = np.random.default_rng(3).choice(512, 256, replace=False)
    full = pw.pairwise_acc_plain(pos, m, G, EPS)
    got = pw.pairwise_acc_targets_plain(pos[idx], pos, m, G, EPS)
    assert torch.equal(got, full[idx])
    ref = pairwise_acc_pallas_targets(pos.numpy()[idx], pos.numpy(),
                                      m.numpy(), params.g, params.g_soft,
                                      tile_i=128, tile_j=128, interpret=True)
    assert rel_err(got, ref) < 1e-4


def test_wrappers_on_cpu_run_the_plain_twins():
    _, _, pos, m, _ = disc(300, 512, kill=5)
    pw.reset_launch_counts()
    assert torch.equal(pw.pairwise_acc(pos, m, G, EPS),
                       pw.pairwise_acc_plain(pos, m, G, EPS))
    assert torch.equal(pw.pairwise_acc_sym(pos, m, G, EPS),
                       pw.pairwise_acc_sym_plain(pos, m, G, EPS))
    assert torch.equal(pw.pairwise_acc_targets(pos[:7], pos, m, G, EPS),
                       pw.pairwise_acc_targets_plain(pos[:7], pos, m, G, EPS))
    assert torch.equal(pw.pairwise_acc_mxu(pos, m, G, EPS),
                       pw.pairwise_acc_mxu_plain(pos, m, G, EPS))
    # the plain twin is no kernel launch
    assert pw.launch_counts() == {"pairwise_acc_sym": 0,
                                  "pairwise_acc_targets": 0,
                                  "pairwise_acc_mxu": 0}


def test_wrappers_reject_bad_input():
    pos = torch.zeros((16, 3))
    m = torch.ones(16)
    with pytest.raises(ValueError):  # 2D states have no kernel
        pw.pairwise_acc(torch.zeros((16, 2)), m, G, EPS)
    with pytest.raises(ValueError):  # neither cpu nor cuda
        pw.pairwise_acc(pos.to("meta"), m.to("meta"), G, EPS)
    with pytest.raises(ValueError):  # mixed devices
        pw.pairwise_acc_sym(pos, m.to("meta"), G, EPS)


def test_f64_plain_twin_runs_in_f64():
    """The CPU path takes float64 (the kernels take float32 only)."""
    _, _, pos, m, _ = disc(200, 256)
    got = pw.pairwise_acc(pos.double(), m.double(), G, EPS)
    assert got.dtype == torch.float64
    assert rel_err(got, pw.pairwise_acc(pos, m, G, EPS)) < 1e-5


def test_engine_dispatch(monkeypatch):
    """brute-pallas sends 4096 <= N <= 262144 to K1 and every other N to
    K2; brute-pallas-sym sends everything up to 262144 to K1."""
    calls = []
    monkeypatch.setattr(pw, "pairwise_acc_sym",
                        lambda pos, *a: calls.append(("k1", len(pos))))
    monkeypatch.setattr(pw, "pairwise_acc",
                        lambda pos, *a: calls.append(("k2", len(pos))))
    params = type("P", (), {"g": G, "g_soft": EPS})
    for n in (2048, 4096, 65536, 262144, 264192):
        pw._force(torch.empty((n, 3)), torch.empty(n), params)
    for n in (2048, 262144, 264192):
        pw._force_sym(torch.empty((n, 3)), torch.empty(n), params)
    assert calls == [("k2", 2048), ("k1", 4096), ("k1", 65536),
                     ("k1", 262144), ("k2", 264192),
                     ("k1", 2048), ("k1", 262144), ("k2", 264192)]


@pytest.mark.parametrize("n,groups,want", [
    (65536, None, (256, 65536, 3)),   # K1 at the 65536 main run: 0.2 GB
    (4999, None, (20, 4999, 3)),      # a ragged last tile
    (8192, 128, (128, 32, 8192, 3)),  # K5 at the 1M tier: 0.4 GB
    (300, 2, (2, 2, 300, 3))])
def test_sym_partial_shape(n, groups, want):
    """The scratch of K1 and K5: one [n, 3] slot of partial sums per tile
    of nbody_sym_tile() rows (256 on the card; the library is not loaded
    here)."""
    assert pw.sym_partial_shape(n, 256, groups) == want


@pytest.mark.parametrize("n", [1, 127, 128, 2047, 2048, 40000, 65536,
                               262145, 1 << 20])
def test_k2_launch_plan(n):
    """K2's chunks cover [0, N) in order, none of them empty, each a whole
    number of 128-source stages; the plan takes N alone (so a target's
    summation order cannot depend on K), and a full call's partial sums,
    [splits, min(N, batch), 3], stay within 50 MB at any N."""
    assert list(inspect.signature(pw.targets_launch).parameters) == ["n"]
    chunk, splits = pw.targets_launch(n)
    assert chunk > 0 and chunk % pw._K2_STAGE == 0
    spans = [(c * chunk, min(n, (c + 1) * chunk)) for c in range(splits)]
    assert spans[0][0] == 0 and spans[-1][1] == n
    assert all(a < b for a, b in spans)
    assert all(b == a for (_, b), (a, _) in zip(spans, spans[1:]))
    assert splits * min(n, pw._K2_BATCH) * 12 <= 50 * 2**20


@pytest.mark.parametrize("k,n,least", [
    (4096, 1 << 20, 264),  # the bh checks' oracle: two blocks an SM
    (1024, 65536, 132),    # the 65536 run's oracle
    (65536, 65536, 132),   # a full call
    (2048, 2048, 17)])     # brute-pallas below 4096: more than 16, the
                           # grid of one block per 128 targets
def test_k2_launch_fills_the_card(k, n, least):
    _, splits = pw.targets_launch(n)
    assert -(-k // (pw._K2_THREADS * pw._K2_TARGETS)) * splits >= least
