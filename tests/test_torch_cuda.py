"""The CUDA kernels K1-K4 against their plain torch twins on the card, and
the bh engine on the card against the CPU path.

Marked ``cuda``: they need an NVIDIA GPU (sm_90a) and nvcc, and skip
without them.  Run them on the card with

    python -m pytest -m cuda tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import torch

from nbody_tpu_torch import Simulation
from nbody_tpu_torch.core.state import ParticleState
from nbody_tpu_torch.ops import group_force as gf
from nbody_tpu_torch.ops import pairwise as pw
from nbody_tpu_torch.ops import traversal as tt
from nbody_tpu_torch.scenes import self_gravitating_disc
from torch_slabs import cluster_quad_case, quad_case, species_slab

pytestmark = pytest.mark.cuda

G, EPS = 1.0, 0.02


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _disc(n, capacity, kill, dev):
    pos, vel, mass = self_gravitating_disc(n, seed=7)
    st = ParticleState.create(pos, vel, mass, capacity=capacity, device=dev)
    alive = st.alive.clone()
    alive[1:1 + kill] = False
    return st.pos, torch.where(alive, st.mass, 0.0), alive


def _rel_err(got, ref):
    return float((got - ref).norm(dim=1).max() / ref.norm(dim=1).mean())


@pytest.mark.parametrize("n,cap,kill", [(2000, 2048, 37), (300, 333, 0)])
def test_k2_matches_plain(dev, n, cap, kill):
    pos, m, alive = _disc(n, cap, kill, dev)
    got = pw.pairwise_acc(pos, m, G, EPS)
    torch.cuda.synchronize()
    assert _rel_err(got, pw.pairwise_acc_plain(pos, m, G, EPS)) < 1e-4
    got0 = pw.pairwise_acc(pos, m, G, 0.0)
    ref0 = pw.pairwise_acc_plain(pos, m, G, 0.0)
    assert bool(torch.isfinite(got0).all())
    row = (got0 - ref0).norm(dim=1) / ref0.norm(dim=1).clamp_min(1e-30)
    assert float(row[alive].max()) < 1e-3


def test_k2_targets_bitwise_equal_full_rows(dev):
    pos, m, _ = _disc(4000, 4096, 0, dev)
    full = pw.pairwise_acc(pos, m, G, EPS)
    for k in (1, 129, 1000):
        idx = torch.as_tensor(
            np.random.default_rng(k).choice(4096, k, replace=False),
            device=dev)
        got = pw.pairwise_acc_targets(pos[idx], pos, m, G, EPS)
        assert torch.equal(got, full[idx])


@pytest.mark.parametrize("n,cap,kill", [(8191, 8192, 0), (8191, 8192, 37),
                                        (4999, 5000, 11), (99, 100, 0)])
def test_k1_matches_plain(dev, n, cap, kill):
    """Includes ragged sizes (5000 and 100 are not multiples of the 128-wide
    tile)."""
    pos, m, _ = _disc(n, cap, kill, dev)
    got = pw.pairwise_acc_sym(pos, m, G, EPS)
    assert _rel_err(got, pw.pairwise_acc_sym_plain(pos, m, G, EPS)) < 1e-4
    net = (got * m[:, None]).sum(dim=0).abs()
    assert bool((net < 1e-5 * (got.abs() * m[:, None]).sum()).all())
    assert torch.equal(got, pw.pairwise_acc_sym(pos, m, G, EPS))


def test_kernels_reject_what_they_do_not_take(dev):
    pos, m, _ = _disc(500, 512, 0, dev)
    with pytest.raises(TypeError):
        pw.pairwise_acc_sym(pos.double(), m.double(), G, EPS)
    with pytest.raises(ValueError):
        pw.pairwise_acc(pos.t().contiguous().t(), m, G, EPS)


def test_launch_counts(dev):
    pos, m, _ = _disc(4095, 4096, 0, dev)
    pw.reset_launch_counts()
    pw.pairwise_acc_sym(pos, m, G, EPS)
    pw.pairwise_acc_targets(pos[:10], pos, m, G, EPS)
    pw.pairwise_acc_plain(pos, m, G, EPS)
    assert pw.launch_counts() == {"pairwise_acc_sym": 1,
                                  "pairwise_acc_targets": 1}


@pytest.mark.parametrize("n", [999, 4999])
def test_simulation_on_card_matches_cpu(dev, n):
    """brute-pallas through K2 (capacity 2048) and K1 (capacity 6144)."""
    pos, vel, mass = self_gravitating_disc(n, seed=1)
    kw = dict(engine="brute-pallas", dt=3e-2, g_soft=EPS)
    gpu = Simulation(pos, vel, mass, device="cuda", **kw)
    cpu = Simulation(pos, vel, mass, device="cpu", **kw)
    gpu.run(5)
    cpu.run(5)
    assert gpu.n_alive == cpu.n_alive
    for a, b in zip(gpu.get_points(), cpu.get_points()):
        assert np.abs(a - b).max() < 1e-4
    assert gpu.energy("exact") == pytest.approx(cpu.energy("exact"), rel=1e-5)


def _k3(tgt8, slab, g_soft, tile, mask, dev, plain=False):
    fn = gf.group_force_plain if plain else gf.group_force
    return fn(torch.from_numpy(tgt8).to(dev), torch.from_numpy(slab).to(dev),
              G, g_soft, tile=tile,
              mask=None if mask is None else torch.from_numpy(mask).to(dev))


@pytest.mark.parametrize("kind", ["plain", "masked", "eps0", "padding"])
def test_k3_matches_plain(dev, kind):
    """The hand-built slabs of test_torch_group_force.py: every row species,
    a block-dual mask over two target tiles, eps = 0 with coincident pairs,
    and zero-mass padding tiles (bitwise inert)."""
    mask, g_soft, tile = None, EPS, 128
    if kind == "masked":
        tgt8, slab = species_slab(G=2, B=1024, S=512, seed=3)
        mask = np.random.default_rng(4).random((2, 2, 4)) < 0.5
    elif kind == "eps0":
        tgt8 = np.zeros((1, 128, 8), np.float32)
        tgt8[0, :, :3] = (np.linspace(0.1, 1.0, 128)[:, None]
                          * [[1.0, 0.5, -0.3]])
        tgt8[0, :, 3] = 1.0
        tgt8[0, :, 4] = np.arange(128)
        slab, g_soft = tgt8.copy(), 0.0
    else:
        tgt8, slab = species_slab()
    got = _k3(tgt8, slab, g_soft, tile, mask, dev)
    torch.cuda.synchronize()
    ref = _k3(tgt8, slab, g_soft, tile, mask, dev, plain=True)
    assert bool(torch.isfinite(got).all())
    assert _rel_err(got.reshape(-1, 3), ref.reshape(-1, 3)) < 1e-5
    assert torch.equal(got, _k3(tgt8, slab, g_soft, tile, mask, dev))
    if kind == "padding":
        padded = np.concatenate(
            [slab, np.zeros((slab.shape[0], 256, 8), np.float32)], axis=1)
        assert torch.equal(got, _k3(tgt8, padded, g_soft, tile, None, dev))


@pytest.mark.parametrize("case", ["eps0-small-scale", "clusters"])
def test_k4_matches_plain(dev, case):
    """The eps = 0 scene at 1e-3 scale of test_pallas_kernels.py, and rows
    of real point clusters at eps 0.02 (random Q at unit scale is
    ill-conditioned: its terms cancel far beyond any accepted node's)."""
    if case == "clusters":
        (tgt8, qrows), g_soft = cluster_quad_case(), EPS
    else:
        (tgt8, qrows), g_soft = quad_case(1e-3, 0.0), 0.0
    t, q = torch.from_numpy(tgt8).to(dev), torch.from_numpy(qrows).to(dev)
    got = gf.quad_force(t, q, G, g_soft, tile=128)
    torch.cuda.synchronize()
    ref = gf.quad_force_plain(t, q, G, g_soft, tile=128)
    assert _rel_err(got.reshape(-1, 3), ref.reshape(-1, 3)) < 5e-5
    assert torch.equal(got, gf.quad_force(t, q, G, g_soft, tile=128))


# a walk where block-dual accepts tile pairs (tests/test_torch_traversal.py)
DUAL = dict(max_level=4, group_size=128, subgroups=8, window_pad=1024,
            frontier_cap=2048, accept_cap=1024, near_cell_cap=512,
            near_particle_cap=1024, start_level=1, chunk_groups=1,
            eval_tile=128, block_dual=True, dual_margin=1.2)


def test_bh_on_card_matches_cpu(dev):
    """The bh engine through K3 (masked: block-dual on) and K4 on the card
    against the plain torch path on the CPU: the same walk, and forces
    within f32 summation order.  A float64 run on the card raises."""
    pos, vel, mass = self_gravitating_disc(2999, seed=4)
    kw = dict(engine="bh", engine_options=dict(DUAL, mxu_blocks=False),
              dt=3e-2, g_soft=EPS)
    gpu = Simulation(pos, vel, mass, device="cuda", **kw)
    cpu = Simulation(pos, vel, mass, device="cpu", **kw)
    gf.reset_launch_counts()
    gpu.update_forces()
    cpu.update_forces()
    assert gf.launch_counts()["group_force_masked"] == 1
    assert gf.launch_counts()["quad_force"] == 2
    assert _rel_err(gpu.state.acc.cpu(), cpu.state.acc) < 1e-5
    st = gpu.state
    p = gpu.settings
    cfg = tt.BHConfig(**DUAL)
    a1, s1 = tt.bh_accel(st.pos, st.effective_mass(), p.bounds, p.theta2,
                         p.g, p.g_soft, cfg)
    a2, s2 = tt.bh_accel(st.pos, st.effective_mass(), p.bounds, p.theta2,
                         p.g, p.g_soft, cfg)
    assert torch.equal(a1, a2)
    assert int(s1["dual_tiles"]) > 0 and int(s1["accept_dropped"]) == 0
    with pytest.raises(TypeError, match="float32"):
        Simulation(pos, vel, mass, device="cuda", dtype=torch.float64,
                   **kw).update_forces()
