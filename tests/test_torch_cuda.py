"""The CUDA kernels K1-K6 against their plain torch twins on the card, the
build's prefix table kernel against the exact sums, the collect walk kernel
against its twin bit for bit, and the bh (with and without near_sym, and
refined) and brute-pallas-mxu engines on the card against the CPU path.

Marked ``cuda``: they need an NVIDIA GPU (sm_90a) and nvcc, and skip
without them.  Run them on the card with

    python -m pytest -m cuda tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import torch

from nbody_tpu_torch import Simulation
from nbody_tpu_torch.core.state import Bounds, ParticleState
from nbody_tpu_torch.ops import collect_walk as cw
from nbody_tpu_torch.ops import group_force as gf
from nbody_tpu_torch.ops import pairwise as pw
from nbody_tpu_torch.ops import prefix_scan as ps
from nbody_tpu_torch.ops import traversal as tt
from nbody_tpu_torch.ops import tree as ttree
from nbody_tpu_torch.scenes import self_gravitating_disc
import torch_walk_cases as walk_cases
from torch_prefix_cases import DF_UNIT, exact_error, prefix_case
from torch_slabs import (cluster_quad_case, quad_case, self_square_case,
                         species_slab)

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


@pytest.mark.parametrize("n,cap,kill", [(2000, 2048, 37), (300, 333, 0),
                                        (39999, 40000, 37)])
def test_k2_matches_plain(dev, n, cap, kill):
    """40000 sources make 63 chunks of 640 (the last one ragged,
    ``pw.targets_launch``); 333 one ragged chunk."""
    pos, m, alive = _disc(n, cap, kill, dev)
    got = pw.pairwise_acc(pos, m, G, EPS)
    torch.cuda.synchronize()
    assert _rel_err(got, pw.pairwise_acc_plain(pos, m, G, EPS)) < 1e-4
    got0 = pw.pairwise_acc(pos, m, G, 0.0)
    ref0 = pw.pairwise_acc_plain(pos, m, G, 0.0)
    assert bool(torch.isfinite(got0).all())
    row = (got0 - ref0).norm(dim=1) / ref0.norm(dim=1).clamp_min(1e-30)
    assert float(row[alive].max()) < 1e-3


@pytest.mark.parametrize("cap,g_soft", [(4096, EPS), (40000, EPS),
                                        (40000, 0.0)])
def test_k2_targets_bitwise_equal_full_rows(dev, cap, g_soft):
    """Sampled targets give bitwise the full call's rows, and two calls are
    bitwise equal, at one chunk-plan whole (4096: 16 chunks of 256) and
    one with a ragged last chunk (40000), and at eps = 0 with coincident
    rows through the guarded instance.  70000 targets (drawn with
    replacement) go through in two batches."""
    pos, m, _ = _disc(cap - 37, cap, 37, dev)
    if g_soft == 0.0:
        pos = pos.clone()
        pos[200:205] = pos[100]
    full = pw.pairwise_acc(pos, m, G, g_soft)
    assert bool(torch.isfinite(full).all())
    assert torch.equal(full, pw.pairwise_acc(pos, m, G, g_soft))
    for k in (1, 129, 1000, 4096, 70000):
        idx = torch.as_tensor(
            np.random.default_rng(k).choice(cap, k, replace=k > cap),
            device=dev)
        got = pw.pairwise_acc_targets(pos[idx], pos, m, G, g_soft)
        assert torch.equal(got, full[idx])


def test_k2_long_source_range_matches_float64(dev):
    """512 alive rows against the 2^20 disc, the shape of the bh checks'
    oracle: summed stage by stage, K2 stays within 1e-4 of the float64 sum
    (max row over mean row), as the plain twin does; one f32 chain over
    all 2^20 sources drifts two orders of magnitude past that."""
    pos, m, alive = _disc(1048575, 1 << 20, 0, dev)
    idx = torch.as_tensor(np.sort(np.random.default_rng(0).choice(
        np.nonzero(alive.cpu().numpy())[0], 512, replace=False)), device=dev)
    got = pw.pairwise_acc_targets(pos[idx].contiguous(), pos, m, G, EPS)
    ref = pw.pairwise_acc_targets_plain(pos[idx].double(), pos.double(),
                                        m.double(), G, EPS, tile=128)
    assert _rel_err(got.double(), ref) < 1e-4


@pytest.mark.parametrize("n,cap,kill,g_soft", [
    (8191, 8192, 0, EPS), (8191, 8192, 37, EPS), (4999, 5000, 11, EPS),
    (99, 100, 0, EPS), (299, 300, 0, EPS), (4999, 5000, 11, 0.0)])
def test_k1_matches_plain(dev, n, cap, kill, g_soft):
    """Includes ragged sizes (5000, 300 and 100 are not multiples of the
    256-wide tile; 300 leaves a ragged tile below the diagonal) and eps = 0
    through the guarded instance, with coincident particles, held per alive
    row as K2 is."""
    pos, m, alive = _disc(n, cap, kill, dev)
    if g_soft == 0.0:
        pos = pos.clone()
        pos[200:205] = pos[100]  # coincident: r^2 == 0 takes the guard
    got = pw.pairwise_acc_sym(pos, m, G, g_soft)
    ref = pw.pairwise_acc_sym_plain(pos, m, G, g_soft)
    assert bool(torch.isfinite(got).all())
    if g_soft == 0.0:
        row = (got - ref).norm(dim=1) / ref.norm(dim=1).clamp_min(1e-30)
        assert float(row[alive].max()) < 1e-3
    else:
        assert _rel_err(got, ref) < 1e-4
    net = (got * m[:, None]).sum(dim=0).abs()
    assert bool((net < 1e-5 * (got.abs() * m[:, None]).sum()).all())
    assert torch.equal(got, pw.pairwise_acc_sym(pos, m, G, g_soft))


def test_kernels_reject_what_they_do_not_take(dev):
    pos, m, _ = _disc(500, 512, 0, dev)
    with pytest.raises(TypeError):
        pw.pairwise_acc_sym(pos.double(), m.double(), G, EPS)
    with pytest.raises(ValueError):
        pw.pairwise_acc(pos.t().contiguous().t(), m, G, EPS)
    # K3 looks its mask up once per 128-row stage: a finer source tile
    tgt8, slab = (torch.from_numpy(a).to(dev) for a in species_slab())
    mask = torch.zeros((3, 1, 8), dtype=torch.bool, device=dev)
    with pytest.raises(ValueError, match="multiple of 128"):
        gf.group_force(tgt8, slab, G, EPS, tile=64, mask=mask)


def test_launch_counts(dev):
    pos, m, _ = _disc(4095, 4096, 0, dev)
    pw.reset_launch_counts()
    pw.pairwise_acc_sym(pos, m, G, EPS)
    pw.pairwise_acc_targets(pos[:10], pos, m, G, EPS)
    pw.pairwise_acc_plain(pos, m, G, EPS)
    assert pw.launch_counts() == {"pairwise_acc_sym": 1,
                                  "pairwise_acc_targets": 1,
                                  "pairwise_acc_mxu": 0}


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


@pytest.mark.parametrize("kind", ["plain", "masked", "eps0", "padding",
                                  "ragged-B", "small-TI"])
def test_k3_matches_plain(dev, kind):
    """The hand-built slabs of test_torch_group_force.py: every row species,
    a block-dual mask over two target tiles, eps = 0 with coincident pairs,
    and zero-mass padding tiles (bitwise inert); a B and an S that are not
    multiples of the 128 rows of a block and of a stage, and a mask of
    4-row target tiles (finer than a block's 128 rows) at eps = 0 (the
    guarded masked instance)."""
    mask, g_soft, tile = None, EPS, 128
    if kind == "masked":
        tgt8, slab = species_slab(G=2, B=1024, S=512, seed=3)
        mask = np.random.default_rng(4).random((2, 2, 4)) < 0.5
    elif kind == "ragged-B":
        tgt8, slab = species_slab(G=3, B=1000, S=640, seed=5)
    elif kind == "small-TI":
        tgt8, slab = species_slab(G=2, B=1024, S=512, seed=6)
        mask = np.random.default_rng(7).random((2, 256, 4)) < 0.5
        g_soft = 0.0
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


def _k4_check(dev, tgt8, qrows, g_soft):
    t, q = torch.from_numpy(tgt8).to(dev), torch.from_numpy(qrows).to(dev)
    got = gf.quad_force(t, q, G, g_soft, tile=128)
    torch.cuda.synchronize()
    ref = gf.quad_force_plain(t, q, G, g_soft, tile=128)
    assert bool(torch.isfinite(got).all())
    assert _rel_err(got.reshape(-1, 3), ref.reshape(-1, 3)) < 5e-5
    assert torch.equal(got, gf.quad_force(t, q, G, g_soft, tile=128))
    return got


@pytest.mark.parametrize("g_soft", [EPS, 0.0])
def test_k4_chunk_ends_at_its_last_massive_row(dev, g_soft):
    """The kernel's sum over a 128-row chunk stops at the chunk's last
    massive row, rounded up to its unroll width: massive rows that end at
    every residue of that width, in both chunks of the slab, against the
    twin; and the zero-mass rows past the end (M = 0, Q = 0) change no bit
    wherever they sit."""
    from nbody_tpu_torch.ops import _build

    unroll = _build.load_library().nbody_k4_unroll()
    tgt8, qrows = cluster_quad_case()
    rng = np.random.default_rng(8)
    for r in range(unroll):
        q = qrows.copy()
        ends = (3 * unroll + r, 128 + 5 * unroll + r)
        q[:, ends[0] + 1:128] = 0.0
        q[:, ends[1] + 1:] = 0.0
        got = _k4_check(dev, tgt8, q, g_soft)
        moved = q.copy()
        for lo, hi in ((ends[0] + 1, 128), (ends[1] + 1, q.shape[1])):
            moved[:, lo:hi, :3] = rng.uniform(-5.0, 5.0, (2, hi - lo, 3))
        assert torch.equal(got, gf.quad_force(
            torch.from_numpy(tgt8).to(dev), torch.from_numpy(moved).to(dev),
            G, g_soft, tile=128))


def test_k4_massive_row_after_zero_mass_rows(dev):
    """One massive row after 100 zero-mass rows in the first chunk, and a
    few at the start of the second."""
    tgt8, qrows = cluster_quad_case()
    q = np.zeros_like(qrows)
    q[:, 100] = qrows[:, 100 - 20]
    q[:, 128:133] = qrows[:, 128:133]
    _k4_check(dev, tgt8, q, EPS)


def test_k4_rsqrt_against_double_on_every_normal_float(dev):
    """K4's f32 1/r against the twin's (float)rsqrt((double)x), swept over
    every positive normal float: at most 1 ulp apart."""
    bad, ulps = gf.quad_rsqrt_sweep(dev)
    assert ulps <= 1, (bad, ulps)


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


def _clustered(n=4096, seed=0):
    """tests/test_refine.py's scene: half a tight core, half uniform."""
    rng = np.random.default_rng(seed)
    pos = np.concatenate([rng.normal(0, 0.03, (n // 2, 3)),
                          rng.uniform(-4, 4, (n // 2, 3))]).astype(np.float32)
    return torch.from_numpy(pos), torch.full((n,), 1.0 / n)


# tests/test_torch_refine.py's refined config (starved unrefined budgets)
REFINED = dict(max_level=4, group_size=512, subgroups=16, window_pad=128,
               near_particle_cap=256, near_cell_cap=256, frontier_cap=2048,
               accept_cap=2048, fb_cap=256, chunk_groups=1, start_level=2,
               refine_levels=2, refine_cap=512, refine_frontier=512)


@pytest.mark.parametrize("cap", [64, 2])
def test_refined_build_on_card_matches_cpu(dev, cap):
    """The refined build on the card: every integer output equal to the
    CPU build's, the tables' sums within f32 rounding."""
    from nbody_tpu_torch.core.state import Bounds
    from nbody_tpu_torch.ops.tree import build_octree

    pos, mass = _clustered()
    kw = dict(max_level=3, refine_levels=2, refine_cap=cap,
              refine_threshold=64)
    b = Bounds.cube((0.0, 0.0, 0.0), 10.0, device="cpu")
    cpu = build_octree(pos, mass, b, **kw)
    gpu = build_octree(pos.to(dev), mass.to(dev),
                       Bounds.cube((0.0, 0.0, 0.0), 10.0, device=dev), **kw)
    for name in ("order", "code_s", "leaf_starts", "refine_slot_leaf",
                 "refine_stats"):
        assert torch.equal(getattr(gpu, name).cpu(), getattr(cpu, name)), name
    for g, c in zip(gpu.refine_child_slot, cpu.refine_child_slot):
        assert torch.equal(g.cpu(), c)
    for g, c in zip(gpu.refine_tables, cpu.refine_tables):
        assert torch.equal(g[:, 4:].cpu(), c[:, 4:])
        torch.testing.assert_close(g[:, :4].cpu(), c[:, :4], rtol=1e-6,
                                   atol=1e-6 * float(c[:, :4].abs().max()))


def test_refined_bh_on_card_matches_cpu(dev):
    """The refined walk on the card through K3 and K4 against the plain
    torch path on the CPU (d-form, what the kernels compute): the same
    counters and forces within f32 summation order; two calls bitwise
    equal."""
    from nbody_tpu_torch.core.state import Bounds

    pos, mass = _clustered()
    out = {}
    for d, over in (("cpu", dict(mxu_blocks=False)), (dev, {})):
        b = Bounds.cube((0.0, 0.0, 0.0), 10.0, device=d)
        args = (pos.to(d), mass.to(d), b, 1.0, 1.0, 1e-2,
                tt.BHConfig(**REFINED, **over))
        gf.reset_launch_counts()
        out[d] = tt.bh_accel(*args)
        if d != "cpu":
            counts = gf.launch_counts()
            assert counts["group_force"] == 1 and counts["quad_force"] == 1
            assert torch.equal(out[d][0], tt.bh_accel(*args)[0])
    (ac, sc), (ag, sg) = out["cpu"], out[dev]
    for k in ("accept_dropped", "frontier_fallback", "near_fallback",
              "fb_spill", "near_totals", "refine_near_totals",
              "refine_build_dropped"):
        assert torch.equal(sg[k].cpu(), sc[k]), k
    assert int(sg["refine_near_totals"].sum()) > 0
    assert _rel_err(ag.cpu(), ac) < 1e-5


@pytest.mark.parametrize("B,masked,g_soft", [(2048, 0.3, EPS), (1000, 0.0, EPS),
                                             (512, 0.2, 0.0), (300, 0.1, EPS)])
def test_k5_matches_plain(dev, B, masked, g_soft):
    """Masked source masses, B that are not multiples of the 256-row tile
    (1000, and 300: one full tile and a ragged one), and eps = 0 with
    coincident rows; momentum within each group; two calls bitwise
    equal."""
    tgt8, msrc = self_square_case(G=3, B=B, masked=masked)
    if g_soft == 0.0:
        tgt8[:, 100:110, :3] = tgt8[:, 50:51, :3]
    t, m = torch.from_numpy(tgt8).to(dev), torch.from_numpy(msrc).to(dev)
    got = gf.group_self_force(t, m, G, g_soft)
    torch.cuda.synchronize()
    ref = gf.group_self_force_plain(t, m, G, g_soft)
    assert bool(torch.isfinite(got).all())
    assert _rel_err(got.reshape(-1, 3), ref.reshape(-1, 3)) < 3e-5
    net = (got.double() * m[..., None]).sum(dim=1).abs().amax(dim=1)
    scale = (got.double().abs() * m[..., None]).sum(dim=(1, 2))
    assert bool((net < 1e-6 * scale).all())
    assert torch.equal(got, gf.group_self_force(t, m, G, g_soft))


def _sorted_disc(n, capacity, kill, dev):
    """The disc sorted by the brute-pallas-mxu engine's own order."""
    from nbody_tpu_torch.core.state import SimParams

    pos, m, _ = _disc(n, capacity, kill, dev)
    params = SimParams.create(bounds_width=10.0, device=dev)
    order = pw.mxu_order(pos, m, params.bounds)
    return pos[order].contiguous(), m[order].contiguous()


@pytest.mark.parametrize("n,cap,kill,tiles", [
    (2047, 2048, 0, (512, 1024)), (2047, 2048, 37, (128, 128)),
    (99, 100, 0, (512, 1024)), (4095, 4096, 0, (64, 1024)),
    (383, 384, 0, (512, 1024)), (2559, 2560, 0, (512, 1024)),
    (63, 64, 0, (512, 1024))])
def test_k6_matches_plain(dev, n, cap, kill, tiles):
    """The kernel forms r^2 with the twin's roundings, so the two differ
    only in summation order, which the fold A - (p - c) sum s magnifies in
    the rows far from their anchor.  Includes a single tile below one
    128-source stage (N = 100, 64), 64-row target tiles (blocks of 16
    threads), and grids whose source tiles are narrower than 1024 (384:
    128 x 128; 2560: 512 x 512)."""
    pos, m = _sorted_disc(n, cap, kill, dev)
    ti, tj = tiles
    got = pw.pairwise_acc_mxu(pos, m, G, EPS, tile_i=ti, tile_j=tj)
    torch.cuda.synchronize()
    ref = pw.pairwise_acc_mxu_plain(pos, m, G, EPS, tile_i=ti, tile_j=tj)
    assert bool(torch.isfinite(got).all())
    assert _rel_err(got, ref) < 1e-3
    assert torch.equal(got, pw.pairwise_acc_mxu(pos, m, G, EPS, tile_i=ti,
                                                tile_j=tj))
    if n > 300:  # ragged above 128 rows: refused, not left unwritten
        with pytest.raises(ValueError, match="divisible"):
            pw.pairwise_acc_mxu(pos[:300].contiguous(),
                                m[:300].contiguous(), G, EPS)


@pytest.mark.parametrize("cap,tiles,splits", [
    (1024, (512, 1024), 1), (2048, (512, 1024), 2), (4096, (512, 1024), 4),
    (8192, (512, 1024), 8), (16384, (512, 1024), 16),
    (32768, (512, 1024), 32), (8192, (512, 128), 64)])
def test_k6_source_splits(dev, cap, tiles, splits):
    """Every number of source splits the launch takes on these grids, each
    held against the twin as chip_smoke.py holds N = 65536 (16 splits)."""
    pos, m = _sorted_disc(cap - 1, cap, 0, dev)
    ti, tj = pw.mxu_tiles(cap, *tiles)
    assert pw.mxu_launch(cap, ti, tj)[1] == splits
    got = pw.pairwise_acc_mxu(pos, m, G, EPS, tile_i=ti, tile_j=tj)
    torch.cuda.synchronize()
    ref = pw.pairwise_acc_mxu_plain(pos, m, G, EPS, tile_i=ti, tile_j=tj)
    assert _rel_err(got, ref) < 1e-3
    rn = ref.norm(dim=1)
    med = ((got - ref).norm(dim=1) / rn.clamp_min(float(rn.median())))
    assert float(med.median()) < 1e-5
    assert torch.equal(got, pw.pairwise_acc_mxu(pos, m, G, EPS, tile_i=ti,
                                                tile_j=tj))


def test_k6_eps0_coincident(dev):
    """eps = 0 (rsqrtf, the guarded instance) with coincident particles:
    their r^2 is exactly 0 in the kernel and the twin alike and the pair is
    skipped.  Unsoftened close pairs make the fold A - (p - c) sum s cancel
    far more than at eps > 0, so each summation order carries its own
    rounding there: the kernel is held, as the twin is against the JAX
    kernel (test_torch_pairwise_mxu.py), to the twin's own accuracy
    against the float64 direct sum, row by row on the alive rows."""
    pos, m = _sorted_disc(2047, 2048, 37, dev)
    pos = pos.clone()
    pos[200:205] = pos[100]
    got = pw.pairwise_acc_mxu(pos, m, G, 0.0)
    torch.cuda.synchronize()
    ref = pw.pairwise_acc_mxu_plain(pos, m, G, 0.0)
    exact = pw.pairwise_acc_targets_plain(pos.double(), pos.double(),
                                          m.double(), G, 0.0, tile=256)
    alive = m > 0
    assert bool(torch.isfinite(got[alive]).all())

    def row_err(a):
        rn = exact.norm(dim=1)
        e = (a.double() - exact).norm(dim=1) / rn.clamp_min(float(rn.median()))
        return e[alive].cpu().numpy()

    e_got, e_ref = row_err(got), row_err(ref)
    for q, k in ((50, 1.5), (90, 1.5), (99, 2.5), (100, 2.5)):
        assert np.percentile(e_got, q) <= k * np.percentile(e_ref, q) + 1e-7
    assert torch.equal(got, pw.pairwise_acc_mxu(pos, m, G, 0.0))


def test_near_sym_on_card_matches_cpu(dev):
    """bh with near_sym through K5 (and masked K3, K4) on the card against
    the plain torch path on the CPU, and against the card's own walk without
    near_sym: the same walk and the same force set."""
    pos, vel, mass = self_gravitating_disc(2999, seed=4)
    opts = dict(DUAL, mxu_blocks=False, near_sym=True)
    kw = dict(engine="bh", dt=3e-2, g_soft=EPS)
    gpu = Simulation(pos, vel, mass, device="cuda", engine_options=opts, **kw)
    cpu = Simulation(pos, vel, mass, device="cpu", engine_options=opts, **kw)
    gf.reset_launch_counts()
    gpu.update_forces()
    cpu.update_forces()
    assert gf.launch_counts()["group_self_force"] == 1
    assert _rel_err(gpu.state.acc.cpu(), cpu.state.acc) < 1e-5
    st, p = gpu.state, gpu.settings
    args = (st.pos, st.effective_mass(), p.bounds, p.theta2, p.g, p.g_soft)
    a1, s1 = tt.bh_accel(*args, tt.BHConfig(**dict(DUAL, near_sym=True)))
    a2, _ = tt.bh_accel(*args, tt.BHConfig(**dict(DUAL, near_sym=True)))
    a0, s0 = tt.bh_accel(*args, tt.BHConfig(**DUAL))
    assert torch.equal(a1, a2)
    for k in ("accept_dropped", "frontier_fallback", "near_fallback",
              "fb_spill"):
        assert int(s1[k]) == int(s0[k])
    alive = st.alive
    row = (a1 - a0).norm(dim=1) / a0.norm(dim=1).clamp_min(1e-30)
    assert float(row[alive].median()) < 1e-5


def test_mxu_simulation_on_card_matches_cpu(dev):
    """brute-pallas-mxu through K6 on the card against the plain twin on
    the CPU: a few steps, positions within the norm trick's rounding."""
    pos, vel, mass = self_gravitating_disc(1999, seed=1)
    kw = dict(engine="brute-pallas-mxu", dt=3e-2, g_soft=EPS)
    gpu = Simulation(pos, vel, mass, device="cuda", **kw)
    cpu = Simulation(pos, vel, mass, device="cpu", **kw)
    pw.reset_launch_counts()
    gpu.run(3)
    cpu.run(3)
    assert pw.launch_counts()["pairwise_acc_mxu"] == 3
    assert gpu.n_alive == cpu.n_alive
    assert np.abs(gpu.get_points()[0] - cpu.get_points()[0]).max() < 1e-4
    assert gpu.energy("exact") == pytest.approx(cpu.energy("exact"), rel=1e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_bh_potential_on_card_matches_cpu(dev, dtype):
    """The tree potential (plain torch, no kernel) on the card against the
    CPU: the same walk counters, U within f32 rounding of the rsqrt (float64
    to 1e-12); the call enqueues with no host sync, and two calls are
    bitwise equal."""
    from nbody_tpu_torch.core.energy import potential_energy_bh
    from nbody_tpu_torch.core.state import SimParams

    pos, vel, mass = self_gravitating_disc(20000, seed=5)
    out = {}
    for d in ("cpu", dev):
        st = ParticleState.create(pos, vel, mass, dtype=dtype, device=d)
        pr = SimParams.create(g_soft=EPS, theta2=1.0, dtype=dtype, device=d)
        cfg = tt.BHConfig.auto_for(st.capacity, multipole="mono",
                                   fb_cap=2048)
        args = (st.pos, st.effective_mass(), pr.bounds, pr.theta2, pr.g,
                pr.g_soft, cfg)
        if d == "cpu":
            out[d] = tt.bh_potential(*args)
            continue
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            u1, s1 = tt.bh_potential(*args)
            u2, _ = tt.bh_potential(*args)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        assert u1.is_cuda and torch.equal(u1, u2)
        assert float(potential_energy_bh(st, pr)) == float(u1)
        out[d] = (u1, s1)
    (uc, sc), (ug, sg) = out["cpu"], out[dev]
    for k in ("accept_dropped", "frontier_fallback", "near_fallback",
              "fb_spill"):
        assert int(sg[k]) == int(sc[k]), k
    rel = 1e-5 if dtype == torch.float32 else 1e-12
    assert float(ug) == pytest.approx(float(uc), rel=rel)


def test_step_comp_on_card_bitwise_equal_to_cpu(dev):
    """One compensated step under an elementwise force (no reduction): each
    operation rounds on its own on both devices, so every word is equal."""
    from nbody_tpu_torch.core.state import SimParams
    from nbody_tpu_torch.core.stepper import make_step_comp

    pos, vel, mass = self_gravitating_disc(5000, seed=2)
    rng = np.random.default_rng(3)
    lo = [rng.normal(size=(5120, 3)).astype(np.float32) * 1e-9
          for _ in range(2)]
    out = []
    for d in ("cpu", dev):
        st = ParticleState.create(pos, vel, mass, device=d)
        pr = SimParams.create(dt=3e-2, bounds_width=3.0, device=d)
        step = make_step_comp(lambda p, m, prm: -p)
        s1, l1 = step(st, tuple(torch.from_numpy(a).to(d) for a in lo), pr)
        out.append([t.cpu() for t in (s1.pos, s1.vel, s1.alive, *l1)])
    assert int(out[0][2].sum()) < 5001  # the narrow box culls some
    for a, b in zip(*out):
        assert torch.equal(a, b)


def _capture(monkeypatch, calls):
    """Record the (tgt8, slab) of every K3 and K4 wrapper call the walk
    makes, then launch as usual."""
    for name in ("group_force", "quad_force"):
        fn = getattr(gf, name)

        def spy(tgt8, slab, *a, _fn=fn, _name=name, **k):
            calls.append((_name, tgt8, slab, a, k))
            return _fn(tgt8, slab, *a, **k)

        monkeypatch.setattr(gf, name, spy)


def _kernels_match_twins(calls):
    """Each captured K3 / K4 call against its plain twin (1e-5, 5e-5)."""
    for name, tgt8, slab, a, k in calls:
        got = getattr(gf, name)(tgt8, slab, *a, **k)
        torch.cuda.synchronize()
        ref = getattr(gf, name + "_plain")(tgt8, slab, *a, **k)
        tol = 1e-5 if name == "group_force" else 5e-5
        assert _rel_err(got.reshape(-1, 3), ref.reshape(-1, 3)) < tol, name


def test_k3_k4_on_2d_slabs_match_plain(dev, monkeypatch):
    """A 2D state's quadtree walk hands K3 and K4 rows whose z column is
    all zero; each kernel agrees with its twin on them, and the card's
    forces with the CPU's on the alive rows (a dead row parked at the
    origin, beside the star, is not a force any step uses)."""
    from nbody_tpu_torch.core.state import SimParams
    from nbody_tpu_torch.scenes import disc_2d

    pos, vel, mass = disc_2d(6000, seed=1)
    # the d-form pair blocks on the CPU, as the kernels compute (the f32
    # norm trick rounds to ~1e-3 next to the star)
    cfg = tt.BHConfig(dim=2, max_level=6, group_size=512, subgroups=16,
                      window_pad=256, start_level=1, mxu_blocks=False)
    out = {}
    calls = []
    _capture(monkeypatch, calls)
    for d in ("cpu", dev):
        st = ParticleState.create(pos, vel, mass, device=d)
        p = SimParams.create(g_soft=EPS, theta2=0.5, bounds_center=(0.0, 0.0),
                             device=d)
        out[str(d)] = tt.bh_accel(st.pos, st.effective_mass(), p.bounds,
                                  p.theta2, p.g, p.g_soft, cfg)[0]
        alive = st.alive.cpu()
    card = [c for c in calls if c[1].is_cuda]
    assert {c[0] for c in card} == {"group_force", "quad_force"}
    for _name, tgt8, slab, _a, _k in card:
        assert float(tgt8[..., 2].abs().max()) == 0.0
        assert float(slab[..., 2].abs().max()) == 0.0
    monkeypatch.undo()
    _kernels_match_twins(card)
    assert out[str(dev)].shape == (6016, 2)
    assert _rel_err(out[str(dev)].cpu()[alive], out["cpu"][alive]) < 1e-5


def test_cached_slabs_and_forces_on_card(dev, monkeypatch):
    """Walk reuse on the card: at the positions of the full walk the cached
    call equals it (max row over mean row below 1e-6); the cached slabs
    hold zero-mass rows with stale particle ids, on which K3 and K4 agree
    with their twins."""
    from nbody_tpu_torch.core.state import SimParams
    from nbody_tpu_torch.ops import tree as ttree

    pos, vel, mass = self_gravitating_disc(20000, seed=3)
    st = ParticleState.create(pos, vel, mass, device=dev)
    p = SimParams.create(g_soft=EPS, theta2=1.0, bounds_center=(0.3, 0.0, 0.0),
                         device=dev)
    cfg = tt.BHConfig.auto_for(st.capacity)
    m = st.effective_mass()
    b0 = p.bounds.centered()
    tree = ttree.build_octree(st.pos - p.bounds.center, m, b0, cfg.max_level,
                              **tt._build_args(cfg))
    full, _, topo = tt.traverse_tree(tree, b0, p.theta2, p.g, p.g_soft, cfg,
                                     st.capacity, return_topo=True)
    calls = []
    _capture(monkeypatch, calls)
    fresh = ttree.refresh_octree(tree, st.pos - p.bounds.center, m,
                                 quad=True, quad_leaf=cfg.quad_leaf)
    cached, _ = tt.traverse_tree_cached(fresh, topo, p.theta2, p.g, p.g_soft,
                                        cfg, st.capacity)
    monkeypatch.undo()
    assert _rel_err(cached, full) < 1e-6
    k3 = [c for c in calls if c[0] == "group_force"]
    assert k3 and bool(((k3[0][2][..., 3] == 0)
                        & (k3[0][2][..., 4] != 0)).any())
    _kernels_match_twins(calls)


@pytest.mark.parametrize("dtype", [np.float32, np.float64],
                         ids=["float32", "float64"])
@pytest.mark.parametrize("k", [1, 3, 4])
@pytest.mark.parametrize("n", [1, 2, 1023, 1024, 1025, 100096, (1 << 20) + 3])
def test_prefix_kernel_against_exact_sums(dev, n, k, dtype):
    """The build's prefix table kernel: every partial within twice the
    twin's own error against the exact sums (or within the pair's unit of
    rounding where the twin comes out exact); row 0 and the padding
    columns zero; one wrapper launch counted."""
    v, s = prefix_case(n, k, dtype, seed=n + k)
    x = torch.from_numpy(v).to(dev)
    ps.reset_launch_counts()
    got = ps.prefix_table(x)
    torch.cuda.synchronize()
    assert ps.launch_counts() == {"prefix_table": 1}
    assert got.is_cuda and got.dtype == x.dtype and got.shape == (n + 1, 8)
    g = got.cpu().numpy()
    assert not g[0].any() and not g[:, 2 * k:].any()
    twin = exact_error(v, s, ps.prefix_table_plain(x).cpu().numpy())
    assert exact_error(v, s, g) <= 2 * max(twin, DF_UNIT[dtype])


def _disc_build(dev):
    """The 100k disc's ``bh`` build on ``dev`` at its ``auto_for`` tier:
    (pos, effective mass, bounds, max_level, build_octree's options)."""
    pos, m, _ = _disc(100000, 100096, 37, dev)
    cfg = tt.BHConfig.auto_for(100096)
    return (pos, m, Bounds.cube((0.0, 0.0, 0.0), 10.0, device=dev),
            cfg.max_level, tt._build_args(cfg))


_TREE_FIELDS = ("pos_s", "mass_s", "code_s", "order", "leaf_starts",
                "level_mass", "level_mpos", "level_table", "all_quad")


def _same(a, b):
    if isinstance(a, tuple):
        return len(a) == len(b) and all(map(torch.equal, a, b))
    return torch.equal(a, b)


def test_prefix_kernel_builds_are_bitwise_repeatable(dev):
    """Two builds of the 100k disc on the card are bitwise equal, and a
    refresh at the build's positions equals the build, all enqueued with no
    host sync."""
    pos, m, b, level, kw = _disc_build(dev)
    ttree.build_octree(pos, m, b, level, **kw)  # builds the kernels
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        t1 = ttree.build_octree(pos, m, b, level, **kw)
        t2 = ttree.build_octree(pos, m, b, level, **kw)
        fresh = ttree.refresh_octree(t1, pos, m, quad_leaf=kw["quad_leaf"])
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert t1.all_quad is not None
    for name in _TREE_FIELDS:
        assert _same(getattr(t1, name), getattr(t2, name)), name
        assert _same(getattr(fresh, name), getattr(t1, name)), name


def test_prefix_kernel_tree_matches_cpu(dev):
    """The 100k disc's tree on the card against its CPU tree (the twin's
    tables): the integers exact, the statistics within
    tests/test_torch_tree.py's per-cell f32 tolerance (1e-6 of the mass,
    of mass x half-width for the position sums and of mass x half-width^2
    for the second moments)."""
    pos, m, b, level, kw = _disc_build(dev)
    gpu = ttree.build_octree(pos, m, b, level, **kw)
    cpu = ttree.build_octree(pos.cpu(), m.cpu(),
                             Bounds.cube((0.0, 0.0, 0.0), 10.0, device="cpu"),
                             level, **kw)
    rtol, half = 1e-6, 5.0
    for name in ("order", "code_s", "leaf_starts"):
        assert torch.equal(getattr(gpu, name).cpu(), getattr(cpu, name)), name
    for g, c in zip(gpu.level_table, cpu.level_table):
        assert torch.equal(g[:, 4:].cpu(), c[:, 4:])
    for gm, cm, gp, cp in zip(gpu.level_mass, cpu.level_mass,
                              gpu.level_mpos, cpu.level_mpos):
        cm64 = cm.double()
        assert bool(((gm.cpu().double() - cm64).abs() <= rtol * cm64).all())
        d = (gp.cpu().double() - cp.double()).abs()
        assert bool((d <= rtol * half * cm64[:, None]).all())
    levels = gpu.all_quad.shape[0]
    m_all = torch.cat([c.double() for c in cpu.level_mass])[:levels]
    d = (gpu.all_quad.cpu().double() - cpu.all_quad.double()).abs()
    assert bool((d <= rtol * half * half * m_all[:, None]).all())


def test_prefix_table_launches_per_bh_step(dev):
    """A bh step of the 100k disc takes its three prefix tables (the leaf
    stats and the two second-moment halves) from the kernel: three wrapper
    launches a step."""
    pos, vel, mass = self_gravitating_disc(100000, seed=0)
    sim = Simulation(pos, vel, mass, engine="bh", device="cuda")
    sim.run(1)
    ps.reset_launch_counts()
    sim.run(2)
    torch.cuda.synchronize()
    assert ps.launch_counts() == {"prefix_table": 6}


@pytest.mark.parametrize("name", walk_cases.CASES)
def test_walk_kernel_matches_twin(dev, name):
    """The collect walk kernel against its plain twin on the card, bit for
    bit: every slab row, list, counter, offset, the diff array, the window
    mask, the frame and, with refined levels, the boxes and descend list
    (tests/torch_walk_cases.py: the 100k disc at auto_for(100001), profile
    'domain' at 2^18 rows with the wide rows, accept_offset and the
    rank's slab, and with the slab narrowed so cells take the far
    budgets; a 2D state's group slice with the sliding window, a 2D
    float64 walk with accept_offset and delta_onepass, the adaptive
    stack's hand-off, and budgets cut so every counter fires).  Two
    launches are bitwise equal and enqueue with no host sync."""
    args = walk_cases.case(name, dev, card=True)
    twin = tt._collect_dense(*args)
    cw.group_collect(*args)  # builds the kernels
    torch.cuda.synchronize()
    cw.reset_launch_counts()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = cw.group_collect(*args)
        again = cw.group_collect(*args)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert cw.launch_counts() == {"group_collect": 2}
    assert walk_cases.mismatches(got, twin, args[5]) == []
    assert walk_cases.mismatches(again, got, args[5]) == []
    if name == "budgets":
        assert all(int(twin[k].sum()) > 0 for k in walk_cases.COUNTERS)
    if name == "domain-far":
        assert bool(got["far_valid"].any())
    if name == "refined":
        assert bool(got["rvalid"].any()) and "wmask" not in got


def test_walk_kernel_refined_handoff_on_card(dev):
    """The adaptive stack's whole walk on the card (the kernel's dense
    levels, then the plain refined loop) equals the plain twin's dense and
    refined levels on the card, output for output."""
    args = walk_cases.case("refined", dev, card=True)
    tree, n_total, width, thr, cfg, W, gpos, gmass, gidx = args[:9]
    ref = tt._collect_finish(
        tt._collect_refined(tree, tt._collect_dense(*args),
                            cfg.cell_w2s(width), thr, cfg, W), cfg, W)
    cw.reset_launch_counts()
    got = tt._group_collect(tree, n_total, width, 1.0, cfg, W, gpos, gmass,
                            gidx)
    assert cw.launch_counts() == {"group_collect": 1}
    assert sorted(got) == sorted(ref)
    for k in ref:
        assert torch.equal(got[k], ref[k]), k


def test_walk_kernel_launches_per_bh_step(dev):
    """A bh step of the 100k disc walks once, through the kernel: one
    launch a step; a force call with the twin swapped in walks the same,
    output for output, and gives the same forces (the benchmark's
    softening and step: the defaults' eps = 0 lets close pairs blow up)."""
    pos, vel, mass = self_gravitating_disc(100000, seed=0)
    sim = Simulation(pos, vel, mass, engine="bh", device="cuda", dt=3e-2,
                     g_soft=EPS)
    sim.run(1)
    cw.reset_launch_counts()
    sim.run(2)
    torch.cuda.synchronize()
    assert cw.launch_counts() == {"group_collect": 2}
    walks, accs = [], []
    real_walk, real_kernel = tt._group_collect, cw.group_collect

    def spy(*a, **k):
        walks.append(real_walk(*a, **k))
        return walks[-1]

    try:
        tt._group_collect = spy
        for dense in (real_kernel, tt._collect_dense):
            cw.group_collect = dense
            sim.update_forces()
            accs.append(sim.state.acc.clone())
    finally:
        tt._group_collect, cw.group_collect = real_walk, real_kernel
    kernel, twin = walks
    assert sorted(kernel) == sorted(twin)
    assert [k for k in twin if not torch.equal(kernel[k], twin[k])] == []
    assert bool(torch.isfinite(accs[0]).all())
    assert torch.equal(accs[0], accs[1])
