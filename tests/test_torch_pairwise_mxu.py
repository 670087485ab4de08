"""The plain torch twin of kernel K6 (the norm-trick all-pairs sum of the
``brute-pallas-mxu`` engine) against the JAX package's Pallas kernel
``pairwise_acc_pallas_mxu`` run in interpret mode, on the Morton-sorted
disc; the engine's sort order against JAX's; the engine through
``Simulation`` against the JAX package's; and what the wrapper refuses.
The CUDA kernel is held against this twin on the card (chip_smoke.py,
tests/test_torch_cuda.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nbody_tpu
from nbody_tpu.engines import Engine as JaxEngine
from nbody_tpu.ops import morton as jax_morton
from nbody_tpu.ops.pairwise import pairwise_acc_pallas_mxu
from nbody_tpu.ops.tree import grid_bounds as jax_grid_bounds
from nbody_tpu_torch import Simulation
from nbody_tpu_torch.core.state import SimParams
from nbody_tpu_torch.ops import pairwise as pw
from nbody_tpu_torch.scenes import self_gravitating_disc
from torch_parity import G, EPS, disc


def jax_order(pos, mass, bounds):
    """The JAX engine's sort (nbody_tpu/ops/pairwise.py:514-526)."""
    codes = jax_morton.cell_codes(pos, jax_grid_bounds(bounds, 10), 10)
    return jnp.argsort(jnp.where(mass > 0, codes, jnp.int32(1 << 30)))


def port_order(pos, mass):
    """The engine's own sort, on the bounds of ``disc``'s parameters."""
    return pw.mxu_order(pos, mass, SimParams.create(bounds_width=10.0,
                                                    device="cpu").bounds)


@pytest.mark.parametrize("kill", [0, 37])
def test_mxu_order_matches_jax(kill):
    """The order ``brute-pallas-mxu`` hands to K6 is JAX's, index for
    index, with the dead rows last."""
    st, params, pos, mass, _ = disc(2047, 2048, kill)
    order = port_order(pos, mass)
    assert np.array_equal(order.numpy(), np.asarray(
        jax_order(st.pos, st.effective_mass(), params.bounds)))
    assert bool((mass[order][2048 - kill:] == 0).all())
    assert bool((mass[order][:2048 - kill] > 0).all())


def sorted_disc(kill):
    """The disc of 2047 + the star at capacity 2048, Morton-sorted by the
    engine's own ``mxu_order``."""
    _, _, pos, mass, _ = disc(2047, 2048, kill)
    order = port_order(pos, mass)
    return pos[order].contiguous(), mass[order].contiguous()


def truth(pos, mass):
    """The float64 direct sum."""
    p, m = pos.double(), mass.double()
    d = p[None, :, :] - p[:, None, :]
    r2 = (d * d).sum(-1) + np.float64(np.float32(EPS)) ** 2
    return (G * ((m / r2 ** 1.5)[..., None] * d).sum(1)).numpy()


def row_err(got, ref):
    """|d| / max(|ref|, median |ref|) per row (the bench's force error)."""
    rn = np.linalg.norm(ref, axis=1)
    return np.linalg.norm(np.asarray(got, np.float64) - ref, axis=1) \
        / np.maximum(rn, np.median(rn))


@pytest.mark.parametrize("kill", [0, 37])
@pytest.mark.parametrize("tiles", [(128, 128), (512, 1024)])
def test_k6_plain_matches_pallas(tiles, kill):
    """Both sides carry the norm trick's rounding, which the cancellation
    in r^2 magnifies up to ~1e-2 in the worst row of this small disc (its
    tiles are wide, so |p - c| is large), each in its own way: the twin
    must be as accurate as the JAX kernel against the float64 truth (the
    median and p90 of the row error within 1.5x of the kernel's, measured
    1.0-1.14x; p99 and the worst row, which rest on ~20 rows and one,
    within 2.5x, measured 0.93-1.69x), and close to it row by row (median
    6e-7 to 4e-6 measured)."""
    pos, mass = sorted_disc(kill)
    ti, tj = tiles
    ref = np.asarray(pairwise_acc_pallas_mxu(
        jnp.asarray(pos.numpy()), jnp.asarray(mass.numpy()), jnp.float32(G),
        jnp.float32(EPS), tile_i=ti, tile_j=tj, interpret=True))
    got = pw.pairwise_acc_mxu(pos, mass, G, EPS, tile_i=ti, tile_j=tj).numpy()
    exact = truth(pos, mass)
    e_ref, e_got = row_err(ref, exact), row_err(got, exact)
    for q, k in ((50, 1.5), (90, 1.5), (99, 2.5), (100, 2.5)):
        assert np.percentile(e_got, q) <= k * np.percentile(e_ref, q) + 1e-7
    assert float(np.median(row_err(got, ref))) < 2e-5


def test_k6_plain_is_the_direct_sum_up_to_the_norm_trick():
    """Against the d-form direct sum (K1/K2's twin) on the same input."""
    pos, mass = sorted_disc(0)
    e = row_err(pw.pairwise_acc_mxu(pos, mass, G, EPS).numpy(),
                truth(pos, mass))
    assert np.median(e) < 1e-4 and e.max() < 2e-2


def test_mxu_tiles_shrink_rule():
    assert pw.mxu_tiles(2048) == (512, 1024)
    assert pw.mxu_tiles(65536) == (512, 1024)
    assert pw.mxu_tiles(384) == (128, 128)
    assert pw.mxu_tiles(100) == (100, 100)
    assert pw.mxu_tiles(6144) == (512, 1024)


@pytest.mark.parametrize("n,tiles,launch", [
    (65536, (512, 1024), (128, 16)),  # the main path: 128 blocks x 16
    (2048, (512, 1024), (128, 2)),
    (1024, (512, 1024), (128, 1)),
    (32768, (512, 1024), (128, 32)),
    (8192, (512, 128), (128, 64)),
    (4096, (64, 1024), (16, 4)),
    (384, (128, 128), (32, 3)),
    (100, (100, 100), (128, 1))])
def test_mxu_launch(n, tiles, launch):
    """K6's launch on the card: threads a block (4 targets each, every
    block's rows in one target tile) and source splits (whole source
    tiles, dividing their number, ~2048 blocks in all)."""
    ti, tj = pw.mxu_tiles(n, *tiles)
    threads, splits = pw.mxu_launch(n, ti, tj)
    assert (threads, splits) == launch
    rows = 4 * threads
    assert ti == n or ti % rows == 0
    assert (n // tj) % splits == 0


def test_mxu_launch_refuses_what_the_kernel_does_not_take():
    with pytest.raises(ValueError, match="multiple of 128"):
        pw.mxu_launch(4096, 512, 64)
    with pytest.raises(ValueError, match="multiple of 4"):
        pw.mxu_launch(4096, 2, 1024)


@pytest.mark.parametrize("n", [300, 2050])
def test_k6_refuses_ragged_n(n):
    """Above 128 rows an N that is not a multiple of 128 would leave the
    JAX kernel's last rows unwritten (ROADMAP.md queue 3); the port
    raises."""
    pos = torch.zeros((n, 3))
    with pytest.raises(ValueError, match="divisible"):
        pw.pairwise_acc_mxu(pos, torch.ones(n), G, EPS)


def test_k6_refuses_2d():
    with pytest.raises(ValueError, match="3D"):
        pw.pairwise_acc_mxu(torch.zeros((256, 2)), torch.ones(256), G, EPS)
    sim = Simulation(np.zeros((50, 2)), np.zeros((50, 2)), np.ones(50),
                     engine="brute-pallas-mxu", bounds_center=(0.0, 0.0),
                     device="cpu")
    with pytest.raises(ValueError, match="3D"):
        sim.run(1)


def _jax_force_mxu(pos, mass, params):
    """The JAX engine's force with its kernel in interpret mode."""
    order = jax_order(pos, mass, params.bounds)
    acc_s = pairwise_acc_pallas_mxu(pos[order], mass[order], params.g,
                                    params.g_soft, interpret=True)
    return jnp.zeros_like(acc_s).at[order].set(acc_s)


def test_mxu_simulation_matches_jax():
    """A few steps of ``brute-pallas-mxu`` through the port's Simulation
    against the JAX package's (its kernel in interpret mode, under a name
    with "pallas" so both pad the capacity to 2048), with one particle
    removed and so one dead row in the sort.  The two carry the norm
    trick's rounding each in its own way, so each is held against the
    direct sum (``brute-pallas``, the d-form): the port must stay as close
    to it as JAX does (within 2.5x, as the worst rows above), and its
    energy must equal JAX's."""
    pos, vel, mass = self_gravitating_disc(999, seed=4)
    kw = dict(dt=3e-2, g_soft=EPS, theta2=1.0)
    ref = nbody_tpu.Simulation(
        pos, vel, mass, engine=JaxEngine(name="brute-pallas-mxu-interp",
                                         force=_jax_force_mxu),
        dtype=jnp.float32, **kw)
    sim = Simulation(pos, vel, mass, engine="brute-pallas-mxu", device="cpu",
                     **kw)
    exact = Simulation(pos, vel, mass, engine="brute-pallas", device="cpu",
                       **kw)
    assert sim.state.capacity == ref.state.capacity == 2048
    for s in (ref, sim, exact):
        s.remove_point(5)
        s.run(3)
    assert sim.n_alive == ref.n_alive == 999
    assert sim.energy(method="exact") == pytest.approx(
        ref.energy(method="exact"), rel=1e-5)
    for a, b, c in zip(sim.get_points(), ref.get_points(),
                       exact.get_points()):
        d_port = np.abs(a - c).max()
        d_jax = np.abs(np.asarray(b) - c).max()
        assert d_port <= 2.5 * d_jax + 1e-7
