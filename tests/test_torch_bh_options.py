"""The Barnes-Hut options off the default path, held against the JAX
package on the seeded disc of ``tests/test_torch_traversal.py``:
``quad_leaf`` (leaf-level quadrupoles), ``fb_quad`` (self-excluded
quadrupoles on the fallback rows), ``delta_onepass`` (every level's window
coverage in one scatter-add) and ``sliding_window`` (the gather-free window
assembly with unclamped window starts).

Walk counters are exact, float64 forces agree to 1e-10 of the largest row,
``delta_onepass`` leaves every integer of the walk as it was, and sliding
windows change nothing but the first and the last group."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nbody_tpu.core.state import Bounds as JaxBounds
from nbody_tpu.ops import traversal as jt
from nbody_tpu_torch.core.state import Bounds
from nbody_tpu_torch.ops import traversal as tt
from nbody_tpu_torch.ops import tree as ttree
from test_torch_traversal import BASE, CASES, _inputs

STATS = ("accept_dropped", "frontier_fallback", "near_fallback", "fb_spill")
BUDGETS = CASES["budgets"]  # fallback rows and spills on every path
SLIDE = dict(BASE, window_pad=128, chunk_groups=2)  # W = B + 2 pad


def _jax(over, dtype="float64"):
    pos, mass = _inputs(dtype)
    jd = getattr(jnp, dtype)
    acc, stats = jt.bh_accel(
        jnp.asarray(pos), jnp.asarray(mass),
        JaxBounds.cube([0.0, 0.0, 0.0], 10.0, dtype=jd), jnp.asarray(1.0, jd),
        jnp.asarray(1.0, jd), jnp.asarray(0.02, jd),
        jt.BHConfig(eval_mode="xla", **over))
    return np.asarray(acc), {k: float(stats[k])
                             for k in STATS + ("window_cov",)}


def _port(over, dtype="float64", **kw):
    pos, mass = _inputs(dtype)
    td = getattr(torch, dtype)
    acc, stats = tt.bh_accel(
        torch.from_numpy(pos), torch.from_numpy(mass),
        Bounds.cube([0.0, 0.0, 0.0], 10.0, dtype=td, device="cpu"), 1.0, 1.0,
        float(torch.tensor(0.02, dtype=td)), tt.BHConfig(**over), **kw)
    return acc.numpy(), {k: float(stats[k]) for k in STATS + ("window_cov",)}


def _close(got, ref, tol=1e-10):
    np.testing.assert_allclose(got, ref, rtol=0, atol=tol * np.abs(ref).max())


@pytest.mark.parametrize("over", [
    dict(quad_leaf=True), dict(quad_leaf=True, fb_quad=True),
    dict(BUDGETS, quad_leaf=True), dict(BUDGETS, quad_leaf=True,
                                        fb_quad=True)],
    ids=["quad_leaf", "fb_quad", "budgets-quad_leaf", "budgets-fb_quad"])
def test_quad_options_match_jax_f64(over):
    """Leaf quadrupoles on the accepted slab and, with fb_quad, on the
    self-excluded fallback rows: the walk is the default one (same
    counters) and the forces are JAX's to 1e-10."""
    over = dict(BASE, **over)
    ref, rstats = _jax(over)
    got, stats = _port(over)
    assert stats == rstats
    if "fb_cap" in over:
        assert min(stats[k] for k in STATS[1:]) > 0
    _close(got, ref)


def test_fb_quad_moves_the_fallback_term():
    """fb_quad adds the fallback rows' quadrupoles: under starved budgets
    (many fallback rows) the forces move, in both packages alike (above)."""
    plain, _ = _port(dict(BUDGETS, quad_leaf=True))
    fbq, _ = _port(dict(BUDGETS, quad_leaf=True, fb_quad=True))
    assert np.abs(fbq - plain).max() > 1e-8 * np.abs(plain).max()


@pytest.mark.parametrize("case", ["quad", "budgets", "dual-quad"])
def test_delta_onepass_integers_unchanged(case):
    """One scatter-add of every level's coverage updates gives the same
    window mask, integer for integer, so the forces are bitwise the
    default's; the window coverage and the counters equal JAX's."""
    base = CASES[case]
    pos, mass = _inputs("float64")
    tree = ttree.build_octree(torch.from_numpy(pos), torch.from_numpy(mass),
                              Bounds.cube([0.0, 0.0, 0.0], 10.0,
                                          dtype=torch.float64, device="cpu"),
                              base["max_level"], quad=True)
    b0 = Bounds.cube([0.0, 0.0, 0.0], 10.0, dtype=torch.float64,
                     device="cpu")
    walks = [tt._walk(tree, b0, 1.0, 0.02, tt.BHConfig(**base,
                                                       delta_onepass=on),
                      pos.shape[0])[-1] for on in (False, True)]
    for k in ("wmask", "wstart", "near_ids", "near_valid", "mono", "fb"):
        assert torch.equal(walks[0][k], walks[1][k]), k
    a, astats = _port(dict(base, delta_onepass=True))
    b, _ = _port(base)
    np.testing.assert_array_equal(a, b)
    ref, rstats = _jax(dict(base, delta_onepass=True))
    assert astats == rstats
    _close(a, ref)


def test_sliding_ok_gates_match_jax():
    W = SLIDE["group_size"] + 2 * SLIDE["window_pad"]
    cases = [(dict(SLIDE, sliding_window=True), W),
             (dict(SLIDE, sliding_window=True), W - 128),
             (dict(SLIDE, sliding_window=True, window_pad=640), 512 + 1280),
             (dict(SLIDE, sliding_window=True, near_sym=True), W),
             (dict(SLIDE), W)]
    got = [tt._sliding_ok(tt.BHConfig(**c), w) for c, w in cases]
    assert got == [jt._sliding_ok(jt.BHConfig(**c), w) for c, w in cases]
    assert got == [True, False, False, False, False]


def test_sliding_window_rows_are_padded_slices():
    """The shifted-reshape window equals each group's slice of the rows
    padded with zeros on both ends, bitwise, masses masked."""
    rng = np.random.default_rng(7)
    B, p, G = 256, 64, 5
    W = B + 2 * p
    cfg = tt.BHConfig(group_size=B, window_pad=p, subgroups=16,
                      sliding_window=True)
    pmass8 = rng.normal(size=(B * G, 8)).astype(np.float32)
    wmask = rng.random((G, W)) < 0.7
    wstart = np.arange(G, dtype=np.int32) * B - p
    got = tt._window_rows(torch.from_numpy(pmass8), torch.from_numpy(wstart),
                          torch.from_numpy(wmask), W, cfg, sliding=True)
    padded = np.concatenate([np.zeros((p, 8), np.float32), pmass8,
                             np.zeros((p, 8), np.float32)])
    want = np.stack([padded[g * B: g * B + W] for g in range(G)])
    want[:, :, 3] = np.where(wmask, want[:, :, 3], 0.0)
    np.testing.assert_array_equal(got.numpy(), want)


def test_sliding_window_matches_jax_interior_bitwise():
    """Sliding windows: JAX's forces to 1e-10 and counters exactly; against
    the clamped window, every particle outside the first and the last
    sorted group bitwise equal, the boundary groups inside the walk's
    envelope (their clamp-only cells re-enter the walk)."""
    on = dict(SLIDE, sliding_window=True)
    ref, rstats = _jax(on)
    got, stats = _port(on)
    assert stats == rstats
    _close(got, ref)
    off, _ = _port(SLIDE)
    pos, mass = _inputs("float64")
    order = ttree.build_octree(
        torch.from_numpy(pos), torch.from_numpy(mass),
        Bounds.cube([0.0, 0.0, 0.0], 10.0, dtype=torch.float64,
                    device="cpu"), SLIDE["max_level"]).order.numpy()
    B = SLIDE["group_size"]
    edge = np.zeros(len(order), bool)
    edge[order[:B]] = edge[order[-B:]] = True
    np.testing.assert_array_equal(got[~edge], off[~edge])
    err = np.linalg.norm(got - off, axis=1) / (np.linalg.norm(off, axis=1)
                                               + 1e-12)
    assert np.quantile(err, 0.99) < 5e-2


def test_sliding_window_potential_matches_jax():
    """The potential's walk and window assembly slide too."""
    pos, mass = _inputs("float64")
    cfg = dict(SLIDE, sliding_window=True)
    want, _ = jt.bh_potential(
        jnp.asarray(pos), jnp.asarray(mass),
        JaxBounds.cube([0.0, 0.0, 0.0], 10.0, dtype=jnp.float64), 1.0, 1.0,
        0.02, jt.BHConfig(eval_mode="xla", **cfg))
    got, _ = tt.bh_potential(
        torch.from_numpy(pos), torch.from_numpy(mass),
        Bounds.cube([0.0, 0.0, 0.0], 10.0, dtype=torch.float64,
                    device="cpu"), 1.0, 1.0, 0.02, tt.BHConfig(**cfg))
    assert abs(float(got) - float(want)) <= 1e-10 * abs(float(want))


def test_kernel_mode_glue_takes_the_options(monkeypatch):
    """The kernel path's glue (K3 and K4 wrappers forced on CPU tensors run
    their plain twins) under quad_leaf + fb_quad and sliding windows
    agrees with the plain eval in f32."""
    over = dict(BUDGETS, quad_leaf=True, fb_quad=True, mxu_blocks=False)
    slide = dict(SLIDE, sliding_window=True, mxu_blocks=False)
    refs = [_port(o, "float32")[0] for o in (over, slide)]
    monkeypatch.setattr(tt, "_resolve_eval_mode", lambda cfg, t: "pallas")
    for o, ref in zip((over, slide), refs):
        got, _ = _port(o, "float32")
        scale = np.linalg.norm(ref, axis=1).mean()
        assert np.linalg.norm(got - ref, axis=1).max() / scale < 1e-5


def test_options_keep_the_config_jax_builds():
    for over in (dict(quad_leaf=True, fb_quad=True), dict(delta_onepass=True),
                 dict(sliding_window=True), dict(dim=2)):
        assert dataclasses.asdict(tt.BHConfig(**over)) == dataclasses.asdict(
            jt.BHConfig(**over))
