"""The collect walk's inputs for the tests of its kernel against its plain
twin (``ops/traversal.py`` ``_collect_dense``): the CPU tests hold the
kernel's packed arguments through ``tests/torch_collect_emulator.py``,
the card tests (``tests/test_torch_cuda.py``, which must not import jax)
the kernel itself.  Each case builds the walk's arguments on a device,
small for the CPU and at the main paths' shapes for the card."""

import contextlib

import numpy as np
import torch

from nbody_tpu_torch.core.state import Bounds
from nbody_tpu_torch.ops import traversal as tt
from nbody_tpu_torch.ops import tree as ttree
from nbody_tpu_torch.parallel import domain
from nbody_tpu_torch.parallel.mesh import Mesh
from nbody_tpu_torch.scenes import self_gravitating_disc
from nbody_tpu_torch.scenes.extras import disc_2d

#: the walk's four counters
COUNTERS = ("accept_dropped", "frontier_fallback", "near_fallback",
            "fb_spill")


def walk_args(pos, mass, cfg, dev, dtype=torch.float32, theta2=1.0,
              groups=None, width=10.0):
    """The dense walk's arguments for the scene (pos [N, dim], mass [N],
    numpy) as ``traversal._walk`` makes them, on ``dev``.  ``groups``
    walks a slice of the groups, as a shard does."""
    pos = torch.as_tensor(np.asarray(pos)[:, :cfg.dim], dtype=dtype,
                          device=dev)
    mass = torch.as_tensor(np.asarray(mass), dtype=dtype, device=dev)
    b = Bounds.cube([0.0] * cfg.dim, width, dtype=dtype, device=dev)
    tree = ttree.build_octree(pos, mass, b, cfg.max_level,
                              **tt._build_args(cfg), **tt._refine_args(cfg))
    _eps2, pmass8, tgt8, gidx, W = tt._pack(tree, 0.02, cfg, pos.shape[0])
    if groups is not None:
        tgt8, gidx = tgt8[groups], gidx[groups]
    thr = tt._scalar(cfg.accept_margin, pos) * tt._scalar(theta2, pos)
    grid = ttree.grid_bounds(b, cfg.max_level) if cfg.accept_offset else None
    return (tree, pmass8.shape[0], b.width, thr, cfg, W, tgt8[..., :3],
            tgt8[..., 3], gidx, tt._sliding_ok(cfg, W), None, grid)


class _Captured(Exception):
    pass


@contextlib.contextmanager
def _wide_n(n):
    old = ttree.WIDE_N
    ttree.WIDE_N = n
    try:
        yield
    finally:
        ttree.WIDE_N = old


def domain_args(n_loc, cfg, dev, local=None):
    """The walk's arguments inside ``domain_accel`` at world size 1 with
    the wide rows forced on (``WIDE_N`` lowered), on the disc of
    ``n_loc`` rows (n_loc - 1 + the star); ``local`` replaces the rank's
    slab (lo, hi), so that cells outside it take the far budgets."""
    pos, _vel, mass = self_gravitating_disc(n_loc - 1, seed=2)
    pos = torch.as_tensor(pos, dtype=torch.float32, device=dev)
    mass = torch.as_tensor(mass, dtype=torch.float32, device=dev)
    b = Bounds.cube((0.0, 0.0, 0.0), 10.0, device=dev)
    got = []

    def spy(*a, **k):
        got.append((a, k))
        raise _Captured

    real = domain._group_collect
    domain._group_collect = spy
    try:
        with _wide_n(1):
            domain.domain_accel(pos, mass, b, 1.0, 1.0, 0.02, cfg,
                                Mesh(rank=0, world=1, group=None, device=dev))
    except _Captured:
        pass
    finally:
        domain._group_collect = real
    (tree, n_tot, width, theta2, cfg_w, window, gpos, gmass, gidx), k = got[0]
    assert cfg_w.wide
    thr = tt._scalar(cfg_w.accept_margin, gpos) * tt._scalar(theta2, gpos)
    return (tree, n_tot, width, thr, cfg_w, window, gpos, gmass, gidx, False,
            local or k["local_bounds"], k["grid"])


def _disc(n, seed=0):
    pos, _vel, mass = self_gravitating_disc(n - 1, seed=seed)
    return pos, mass


def _clustered(n, seed=0):
    """Half a tight core, half uniform (tests/test_refine.py's scene)."""
    rng = np.random.default_rng(seed)
    pos = np.concatenate([rng.normal(0, 0.03, (n // 2, 3)),
                          rng.uniform(-4, 4, (n // 2, 3))])
    return pos, np.full((n,), 1.0 / n)


def case(name, dev, card=False):
    """The named case's ``_collect_dense`` arguments on ``dev``; ``card``
    takes the main paths' shapes."""
    if name == "100k":
        n = 100001 if card else 40001
        return walk_args(*_disc(n), tt.BHConfig.auto_for(n), dev)
    if name in ("domain", "domain-far"):
        n = 1 << 18 if card else 1 << 15
        over = {} if card else dict(
            max_level=6, group_size=4096, subgroups=64, window_pad=2048,
            near_particle_cap=4096, far_particle_cap=2048,
            near_cell_cap=256, far_cell_cap=128)
        cfg = tt.BHConfig.auto_for(n, profile="domain", **over)
        local = (n // 4, 3 * n // 4) if name == "domain-far" else None
        return domain_args(n, cfg, dev, local)
    if name == "2d-sharded":
        n = 1 << 18 if card else 1 << 15
        pos, _vel, mass = disc_2d(n - 1, seed=1)
        cfg = tt.BHConfig.auto_for(n, dim=2, sliding_window=True)
        G = n // cfg.group_size
        return walk_args(pos, mass, cfg, dev, groups=slice(G // 4, G // 2))
    if name == "2d-offset-f64":
        n = 1 << 16 if card else 1 << 14
        pos, _vel, mass = disc_2d(n - 1, seed=3)
        cfg = tt.BHConfig.auto_for(n, dim=2, accept_offset=True,
                                   delta_onepass=True)
        return walk_args(pos, mass, cfg, dev, dtype=torch.float64,
                         theta2=0.49)
    if name == "refined":
        n = 1 << 17 if card else 1 << 13
        over = {} if card else dict(group_size=1024, subgroups=32,
                                    window_pad=256, frontier_cap=2048,
                                    refine_frontier=512, max_level=4,
                                    refine_levels=2)
        cfg = tt.BHConfig.auto_for(n, profile="adaptive", **over)
        return walk_args(*_clustered(n), cfg, dev)
    if name == "budgets":
        # every budget cut: frontier and near fallbacks, fb spill, accept
        # drops
        n = 100001 if card else 20001
        cfg = tt.BHConfig.auto_for(n, frontier_cap=512, near_cell_cap=64,
                                   near_particle_cap=512, fb_cap=16,
                                   accept_cap=256)
        return walk_args(*_disc(n), cfg, dev)
    raise KeyError(name)


CASES = ("100k", "domain", "domain-far", "2d-sharded", "2d-offset-f64",
         "refined", "budgets")


def mismatches(state, twin, window) -> list:
    """The keys of a kernel walk state that differ from the twin's (the
    slabs without their trash rows; the window mask against the prefix of
    the twin's diff array)."""
    bad = []
    for k, v in state.items():
        if k == "wmask":
            r = torch.cumsum(twin["delta"], dim=1)[:, :window] > 0
        else:
            r = twin[k]
        if k in ("mono", "fb"):
            v, r = v[:, :-1], r[:, :-1]
        if v.shape != r.shape or v.dtype != r.dtype or not torch.equal(v, r):
            bad.append(k)
    return bad
