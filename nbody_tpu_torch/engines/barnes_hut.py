"""Barnes-Hut octree engines (the counterpart of
``nbody_tpu/engines/barnes_hut.py``): a Morton-sorted dense level pyramid
and a vectorized group walk (``ops/tree.py``, ``ops/traversal.py``), whose
interaction sums run in the CUDA kernels K3 and K4 on the card (and K5 for
each group's own square with ``near_sym=True``).

Engine names:
  * ``bh``      -- leaf grid of depth 7 (the flagship engine)
  * ``bh-deep`` -- leaf grid of depth 8
  * ``bh-lazy`` -- the carried tree's binning refreshed each step, rebuilt
    when too many particles left their cells (stateful)

Options (``engine_options``): any ``BHConfig`` field, plus ``profile``
('fast', 'accurate', 'dense', 'adaptive': the deep refined stack,
``ADAPTIVE_OVERRIDES``, or 'domain': ``DOMAIN_OVERRIDES``, whose fields
the caller's override).
``near_sym=True`` evaluates each group's own square once per unordered pair
(the same force set, another summation order).  ``walk_every=K > 1`` makes
``bh`` stateful: the collect walk runs every K steps (and when more than
``walk_rebuild_frac`` of the particles left their cells), the frozen
topology is evaluated at the current positions in between.  Without
group_size / subgroups / chunk_groups the config follows the state's
capacity (``BHConfig.auto_for``), and ``dim`` follows the state (2D states
walk a quadtree).  The opening angle theta^2 stays a runtime setting
(``SimParams.theta2``).

The JAX package measured walk reuse a win only at N <= 64k and ``bh-lazy``
slower than ``bh`` everywhere, both on a TPU v5e; on the card they are
measured apart (PERF.md).
"""

from __future__ import annotations

import dataclasses

from nbody_tpu_torch.engines import Engine
from nbody_tpu_torch.ops.traversal import (
    ADAPTIVE_OVERRIDES,
    DENSE_OVERRIDES,
    DOMAIN_OVERRIDES,
    PROFILES,
    BHConfig,
    _build_args,
    _refine_args,
    bh_accel,
    bh_accel_lazy,
    bh_accel_reuse,
    empty_topo,
)
from nbody_tpu_torch.ops.tree import build_octree, tree_boxes
from nbody_tpu_torch.utils.profiling import annotate


def _fitter(options: dict):
    """``fit(pos) -> BHConfig``: the capacity-adaptive preset unless the
    caller sized the groups, with ``dim`` taken from the state."""
    cfg = BHConfig(**options)
    auto_group = not any(
        k in options for k in ("group_size", "subgroups", "chunk_groups"))

    def fit(pos):
        c = BHConfig.auto_for(pos.shape[0], **options) if auto_group else cfg
        d = pos.shape[1]
        return c if d == c.dim else dataclasses.replace(c, dim=d)

    return cfg, fit


def _initial_tree(pos, mass, params, c: BHConfig):
    """The carried tree of a stateful engine, built in the grid frame
    (``pos - bounds.center``), the frame the force calls walk in."""
    return build_octree(pos - params.bounds.center, mass,
                        params.bounds.centered(), c.max_level,
                        **_build_args(c))


def make_bh_engine(name: str = "bh", **options) -> Engine:
    profile = options.pop("profile", "fast")
    if profile not in PROFILES:
        raise ValueError(f"profile must be one of {PROFILES}, got "
                         f"{profile!r}")
    if profile == "accurate":
        options.setdefault("window_pad", 2048)
    elif profile != "fast":
        stack = {"dense": DENSE_OVERRIDES, "adaptive": ADAPTIVE_OVERRIDES,
                 "domain": DOMAIN_OVERRIDES}[profile]
        for k, v in stack.items():
            options.setdefault(k, v)
    # walk reuse: engine options of the JAX package, not BHConfig fields
    walk_every = int(options.pop("walk_every", 1))
    walk_rebuild_frac = float(options.pop("walk_rebuild_frac", 0.5))
    cfg, fit = _fitter(options)

    def force(pos, mass, params):
        acc, _stats = bh_accel(pos, mass, params.bounds, params.theta2,
                               params.g, params.g_soft, fit(pos))
        return acc

    def aux(pos, mass, params):
        """The octree's node boxes (``tree_boxes``) and the walk's counters
        as Python ints, the JAX engine's keys.  The boxes come from a tree
        built in the world frame, as the JAX engine builds it; the counters
        from a whole ``bh_accel`` (grid frame), whose kernels launch as in
        a step.  A root span ``aux`` of the span recorder."""
        c = fit(pos)
        with annotate("aux", pos.device):
            tree = build_octree(pos, mass, params.bounds, c.max_level,
                                dim=c.dim, **_refine_args(c))
            _acc, stats = bh_accel(pos, mass, params.bounds, params.theta2,
                                   params.g, params.g_soft, c)
        keys = ["accept_dropped", "frontier_fallback", "near_fallback",
                "fb_spill"] + (["refine_build_dropped"] if c.refine_levels
                               else [])
        return {"tree_boxes": tree_boxes(tree, params.bounds),
                **{k: int(stats[k]) for k in keys}}

    init_carry = force_carry = None
    if walk_every > 1:
        def init_carry(pos, mass, params):
            # age 0 makes the first force call a build and a full walk
            c = fit(pos)
            return (_initial_tree(pos, mass, params, c),
                    empty_topo(pos.shape[0], c, pos.dtype, pos.device), 0)

        def force_carry(pos, mass, params, carry):
            tree, topo, age = carry
            acc, _stats, tree, topo, age = bh_accel_reuse(
                pos, mass, params.bounds, params.theta2, params.g,
                params.g_soft, tree, topo, age, fit(pos), walk_every,
                walk_rebuild_frac)
            return acc, (tree, topo, age)

    return Engine(name=name, force=force, aux=aux, init_carry=init_carry,
                  force_carry=force_carry,
                  description=f"Barnes-Hut linear octree, {cfg}")


def make_bh_lazy_engine(name: str = "bh-lazy", rebuild_frac: float = 0.3,
                        move_cells: float = 1.0, **options) -> Engine:
    """The lazy-rebuild Barnes-Hut engine (``nbody_tpu/engines/
    barnes_hut.py:153``): the carried tree's node statistics are refreshed
    each step (no sort), and a rebuild fires only when more than
    ``rebuild_frac`` of the alive particles strayed more than
    ``move_cells`` leaf cells from their frozen cell.  ``force`` (a step
    without the carry, ``update_forces``) builds and walks afresh."""
    cfg, fit = _fitter(options)

    def init_carry(pos, mass, params):
        return _initial_tree(pos, mass, params, fit(pos))

    def force_carry(pos, mass, params, tree):
        acc, _stats, tree = bh_accel_lazy(
            pos, mass, params.bounds, params.theta2, params.g, params.g_soft,
            tree, fit(pos), rebuild_frac, move_cells)
        return acc, tree

    def force(pos, mass, params):
        acc, _stats = bh_accel(pos, mass, params.bounds, params.theta2,
                               params.g, params.g_soft, fit(pos))
        return acc

    return Engine(name=name, force=force, init_carry=init_carry,
                  force_carry=force_carry,
                  description=f"incremental Barnes-Hut (lazy rebuild), {cfg}")


def bh_factory(**options) -> Engine:
    options.setdefault("max_level", 7)
    return make_bh_engine("bh", **options)


def bh_deep_factory(**options) -> Engine:
    options.setdefault("max_level", 8)
    return make_bh_engine("bh-deep", **options)
