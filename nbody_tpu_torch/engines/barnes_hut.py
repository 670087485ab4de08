"""Barnes-Hut octree engines (the counterpart of
``nbody_tpu/engines/barnes_hut.py``): a Morton-sorted dense level pyramid
and a vectorized group walk (``ops/tree.py``, ``ops/traversal.py``), whose
interaction sums run in the CUDA kernels K3 and K4 on the card (and K5 for
each group's own square with ``near_sym=True``).

Engine names:
  * ``bh``      -- leaf grid of depth 7 (the flagship engine)
  * ``bh-deep`` -- leaf grid of depth 8

Options (``engine_options``): any ``BHConfig`` field, plus ``profile``
('fast', 'accurate', 'dense' or 'adaptive': the deep refined stack,
``ADAPTIVE_OVERRIDES``, whose fields the caller's override).
``near_sym=True`` evaluates each group's own square once per unordered pair
(the same force set, another summation order).  Fields of paths not ported
yet raise, naming their ROADMAP item.  Without group_size / subgroups /
chunk_groups the config follows the state's capacity
(``BHConfig.auto_for``).  The opening angle theta^2 stays a runtime
setting (``SimParams.theta2``).
"""

from __future__ import annotations

from nbody_tpu_torch.engines import Engine
from nbody_tpu_torch.ops.traversal import (
    ADAPTIVE_OVERRIDES,
    DENSE_OVERRIDES,
    ROADMAP_BH_OPTIONS,
    ROADMAP_OPT_IN,
    BHConfig,
    _refine_args,
    bh_accel,
)
from nbody_tpu_torch.ops.tree import build_octree, tree_boxes


def make_bh_engine(name: str = "bh", **options) -> Engine:
    profile = options.pop("profile", "fast")
    if profile not in ("fast", "accurate", "dense", "adaptive"):
        raise ValueError(f"profile must be 'fast', 'accurate', 'dense' or "
                         f"'adaptive', got {profile!r}")
    if profile == "accurate":
        options.setdefault("window_pad", 2048)
    elif profile in ("dense", "adaptive"):
        stack = DENSE_OVERRIDES if profile == "dense" else ADAPTIVE_OVERRIDES
        for k, v in stack.items():
            options.setdefault(k, v)
    # engine options of the JAX package that are not BHConfig fields
    walk_every = int(options.pop("walk_every", 1))
    options.pop("walk_rebuild_frac", None)
    if walk_every > 1:
        raise NotImplementedError(
            "walk_every > 1 (walk-topology reuse) is not yet ported to "
            f"nbody_tpu_torch ({ROADMAP_OPT_IN})")
    cfg = BHConfig(**options)
    # group sizing left to the engine: the capacity-adaptive preset
    auto_group = not any(
        k in options for k in ("group_size", "subgroups", "chunk_groups"))

    def fit(pos):
        if pos.shape[1] != cfg.dim:
            raise NotImplementedError(
                "2D (quadtree) states on the bh engines are not yet ported to "
                f"nbody_tpu_torch ({ROADMAP_BH_OPTIONS})")
        return BHConfig.auto_for(pos.shape[0], **options) if auto_group \
            else cfg

    def force(pos, mass, params):
        acc, _stats = bh_accel(pos, mass, params.bounds, params.theta2,
                               params.g, params.g_soft, fit(pos))
        return acc

    def aux(pos, mass, params):
        """The octree's node boxes (``tree_boxes``) and the walk's counters
        as Python ints, the JAX engine's keys.  The boxes come from a tree
        built in the world frame, as the JAX engine builds it; the counters
        from a whole ``bh_accel`` (grid frame), whose kernels launch as in
        a step."""
        c = fit(pos)
        tree = build_octree(pos, mass, params.bounds, c.max_level,
                            **_refine_args(c))
        _acc, stats = bh_accel(pos, mass, params.bounds, params.theta2,
                               params.g, params.g_soft, c)
        keys = ["accept_dropped", "frontier_fallback", "near_fallback",
                "fb_spill"] + (["refine_build_dropped"] if c.refine_levels
                               else [])
        return {"tree_boxes": tree_boxes(tree, params.bounds),
                **{k: int(stats[k]) for k in keys}}

    return Engine(name=name, force=force, aux=aux,
                  description=f"Barnes-Hut linear octree, {cfg}")


def bh_factory(**options) -> Engine:
    options.setdefault("max_level", 7)
    return make_bh_engine("bh", **options)


def bh_deep_factory(**options) -> Engine:
    options.setdefault("max_level", 8)
    return make_bh_engine("bh-deep", **options)
