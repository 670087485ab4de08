"""Vectorized Barnes-Hut traversal (the counterpart of
``nbody_tpu/ops/traversal.py``, single device), with the density-adaptive
refined levels (``BHConfig.refine_levels``) and the adaptive presets.

Particles are Morton-sorted (``ops/tree.py``), so consecutive blocks of
``group_size`` particles are spatially compact and a whole group shares one
breadth-first theta walk over the dense level pyramid:

  * acceptance ``cell_w^2 < (accept_margin * theta^2) * r_min^2`` with r_min
    the exact distance from the node's COM to the union of the group's
    subgroup boxes (conservative for every member);
  * a Morton window of sorted neighbours around each group is summed
    exactly; cells whose particle range lies inside it are removed from the
    walk (coverage kept as an integer diff array);
  * the walk only collects: accepted nodes compact into a multipole slab,
    unexpandable leaf cells into a near-particle list, budget overflow into
    a self-excluded fallback slab;
  * with ``refine_levels > 0``, flagged leaf cells descend into the refined
    tables below the leaf grid (``ops/tree.py`` ``_build_refined``) under
    the same rules; their unexpandable cells become explicit sorted ranges
    that join the near list;
  * one pass then evaluates every group against its assembled slab: the
    hand-written CUDA kernels K3 (pair rows, with the block-dual mask) and
    K4 (quadrupole rows) on the card, ``ops/group_force.py``; with
    ``near_sym`` the group's own square leaves the slab for K5, which
    evaluates each of its unordered pairs once.

All groups are walked at once (a leading G axis where the JAX package used
``vmap`` + ``lax.map``), with fixed caps, cumsum + scatter compaction and a
Python loop over the few tree levels: nothing in a force call reads a device
value on the host.  Walk decisions are computed in the state dtype in the
JAX package's order (each host scalar is rounded to the dtype first), so the
walk statistics equal the JAX package's on equal input.

Evaluation backends (``BHConfig.eval_mode``): ``"pallas"`` (the name kept for
parity) runs the CUDA kernels and needs float32 CUDA tensors; ``"xla"`` runs
the port of the JAX package's XLA contractions (``_pair_block`` /
``_pair_block_mxu`` / ``_quad_block``) in plain torch on any device;
``"auto"`` takes the kernels for CUDA tensors and the plain torch path for
CPU tensors.  Nothing is chosen by failure.

The potential estimator (``bh_potential``, ``traverse_tree_phi``) runs the
same walk and evaluates its slab as monopoles in plain torch on the tree's
device, as the JAX package's is XLA, not Pallas.

2D states walk a quadtree (``BHConfig.dim = 2``: four children a cell) over
3-wide rows with z = 0, so the kernels see the same slabs.  Walk reuse
(``traverse_tree(return_topo=True)``, ``traverse_tree_cached``,
``bh_accel_reuse``) and the lazy rebuild (``bh_accel_lazy``) keep a frozen
binning between steps; where the JAX package decides "full or cached" and
"rebuild or refresh" with ``lax.cond`` on the card, these read the moved
fraction back to the host once a step (``HOST_READS``) and branch there.
"""

from __future__ import annotations

from dataclasses import dataclass

from typing import NamedTuple

import torch

from nbody_tpu_torch.ops import collect_walk
from nbody_tpu_torch.ops import group_force as gf
from nbody_tpu_torch.ops import morton
from nbody_tpu_torch.ops.tree import (
    LinearOctree,
    _compact,
    build_octree,
    decode_ranges,
    grid_bounds,
    refresh_octree,
)
from nbody_tpu_torch.ops.work import LOCK
from nbody_tpu_torch.utils.profiling import mark

# profile='dense' field stack (auto_for / make_bh_engine / --dense), as in
# the JAX package (traversal.py:66)
DENSE_OVERRIDES = dict(max_level=8, near_particle_cap=2048,
                       frontier_cap=4096, accept_cap=4096,
                       near_cell_cap=4096, fb_cap=512)

# The adaptive stacks, copied verbatim from the JAX package
# (traversal.py:98-159, where the comments record how each was tuned on a
# TPU v5e): the deep stack (ml7 + R3, threshold 128) where refinement fires
# on most of the scene, the tight-box stack (ml6 + R4, threshold 512)
# otherwise, and the mid-N stack below ADAPTIVE_CUT_MIN_N for both.
ADAPTIVE_OVERRIDES = dict(
    max_level=7, refine_levels=3, refine_threshold=128,
    near_particle_cap=2048, frontier_cap=2048, accept_cap=4096,
    near_cell_cap=4096, fb_cap=512, refine_frontier=1024,
    refine_near_cell_cap=2048, refine_near_particle_cap=4096)
ADAPTIVE_TIGHT_OVERRIDES = dict(
    max_level=6, refine_levels=4, refine_threshold=512,
    near_particle_cap=2048, frontier_cap=4096, accept_cap=8192,
    near_cell_cap=4096, fb_cap=512, refine_frontier=1024,
    refine_near_cell_cap=2048, refine_near_particle_cap=8192)
#: the 1M budget cuts do not transfer down-N; at or below this N the mid-N
#: stack applies
ADAPTIVE_CUT_MIN_N = 262145
_ADAPTIVE_BIG_BUDGETS = dict(frontier_cap=8192, accept_cap=8192,
                             fb_cap=2048, refine_near_particle_cap=16384)
ADAPTIVE_MIDN_OVERRIDES = dict(
    max_level=6, refine_levels=4, refine_threshold=128,
    near_particle_cap=2048, frontier_cap=16384, accept_cap=16384,
    near_cell_cap=4096, fb_cap=2048, refine_frontier=2048,
    refine_near_cell_cap=8192, refine_near_particle_cap=32768)

# profile='domain': the domain route's tier for the wide rows (N >= 2^24
# over several cards), a port divergence (the JAX package has no such
# tier).  Set on four H100s on the disc at 2^25, 2^23 rows a card, where
# the JAX package's preset reads p99 0.146 against the exact sum: level-8
# leaves, a window that holds a group's own clump cells, frontier and
# accept budgets that the level-8 walk does not overflow, near and far
# budgets that hold a group's near field on its own rank and across a
# rank's edge, and Barnes' modified accept test for the star's corner
# cells.  The near budgets hold the clumps the cold disc grows: at 65536
# rows and 2048 cells a group the force read p99 0.070 ~56 steps from the
# scene and 0.107 ~62 steps on, at 131072 and 4096 0.0088 and 0.0073 (the
# call ~10% slower).  It holds bh's envelope there at the scene and to ~62
# steps on; ~190 steps on is unread at these budgets (ROADMAP queue 3
# item 2b).
DOMAIN_OVERRIDES = dict(max_level=8, window_pad=16384, frontier_cap=16384,
                        accept_cap=8192, fb_cap=512,
                        near_particle_cap=131072, near_cell_cap=4096,
                        far_particle_cap=16384, accept_offset=True)
#: ShardedSimulation's domain route takes profile 'domain' by default from
#: this many rows on more than one card (the wide rows, ops/tree.py WIDE_N)
DOMAIN_MIN_N = 1 << 24
PROFILES = ("fast", "accurate", "dense", "adaptive", "domain")

#: contrast above this = steep-core scene (auto-detection threshold)
STEEP_CONTRAST = 40.0
#: the deep stack where frac_over128_l7 reaches this, the tight-box stack
#: below it (the JAX package's DEEP_FRAC)
DEEP_FRAC = 0.5


def scene_occupancy(pos, bounds_center, bounds_width, sample_cap=1 << 21):
    """Host-side (numpy) leaf-occupancy statistics of a scene, copied from
    the JAX package (traversal.py:162) with its fault mirrored so routing
    stays the same: above ``sample_cap`` particles ``n_in`` is the
    subsampled count, not scaled by the stride (ROADMAP.md, queue 3).

    Returns {"n_in", "contrast" (p99.9 / median occupied-cell count at
    level 6), "frac_over128_l7"}."""
    import numpy as np

    p = np.asarray(pos, dtype=np.float64)
    c = np.asarray(bounds_center, dtype=np.float64)
    half = float(bounds_width) / 2.0
    stride = 1
    if p.shape[0] > sample_cap:  # deterministic stride subsample
        stride = p.shape[0] // sample_cap + 1
        p = p[::stride]
    q = p - c[: p.shape[1]]
    alive = np.all(np.abs(q) <= half, axis=1)
    q = q[alive]
    out = {"n_in": int(q.shape[0])}
    if q.shape[0] == 0:
        out.update(contrast=1.0, frac_over128_l7=0.0)
        return out
    dim = q.shape[1]
    for level, key in ((6, "contrast"), (7, "frac_over128_l7")):
        cell = float(bounds_width) / (1 << level)
        gi = np.clip(((q + half - 0.5 * cell) / cell).astype(np.int64),
                     0, (1 << level) - 1)
        cid = gi[:, 0]
        for d in range(1, dim):
            cid = (cid << level) | gi[:, d]
        counts = np.sort(np.unique(cid, return_counts=True)[1])
        if key == "contrast":
            hi = counts[max(0, int(len(counts) * 0.999) - 1)]
            out[key] = float(hi) / float(max(np.median(counts), 1.0))
        else:
            out[key] = float(counts[counts * stride > 128].sum()) \
                / q.shape[0]
    return out


def resolve_adaptive_overrides(pos, bounds_center, bounds_width,
                               occupancy=None):
    """The adaptive stack for this scene: the mid-N stack below
    ADAPTIVE_CUT_MIN_N in-bounds particles; above it the deep stack where
    frac_over128_l7 >= DEEP_FRAC, the tight-box stack otherwise."""
    occ = occupancy or scene_occupancy(pos, bounds_center, bounds_width)
    if occ["n_in"] < ADAPTIVE_CUT_MIN_N:
        return dict(ADAPTIVE_MIDN_OVERRIDES)
    deep = occ["frac_over128_l7"] >= DEEP_FRAC
    return dict(ADAPTIVE_OVERRIDES if deep else ADAPTIVE_TIGHT_OVERRIDES)


def detect_scene_profile(pos, bounds_center, bounds_width, occupancy=None):
    """'fast' or 'adaptive' from the density-contrast statistic."""
    occ = occupancy or scene_occupancy(pos, bounds_center, bounds_width)
    return "adaptive" if occ["contrast"] > STEEP_CONTRAST else "fast"


@dataclass(frozen=True)
class BHConfig:
    """Static traversal configuration: the JAX package's fields with the
    same defaults and checks (``nbody_tpu/ops/traversal.py:266-548``; the
    comments there record how each default was tuned on a TPU v5e).
    ``wide`` is the domain path's row format for N >= 2^24
    (``traversal.py:441``): hi/lo node-table ranges (``decode_ranges``),
    fallback containment by Morton prefix and no index compare in the
    pair eval, set by ``parallel/domain.py`` from ``wide_ranges``.
    ``accept_offset`` (the port's alone, off but in profile 'domain')
    takes Barnes' modified accept test in the walk: a node's distance from
    the group less its COM's offset from its cell's centre must clear the
    cell width, so that a cell whose mass sits at one corner (the disc's
    star makes its cells so) is opened where its far side comes near."""

    max_level: int = 7
    dim: int = 3
    group_size: int = 4096
    window_pad: int = 2048
    frontier_cap: int = 2048
    accept_cap: int = 2048
    near_cell_cap: int = 2048
    near_particle_cap: int = 8192
    fb_cap: int = 128
    far_particle_cap: int = 2048  # domain-decomposed runs only
    far_cell_cap: int = 512  # domain-decomposed runs only
    start_level: int = 3
    chunk_groups: int = 1
    subgroups: int = 64
    mxu_blocks: bool = True  # "xla" backend: norm-trick matmul pair blocks
    eval_mode: str = "auto"  # "pallas" (CUDA kernels) | "xla" | "auto"
    eval_tile: int = 2048
    delta_onepass: bool = False
    xla_p_block: int = -1  # "xla" backend source-block width; -1 = 2048
    multipole: str = "quad"  # "quad" | "mono"
    quad_tile: int = 512
    quad_leaf: bool = False
    fb_quad: bool = False
    accept_margin: float = 0.8
    block_dual: bool = False
    dual_margin: float = 0.8
    near_sym: bool = False
    sliding_window: bool = False
    wide: bool = False
    frontier_schedule: tuple = None
    refine_levels: int = 0
    refine_cap: int = 8192
    refine_threshold: int = 0
    refine_frontier: int = 512
    refine_near_cell_cap: int = 2048
    refine_near_particle_cap: int = 8192
    refine_far_cell_cap: int = 512
    refine_far_particle_cap: int = 4096
    accept_offset: bool = False

    def __post_init__(self):
        branch = 1 << self.dim
        if self.refine_levels:
            # the JAX package's checks and texts (traversal.py:497-548)
            limit = 10 if self.dim == 3 else 15
            if self.max_level + self.refine_levels > limit:
                raise ValueError(
                    f"max_level + refine_levels = "
                    f"{self.max_level + self.refine_levels} exceeds the "
                    f"{self.dim}D Morton depth limit ({limit})")
            if self.wide:
                raise ValueError(
                    "refine_levels does not support the wide row format "
                    "(N >= 2^24): refined tables are narrow-only and the "
                    "refined fallback rows rely on narrow range "
                    "containment for self-exclusion")
            if self.fb_quad:
                raise ValueError(
                    "refine_levels does not support fb_quad (refined "
                    "fallback rows have no quadrupole table entry)")
            if self.refine_frontier <= 0 or self.refine_frontier % branch:
                raise ValueError(
                    f"refine_frontier must be a positive multiple of "
                    f"{branch}, got {self.refine_frontier}")
        # fb rows can be leaf cells, whose quadrupole gather needs the leaf
        # level in the table
        if self.fb_quad and not self.quad_leaf:
            raise ValueError("fb_quad=True requires quad_leaf=True")
        if self.multipole not in ("quad", "mono"):
            raise ValueError(
                f"multipole must be 'quad' or 'mono', got {self.multipole!r}")
        if self.eval_mode not in ("auto", "pallas", "xla"):
            raise ValueError(f"eval_mode must be 'auto', 'pallas' or 'xla', "
                             f"got {self.eval_mode!r}")
        if self.group_size % self.subgroups:
            raise ValueError(f"subgroups {self.subgroups} must divide "
                             f"group_size {self.group_size}")

    def schedule(self) -> tuple:
        """Frontier slots for levels start_level+1..max_level."""
        if self.frontier_schedule is not None:
            sched = tuple(self.frontier_schedule)
            if len(sched) != self.max_level - self.start_level:
                raise ValueError(
                    f"frontier_schedule needs {self.max_level - self.start_level}"
                    f" entries, got {len(sched)}")
        else:
            sched = tuple(
                min(self.branch ** l, self.frontier_cap,
                    max(512, self.frontier_cap >> (self.max_level - l)))
                for l in range(self.start_level + 1, self.max_level + 1))
        # slots must stay multiples of the branch factor (parent compaction)
        if any(s % self.branch for s in sched):
            raise ValueError(f"frontier slots must be multiples of "
                             f"{self.branch}: {sched}")
        return sched

    @property
    def branch(self) -> int:
        """Children per cell: 8 (octree) or 4 (quadtree)."""
        return 1 << self.dim

    @property
    def window(self) -> int:
        return self.group_size + 2 * self.window_pad

    @property
    def refine_threshold_resolved(self) -> int:
        """0 = auto: near_particle_cap (a cell that cannot fit the near
        budget is one whose fallback multipole carries leaf-resolution
        error)."""
        return self.refine_threshold or self.near_particle_cap

    def cell_w2s(self, width):
        """Squared cell widths for every walk level, refined levels
        included (index l = tree level l), computed from the box width (a
        0-d tensor) in its dtype."""
        return tuple((width / (1 << l)) * (width / (1 << l))
                     for l in range(self.max_level + self.refine_levels + 1))

    @staticmethod
    def auto_for(n: int, profile: str = "fast", **overrides) -> "BHConfig":
        """Size-adaptive preset: the JAX package's tiers
        (``traversal.py:570-721``), tuned on a TPU v5e and copied verbatim
        for parity; they are still to be decided again on the H100.
        'adaptive' without positions takes the deep stack at
        ADAPTIVE_CUT_MIN_N and above, the mid-N stack below
        (``resolve_adaptive_overrides`` picks by scene); 'domain' is the
        port's tier for the domain route's wide rows (``DOMAIN_OVERRIDES``)."""
        if profile not in PROFILES:
            raise ValueError(f"profile must be one of {PROFILES}, got "
                             f"{profile!r}")
        if n <= 32768:
            base = dict(group_size=2048, subgroups=64)
        elif n <= 262144:
            base = dict(group_size=4096, subgroups=64, block_dual=True,
                        dual_margin=1.2, near_particle_cap=2048,
                        window_pad=1024)
        elif n <= 1048576:
            base = dict(group_size=8192, subgroups=128, block_dual=False,
                        dual_margin=1.2, near_particle_cap=512,
                        window_pad=512)
        elif n <= (1 << 21):
            base = dict(group_size=8192, subgroups=128, block_dual=True,
                        dual_margin=1.2, near_particle_cap=512,
                        window_pad=1024)
        else:
            base = dict(group_size=8192, subgroups=128, block_dual=True,
                        dual_margin=1.2, near_particle_cap=512,
                        window_pad=2048)
        if profile == "dense":
            base.update(DENSE_OVERRIDES)
        if profile == "adaptive":
            base.update(ADAPTIVE_OVERRIDES if n >= ADAPTIVE_CUT_MIN_N
                        else ADAPTIVE_MIDN_OVERRIDES)
        if profile == "domain":
            base.update(DOMAIN_OVERRIDES)
        if profile == "accurate" and n > 32768:
            base.update(window_pad=2048, block_dual=True)
        # overrides apply before chunk_groups is fitted to the final group
        # size
        base.update(overrides)
        if "chunk_groups" not in overrides:
            n_groups = max(1, -(-n // base["group_size"]))
            for cg in (8, 4, 2, 1):
                if n_groups % cg == 0:
                    base["chunk_groups"] = cg
                    break
        return BHConfig(**base)


def fit_chunks(cg: int, n_groups: int, multiple: int = 1) -> int:
    """Largest cg' <= cg that divides ``n_groups`` with a chunk count
    (n_groups // cg') divisible by ``multiple``."""
    cg = max(1, min(cg, n_groups))
    while cg > 1 and (n_groups % cg or (n_groups // cg) % multiple):
        cg -= 1
    return cg


def _resolve_eval_mode(cfg: BHConfig, t: torch.Tensor) -> str:
    """'pallas' (the CUDA kernels) or 'xla' (plain torch) for tensors like
    ``t``.  'auto' follows the device; 'pallas' raises for CPU tensors and
    for CUDA tensors that are not float32."""
    mode = cfg.eval_mode
    if mode == "auto":
        mode = "pallas" if t.is_cuda else "xla"
    if mode == "pallas":
        if not t.is_cuda:
            raise ValueError(
                "eval_mode='pallas' runs the CUDA kernels and needs CUDA "
                "tensors; use eval_mode='xla' or 'auto' on the CPU")
        if t.dtype != torch.float32:
            raise TypeError(
                f"the CUDA kernels take float32, got {t.dtype}; pass "
                "eval_mode='xla' to run the plain torch path")
    return mode


def _resolve_p_block(cfg: BHConfig) -> int:
    """Source-block width of the plain 'xla' eval (0 = unbounded)."""
    return 2048 if cfg.xla_p_block == -1 else cfg.xla_p_block


def _scalar(x, like: torch.Tensor) -> torch.Tensor:
    """A host scalar (or 0-d tensor) as a 0-d CPU tensor of ``like``'s
    dtype: rounded to the dtype before any arithmetic, as JAX does with its
    weakly typed scalars."""
    return torch.as_tensor(x, dtype=like.dtype).cpu()


def _sq3(v):
    """|v|^2 over the last axis of size 3, added in the order x, y, z."""
    return v[..., 0] * v[..., 0] + v[..., 1] * v[..., 1] + v[..., 2] * v[..., 2]


# ---------------------------------------------------------------------------
# Plain ("xla") evaluation, batched over a leading group axis
# ---------------------------------------------------------------------------


def _pair_block(gpos, gidx, ppos, pm, pidx, pvalid, g, eps2, center=None,
                p_block=0):
    """Direct acceleration of targets gpos [C, B, 3] by sources ppos
    [C, P, 3] / pm [C, P], self-pairs masked by sorted index (gidx [C, B],
    pidx [C, P]; None skips the test), invalid and coincident pairs skipped.
    ``center`` [C, 3] selects the norm-trick matmul form (_pair_block_mxu).
    ``p_block`` > 0 accumulates over source blocks of that width."""
    P = ppos.shape[1]
    if p_block and P > p_block:
        acc = torch.zeros_like(gpos)
        for s in range(0, P, p_block):
            e = s + p_block
            acc = acc + _pair_block(
                gpos, gidx, ppos[:, s:e], pm[:, s:e],
                None if pidx is None else pidx[:, s:e], pvalid[:, s:e], g,
                eps2, center)
        return acc
    if center is not None:
        return _pair_block_mxu(gpos, gidx, ppos, pm, pidx, pvalid, g, eps2,
                               center)
    dd = ppos[:, None, :, :] - gpos[:, :, None, :]  # [C, B, P, 3]
    r2 = _sq3(dd) + eps2
    skip = (r2 <= 0.0) | ~pvalid[:, None, :]
    if gidx is not None:
        skip = skip | (pidx[:, None, :] == gidx[:, :, None])
    inv_r = torch.rsqrt(torch.where(skip, 1.0, r2))
    s = torch.where(skip, 0.0, inv_r * inv_r * inv_r * pm[:, None, :])
    return g * torch.einsum("cbp,cbpd->cbd", s, dd)


def _pair_block_mxu(gpos, gidx, ppos, pm, pidx, pvalid, g, eps2, center):
    """Norm-trick form of the pair block in the group frame:
        r^2 = |g - c|^2 + |p - c|^2 - 2 (g - c).(p - c) + eps^2
        a   = s @ (p - c) - (g - c) sum_p s
    in full fp32 matmuls (TF32 off)."""
    gp = gpos - center[:, None, :]
    pp = ppos - center[:, None, :]
    n2g = _sq3(gp)[:, :, None]
    n2p = _sq3(pp)[:, None, :]
    cross = torch.bmm(gp, pp.transpose(1, 2))
    r2 = n2g + n2p - 2.0 * cross + eps2
    skip = (r2 <= 0.0) | ~pvalid[:, None, :]
    if gidx is not None:
        skip = skip | (pidx[:, None, :] == gidx[:, :, None])
    inv_r = torch.rsqrt(torch.where(skip, 1.0, r2))
    s = torch.where(skip, 0.0, inv_r * inv_r * inv_r * pm[:, None, :])
    acc = torch.bmm(s, pp) - gp * s.sum(dim=2)[:, :, None]
    return g * acc


def _quad_block(gpos, qrows, g, eps2, p_block=0):
    """Plain quadrupole slab eval: targets gpos [C, B, 3] vs rows qrows
    [C, A, 16] -> [C, B, 3] with the guard masks ok = (M > 0) & (r^2 > 0)."""
    A = qrows.shape[1]
    if p_block and A > p_block:
        acc = torch.zeros_like(gpos)
        for s in range(0, A, p_block):
            acc = acc + _quad_block(gpos, qrows[:, s:s + p_block], g, eps2)
        return acc
    q = qrows[:, None, :, :]  # [C, 1, A, 16]
    ex = q[..., 0] - gpos[:, :, None, 0]
    ey = q[..., 1] - gpos[:, :, None, 1]
    ez = q[..., 2] - gpos[:, :, None, 2]
    m = q[..., 3]
    r2 = ex * ex + ey * ey + ez * ez + eps2
    ok = (m > 0) & (r2 > 0.0)
    inv_r = torch.rsqrt(torch.where(ok, r2, 1.0))
    ir2 = inv_r * inv_r
    ir3 = ir2 * inv_r
    ir5 = ir3 * ir2
    ir7 = ir5 * ir2
    s = torch.where(ok, ir3 * m, 0.0)
    qxx, qyy, qzz = q[..., 4], q[..., 5], q[..., 6]
    qxy, qxz, qyz = q[..., 7], q[..., 8], q[..., 9]
    ux = qxx * ex + qxy * ey + qxz * ez
    uy = qxy * ex + qyy * ey + qyz * ez
    uz = qxz * ex + qyz * ey + qzz * ez
    qe = ex * ux + ey * uy + ez * uz
    w = s + torch.where(ok, 2.5 * qe * ir7, 0.0)
    ir5 = torch.where(ok, ir5, 0.0)
    return g * torch.stack([(w * ex - ir5 * ux).sum(-1),
                            (w * ey - ir5 * uy).sum(-1),
                            (w * ez - ir5 * uz).sum(-1)], dim=-1)


def _fb_inside(fb, gidx, dtype, tcell=None, dim: int = 3,
               max_level: int = 0):
    """[G, B, F] "fb cell contains target" mask.  Narrow: the sorted-range
    compare cs <= sorted_idx < ce (cols 4/5 of fb [G, F, 8]; exact integers
    in the dtype by the tree guard).  Wide (``tcell`` [G, B], the targets'
    leaf codes): the equivalent Morton-prefix test on the row's (level,
    cell id) in cols 6/7, exact at any N (``traversal.py:929``).  Empty fb
    slots hold a zero row; their M = 0 is masked by the caller's m_eff
    guard either way."""
    if tcell is None:
        ti = gidx.to(dtype)[:, :, None]
        return (fb[:, None, :, 4] <= ti) & (ti < fb[:, None, :, 5])
    lvl = fb[..., 6].to(torch.int32)
    cid = fb[..., 7].to(torch.int32)
    shift = dim * torch.clamp(max_level - lvl, min=0)  # spill level -1 too
    return (tcell[:, :, None] >> shift[:, None, :]) == cid[:, None, :]


def _fb_terms(gpos, gidx, gmass, fb, eps2, tcell=None, dim: int = 3,
             max_level: int = 0):
    """The self-excluded monopole terms of the overflow-fallback slab fb
    [G, F, 8] (raw packed node rows: M, mass-weighted sums S, range
    start/end), chunk of groups by chunk so the [C, B, F] temporaries stay
    bounded.  A cell whose sorted range holds the target has the target's
    own mass and position removed in closed form:
        M' = M - m_i,   com' = (S - m_i p_i) / M'
    Yields (chunk slice, mi, m_eff, com' [C, B, F, 3], d = com' - p, ok,
    inv_r), the others [C, B, F]; empty slots and self-only cells have ok
    False.  ``tcell`` (wide rows) selects the Morton-prefix containment
    (``_fb_inside``)."""
    G, B, _ = gpos.shape
    F = fb.shape[1]
    tiny = torch.finfo(gpos.dtype).tiny
    step = max(1, (1 << 25) // max(B * F, 1))
    for c0 in range(0, G, step):
        sl = slice(c0, c0 + step)
        p = gpos[sl][:, :, None, :]  # [C, B, 1, 3]
        f = fb[sl][:, None, :, :]  # [C, 1, F, 8]
        inside = _fb_inside(fb[sl], gidx[sl], gpos.dtype,
                            None if tcell is None else tcell[sl], dim,
                            max_level)
        mi = torch.where(inside, gmass[sl][:, :, None], 0.0)
        m_eff = f[..., 0] - mi
        den = torch.clamp(m_eff, min=tiny)
        com = (f[..., 1:4] - mi[..., None] * p) / den[..., None]
        d = com - p
        r2 = _sq3(d) + eps2
        ok = (m_eff > 0.0) & (r2 > 0.0)
        inv_r = torch.rsqrt(torch.where(ok, r2, 1.0))
        yield sl, mi, m_eff, com, d, ok, inv_r


def _level_offsets(lvl, branch: int):
    """Row of level ``lvl`` (an int tensor, >= 0) in the all-level quadrupole
    table, (branch^l - 1) / (branch - 1), computed on the device."""
    dim = branch.bit_length() - 1
    return (torch.ones_like(lvl) << (dim * lvl)) // (branch - 1)


def _fb_eval(gpos, gidx, gmass, fb, g, eps2, all_quad=None,
             branch: int = 8, tcell=None, max_level: int = 0):
    """Self-excluded acceleration from the overflow-fallback slab
    (``_fb_terms``) -> [G, B, 3].  With ``all_quad`` (``fb_quad``) each
    cell adds its self-excluded traceless quadrupole
    (``nbody_tpu/ops/traversal.py:880-925``): the raw second moments by
    (level, cell id) in slots 6/7 minus the target's own m_i p pᵀ,
    centralized about com'.  ``tcell`` [G, B] (the wide rows: the targets'
    leaf codes at ``max_level``) takes the Morton-prefix containment."""
    out = []
    dim = branch.bit_length() - 1
    for sl, mi, m_eff, com, d, ok, inv_r in _fb_terms(
            gpos, gidx, gmass, fb, eps2, tcell, dim, max_level):
        ir2 = inv_r * inv_r
        ir3 = ir2 * inv_r
        s = torch.where(ok, ir3 * m_eff, 0.0)
        ex, ey, ez = d[..., 0], d[..., 1], d[..., 2]
        acc = torch.stack([(s * ex).sum(-1), (s * ey).sum(-1),
                           (s * ez).sum(-1)], dim=-1)
        if all_quad is not None:
            f = fb[sl]
            lvl = f[..., 6].to(torch.int64)
            # empty slots decode to the root, masked by ok (M = 0)
            s2 = all_quad[_level_offsets(lvl, branch)
                          + f[..., 7].to(torch.int64)][:, None]  # [C,1,F,8]
            p = gpos[sl][:, :, None, :]
            px, py, pz = p[..., 0], p[..., 1], p[..., 2]
            cx, cy, cz = com[..., 0], com[..., 1], com[..., 2]
            pxx = (s2[..., 0] - mi * px * px) - m_eff * cx * cx
            pyy = (s2[..., 1] - mi * py * py) - m_eff * cy * cy
            pzz = (s2[..., 2] - mi * pz * pz) - m_eff * cz * cz
            pxy = (s2[..., 3] - mi * px * py) - m_eff * cx * cy
            pxz = (s2[..., 4] - mi * px * pz) - m_eff * cx * cz
            pyz = (s2[..., 5] - mi * py * pz) - m_eff * cy * cz
            tr = pxx + pyy + pzz
            qxx, qyy, qzz = 3 * pxx - tr, 3 * pyy - tr, 3 * pzz - tr
            qxy, qxz, qyz = 3 * pxy, 3 * pxz, 3 * pyz
            ux = qxx * ex + qxy * ey + qxz * ez
            uy = qxy * ex + qyy * ey + qyz * ez
            uz = qxz * ex + qyz * ey + qzz * ez
            qe = ex * ux + ey * uy + ez * uz
            ir5 = ir3 * ir2
            w = torch.where(ok, 2.5 * qe * (ir5 * ir2), 0.0)
            ir5 = torch.where(ok, ir5, 0.0)
            acc = acc + torch.stack([(w * ex - ir5 * ux).sum(-1),
                                     (w * ey - ir5 * uy).sum(-1),
                                     (w * ez - ir5 * uz).sum(-1)], dim=-1)
        out.append(acc)
    return g * torch.cat(out)


def _fb_phi(gpos, gidx, gmass, fb, g, eps2):
    """Self-excluded potential from the overflow-fallback slab, the φ
    analog of ``_fb_eval``'s monopole terms: φ_i += -G M' /
    sqrt(|com' - p_i|^2 + eps^2) -> [G, B]."""
    return -g * torch.cat([
        torch.where(ok, m_eff * inv_r, 0.0).sum(-1)
        for _sl, _mi, m_eff, _com, _d, ok, inv_r in _fb_terms(
            gpos, gidx, gmass, fb, eps2)])


# ---------------------------------------------------------------------------
# The collect walk
# ---------------------------------------------------------------------------


def _push_rows(slab, offset, rows, mask, cap: int):
    """Append ``rows[mask]`` (per group) to a prefix-dense slab [G, cap+1, K]
    whose row ``cap`` is trash.  Returns (slab, new_offset, dropped_mask):
    rows past the cap are not written."""
    slot = offset[:, None] + torch.cumsum(mask.to(torch.int32), dim=1) - 1
    keep = mask & (slot < cap)
    write = torch.where(keep, slot, cap).long()
    slab.scatter_(1, write[:, :, None].expand(-1, -1, slab.shape[2]), rows)
    new_off = torch.clamp(offset + mask.sum(dim=1), max=cap).to(offset.dtype)
    return slab, new_off, mask & ~keep


def _capped(mask, cap: int):
    """``mask`` with its entries past the first ``cap`` of each row
    cleared (the order-preserving prefix a budget admits)."""
    return mask & (torch.cumsum(mask.to(torch.int32), 1) <= cap)


def _children(parents, keep, parent_cap: int, branch: int):
    """Compact the kept parents to ``parent_cap`` slots a group and list
    their children: (ids [G, parent_cap * branch], valid).  Invalid slots
    hold the children of parent 0, so every id indexes in range."""
    p, pvalid, _ = _compact(parents, keep, parent_cap)
    ids = (p[:, :, None] * branch
           + torch.arange(branch, dtype=torch.int32, device=p.device)
           ).reshape(p.shape[0], parent_cap * branch)
    return ids, pvalid.repeat_interleave(branch, dim=1)


def _cover(delta, pending, occupied, cs, ce, wstart, wend, W: int):
    """Cells whose sorted range lies wholly inside the group's window
    (summed exactly by the window pass): marked in the coverage diff array
    ``delta`` [G, W + 1] (+1 at the start, -1 past the end; column W is
    trash).  With ``pending`` (a list: ``BHConfig.delta_onepass``) the
    updates are collected there for one scatter-add after the walk, the
    same integers.  Returns the covered mask."""
    covered = occupied & (cs >= wstart[:, None]) & (ce <= wend[:, None])
    inc = covered.to(torch.int32)
    upd = ((torch.where(covered, cs - wstart[:, None], W).long(), inc),
           (torch.where(covered, ce - wstart[:, None], W).long(), -inc))
    if pending is not None:
        pending.extend(upd)
    else:
        for idx, val in upd:
            delta.scatter_add_(1, idx, val)
    return covered


def _group_center(gpos, gmass):
    """Group frame of the norm-trick eval: the midpoint of the alive
    members' box (the origin for a group with none).  gpos [G, B, 3],
    gmass [G, B] -> [G, 3]."""
    has = (gmass > 0)[..., None]
    big = torch.finfo(gpos.dtype).max
    glo = torch.where(has, gpos, big).amin(dim=1)
    ghi = torch.where(has, gpos, -big).amax(dim=1)
    return torch.where(has.any(dim=1), 0.5 * (glo + ghi), 0.0)


# elements of one [G, F, S, 3] block of the walk's distance test
_RMIN_BLOCK = 1 << 25


def _rmin2(com, gc, gh):
    """Squared exact distance from each node COM [G, F, 3] to the union of
    the group's subgroup boxes (centres gc, half-widths gh [G, S, 3]) ->
    [G, F], over blocks of frontier slots so the [G, F, S, 3] temporary
    stays bounded (each slot's minimum is computed whole, so the blocks
    change no bit)."""
    G, F, _ = com.shape
    step = max(1, _RMIN_BLOCK // max(G * gc.shape[1] * 3, 1))
    out = []
    for f0 in range(0, F, step):
        d = torch.clamp((com[:, f0:f0 + step, None, :] - gc[:, None]).abs()
                        - gh[:, None], min=0.0)  # [G, f, S, 3]
        out.append(_sq3(d).amin(dim=2))
    return torch.cat(out, dim=1)


def _group_collect(tree: LinearOctree, n_total: int, width, theta2, cfg,
                   window: int, gpos, gmass, gidx, sliding: bool = False,
                   local_bounds=None, grid=None):
    """The collect walk for all G groups at once
    (``nbody_tpu/ops/traversal.py:1124-1526``): the frame and the dense
    levels through the kernel ``csrc/collect_walk.cu`` for CUDA tensors
    (``ops/collect_walk.py``, one launch; it raises where it cannot run,
    there is no fallback) and through its plain twin ``_collect_dense`` for
    CPU tensors, then the refined levels (``_collect_refined``, plain
    torch on either device) and ``_collect_finish``.

    ``width`` is the tree box's width (0-d), whose squares over 2^level are
    the cell widths the accept test compares.  gpos [G, B, 3], gmass [G,
    B], gidx [G, B] (sorted indices, int32) -> dict with the multipole slab
    ``mono`` [G, accept_cap, 8] (com, M, -1, level or -1 for fb spill and
    refined cells, cell id, level), the near cells ``near_ids`` /
    ``near_valid`` [G, near_cell_cap], the window coverage ``wmask`` [G, W]
    and start ``wstart`` [G], the group frame ``center`` [G, 3], the
    fallback slab ``fb`` [G, fb_cap, 8] and the four walk counters [G].
    With ``cfg.refine_levels`` also the refined-near ranges ``rnear`` [G,
    RC, 2] / ``rnear_valid`` [G, RC] and the counter
    ``refine_near_totals`` [G] (their particles).  ``sliding``
    (``_sliding_ok``) leaves the window starts unclamped, as the
    gather-free window assembly reads them.

    ``local_bounds`` (lo, hi) (the domain decomposition,
    ``parallel/domain.py``): the global sorted range this rank gathers
    locally (its halo-extended slab).  Unexpandable leaf cells outside it
    go to a separate far list under ``far_particle_cap`` /
    ``far_cell_cap``, returned as ``far_ids`` / ``far_valid`` [G,
    far_cell_cap] and fetched by a request/reply collective; overflow of
    either list keeps the self-excluded fallback
    (``nbody_tpu/ops/traversal.py:1283-1310``).  The refined levels split
    their ranges the same way (``traversal.py:1413-1451``): those outside
    the slab go to the refined-far list under ``refine_far_cell_cap`` /
    ``refine_far_particle_cap``, returned as ``rfar`` [G, RFC, 2] /
    ``rfar_valid`` with the counter ``refine_far_totals`` [G].

    With ``cfg.accept_offset`` the dense levels take Barnes' modified
    accept test (``BHConfig``), the cell centres from ``grid``, the tree's
    grid ``Bounds`` (``ops/tree.py`` ``grid_bounds``); the refined levels,
    whose rows carry no cell address, keep the plain test."""
    thr = _scalar(cfg.accept_margin, gpos) * _scalar(theta2, gpos)
    dense = collect_walk.group_collect if gpos.is_cuda else _collect_dense
    st = dense(tree, n_total, width, thr, cfg, window, gpos, gmass, gidx,
               sliding, local_bounds, grid)
    if cfg.refine_levels:
        st = _collect_refined(tree, st, cfg.cell_w2s(width), thr, cfg,
                              window, local_bounds)
    return _collect_finish(st, cfg, window)


def _walk_frame(gpos, gmass, gidx, cfg, n_total: int, W: int, sliding):
    """The walk's per-group frame: the subgroup boxes over alive members
    (centres gc, half-widths gh [G, S, 3]; their union covers the group
    tightly even where it straddles a Morton seam), the group centre
    ``_group_center`` [G, 3] and the window starts [G] (clamped into
    range, or unclamped for the sliding assembly: zero rows past the
    array's ends)."""
    G, B, _ = gpos.shape
    S = cfg.subgroups
    has = (gmass > 0).reshape(G, S, B // S)
    spos = gpos.reshape(G, S, B // S, 3)
    big = torch.finfo(gpos.dtype).max
    masked_lo = torch.where(has[..., None], spos, big)
    masked_hi = torch.where(has[..., None], spos, -big)
    lo = masked_lo.amin(dim=2)  # [G, S, 3]
    hi = masked_hi.amax(dim=2)
    any_alive = has.any(dim=2)[..., None]
    # empty subgroups: a point box parked far outside the domain
    lo = torch.where(any_alive, lo, 1e30)
    hi = torch.where(any_alive, hi, 1e30)
    wstart = gidx[:, 0] - cfg.window_pad
    if not sliding:
        wstart = torch.clamp(wstart, 0, max(n_total - W, 0))
    return (0.5 * (lo + hi), 0.5 * (hi - lo), _group_center(gpos, gmass),
            wstart)


def _sqn(v):
    """|v|^2 over the last axis (2 or 3 wide), added in axis order."""
    s = v[..., 0] * v[..., 0] + v[..., 1] * v[..., 1]
    return s + v[..., 2] * v[..., 2] if v.shape[-1] == 3 else s


def _collect_dense(tree: LinearOctree, n_total: int, width, thr, cfg,
                   window: int, gpos, gmass, gidx, sliding: bool = False,
                   local_bounds=None, grid=None):
    """The collect walk's frame and dense levels (start_level..max_level)
    in plain torch on any device: the twin of ``csrc/collect_walk.cu``,
    which reproduces it bit for bit.  ``thr`` is accept_margin * theta2
    as a 0-d CPU tensor of the dtype; the rest as ``_group_collect``.

    Returns the walk state: the slabs with their trash rows ``mono`` [G,
    A + 1, 8] and ``fb`` [G, FB + 1, 8], their fill ``mono_off`` /
    ``fb_off`` [G], the coverage diff array ``delta`` [G, W + 1], the four
    counters, ``wstart``, ``center``, the subgroup boxes ``gc`` / ``gh``,
    the near (and far) cell lists, and with refined levels the descend
    list ``rids`` / ``rvalid`` [G, refine_frontier]."""
    G, B, _ = gpos.shape
    L = cfg.max_level
    W = window
    branch = cfg.branch
    dtype, dev = gpos.dtype, gpos.device
    cell_w2 = cfg.cell_w2s(width)
    gc, gh, center, wstart = _walk_frame(gpos, gmass, gidx, cfg, n_total, W,
                                         sliding)
    wend = wstart + W

    sched = cfg.schedule()
    n0 = branch ** cfg.start_level
    ids = torch.arange(n0, dtype=torch.int32, device=dev).expand(G, n0)
    valid = torch.ones((G, n0), dtype=torch.bool, device=dev)

    A, FB = cfg.accept_cap, cfg.fb_cap
    mono = torch.zeros((G, A + 1, 8), dtype=dtype, device=dev)
    fb = torch.zeros((G, FB + 1, 8), dtype=dtype, device=dev)
    i32 = dict(dtype=torch.int32, device=dev)
    mono_off = torch.zeros((G,), **i32)
    fb_off = torch.zeros((G,), **i32)
    a_dropped = torch.zeros((G,), **i32)
    f_fallback = torch.zeros((G,), **i32)
    fb_spill = torch.zeros((G,), **i32)
    # window-coverage diff array (+1 at a covered range's start, -1 past its
    # end); slot W is trash
    delta = torch.zeros((G, W + 1), **i32)
    pending = [] if cfg.delta_onepass else None
    R = cfg.refine_levels
    rf_parent_cap = cfg.refine_frontier // branch
    st = {}

    for l in range(cfg.start_level, L + 1):
        # one packed-row gather per slot: (m, mx, my, mz, start, end, _, _)
        row = tree.level_table[l][ids.long()]  # [G, F, 8]
        m = torch.where(valid, row[..., 0], 0.0)
        row = torch.cat([m[..., None], row[..., 1:]], dim=-1)
        occupied = m > 0
        com = row[..., 1:4] / torch.where(occupied, m, 1.0)[..., None]
        cs, ce = decode_ranges(row, cfg.wide)

        covered = _cover(delta, pending, occupied, cs, ce, wstart, wend, W)

        rmin2 = _rmin2(com, gc, gh)
        if cfg.accept_offset:
            d = com[..., :cfg.dim] - morton.cell_centers_from_codes(
                ids, grid, l, cfg.dim)
            reach = torch.clamp(torch.sqrt(rmin2) - torch.sqrt(_sqn(d)),
                                min=0.0)
            rmin2 = reach * reach
        accept = occupied & ~covered & (cell_w2[l] < thr * rmin2)
        expand = occupied & ~covered & ~accept

        if l < L:
            # cells that would expand past the parent cap degrade to
            # self-excluded monopoles (counted, never dropped)
            parent_cap = sched[l - cfg.start_level] // branch
            overflowed = expand & ~_capped(expand, parent_cap)
            f_fallback = f_fallback + overflowed.sum(dim=1, dtype=torch.int32)
            expand = expand & ~overflowed
        else:
            if R:
                # flagged and materialized cells descend into the refined
                # tables; past the refined frontier they keep the unrefined
                # path
                rbase = tree.refine_slot_leaf[ids.long()]
                descend = _capped(expand & (rbase >= 0), rf_parent_cap)
                expand = expand & ~descend
            # leaf level: unexpandable cells join the exact near field while
            # they fit the particle and cell budgets (order-preserving
            # prefix); the rest degrade to self-excluded monopoles.  A
            # domain walk splits them by gather locality: cells inside the
            # rank's halo slab take the near budgets, Morton-far seam cells
            # the far ones
            exp_l = expand
            if local_bounds is not None:
                is_local = ((cs >= local_bounds[0])
                            & (ce <= local_bounds[1]))
                exp_l = expand & is_local
                exp_f = expand & ~is_local
                cnt_f = torch.where(exp_f, ce - cs, 0)
                expand_far = (exp_f
                              & (torch.cumsum(cnt_f, 1)
                                 <= cfg.far_particle_cap)
                              & (torch.cumsum(exp_f.to(torch.int32), 1)
                                 <= cfg.far_cell_cap))
            cnt = torch.where(exp_l, ce - cs, 0)
            inc_l = (exp_l
                     & (torch.cumsum(cnt, 1) <= cfg.near_particle_cap)
                     & (torch.cumsum(exp_l.to(torch.int32), 1)
                        <= cfg.near_cell_cap))
            overflowed = expand & ~inc_l
            if local_bounds is not None:
                overflowed = overflowed & ~expand_far
            st["near_fallback"] = overflowed.sum(dim=1, dtype=torch.int32)
            expand = inc_l

        # overflow cells -> fallback slab: the raw node rows plus (level,
        # cell id) in slots 6/7
        idf = ids.to(dtype)  # cell ids < 2^24: exact
        lvlf = torch.full_like(idf, float(l))
        fbrow = torch.cat([row[..., :6], lvlf[..., None], idf[..., None]],
                          dim=-1)
        fb, fb_off, fb_drop = _push_rows(fb, fb_off, fbrow, overflowed, FB)
        fb_spill = fb_spill + fb_drop.sum(dim=1, dtype=torch.int32)

        # accepted nodes (+ fb spill, which loses only the self-exclusion
        # and whose level -1 zeroes its quadrupole) -> multipole slab rows;
        # slot 7 keeps the true level, by which the cached-topology path
        # re-gathers (no kernel reads it)
        mono_mask = accept | fb_drop
        neg = torch.full_like(idf, -1.0)
        mrows = torch.stack(
            [com[..., 0], com[..., 1], com[..., 2], m, neg,
             torch.where(fb_drop, -1.0, lvlf), idf, lvlf], dim=-1)
        mono, mono_off, mono_drop = _push_rows(mono, mono_off, mrows,
                                               mono_mask, A)
        a_dropped = a_dropped + mono_drop.sum(dim=1, dtype=torch.int32)

        if l < L:
            ids, valid = _children(ids, expand, parent_cap, branch)
        else:
            st["near_ids"], st["near_valid"], _ = _compact(
                ids, expand, cfg.near_cell_cap)
            if local_bounds is not None:
                st["far_ids"], st["far_valid"], _ = _compact(
                    ids, expand_far, cfg.far_cell_cap)
            if R:
                st["rids"], st["rvalid"] = _children(rbase, descend,
                                                     rf_parent_cap, branch)
    if pending:
        # delta_onepass: every level's coverage updates in one scatter-add
        _apply_pending(delta, pending)
    st.update(mono=mono, mono_off=mono_off, fb=fb, fb_off=fb_off,
              delta=delta, wstart=wstart, center=center, gc=gc, gh=gh,
              accept_dropped=a_dropped, frontier_fallback=f_fallback,
              fb_spill=fb_spill)
    return st


def _apply_pending(delta, pending):
    """The coverage updates ``_cover`` collected (``delta_onepass``) in one
    scatter-add: the same integers as level by level."""
    delta.scatter_add_(1, torch.cat([i for i, _ in pending], dim=1),
                       torch.cat([v for _, v in pending], dim=1))


def _collect_refined(tree: LinearOctree, st: dict, cell_w2, thr, cfg,
                     window: int, local_bounds=None):
    """The refined levels of the collect walk over the dense levels' state
    (``_collect_dense`` or the kernel's), in plain torch on any device:
    the same rules over the slot-indexed refined tables.  ``rids`` are
    rows of refine_tables[r - 1]; children of a row j that was refined
    further are rows child_slot[j] * 8 + k.  Accepted cells and spill ride
    the multipole slab as level -1 rows (no quadrupole), unexpandable
    cells become explicit sorted ranges under per-group cumulative
    budgets, and overflow keeps the self-excluded fallback.  Returns the
    state with the refined lists added."""
    G = st["mono"].shape[0]
    L, R, W = cfg.max_level, cfg.refine_levels, window
    branch = cfg.branch
    dev = st["mono"].device
    A, FB = cfg.accept_cap, cfg.fb_cap
    mono, mono_off, fb, fb_off = (st["mono"], st["mono_off"], st["fb"],
                                  st["fb_off"])
    a_dropped, n_fallback, fb_spill = (st["accept_dropped"],
                                       st["near_fallback"], st["fb_spill"])
    delta, wstart, gc, gh = st["delta"], st["wstart"], st["gc"], st["gh"]
    wend = wstart + W
    rids, rvalid = st["rids"], st["rvalid"]
    pending = [] if cfg.delta_onepass else None
    rf_parent_cap = cfg.refine_frontier // branch
    i32 = dict(dtype=torch.int32, device=dev)
    RC = cfg.refine_near_cell_cap
    # a domain walk splits the refined ranges by gather locality too
    RFC = cfg.refine_far_cell_cap if local_bounds is not None else 0
    rnear = torch.zeros((G, RC + 1, 2), **i32)  # column RC is trash
    rn_off = torch.zeros((G,), **i32)
    rn_pcnt = torch.zeros((G,), **i32)
    rfar = torch.zeros((G, RFC + 1, 2), **i32)
    rf_off = torch.zeros((G,), **i32)
    rf_pcnt = torch.zeros((G,), **i32)
    for r in range(1, R + 1):
        row = tree.refine_tables[r - 1][rids.long()]  # [G, F, 8]
        m = torch.where(rvalid, row[..., 0], 0.0)
        row = torch.cat([m[..., None], row[..., 1:]], dim=-1)
        occupied = m > 0
        com = row[..., 1:4] / torch.where(occupied, m, 1.0)[..., None]
        cs, ce = decode_ranges(row)
        covered = _cover(delta, pending, occupied, cs, ce, wstart, wend, W)
        accept = occupied & ~covered & (cell_w2[L + r]
                                        < thr * _rmin2(com, gc, gh))
        expand = occupied & ~covered & ~accept
        if r < R:
            # rids are in range for every slot (compacted rows of slot 0
            # where invalid), so the gather never reads a -1
            rbase = torch.where(
                rvalid, tree.refine_child_slot[r - 1][rids.long()], -1)
            descend = _capped(expand & (rbase >= 0), rf_parent_cap)
            expand = expand & ~descend

        # refined ranges under the budgets left by the earlier levels: a
        # domain walk's ranges inside the rank's slab join the near list,
        # the Morton-far (seam-core) ones the refined-far list
        exp_l = expand
        if RFC:
            is_local = (cs >= local_bounds[0]) & (ce <= local_bounds[1])
            exp_l = expand & is_local
            exp_f = expand & ~is_local
        rnear, rn_off, rn_pcnt, inc_n = _push_ranges(
            rnear, rn_off, rn_pcnt, exp_l, cs, ce,
            cfg.refine_near_particle_cap, RC)
        overflowed = expand & ~inc_n
        if RFC:
            rfar, rf_off, rf_pcnt, inc_f = _push_ranges(
                rfar, rf_off, rf_pcnt, exp_f, cs, ce,
                cfg.refine_far_particle_cap, RFC)
            overflowed = overflowed & ~inc_f
        n_fallback = n_fallback + overflowed.sum(dim=1, dtype=torch.int32)

        # fallback rows: self-exclusion by range containment; slots 6/7
        # hold (-1, 0), as refined rows have no (level, cell id) address
        neg = torch.full_like(m, -1.0)
        zero = torch.zeros_like(m)
        fbrow = torch.cat([row[..., :6], neg[..., None], zero[..., None]],
                          dim=-1)
        fb, fb_off, fb_drop = _push_rows(fb, fb_off, fbrow, overflowed, FB)
        fb_spill = fb_spill + fb_drop.sum(dim=1, dtype=torch.int32)
        mrows = torch.stack([com[..., 0], com[..., 1], com[..., 2], m, neg,
                             neg, zero, neg], dim=-1)
        mono, mono_off, mono_drop = _push_rows(mono, mono_off, mrows,
                                               accept | fb_drop, A)
        a_dropped = a_dropped + mono_drop.sum(dim=1, dtype=torch.int32)
        if r < R:
            rids, rvalid = _children(rbase, descend, rf_parent_cap, branch)
    if pending:
        _apply_pending(delta, pending)
    st = dict(st, mono=mono, mono_off=mono_off, fb=fb, fb_off=fb_off,
              accept_dropped=a_dropped, near_fallback=n_fallback,
              fb_spill=fb_spill,
              rnear=rnear[:, :RC],
              rnear_valid=torch.arange(RC, **i32)[None, :] < rn_off[:, None],
              refine_near_totals=rn_pcnt)
    if RFC:
        st.update(rfar=rfar[:, :RFC],
                  rfar_valid=(torch.arange(RFC, **i32)[None, :]
                              < rf_off[:, None]),
                  refine_far_totals=rf_pcnt)
    return st


def _collect_finish(st: dict, cfg, window: int):
    """The walk's result from its state: the slabs without their trash
    rows, the window coverage mask (the diff array's prefix > 0, unless
    the kernel computed it), the lists and the counters."""
    wmask = st.get("wmask")
    if wmask is None:
        wmask = torch.cumsum(st["delta"], dim=1)[:, :window] > 0
    keys = ("near_ids", "near_valid", "wstart", "center", "accept_dropped",
            "frontier_fallback", "near_fallback", "fb_spill", "far_ids",
            "far_valid", "rnear", "rnear_valid", "refine_near_totals",
            "rfar", "rfar_valid", "refine_far_totals")
    return dict({k: st[k] for k in keys if k in st},
                mono=st["mono"][:, :cfg.accept_cap],
                fb=st["fb"][:, :cfg.fb_cap], wmask=wmask)


def _push_ranges(ranges, off, pcnt, cand, cs, ce, particle_cap: int,
                 cell_cap: int):
    """Append the candidate ranges ``(cs, ce)[cand]`` [G, F] to a group's
    range list ``ranges`` [G, cell_cap + 1, 2] (column cell_cap is trash)
    while the running particle count ``pcnt`` and range count ``off`` [G]
    stay within their caps (the order-preserving prefix a budget admits).
    Returns (ranges, off, pcnt, admitted [G, F])."""
    cnt = torch.where(cand, ce - cs, 0)
    inc = (cand
           & (pcnt[:, None] + torch.cumsum(cnt, 1) <= particle_cap)
           & (off[:, None] + torch.cumsum(cand.to(torch.int32), 1)
              <= cell_cap))
    slot = off[:, None] + torch.cumsum(inc.to(torch.int32), 1) - 1
    write = torch.where(inc & (slot < cell_cap), slot, cell_cap).long()
    ranges.scatter_(1, write[..., None].expand(-1, -1, 2),
                    torch.stack([cs, ce], dim=-1))
    off = torch.clamp(off + inc.sum(dim=1), max=cell_cap).to(torch.int32)
    pcnt = pcnt + torch.where(inc, cnt, 0).sum(dim=1, dtype=torch.int32)
    return ranges, off, pcnt, inc


def _expand_ranges(leaf_table, cell_ids, cell_valid, cap: int,
                   wide: bool = False):
    """Expand leaf-cell particle ranges into padded flat index lists for all
    groups at once.  cell_ids [G, C], cell_valid [G, C] ->
    (pidx [G, cap] int32, pvalid [G, cap], total [G]); ``wide`` decodes
    the hi/lo range columns."""
    nstart, nend = decode_ranges(leaf_table[cell_ids.long()], wide)
    return _expand_from_ranges(nstart, nend, cell_valid, cap)


def _expand_from_ranges(nstart, nend, cell_valid, cap: int):
    """Slot k of a group's list belongs to its c-th cell, c = #offs <= k:
    one integer scatter + row cumsum instead of a binary search."""
    G, C = nstart.shape
    dev = nstart.device
    counts = torch.where(cell_valid, nend - nstart, 0).to(torch.int32)
    offs = torch.cumsum(counts, dim=1, dtype=torch.int32)
    total = offs[:, -1]
    g_row = torch.arange(G, dtype=torch.int64, device=dev)[:, None]
    stride = cap + 1
    marks = torch.zeros((G * stride,), dtype=torch.int32, device=dev)
    marks.scatter_add_(0, (g_row * stride
                           + torch.clamp(offs, max=cap)).reshape(-1),
                       cell_valid.to(torch.int32).reshape(-1))
    cell_of_k = torch.cumsum(marks.reshape(G, stride), dim=1)[:, :cap]
    cell_of_k = torch.clamp(cell_of_k, max=C - 1)
    k = torch.arange(cap, dtype=torch.int32, device=dev)[None, :]
    rebase = nstart - torch.cat(
        [torch.zeros((G, 1), dtype=torch.int32, device=dev), offs[:, :-1]],
        dim=1)
    pidx = rebase.reshape(G * C)[g_row * C + cell_of_k] + k
    pvalid = k < torch.clamp(total, max=cap)[:, None]
    pidx = torch.where(pvalid, pidx, 0).to(torch.int32)
    return pidx, pvalid, total


# ---------------------------------------------------------------------------
# Slab assembly and evaluation
# ---------------------------------------------------------------------------


def _quad_slab(mono, all_quad, excl_level: int = -1, branch: int = 8):
    """Expand the multipole slab mono [G, A, 8] into 16-wide quadrupole rows
    [G, A, 16]: raw second moments from ``all_quad`` centralized about the
    node COM (P = S2 - M c cᵀ, traceless Q = 3P - tr(P) I).  Rows of level
    -1 (fb spill) and of ``excl_level`` (leaf cells with quad_leaf=False;
    -1 keeps them) keep Q = 0."""
    lvl = mono[..., 5].to(torch.int32)
    cid = mono[..., 6].to(torch.int32)
    m = mono[..., 3]
    okq = (lvl >= 0) & (m > 0)
    if excl_level >= 0:
        okq = okq & (lvl != excl_level)
    # row of (level, cell id) in the all-level table
    lvl0 = torch.clamp(lvl, min=0).long()
    gid = torch.where(okq, _level_offsets(lvl0, branch) + cid, 0)
    s2 = all_quad[gid.long()]
    cx, cy, cz = mono[..., 0], mono[..., 1], mono[..., 2]
    pxx = s2[..., 0] - m * cx * cx
    pyy = s2[..., 1] - m * cy * cy
    pzz = s2[..., 2] - m * cz * cz
    pxy = s2[..., 3] - m * cx * cy
    pxz = s2[..., 4] - m * cx * cz
    pyz = s2[..., 5] - m * cy * cz
    tr = pxx + pyy + pzz
    q = torch.stack([3 * pxx - tr, 3 * pyy - tr, 3 * pzz - tr,
                     3 * pxy, 3 * pxz, 3 * pyz], dim=-1)
    q = torch.where(okq[..., None], q, 0.0)
    return torch.cat([mono[..., :3], m[..., None], q,
                      torch.zeros_like(q)], dim=-1)


def _chunks(G: int, cfg: BHConfig):
    cg = max(1, cfg.chunk_groups)
    return range(0, G, cg), cg


def _quad_eval(qslab, tgt8, g, eps2, g_soft, cfg: BHConfig, mode: str):
    """Quadrupole slab eval: K4 (``gf.quad_force``) in 'pallas' mode, the
    plain ``_quad_block`` chunked over groups in 'xla' mode.
    qslab [G, A, 16], tgt8 [G, B, 8] -> [G, B, 3]."""
    G = tgt8.shape[0]
    A = qslab.shape[1]
    tile = cfg.quad_tile
    while tile > 128 and (tile > A or A % tile):
        tile //= 2
    a_pad = (-A) % tile
    if a_pad:
        qslab = torch.cat([qslab, qslab.new_zeros((G, a_pad, 16))], dim=1)
    if mode == "pallas":
        return gf.quad_force(tgt8, qslab, g, g_soft, tile=tile)
    pb = _resolve_p_block(cfg)
    starts, cg = _chunks(G, cfg)
    return torch.cat([
        _quad_block(tgt8[s:s + cg, :, :3], qslab[s:s + cg], g, eps2,
                    p_block=pb) for s in starts])


def _fit_eval_tile(tile: int, S: int) -> int:
    """The source-tile width _slab_eval uses for a slab of S rows."""
    while tile > 128 and tile > S:
        tile //= 2
    return tile


def _dual_prepare(slab, tgt8, theta2, cfg: BHConfig, tile: int):
    """Block-dual acceptance over the eval grid (``BHConfig.block_dual``).

    slab [G, S, 8] (masses already masked; S % tile == 0), tgt8 [G, B, 8] ->
    (mask [G, bt, st] bool, qrows [G*bt, 128, 16] per-target-tile
    quadrupole rows, n_accepted).  Source-tile moments come from the masked
    slab rows, two-pass about the tile COM; acceptance uses the box-box
    distance, so a source tile overlapping the target tile's box is never
    accepted."""
    G, S, _ = slab.shape
    B = tgt8.shape[1]
    ti = gf.fit_target_tile(B, tile, 512, 1 << 20)
    bt = B // ti
    st = S // tile
    if st > 128:
        raise ValueError(f"block-dual needs at most 128 source tiles, got "
                         f"{st} (S = {S}, tile = {tile})")
    dtype = slab.dtype
    big = torch.finfo(dtype).max
    tiny = torch.finfo(dtype).tiny

    # ---- source tile stats ----
    rows = slab.reshape(G, st, tile, 8)
    sm = rows[..., 3]  # [G, st, T]
    sv = sm > 0
    sp = rows[..., :3]
    M = sm.sum(dim=-1)
    S1 = (sm[..., None] * sp).sum(dim=-2)
    com = S1 / torch.clamp(M, min=tiny)[..., None]
    slo = torch.where(sv[..., None], sp, big).amin(dim=-2)
    shi = torch.where(sv[..., None], sp, -big).amax(dim=-2)
    eligible = M > 0
    w = torch.where(eligible[..., None], shi - slo, 0.0)
    wmax = w.amax(dim=-1)
    w2 = wmax * wmax
    d = sp - com[:, :, None, :]
    dx, dy, dz = d[..., 0], d[..., 1], d[..., 2]
    pxx = (sm * dx * dx).sum(-1)
    pyy = (sm * dy * dy).sum(-1)
    pzz = (sm * dz * dz).sum(-1)
    pxy = (sm * dx * dy).sum(-1)
    pxz = (sm * dx * dz).sum(-1)
    pyz = (sm * dy * dz).sum(-1)
    tr = pxx + pyy + pzz
    z = torch.zeros_like(M)
    qrow16 = torch.stack(
        [com[..., 0], com[..., 1], com[..., 2], M,
         3 * pxx - tr, 3 * pyy - tr, 3 * pzz - tr,
         3 * pxy, 3 * pxz, 3 * pyz, z, z, z, z, z, z], dim=-1)

    # ---- target tile boxes (alive members only) ----
    t = tgt8.reshape(G, bt, ti, 8)
    tv = t[..., 3] > 0
    tp = t[..., :3]
    tlo = torch.where(tv[..., None], tp, big).amin(dim=-2)
    thi = torch.where(tv[..., None], tp, -big).amax(dim=-2)
    any_t = tv.any(dim=-1)

    # ---- box-box acceptance ----
    gap = torch.clamp(torch.maximum(slo[:, None] - thi[:, :, None],
                                    tlo[:, :, None] - shi[:, None]),
                      min=0.0)  # [G, bt, st, 3]
    db2 = _sq3(gap)
    thr = _scalar(cfg.dual_margin, slab) * _scalar(theta2, slab)
    accept = (eligible[:, None, :] & any_t[..., None]
              & (w2[:, None, :] < thr * db2) & (db2 > 0))

    q = torch.where(accept[..., None], qrow16[:, None, :, :], 0.0)
    if st < 128:
        q = torch.cat([q, q.new_zeros((G, bt, 128 - st, 16))], dim=2)
    return accept, q.reshape(G * bt, 128, 16), accept.sum()


def _slab_eval(slab, tgt8, center, g, eps2, g_soft, cfg: BHConfig, mode,
               mask=None, tile=None):
    """Every group's targets vs its assembled slab: K3 (``gf.group_force``)
    in 'pallas' mode; in 'xla' mode the plain pair blocks (norm-trick form
    with ``mxu_blocks``) with index self-exclusion, chunked over groups.
    With ``cfg.wide`` the index compare is retired, as in the maskless K3
    (a self pair adds 0 through d = 0), and so is the norm-trick form,
    whose unskipped self term cancels only to rounding
    (``traversal.py:1916-1945``).

    slab [G, S, 8], tgt8 [G, B, 8], center [G, 3] -> [G, B, 3].  ``mask``
    [G, bt, S // tile] skips the block-dual accepted tile pairs; block-dual
    callers pre-pad the slab to the tile the mask was built on."""
    G, B, _ = tgt8.shape
    S = slab.shape[1]
    if tile is None:
        tile = _fit_eval_tile(cfg.eval_tile, S)
    elif S % tile:
        raise ValueError(f"slab of {S} rows is not padded to tile {tile}")
    s_pad = (-S) % tile
    if s_pad:
        if mask is not None:
            raise ValueError("block-dual callers must pre-pad the slab")
        slab = torch.cat([slab, slab.new_zeros((G, s_pad, 8))], dim=1)
        S += s_pad
    if mode == "pallas":
        return gf.group_force(tgt8, slab, g, g_soft, tile=tile, mask=mask)

    pb = _resolve_p_block(cfg)
    starts, cg = _chunks(G, cfg)
    out = []
    for s0 in starts:
        sl, t8 = slab[s0:s0 + cg], tgt8[s0:s0 + cg]
        ct = (center[s0:s0 + cg] if cfg.mxu_blocks and not cfg.wide
              else None)
        sli = tgi = None
        if not cfg.wide:
            sli, tgi = sl[..., 4].to(torch.int32), t8[..., 4].to(torch.int32)
        if mask is None:
            out.append(_pair_block(
                t8[..., :3], tgi, sl[..., :3], sl[..., 3], sli,
                sl[..., 3] != 0.0, g, eps2, ct, p_block=pb))
            continue
        # masked tile pairs: the source masses zeroed per target tile, each
        # target tile evaluated as its own batch row
        mk = mask[s0:s0 + cg]
        C, bt = mk.shape[0], mk.shape[1]
        ti = B // bt
        keep = (~mk).repeat_interleave(tile, dim=2).to(sl.dtype)  # [C,bt,S]
        m_t = (sl[:, None, :, 3] * keep).reshape(C * bt, S)
        rep = lambda x: x.repeat_interleave(bt, dim=0)
        acc = _pair_block(
            t8[..., :3].reshape(C * bt, ti, 3),
            None if tgi is None else tgi.reshape(C * bt, ti),
            rep(sl[..., :3]), m_t, None if sli is None else rep(sli),
            m_t != 0.0, g, eps2, None if ct is None else rep(ct),
            p_block=pb)
        out.append(acc.reshape(C, B, 3))
    return torch.cat(out)


def _dual_slab_eval(slab, tgt8, center, theta2, g, eps2, g_soft,
                    cfg: BHConfig, mode):
    """``_slab_eval`` with the block-dual far field folded in: pad the slab
    to the eval tile, build the (target tile, source tile) acceptance mask,
    run the masked pair pass and add the accepted tiles' quadrupoles.
    Returns (acc [G, B, 3], n_dual)."""
    G, B, _ = tgt8.shape
    if not cfg.block_dual:
        mark("assembly+dual")
        acc = _slab_eval(slab, tgt8, center, g, eps2, g_soft, cfg, mode)
        mark("K3")
        return acc, torch.zeros((), dtype=torch.int64, device=slab.device)
    tile = _fit_eval_tile(cfg.eval_tile, slab.shape[1])
    s_pad = (-slab.shape[1]) % tile
    if s_pad:
        slab = torch.cat([slab, slab.new_zeros((G, s_pad, 8))], dim=1)
    dmask, dqrows, n_dual = _dual_prepare(slab, tgt8, theta2, cfg, tile)
    mark("assembly+dual")
    # the tile the mask grid was built on, not one re-derived from the
    # padded slab length
    acc = _slab_eval(slab, tgt8, center, g, eps2, g_soft, cfg, mode,
                     mask=dmask, tile=tile)
    mark("K3")
    bt = dmask.shape[1]
    acc = acc + _quad_eval(dqrows, tgt8.reshape(G * bt, B // bt, 8), g,
                           eps2, g_soft, cfg, mode).reshape(G, B, 3)
    mark("K4 dual")
    return acc, n_dual


def _self_square_eval(tgt8, mcen, g, eps2, g_soft, cfg: BHConfig, mode):
    """Each group against itself with window-masked source masses ``mcen``
    [G, B] (``BHConfig.near_sym``): K5 (``gf.group_self_force``, each
    unordered pair once) in 'pallas' mode; in 'xla' mode a maskless d-form
    pair block chunked over groups (self-pairs add 0 through d = 0, masked
    sources through m = 0)."""
    if mode == "pallas":
        return gf.group_self_force(tgt8, mcen, g, g_soft)
    pb = _resolve_p_block(cfg)
    starts, cg = _chunks(tgt8.shape[0], cfg)
    return torch.cat([
        _pair_block(t8[..., :3], None, t8[..., :3], mc, None, mc != 0.0, g,
                    eps2, p_block=pb)
        for t8, mc in ((tgt8[s:s + cg], mcen[s:s + cg]) for s in starts)])


def _split_window(pmass8, tgt8, wstart, wmask, W: int, gstart):
    """``near_sym`` assembly: the window minus the group's own B rows.
    The group sits at columns [off, off + B) of its window, off = group
    start ``gstart`` [G] - wstart (in [0, W - B] by the window clamp).
    Returns the rim rows [G, W - B, 8] (masses under the window mask) and
    the group's own masses under the same mask, ``mcen`` [G, B], the
    weights of the self square."""
    G, B, _ = tgt8.shape
    dev = tgt8.device
    off = (gstart - wstart).to(torch.int32)
    k = torch.arange(W - B, dtype=torch.int32, device=dev)[None, :]
    rimrel = (k + B * (k >= off[:, None])).long()  # [G, W - B]
    rrows = pmass8[wstart[:, None].long() + rimrel]
    rmask = torch.gather(wmask, 1, rimrel)
    rrows = torch.cat([rrows[..., :3],
                       torch.where(rmask, rrows[..., 3], 0.0)[..., None],
                       rrows[..., 4:]], dim=-1)
    cen = off[:, None].long() + torch.arange(B, device=dev)[None, :]
    mcen = torch.where(torch.gather(wmask, 1, cen), tgt8[..., 3], 0.0)
    return rrows, mcen


def _sliding_ok(cfg: BHConfig, W: int) -> bool:
    """Whether the gather-free window assembly applies
    (``BHConfig.sliding_window``; ``nbody_tpu/ops/traversal.py:2013``): an
    unclipped window whose pads fit in a group, and neither ``near_sym``
    (its rim gather needs the clamp) nor the wide rows.  A function of
    (cfg, W) alone, so the walk's window starts and every assembly agree."""
    return (cfg.sliding_window
            and W == cfg.group_size + 2 * cfg.window_pad
            and cfg.window_pad <= cfg.group_size
            and not cfg.near_sym
            and not cfg.wide)


def _window_rows(pmass8, wstart, wmask, W: int, cfg: BHConfig = None,
                 sliding: bool = False):
    """The [G, W, 8] sorted-neighbour window rows, masses zeroed outside the
    covered cells: a gather at each group's clamped start, or with
    ``sliding`` three shifted reshapes of the rows (the left pad, the
    group, the right pad; zero rows past the array's ends), matching the
    walk's unclamped starts.  A shard's groups (fewer than the rows hold)
    take the same rows by a gather from the zero-padded rows."""
    if sliding and wstart.shape[0] * cfg.group_size != pmass8.shape[0]:
        p = cfg.window_pad
        padded = torch.cat([pmass8.new_zeros((p, 8)), pmass8,
                            pmass8.new_zeros((p, 8))])
        idx = (wstart[:, None].long() + p
               + torch.arange(W, device=pmass8.device))
        wrows = padded[idx]
    elif sliding:
        B, p = cfg.group_size, cfg.window_pad
        G = pmass8.shape[0] // B
        wrows = pmass8.reshape(G, B, 8)
        if p:
            zeros = lambda k: pmass8.new_zeros((k, 8))
            left = torch.cat([zeros(p), pmass8[:-p]]).reshape(G, B, 8)
            right = torch.cat([pmass8[B:], zeros(B)]).reshape(G, B, 8)
            wrows = torch.cat([left[:, :p], wrows, right[:, :p]], dim=1)
    else:
        idx = wstart[:, None].long() + torch.arange(W, device=pmass8.device)
        wrows = pmass8[idx]
    m = torch.where(wmask, wrows[..., 3], 0.0)
    return torch.cat([wrows[..., :3], m[..., None], wrows[..., 4:]], dim=-1)


def _near_rows(pmass8, pidx, pvalid):
    """The [G, P, 8] gathered near-particle rows, masses zeroed past each
    group's list."""
    nrows = pmass8[pidx.long()]
    return torch.cat([nrows[..., :3],
                      torch.where(pvalid, nrows[..., 3], 0.0)[..., None],
                      nrows[..., 4:]], dim=-1)


def _assemble_eval(pmass8, tgt8, tree, walk, pidx, pvalid, acc_fb, theta2,
                   g, eps2, g_soft, cfg: BHConfig, W: int, mode, gstart):
    """Slab assembly + force eval: window rows + near gather (+ the
    multipole slab for monopole runs) -> one pair pass with the block-dual
    far field (K3, K4 on the dual rows), the group's own square (K5, with
    ``near_sym``: the window rows are then the rim only), the accepted
    nodes' quadrupoles (K4) and the fallback term.  ``gstart`` [G] is
    each group's first sorted index.  Returns (acc [G, B, 3] in
    sorted-group order, n_dual, slab_fill)."""
    nrows = _near_rows(pmass8, pidx, pvalid)
    if cfg.near_sym:
        wrows, mcen = _split_window(pmass8, tgt8, walk["wstart"],
                                    walk["wmask"], W, gstart)
    else:
        wrows = _window_rows(pmass8, walk["wstart"], walk["wmask"], W, cfg,
                             _sliding_ok(cfg, W))
    if cfg.multipole == "quad":
        # particle rows through K3; accepted nodes through K4
        slab = torch.cat([wrows, nrows], dim=1)
    else:
        slab = torch.cat([wrows, nrows, walk["mono"]], dim=1)
    acc, n_dual = _dual_slab_eval(slab, tgt8, walk["center"], theta2, g,
                                  eps2, g_soft, cfg, mode)
    if cfg.near_sym:
        acc = acc + _self_square_eval(tgt8, mcen, g, eps2, g_soft, cfg, mode)
        mark("K5")
    if cfg.multipole == "quad":
        qslab = _quad_slab(walk["mono"], tree.all_quad,
                           -1 if cfg.quad_leaf else cfg.max_level,
                           cfg.branch)
        acc = acc + _quad_eval(qslab, tgt8, g, eps2, g_soft, cfg, mode)
        mark("K4")
    slab_fill = (slab[..., 3] != 0.0).to(slab.dtype).mean()
    return acc + acc_fb, n_dual, slab_fill


def _pack(tree, g_soft, cfg: BHConfig, n: int):
    """The sorted particles as slab rows, padded to whole chunks of groups.
    Returns (eps2, pmass8 [n_tot, 8], tgt8 [G, B, 8], gidx [G, B], W)."""
    B = cfg.group_size
    block = B * cfg.chunk_groups
    pad = (-n) % block
    dtype, dev = tree.pos_s.dtype, tree.pos_s.device
    n_tot = n + pad
    eps2 = float(_scalar(g_soft, tree.pos_s) * _scalar(g_soft, tree.pos_s))
    # packed source rows (x, y, z, m, sorted_idx, 0, 0, 0): the slab and
    # target row layout of K3; idx is exact in f32 below 2^24 (tree guard)
    pm4 = torch.cat([tree.pos_s, tree.mass_s[:, None]], dim=1)
    if pad:
        pm4 = torch.cat([pm4, pm4.new_zeros((pad, 4))])
    pmass8 = torch.cat([pm4, torch.arange(n_tot, dtype=dtype,
                                          device=dev)[:, None],
                        pm4.new_zeros((n_tot, 3))], dim=1)
    # a window larger than the whole array degenerates to all pairs
    W = min(cfg.window, n_tot)
    G = n_tot // B
    tgt8 = pmass8.reshape(G, B, 8)
    gidx = torch.arange(n_tot, dtype=torch.int32, device=dev).reshape(G, B)
    return eps2, pmass8, tgt8, gidx, W


def _walk(tree, bounds, theta2, g_soft, cfg: BHConfig, n: int,
          groups: slice = None):
    """``_pack`` and the collect walk for every group, or for the
    ``groups`` slice of them (a shard's).  Returns (eps2, pmass8 [n_tot,
    8], tgt8 [G, B, 8], gidx [G, B], W, walk) with G the groups walked."""
    if cfg.wide:  # the containment test needs the targets' leaf codes
        raise ValueError("BHConfig.wide requires target leaf codes (gcode)")
    eps2, pmass8, tgt8, gidx, W = _pack(tree, g_soft, cfg, n)
    if groups is not None:
        tgt8, gidx = tgt8[groups], gidx[groups]
    if cfg.refine_levels and tree.refine_tables is None:
        raise ValueError(
            "cfg.refine_levels > 0 but the tree was built without "
            "refinement (pass refine_levels/refine_cap/refine_threshold "
            "to build_octree)")
    walk = _group_collect(tree, pmass8.shape[0], bounds.width, theta2, cfg,
                          W, tgt8[..., :3], tgt8[..., 3], gidx,
                          sliding=_sliding_ok(cfg, W),
                          grid=(grid_bounds(bounds, cfg.max_level)
                                if cfg.accept_offset else None))
    return eps2, pmass8, tgt8, gidx, W, walk


def _near_lists(tree, walk, cfg: BHConfig):
    """The near cells' particle lists, all groups at once, with the refined
    near ranges (refine_levels > 0) concatenated after them:
    (pidx [G, P], pvalid [G, P], the leaf list's totals [G])."""
    pidx, pvalid, ntot = _expand_ranges(
        tree.level_table[cfg.max_level], walk["near_ids"],
        walk["near_valid"], cfg.near_particle_cap)
    if cfg.refine_levels:
        rnear = walk["rnear"]
        pidx_r, pvalid_r, _ = _expand_from_ranges(
            rnear[..., 0], rnear[..., 1], walk["rnear_valid"],
            cfg.refine_near_particle_cap)
        pidx = torch.cat([pidx, pidx_r], dim=1)
        pvalid = torch.cat([pvalid, pvalid_r], dim=1)
    return pidx, pvalid, ntot


def _walk_counters(walk) -> dict:
    """The walk's four counters, summed over groups (0-d tensors)."""
    return {
        # true drops (should always be 0; raise accept_cap if not)
        "accept_dropped": walk["accept_dropped"].sum(),
        # graceful self-excluded-monopole fallbacks (accuracy, not
        # correctness)
        "frontier_fallback": walk["frontier_fallback"].sum(),
        "near_fallback": walk["near_fallback"].sum(),
        # fb-slab overflow, degraded further to a plain monopole
        "fb_spill": walk["fb_spill"].sum(),
    }


class WalkTopo(NamedTuple):
    """The collect walk's decisions, none of its values
    (``nbody_tpu/ops/traversal.py:1970``): the accepted-node rows (their
    (cell id, level) in slots 6/7), the fallback rows, the near particle
    lists and the window coverage.  Over a frozen binning
    (``refresh_octree``) every index stays valid across steps, so
    ``traverse_tree_cached`` can skip the walk and evaluate the same
    interactions at the current positions."""

    mono: torch.Tensor  # [G, accept_cap, 8] accepted-node rows
    fb: torch.Tensor  # [G, fb_cap, 8] overflow-fallback node rows
    pidx: torch.Tensor  # [G, near_particle_cap] int32 near sources
    pvalid: torch.Tensor  # [G, near_particle_cap] bool
    ntot: torch.Tensor  # [G] int32 near totals (stats)
    wmask: torch.Tensor  # [G, W] bool window coverage
    wstart: torch.Tensor  # [G] int32 window starts


def empty_topo(n: int, cfg: BHConfig, dtype, device) -> WalkTopo:
    """A zero ``WalkTopo`` of the shapes ``traverse_tree(return_topo=True)``
    gives for ``n`` particles: the carry before the first full walk (every
    row has zero mass, inert if evaluated)."""
    block = cfg.group_size * cfg.chunk_groups
    n_tot = n + (-n) % block
    G = n_tot // cfg.group_size
    W = min(cfg.window, n_tot)
    P = cfg.near_particle_cap
    f = dict(dtype=dtype, device=device)
    i32 = dict(dtype=torch.int32, device=device)
    return WalkTopo(
        mono=torch.zeros((G, cfg.accept_cap, 8), **f),
        fb=torch.zeros((G, cfg.fb_cap, 8), **f),
        pidx=torch.zeros((G, P), **i32),
        pvalid=torch.zeros((G, P), dtype=torch.bool, device=device),
        ntot=torch.zeros((G,), **i32),
        wmask=torch.zeros((G, W), dtype=torch.bool, device=device),
        wstart=torch.zeros((G,), **i32))


def _fb_all_quad(tree, cfg: BHConfig):
    """The quadrupole table the fallback eval reads (``fb_quad``), or
    None for self-excluded monopoles."""
    return tree.all_quad if cfg.multipole == "quad" and cfg.fb_quad else None


def _unsort(acc, tree, cfg: BHConfig, n: int):
    """Group-order accelerations [G, B, 3] -> [n, dim] in the original
    particle order (``tree.order`` is a bijection)."""
    acc_s = acc.reshape(-1, 3)[:n, :cfg.dim]
    out = torch.empty_like(acc_s)
    out[tree.order] = acc_s
    return out


def traverse_tree(tree, bounds, theta2, g, g_soft, cfg: BHConfig, n: int,
                  return_topo: bool = False, chunk_range=None,
                  n_shards: int = 1):
    """Group traversal + force over a built tree: collect walk -> slab
    assembly (window rows + near gather + multipole slab) -> one eval pass
    -> scatter back to the original particle order.

    Returns (acc [n, dim] in original order, stats), and the walk's
    ``WalkTopo`` after them with ``return_topo``.  Each phase ends in a
    ``mark`` of the span recorder (``utils/profiling.py``): "walk", "fb",
    "assembly+dual", "K3", "K4 dual", "K5", "K4", "scatter".

    Sharded mode (``nbody_tpu/ops/traversal.py:2161``): with
    ``chunk_range=(first_chunk,)`` only this shard's 1/``n_shards`` of the
    chunks of ``chunk_groups`` groups, from ``first_chunk`` on, is walked
    and evaluated, and acc is that slice [n_tot / n_shards, 3] in sorted
    order, for the caller to gather and un-permute.  Unlike the JAX
    package, which takes its single-chip tail at ``n_shards == 1``, the
    slice is returned whenever ``chunk_range`` is given, so a one-rank
    mesh un-permutes once."""
    sharded = chunk_range is not None
    if sharded and return_topo:
        raise ValueError("return_topo is a single-chip feature")
    if cfg.refine_levels and return_topo:
        raise ValueError(
            "walk-topology caching (walk_every > 1 / bh-lazy) does not "
            "support refine_levels: refined slab rows have no "
            "(level, cell id) address to re-gather by")
    dtype = tree.pos_s.dtype
    mode = _resolve_eval_mode(cfg, tree.pos_s)
    groups = None
    if sharded:
        block = cfg.group_size * cfg.chunk_groups
        n_chunks = (n + (-n) % block) // block
        if n_chunks % n_shards:
            raise ValueError(f"{n_chunks} chunks of {cfg.chunk_groups} "
                             f"groups do not split over {n_shards} shards")
        first = int(chunk_range[0]) * cfg.chunk_groups
        groups = slice(first,
                       first + n_chunks // n_shards * cfg.chunk_groups)
    eps2, pmass8, tgt8, gidx, W, walk = _walk(tree, bounds, theta2, g_soft,
                                              cfg, n, groups)
    mark("walk")
    acc_fb = _fb_eval(tgt8[..., :3], gidx, tgt8[..., 3], walk["fb"], g, eps2,
                      _fb_all_quad(tree, cfg), cfg.branch)
    mark("fb")

    pidx, pvalid, ntot = _near_lists(tree, walk, cfg)
    acc, n_dual, slab_fill = _assemble_eval(
        pmass8, tgt8, tree, walk, pidx, pvalid, acc_fb, theta2, g, eps2,
        g_soft, cfg, W, mode, gidx[:, 0])
    out = acc.reshape(-1, 3) if sharded else _unsort(acc, tree, cfg, n)
    mark("scatter")
    stats = {
        **_walk_counters(walk),
        "near_totals": ntot,
        "dual_tiles": n_dual,
        "window_cov": walk["wmask"].to(dtype).mean(),
        "slab_fill": slab_fill,
    }
    if cfg.refine_levels:
        # refined-near particles a group, and the flagged cells the build
        # could not materialize (they kept the unrefined path)
        stats["refine_near_totals"] = walk["refine_near_totals"]
        stats["refine_build_dropped"] = tree.refine_stats[1]
    if return_topo:
        return out, stats, WalkTopo(
            mono=walk["mono"], fb=walk["fb"], pidx=pidx, pvalid=pvalid,
            ntot=ntot, wmask=walk["wmask"], wstart=walk["wstart"])
    return out, stats


def traverse_tree_cached(tree, topo: WalkTopo, theta2, g, g_soft,
                         cfg: BHConfig, n: int):
    """Forces over a frozen walk topology (``nbody_tpu/ops/traversal.py:
    2358``): no collect walk; every interaction the topology lists is
    evaluated at the current positions.

      * accepted and fallback rows re-gather fresh mass and COM (and, via
        the refreshed ``all_quad``, quadrupoles) by their stored (level,
        cell id) from the refreshed level tables; padding rows (cached
        M = 0) stay inert, as their (0, 0) address would re-gather the
        root;
      * window, near and target rows read the refreshed ``pos_s`` /
        ``mass_s`` in the frozen order;
      * the fallback slab is evaluated here (it rides the walk otherwise).

    ``tree`` must share the topology's binning (``refresh_octree``).  Only
    the routing is stale: which cells are accepted, opened or near.
    Returns (acc [n, dim], stats) with the walk counters at 0."""
    if cfg.wide or cfg.near_sym:
        raise ValueError("walk reuse supports neither wide mode nor "
                         "near_sym")
    mode = _resolve_eval_mode(cfg, tree.pos_s)
    dtype = tree.pos_s.dtype
    eps2, pmass8, tgt8, gidx, W = _pack(tree, g_soft, cfg, n)
    flat = torch.cat(tree.level_table, dim=0)

    def regather(valid, lvl, cid):
        """Fresh node rows [.., 8] at (level, cell id) where ``valid``."""
        at = _level_offsets(lvl.to(torch.int64), cfg.branch) \
            + cid.to(torch.int64)
        return flat[torch.where(valid, at, 0)]

    # mono rows: (com, M, -1, level or -1, cell id, true level)
    mvalid = topo.mono[..., 3] > 0
    mrows = regather(mvalid, topo.mono[..., 7], topo.mono[..., 6])
    mm = torch.where(mvalid, mrows[..., 0], 0.0)
    mcom = mrows[..., 1:4] / torch.where(mm > 0, mm, 1.0)[..., None]
    mono = torch.cat([mcom, mm[..., None], topo.mono[..., 4:]], dim=-1)
    # fb rows: raw node rows + (level, cell id); the ranges are frozen, so
    # the re-gathered row's range equals the cached one
    fvalid = topo.fb[..., 0] > 0
    frows = regather(fvalid, topo.fb[..., 6], topo.fb[..., 7])
    fb = torch.cat([torch.where(fvalid[..., None], frows[..., :6], 0.0),
                    topo.fb[..., 6:]], dim=-1)
    mark("regather")
    acc_fb = _fb_eval(tgt8[..., :3], gidx, tgt8[..., 3], fb, g, eps2,
                      _fb_all_quad(tree, cfg), cfg.branch)
    mark("fb")
    walk = dict(mono=mono, wstart=topo.wstart, wmask=topo.wmask,
                center=_group_center(tgt8[..., :3], tgt8[..., 3]))
    acc, n_dual, slab_fill = _assemble_eval(
        pmass8, tgt8, tree, walk, topo.pidx, topo.pvalid, acc_fb, theta2, g,
        eps2, g_soft, cfg, W, mode, gidx[:, 0])
    out = _unsort(acc, tree, cfg, n)
    mark("scatter")
    zero = torch.zeros((), dtype=torch.int64, device=out.device)
    stats = {"accept_dropped": zero, "frontier_fallback": zero,
             "near_fallback": zero, "fb_spill": zero,
             "near_totals": topo.ntot, "dual_tiles": n_dual,
             "window_cov": topo.wmask.to(dtype).mean(),
             "slab_fill": slab_fill}
    return out, stats


#: host reads of a device value a step makes: the stateful paths read the
#: moved fraction once a step to decide on the host what the JAX package's
#: lax.cond decides on the device (changed under ``ops/work.py``'s LOCK)
HOST_READS = {"moved_frac": 0}


def reset_host_reads():
    with LOCK:
        for k in HOST_READS:
            HOST_READS[k] = 0


def _moved_fraction(tree, pos, mass, bounds, cfg: BHConfig,
                    move_cells: float) -> float:
    """The share of alive particles more than ``move_cells`` leaf cells
    (beyond half a cell) from the centre of the cell they were binned into,
    read back to the host (one counted sync).  ``pos`` and ``bounds`` are
    in the grid frame."""
    L = cfg.max_level
    gb = grid_bounds(bounds, L)
    pos_s = pos[tree.order][:, :cfg.dim]
    alive_s = mass[tree.order] > 0
    centers = morton.cell_centers_from_codes(
        torch.clamp(tree.code_s, max=cfg.branch ** L - 1), gb, L, cfg.dim)
    cell_w = gb.width / (1 << L)
    moved = ((pos_s - centers).abs().amax(dim=-1)
             > (0.5 + move_cells) * cell_w)
    counts = torch.stack([(moved & alive_s).sum(), alive_s.sum()])
    with LOCK:
        HOST_READS["moved_frac"] += 1
    n_moved, n_alive = counts.tolist()
    return n_moved / max(n_alive, 1)


def _build_args(cfg: BHConfig) -> dict:
    """``build_octree``'s arguments for ``cfg``'s unrefined tree."""
    return dict(dim=cfg.dim, quad=cfg.multipole == "quad",
                quad_leaf=cfg.quad_leaf)


def bh_accel_reuse(pos, mass, bounds, theta2, g, g_soft, tree,
                   topo: WalkTopo, age: int, cfg: BHConfig = None,
                   walk_every: int = 2, rebuild_frac: float = 0.5,
                   move_cells: float = 1.0):
    """Barnes-Hut forces with walk reuse (``nbody_tpu/ops/traversal.py:
    2506``): a build and a full walk every ``walk_every`` steps and
    whenever more than ``rebuild_frac`` of the alive particles strayed
    more than ``move_cells`` leaf cells from their frozen cell; in between
    a frozen-binning refresh and the cached-topology eval.

    ``age`` is a host int, so the cadence costs no sync; the moved
    fraction is read once a step (``HOST_READS``).  Returns (acc, stats,
    tree, topo, age_next): thread the last three as the step's carry."""
    cfg = BHConfig() if cfg is None else cfg
    pos = pos - bounds.center
    bounds = bounds.centered()
    frac = _moved_fraction(tree, pos, mass, bounds, cfg, move_cells)
    mark("moved_frac")
    do_full = age % walk_every == 0 or frac > rebuild_frac
    if do_full:
        tree = build_octree(pos, mass, bounds, cfg.max_level,
                            **_build_args(cfg))
        acc, stats, topo = traverse_tree(tree, bounds, theta2, g, g_soft,
                                         cfg, pos.shape[0], return_topo=True)
    else:
        tree = refresh_octree(tree, pos, mass, quad=cfg.multipole == "quad",
                              quad_leaf=cfg.quad_leaf)
        mark("refresh")
        acc, stats = traverse_tree_cached(tree, topo, theta2, g, g_soft, cfg,
                                          pos.shape[0])
    stats = dict(stats, full_walk=int(do_full), moved_frac=frac)
    return acc, stats, tree, topo, 1 if do_full else age + 1


def bh_accel_lazy(pos, mass, bounds, theta2, g, g_soft, tree,
                  cfg: BHConfig = None, rebuild_frac: float = 0.3,
                  move_cells: float = 1.0):
    """Barnes-Hut forces over the carried tree's binning, refreshed from
    the current positions, with a rebuild (the sort) only when more than
    ``rebuild_frac`` of the alive particles strayed more than
    ``move_cells`` leaf cells (``nbody_tpu/ops/traversal.py:2566``).  The
    walk runs every step.  Returns (acc, stats, new_tree)."""
    cfg = BHConfig() if cfg is None else cfg
    pos = pos - bounds.center
    bounds = bounds.centered()
    frac = _moved_fraction(tree, pos, mass, bounds, cfg, move_cells)
    mark("moved_frac")
    rebuilt = frac > rebuild_frac
    if rebuilt:
        tree = build_octree(pos, mass, bounds, cfg.max_level,
                            **_build_args(cfg))
    else:
        tree = refresh_octree(tree, pos, mass, quad=cfg.multipole == "quad",
                              quad_leaf=cfg.quad_leaf)
        mark("refresh")
    acc, stats = traverse_tree(tree, bounds, theta2, g, g_soft, cfg,
                               pos.shape[0])
    stats = dict(stats, rebuilt=int(rebuilt), moved_frac=frac)
    return acc, stats, tree


# elements of one [C, T, S] tile of the potential's pair pass
_PHI_TILE = 1 << 24


def _phi_slab_eval(slab, tgt8, g, eps2):
    """Per-target potential from the assembled slab [G, S, 8] (window and
    near rows exact with index self-exclusion; multipole rows have idx -1,
    which never matches).  Plain torch, tiled over groups and targets so a
    tile holds at most ``_PHI_TILE`` pairs; each target's sum over the S
    rows stays one reduction.  tgt8 [G, B, 8] -> [G, B]."""
    G, B, _ = tgt8.shape
    S = slab.shape[1]
    cg = max(1, _PHI_TILE // (B * S))
    bt = B if cg > 1 else max(1, min(B, _PHI_TILE // S))
    out = []
    for g0 in range(0, G, cg):
        sx, sy, sz, sm, si = (slab[g0:g0 + cg, None, :, k] for k in range(5))
        rows = []
        for b0 in range(0, B, bt):
            t = tgt8[g0:g0 + cg, b0:b0 + bt, None, :]  # [C, T, 1, 8]
            dx = sx - t[..., 0]
            dy = sy - t[..., 1]
            dz = sz - t[..., 2]
            r2 = dx * dx + dy * dy + dz * dz + eps2
            skip = (si == t[..., 4]) | (r2 <= 0.0) | (sm == 0.0)
            inv_r = torch.rsqrt(torch.where(skip, 1.0, r2))
            rows.append(torch.where(skip, 0.0, sm * inv_r).sum(-1))
        out.append(torch.cat(rows, dim=1))
    return -g * torch.cat(out)


def traverse_tree_phi(tree, bounds, theta2, g, g_soft, cfg: BHConfig,
                      n: int):
    """Tree-approximated total potential energy over a built tree: the
    collect walk and slab assembly of ``traverse_tree`` with a φ
    accumulator in place of forces, in plain torch on the tree's device.

    U = ½ Σ_i m_i φ_i.  Window and near pairs are exact (index
    self-exclusion); accepted nodes ride the pair pass as monopoles (no
    quadrupoles, no block-dual mask, no ``near_sym`` split, whatever the
    config's force path uses); fallback rows are self-excluded monopoles,
    fallback spills plain monopoles (counted in the stats).  Returns
    (U 0-d tensor, stats: the walk's four counters)."""
    eps2, pmass8, tgt8, gidx, W, walk = _walk(tree, bounds, theta2, g_soft,
                                              cfg, n)
    phi_fb = _fb_phi(tgt8[..., :3], gidx, tgt8[..., 3], walk["fb"], g, eps2)
    pidx, pvalid, _ = _near_lists(tree, walk, cfg)
    nrows = _near_rows(pmass8, pidx, pvalid)
    wrows = _window_rows(pmass8, walk["wstart"], walk["wmask"], W, cfg,
                         _sliding_ok(cfg, W))
    slab = torch.cat([wrows, nrows, walk["mono"]], dim=1)
    phi = _phi_slab_eval(slab, tgt8, g, eps2) + phi_fb
    u = 0.5 * (tgt8[..., 3] * phi).sum()
    return u, _walk_counters(walk)


def _refine_args(cfg: BHConfig) -> dict:
    """The refined build's arguments of ``build_octree`` for ``cfg``."""
    return dict(refine_levels=cfg.refine_levels, refine_cap=cfg.refine_cap,
                refine_threshold=cfg.refine_threshold_resolved)


def bh_accel(pos, mass, bounds, theta2, g, g_soft, cfg: BHConfig = None):
    """Full Barnes-Hut acceleration: build + traverse + scatter back.

    pos [N, D], mass [N] (zero for dead) -> (acc [N, D], stats).  The
    pipeline runs in the grid frame (pos - bounds.center): acceleration is
    translation-invariant, and recentring bounds every accumulation by the
    domain half-width."""
    cfg = BHConfig() if cfg is None else cfg
    _resolve_eval_mode(cfg, pos)  # refuse a run the kernels cannot take
    pos_c = pos - bounds.center
    b0 = bounds.centered()
    tree = build_octree(pos_c, mass, b0, cfg.max_level, **_build_args(cfg),
                        **_refine_args(cfg))
    return traverse_tree(tree, b0, theta2, g, g_soft, cfg, pos.shape[0])


def bh_potential(pos, mass, bounds, theta2, g, g_soft, cfg: BHConfig = None):
    """Tree-approximated total potential energy: build (no quadrupole
    moments) + ``traverse_tree_phi``, in the grid frame, on ``pos``'s
    device in its dtype (no kernel: float64 runs on the card too).

    pos [N, 3], mass [N] (zero for dead) -> (U 0-d tensor, stats)."""
    cfg = BHConfig() if cfg is None else cfg
    pos_c = pos - bounds.center
    b0 = bounds.centered()
    tree = build_octree(pos_c, mass, b0, cfg.max_level, dim=cfg.dim,
                        quad=False, **_refine_args(cfg))
    return traverse_tree_phi(tree, b0, theta2, g, g_soft, cfg, pos.shape[0])
