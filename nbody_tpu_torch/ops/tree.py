"""Linear octree build: Morton sort + dense level pyramid (the counterpart
of ``nbody_tpu/ops/tree.py``, unrefined 3D path).

The octree is a dense pyramid of per-level cell statistics over the
2^L x 2^L x 2^L Morton grid: level l has 8^l cells and cell c's children are
cells 8c..8c+7 of level l+1.  The build is (1) Morton-encode and stably sort
the particles, (2) leaf statistics from double-float prefix sums over the
sorted particles, (3) reshape-sums up the pyramid.  Mass-weighted position
sums (not COMs) are stored, so empty cells are exact zeros and a parent is a
plain sum of its children.

No float reduction here uses atomics, so a build on the card is
bit-reproducible: the JAX package's float ``segment_sum`` scatters (the
sparse leaf branch and the quadrupole moments) become range differences of
one ordered double-float prefix scan, and the pyramid sums add the eight
children in a fixed order.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from nbody_tpu_torch.ops import morton

BRANCH = 8  # children per cell (octree)


@dataclass(frozen=True)
class LinearOctree:
    """Sorted particles + dense level pyramid.

    ``level_mass[l]`` has shape [8^l]; ``level_mpos[l]`` [8^l, 3]
    (mass-weighted position sums).  ``code_s`` are the leaf-level Morton cell
    ids of the sorted particles, with dead/padding particles given the
    out-of-range sentinel 8^L so they sort to the tail and match no cell."""

    pos_s: torch.Tensor  # [N, 3] positions in Morton order
    mass_s: torch.Tensor  # [N] effective masses in Morton order
    code_s: torch.Tensor  # [N] int32 leaf cell ids (sorted), sentinel 8^L
    order: torch.Tensor  # [N] int64 original index of each sorted slot
    #: [8^L + 1] int32 cumulative particle counts: leaf cell c holds sorted
    #: slots [leaf_starts[c], leaf_starts[c + 1])
    leaf_starts: torch.Tensor
    level_mass: Tuple[torch.Tensor, ...]
    level_mpos: Tuple[torch.Tensor, ...]
    #: packed per-level node rows [8^l, 8]: (mass, mx, my, mz, range_start,
    #: range_end, 0, 0); the ranges are exact integers in the float dtype
    #: (guarded by _check_range_dtype)
    level_table: Tuple[torch.Tensor, ...]
    #: all levels' raw second moments about the grid origin, concatenated
    #: (level l starts at row level_offset(l)): (Sxx, Syy, Szz, Sxy, Sxz,
    #: Syz, 0, 0).  None when built with quad=False.
    all_quad: Optional[torch.Tensor]

    @property
    def max_level(self) -> int:
        return len(self.level_mass) - 1


def level_offset(level: int, branch: int = BRANCH) -> int:
    """Row offset of ``level``'s cells in the concatenated all-level
    quadrupole table."""
    return ((branch ** level) - 1) // (branch - 1)


def grid_bounds(bounds, max_level: int):
    """Tree grid = domain box shifted by half a leaf cell in every axis, so
    the domain's center planes (the disc lies exactly on z = 0) are never
    cell boundaries at any level.  The cull still uses the unshifted box."""
    import dataclasses

    cell = bounds.width / (1 << max_level)
    return dataclasses.replace(bounds, center=bounds.center + cell * 0.5)


def _quad_moments(pos_s, mass_s):
    """Raw second moments m p pᵀ per particle, packed 6-wide
    (xx, yy, zz, xy, xz, yz)."""
    w = pos_s * mass_s[:, None]
    return torch.stack([w[:, 0] * pos_s[:, 0], w[:, 1] * pos_s[:, 1],
                        w[:, 2] * pos_s[:, 2], w[:, 0] * pos_s[:, 1],
                        w[:, 0] * pos_s[:, 2], w[:, 1] * pos_s[:, 2]], dim=1)


def _sum_children(x, branch: int = BRANCH):
    """[C * branch, ...] -> [C, ...]: each parent's children added in the
    fixed order 0..branch-1 (the same order on every device)."""
    x = x.reshape(-1, branch, *x.shape[1:])
    s = x[:, 0]
    for k in range(1, branch):
        s = s + x[:, k]
    return s


def _build_prefix_table(vals):
    """Double-float prefix sums of sorted per-particle values: [N, K<=4] ->
    [N+1, 8] (hi columns | lo columns | zero padding).

    A log-step (Hillis-Steele) scan with the TwoSum combiner of the JAX
    package's ``lax.associative_scan`` (``tree.py:242-251``): every partial
    is a hi + lo pair accurate to ~2^-46 relative, so a boundary difference
    keeps that accuracy where a plain f32 cumsum difference would put
    ~ulp(total) on every range (a one-particle leaf's COM could move by the
    whole domain)."""
    n, k = vals.shape
    if k > 4:
        raise ValueError(f"prefix tables take at most 4 columns, got {k}")
    hi, lo = vals, torch.zeros_like(vals)
    shift = 1
    while shift < n:
        ah, al = hi[:-shift], lo[:-shift]  # earlier partials
        bh, bl = hi[shift:], lo[shift:]
        s = ah + bh
        z = s - ah
        e = (ah - (s - z)) + (bh - z)  # TwoSum rounding error of s
        hi = torch.cat([hi[:shift], s])
        lo = torch.cat([lo[:shift], e + al + bl])
        shift *= 2
    zero = torch.zeros((1, k), dtype=vals.dtype, device=vals.device)
    parts = [torch.cat([zero, hi]), torch.cat([zero, lo])]
    if k < 4:
        parts.append(torch.zeros((n + 1, 8 - 2 * k), dtype=vals.dtype,
                                 device=vals.device))
    return torch.cat(parts, dim=1)


def _prefix_range_sums(vals, starts):
    """Per-range sums of sorted per-particle values: ``vals`` [N, K<=4],
    ``starts`` [C + 1] sorted range boundaries -> [C, K], as the
    double-float boundary difference (hi_e - hi_s) + (lo_e - lo_s)."""
    p = _build_prefix_table(vals)
    k = vals.shape[1]
    r = p[starts.long()]
    d = r[1:] - r[:-1]
    return d[:, :k] + d[:, k:2 * k]


def _prefix_leaf_stats(pos_s, mass_s, leaf_starts):
    """Leaf-cell (mass, mass-weighted position) via _prefix_range_sums."""
    w4 = torch.cat([mass_s[:, None], pos_s * mass_s[:, None]], dim=1)
    vals = _prefix_range_sums(w4, leaf_starts)
    return vals[:, 0], vals[:, 1:4]


def _build_quad(pos_s, mass_s, leaf_starts, max_level: int):
    """Raw second moments of the level-(L-1) cells (the leaf level is not
    built: accepted leaf cells evaluate as monopoles, ``quad_leaf=False``).
    The JAX package segment-sums into code // 8 (``tree.py:200``); here the
    same sums are prefix-range differences over every 8th leaf boundary —
    the variant that file keeps at ``tree.py:188-195``, ordered and free of
    float atomics."""
    m6 = _quad_moments(pos_s, mass_s)
    starts = leaf_starts[::BRANCH]
    q = torch.cat([_prefix_range_sums(m6[:, :3], starts),
                   _prefix_range_sums(m6[:, 3:], starts)], dim=1)
    return q, max_level - 1


def _quad_pyramid(base_quad, top_level: int, ftype):
    """Aggregate second moments from the ``top_level`` cells up the pyramid
    and concatenate levels 0..top_level into one [rows, 8] table (root
    first)."""
    levels = [base_quad]
    for _ in range(top_level):
        levels.append(_sum_children(levels[-1]))
    levels.reverse()
    flat = torch.cat([q.to(ftype) for q in levels], dim=0)
    pad = torch.zeros((flat.shape[0], 2), dtype=ftype, device=flat.device)
    return torch.cat([flat, pad], dim=1)


def _compact(ids, keep, out_slots: int):
    """Order-preserving compaction of ``ids[..., keep]`` into ``out_slots``
    slots along the last axis, by cumsum + scatter (no sort, no host sync).
    Works on any leading batch shape.  Returns (ids [..., out_slots], valid
    [..., out_slots], n_dropped [...])."""
    keep_i = keep.to(torch.int32)
    slot = torch.cumsum(keep_i, dim=-1) - 1
    # kept entries beyond the cap, and all non-kept entries, go to the trash
    # slot at index out_slots
    slot = torch.where(keep & (slot < out_slots), slot, out_slots).long()
    out = torch.zeros((*ids.shape[:-1], out_slots + 1), dtype=ids.dtype,
                      device=ids.device)
    out.scatter_(-1, slot, ids)
    n_keep = keep_i.sum(dim=-1)
    valid = (torch.arange(out_slots, device=ids.device)
             < torch.clamp(n_keep, max=out_slots)[..., None])
    dropped = torch.clamp(n_keep - out_slots, min=0)
    return out[..., :out_slots], valid, dropped


def _check_range_dtype(n: int, ftype) -> None:
    """Packed node rows store particle-range starts/ends in the position
    dtype; counts beyond its mantissa (2^24 in f32, 2^53 in f64) would
    silently corrupt the ranges, so refuse them.  The JAX package's wide
    hi/lo range encoding (domain-decomposed builds) is not ported."""
    limit = 1 << (53 if ftype == torch.float64 else 24)
    if n >= limit:
        raise ValueError(
            f"N={n} exceeds the exact-integer range of {ftype} node tables; "
            "use float64 for N >= 2^24 (the wide row format of the domain "
            "path is ROADMAP.md, queue 1, item 17)"
        )


def decode_ranges(row):
    """(range_start, range_end) int32 from packed node rows [..., 8]
    (narrow mode: columns 4/5 hold exact integers)."""
    return row[..., 4].to(torch.int32), row[..., 5].to(torch.int32)


def _pyramid_tables(leaf_mass, leaf_mpos, leaf_counts, max_level: int,
                    ftype):
    """Aggregate leaf statistics up the dense pyramid and pack the per-level
    node tables.  Returns (level_mass, level_mpos, level_table)."""
    stats = [torch.cat([leaf_mass[:, None], leaf_mpos], dim=1)]  # [C, 4]
    counts = [leaf_counts]
    for _ in range(max_level):
        stats.append(_sum_children(stats[-1]))
        counts.append(counts[-1].reshape(-1, BRANCH).sum(dim=1))
    stats.reverse()
    counts.reverse()

    level_table = []
    for l in range(max_level + 1):
        ends = torch.cumsum(counts[l], dim=0, dtype=torch.int32)
        starts = ends - counts[l]
        zero = torch.zeros_like(starts, dtype=ftype)
        level_table.append(torch.stack(
            [stats[l][:, 0].to(ftype), stats[l][:, 1].to(ftype),
             stats[l][:, 2].to(ftype), stats[l][:, 3].to(ftype),
             starts.to(ftype), ends.to(ftype), zero, zero], dim=1))
    return (tuple(s[:, 0] for s in stats), tuple(s[:, 1:4] for s in stats),
            tuple(level_table))


def build_octree(pos, mass, bounds, max_level: int = 7, quad: bool = False,
                 quad_leaf: bool = False) -> LinearOctree:
    """pos [N, 3], mass [N] (dead particles already at mass 0) -> the
    octree.  ``bounds`` is the domain box; the grid is its half-leaf-shifted
    version (grid_bounds)."""
    n = pos.shape[0]
    _check_range_dtype(n, pos.dtype)
    if pos.shape[1] != 3:
        raise NotImplementedError(
            "2D (quadtree) states on the bh engines are not yet ported to "
            "nbody_tpu_torch (ROADMAP.md, queue 1, item 18)")
    if quad and quad_leaf:
        raise NotImplementedError(
            "quad_leaf=True (leaf-level quadrupoles) is not yet ported to "
            "nbody_tpu_torch (ROADMAP.md, queue 1, item 18)")
    if max_level > morton.MAX_LEVEL_3D:
        raise ValueError(f"max_level {max_level} exceeds the 3D Morton code "
                         f"depth limit ({morton.MAX_LEVEL_3D})")
    n_leaf = BRANCH ** max_level
    gb = grid_bounds(bounds, max_level)
    codes = morton.cell_codes(pos, gb, max_level)
    # dead particles get the sentinel: they sort to the tail and match no
    # cell range
    codes = torch.where(mass > 0, codes, n_leaf)

    # a stable sort is the JAX package's payload-carrying lax.sort with an
    # iota payload: the same permutation
    code_s, order = torch.sort(codes, stable=True)
    pos_s = pos[order]
    mass_s = mass[order]

    # leaf cell c holds the sorted slots [start(c), start(c + 1)), start(c)
    # = #codes < c; a search needs no host sync, where torch.bincount reads
    # the largest code back to size its output
    leaf_starts = torch.searchsorted(
        code_s, torch.arange(n_leaf + 1, dtype=torch.int32,
                             device=pos.device)).to(torch.int32)
    leaf_counts = leaf_starts[1:] - leaf_starts[:-1]
    # both of the JAX package's leaf branches (prefix sums when 4N >= 8^L,
    # sorted segment-sums otherwise) become the prefix path here
    leaf_mass, leaf_mpos = _prefix_leaf_stats(pos_s, mass_s, leaf_starts)

    level_mass, level_mpos, level_table = _pyramid_tables(
        leaf_mass, leaf_mpos, leaf_counts, max_level, pos.dtype)

    all_quad = None
    if quad:
        q, top = _build_quad(pos_s, mass_s, leaf_starts, max_level)
        all_quad = _quad_pyramid(q, top, pos.dtype)

    return LinearOctree(pos_s=pos_s, mass_s=mass_s, code_s=code_s,
                        order=order, leaf_starts=leaf_starts,
                        level_mass=level_mass, level_mpos=level_mpos,
                        level_table=level_table, all_quad=all_quad)


def cell_ranges(tree: LinearOctree, cell_ids, level: int):
    """Sorted-particle ranges [start, end) for level-``level`` cell ids."""
    shift = 3 * (tree.max_level - level)
    cell_ids = cell_ids.long()
    return (tree.leaf_starts[cell_ids << shift],
            tree.leaf_starts[(cell_ids + 1) << shift])


def leaf_ranges(tree: LinearOctree, cell_ids):
    """Sorted-particle ranges [start, end) for leaf cell ids (any shape)."""
    start = torch.searchsorted(tree.code_s, cell_ids, side="left")
    end = torch.searchsorted(tree.code_s, cell_ids + 1, side="left")
    return start, end
