"""Linear octree build: Morton sort + dense level pyramid (the counterpart
of ``nbody_tpu/ops/tree.py``), with optional density-adaptive refined
levels below the leaf grid (``refine_levels > 0``), the frozen-binning
refresh of the lazy and walk-reuse engines (``refresh_octree``) and 2D
quadtrees (``dim=2``).

The octree is a dense pyramid of per-level cell statistics over the
2^L x 2^L x 2^L Morton grid: level l has 8^l cells and cell c's children are
cells 8c..8c+7 of level l+1 (a quadtree: 4^l cells, 4 children, the stored
coordinates kept 3-wide with z = 0).  The build is (1) Morton-encode and
stably sort the particles, (2) leaf statistics from double-float prefix
sums over the sorted particles (``ops/prefix_scan.py``: a kernel on the
card), (3) reshape-sums up the pyramid.  Mass-weighted position
sums (not COMs) are stored, so empty cells are exact zeros and a parent is a
plain sum of its children.

No float reduction here uses atomics, so a build on the card is
bit-reproducible: the JAX package's float ``segment_sum`` scatters (the
sparse leaf branch and the quadrupole moments) become range differences of
one ordered double-float prefix scan, and the pyramid sums add the eight
children in a fixed order.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from nbody_tpu_torch.ops import morton
from nbody_tpu_torch.ops.prefix_scan import prefix_table
from nbody_tpu_torch.utils.profiling import mark

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
    #: (level l starts at row (branch^l - 1) / (branch - 1)): (Sxx, Syy,
    #: Szz, Sxy, Sxz, Syz, 0, 0).  None when built with quad=False.
    all_quad: Optional[torch.Tensor]
    #: density-adaptive refinement (built with refine_levels > 0, else all
    #: None).  refine_tables[r] holds the children of the level-(L + r)
    #: flagged cells as packed node rows [refine_cap * 8, 8] in the
    #: level_table format; the parent of row j is slot j // 8, and invalid
    #: slots carry zero mass and an empty range.  Particles are sorted by
    #: deep Morton codes (depth L + refine_levels, same grid), so every
    #: refined cell is one contiguous sorted range.
    refine_tables: Optional[Tuple[torch.Tensor, ...]] = None
    #: [8^L] int32: flagged leaf cell -> its parent slot in refine_tables[0]
    #: (children at rows slot * 8 + k), -1 otherwise
    refine_slot_leaf: Optional[torch.Tensor] = None
    #: per refined level r < R: [refine_cap * 8] int32, a refine_tables[r]
    #: row -> its parent slot in refine_tables[r + 1], -1 if not refined
    refine_child_slot: Optional[Tuple[torch.Tensor, ...]] = None
    #: [2] int32: flagged cells over all levels, and those dropped because
    #: refine_cap was full (they keep the unrefined near/fallback path)
    refine_stats: Optional[torch.Tensor] = None

    @property
    def max_level(self) -> int:
        return len(self.level_mass) - 1

    @property
    def branch(self) -> int:
        """Children per cell: 8 for octrees (3D), 4 for quadtrees (2D)."""
        return self.level_mass[1].shape[0]

    @property
    def dim(self) -> int:
        return self.branch.bit_length() - 1


def grid_bounds(bounds, max_level: int):
    """Tree grid = domain box shifted by half a leaf cell in every axis, so
    the domain's center planes (the disc lies exactly on z = 0) are never
    cell boundaries at any level.  The cull still uses the unshifted box."""
    cell = bounds.width / (1 << max_level)
    return dataclasses.replace(bounds, center=bounds.center + cell * 0.5)


def _quad_moments(pos_s, mass_s):
    """Raw second moments m p pᵀ per particle as two [N, 3] tables: the
    diagonal (xx, yy, zz) and the off-diagonal (xy, xz, yz)."""
    w = pos_s * mass_s[:, None]
    return w * pos_s, torch.stack([w[:, 0] * pos_s[:, 1],
                                   w[:, 0] * pos_s[:, 2],
                                   w[:, 1] * pos_s[:, 2]], dim=1)


def _sum_children(x, branch: int):
    """[C * branch, ...] -> [C, ...]: each parent's children added in the
    fixed order 0..branch-1 (the same order on every device)."""
    x = x.reshape(-1, branch, *x.shape[1:])
    s = x[:, 0]
    for k in range(1, branch):
        s = s + x[:, k]
    return s


def _prefix_range_sums(vals, starts):
    """Per-range sums of sorted per-particle values: ``vals`` [N, K<=4],
    ``starts`` [C + 1] sorted range boundaries -> [C, K], as the
    double-float boundary difference (hi_e - hi_s) + (lo_e - lo_s)."""
    p = prefix_table(vals)
    k = vals.shape[1]
    r = p[starts.long()]
    d = r[1:] - r[:-1]
    return d[:, :k] + d[:, k:2 * k]


def _range_sums_from_table(p, starts, ends, k: int):
    """Per-range sums from a ``prefix_table`` table for arbitrary
    (start, end) pairs (the refined build's ranges are not consecutive
    boundaries), with _prefix_range_sums' double-float accuracy."""
    d = p[ends.long()] - p[starts.long()]
    return d[:, :k] + d[:, k:2 * k]


def _build_quad(pos_s, mass_s, leaf_starts, max_level: int, branch: int,
                quad_leaf: bool):
    """Raw second moments of the leaf cells (``quad_leaf=True``) or of the
    level-(L-1) cells (the leaf level is not built: accepted leaf cells
    evaluate as monopoles).  The JAX package segment-sums into code or
    code // branch (``tree.py:160-208``); here the same sums are
    prefix-range differences over every leaf boundary or every branch-th
    one (the variant that file keeps at ``tree.py:188-195``), ordered and
    free of float atomics."""
    diag, off = _quad_moments(pos_s, mass_s)
    stride = 1 if quad_leaf else branch
    starts = leaf_starts[::stride]
    q = torch.cat([_prefix_range_sums(diag, starts),
                   _prefix_range_sums(off, starts)], dim=1)
    return q, max_level if quad_leaf else max_level - 1


def _quad_pyramid(base_quad, top_level: int, branch: int, ftype):
    """Aggregate second moments from the ``top_level`` cells up the pyramid
    and concatenate levels 0..top_level into one [rows, 8] table (root
    first)."""
    levels = [base_quad]
    for _ in range(top_level):
        levels.append(_sum_children(levels[-1], branch))
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


def _slot_map(keys, valid, size: int, n_slots: int):
    """[size] int32 map from a compacted key list to its slot: entry
    ``keys[s]`` holds s where ``valid[s]``, every other entry -1.  Invalid
    slots write to a trash entry at ``size`` (sliced off), so no index is
    ever negative."""
    out = torch.full((size + 1,), -1, dtype=torch.int32, device=keys.device)
    out[torch.where(valid, keys, size).long()] = torch.arange(
        n_slots, dtype=torch.int32, device=keys.device)
    return out[:size]


def _build_refined(p, deep_code_s, leaf_counts, max_level: int,
                   refine_levels: int, refine_cap: int, threshold: int,
                   branch: int, dim: int, ftype):
    """Density-adaptive levels below the dense pyramid's leaf grid
    (``nbody_tpu/ops/tree.py:294-393``).

    Leaf cells holding more than ``threshold`` particles are flagged and
    their children materialized as packed node rows; children still above
    the threshold recurse, up to ``refine_levels`` extra levels with at
    most ``refine_cap`` refined parents a level (beyond it the cell keeps
    the unrefined path, counted).  The particles are sorted by deep Morton
    codes, so a refined cell's sorted range is one search of its code
    bounds (lo || hi in one ``searchsorted`` a level); mass and m·pos are
    differences of the leaf stats' double-float prefix table ``p`` of
    (m, m x, m y, m z).

    Returns (refine_tables, refine_slot_leaf, refine_child_slot,
    refine_stats), as the LinearOctree fields."""
    n_leaf = branch ** max_level
    l_deep = max_level + refine_levels
    rows_per = refine_cap * branch
    dev = p.device
    i32 = dict(dtype=torch.int32, device=dev)
    kids = torch.arange(branch, **i32)

    flagged = leaf_counts > threshold
    p_codes, p_valid, dropped = _compact(torch.arange(n_leaf, **i32),
                                         flagged, refine_cap)
    total_flagged = flagged.sum(dtype=torch.int32)
    total_dropped = dropped.to(torch.int32)
    slot_leaf = _slot_map(p_codes, p_valid, n_leaf, refine_cap)

    tables, child_maps = [], []
    for r in range(1, refine_levels + 1):
        child_codes = (p_codes[:, None] * branch + kids).reshape(rows_per)
        child_valid = p_valid.repeat_interleave(branch)
        # (code + 1) << shift reaches 2^30 at the deepest level: int32
        shift = dim * (l_deep - (max_level + r))
        lo = torch.where(child_valid, child_codes << shift, 0)
        hi = torch.where(child_valid, (child_codes + 1) << shift, 0)
        bounds_ = torch.searchsorted(deep_code_s, torch.cat([lo, hi]),
                                     side="left").to(torch.int32)
        cs = torch.where(child_valid, bounds_[:rows_per], 0)
        ce = torch.where(child_valid, bounds_[rows_per:], 0)
        sums = _range_sums_from_table(p, cs, ce, 4)
        m = torch.where(child_valid & (ce > cs), sums[:, 0], 0.0)
        zero = torch.zeros((rows_per,), dtype=ftype, device=dev)
        tables.append(torch.stack(
            [m.to(ftype), sums[:, 1].to(ftype), sums[:, 2].to(ftype),
             sums[:, 3].to(ftype), cs.to(ftype), ce.to(ftype), zero, zero],
            dim=1))
        if r < refine_levels:
            flag_r = child_valid & (ce - cs > threshold)
            p_rows, p_valid, dropped = _compact(torch.arange(rows_per, **i32),
                                                flag_r, refine_cap)
            total_flagged = total_flagged + flag_r.sum(dtype=torch.int32)
            total_dropped = total_dropped + dropped.to(torch.int32)
            child_maps.append(_slot_map(p_rows, p_valid, rows_per,
                                        refine_cap))
            p_codes = torch.where(p_valid, child_codes[p_rows.long()], 0)

    stats = torch.stack([total_flagged, total_dropped])
    return tuple(tables), slot_leaf, tuple(child_maps), stats


def _leaf_stats(pos_s, mass_s, leaf_starts):
    """Leaf (mass, mass-weighted position) of the sorted particles as
    double-float range differences over ``leaf_starts``.  Both of the JAX
    package's leaf branches (prefix sums when 4N >= 8^L, sorted
    segment-sums otherwise) become this path.  Returns (the prefix table,
    which the refined build reuses, leaf_mass, leaf_mpos)."""
    table = prefix_table(
        torch.cat([mass_s[:, None], pos_s * mass_s[:, None]], dim=1))
    leaf = _range_sums_from_table(table, leaf_starts[:-1], leaf_starts[1:], 4)
    return table, leaf[:, 0], leaf[:, 1:4]


def _segment_leaf_stats(pos_s, mass_s, leaf_starts):
    """Leaf [C, 4] float64 rows (mass, mass-weighted position) of the sorted
    particles as segment sums over ``leaf_starts`` [C + 1], each leaf summed
    in row order as the JAX package's sorted ``segment_sum``; rows past the
    last start (the dead tail) drop out.  The sums accumulate in float64, so
    an f32 leaf of a few thousand rows rounds once, as the single-chip
    build's double-float sums do (f32 row-order sums moved a force row of
    the 2^20 disc by 5.5e-4 of the mean row on an H100).  No float
    atomics."""
    wm = torch.cat([mass_s[:, None], pos_s * mass_s[:, None]], dim=1)
    return torch.segment_reduce(wm.to(torch.float64), "sum",
                                offsets=leaf_starts.long(), axis=0,
                                unsafe=True)


#: from this N on, f32 node-table range columns lose integer exactness and
#: the domain-decomposed build switches to the wide row format (each range
#: split hi/lo over two f32 columns, exact to 2^31); module-level so tests
#: can lower it and run the wide path at small N (``tree.py:398``)
WIDE_N = 1 << 24
_RANGE_SHIFT = 12  # wide split: v = hi * 2^12 + lo; hi < 2^19, lo < 2^12


def wide_ranges(n: int, ftype) -> bool:
    """Whether node tables for ``n`` particles in total take the wide range
    encoding: f32 from ``WIDE_N`` on (f64 holds exact integers to 2^53).
    The table build and every range consumer ask this same predicate."""
    return ftype == torch.float32 and n >= WIDE_N


def _check_range_dtype(n: int, ftype, wide: bool = False) -> None:
    """Packed node rows store particle-range starts/ends in the position
    dtype; counts beyond its mantissa (2^24 in f32, 2^53 in f64) would
    silently corrupt the ranges, so refuse them.  The wide encoding
    (domain-decomposed builds, ``wide_ranges``) lifts the f32 ceiling to
    2^31, the limit of the int32 index arithmetic."""
    limit = 1 << (53 if ftype == torch.float64 else (31 if wide else 24))
    if n >= limit:
        raise ValueError(
            f"N={n} exceeds the exact-integer range of {ftype} node tables; "
            "use float64 for N >= 2^24"
        )


def decode_ranges(row, wide: bool = False):
    """(range_start, range_end) int32 from packed node rows [..., 8].
    Narrow: columns 4/5 hold the values (exact integers by the
    _check_range_dtype guard).  Wide: columns 4-7 hold (start_hi, start_lo,
    end_hi, end_lo) with v = hi * 2^12 + lo, every part below 2^19, so an
    f32 row stays exact to N = 2^31."""
    if not wide:
        return row[..., 4].to(torch.int32), row[..., 5].to(torch.int32)
    part = row[..., 4:8].to(torch.int32)
    return ((part[..., 0] << _RANGE_SHIFT) | part[..., 1],
            (part[..., 2] << _RANGE_SHIFT) | part[..., 3])


def _level_stats(leaf_mass, leaf_mpos, max_level: int, branch: int):
    """Leaf (mass, mass-weighted position) summed up the dense pyramid:
    [C, 4] rows a level, root first."""
    stats = [torch.cat([leaf_mass[:, None], leaf_mpos], dim=1)]  # [C, 4]
    for _ in range(max_level):
        stats.append(_sum_children(stats[-1], branch))
    stats.reverse()
    return stats


def _pyramid_tables(leaf_mass, leaf_mpos, leaf_counts, max_level: int,
                    branch: int, ftype, wide: bool = False):
    """Aggregate leaf statistics up the dense pyramid and pack the per-level
    node tables; ``wide`` takes the hi/lo range encoding (decode_ranges).
    Returns (level_mass, level_mpos, level_table)."""
    stats = _level_stats(leaf_mass, leaf_mpos, max_level, branch)
    counts = [leaf_counts]
    for _ in range(max_level):
        counts.append(counts[-1].reshape(-1, branch).sum(dim=1))
    counts.reverse()

    level_table = []
    for l in range(max_level + 1):
        # integer sums: an f32 partial sum would round past 2^24
        ends = torch.cumsum(counts[l], dim=0, dtype=torch.int32)
        starts = ends - counts[l].to(torch.int32)
        if wide:
            mask = (1 << _RANGE_SHIFT) - 1
            ranges = [starts >> _RANGE_SHIFT, starts & mask,
                      ends >> _RANGE_SHIFT, ends & mask]
        else:
            zero = torch.zeros_like(starts)
            ranges = [starts, ends, zero, zero]
        level_table.append(torch.stack(
            [stats[l][:, 0].to(ftype), stats[l][:, 1].to(ftype),
             stats[l][:, 2].to(ftype), stats[l][:, 3].to(ftype),
             *(r.to(ftype) for r in ranges)], dim=1))
    return (tuple(s[:, 0] for s in stats), tuple(s[:, 1:4] for s in stats),
            tuple(level_table))


def build_octree(pos, mass, bounds, max_level: int = 7, dim: int = 3,
                 quad: bool = False, quad_leaf: bool = True,
                 refine_levels: int = 0, refine_cap: int = 8192,
                 refine_threshold: int = 512) -> LinearOctree:
    """pos [N, D], mass [N] (dead particles already at mass 0) -> the
    octree (``nbody_tpu/ops/tree.py:507``).  ``bounds`` is the domain box;
    the grid is its half-leaf-shifted version (grid_bounds).

    ``dim=2`` builds a quadtree (2D Morton codes, 4 children a cell); the
    stored coordinates stay 3-wide with z = 0, so the walk and the kernels
    see 3D rows.  ``quad_leaf=True`` (the default, as in the JAX package)
    builds the leaf level's second moments too; the engines pass their
    config's value (``BHConfig.quad_leaf``, False by default).

    ``refine_levels > 0`` adds up to that many density-adaptive levels below
    the leaf grid for cells holding more than ``refine_threshold``
    particles (_build_refined).  The particles are then sorted by deep
    Morton codes on the same grid, so ``code_s`` (their leaf-level
    prefixes) and the dense pyramid are unchanged; only the order within a
    leaf cell differs.  The span recorder's ``mark`` closes "build" after
    the dense pyramid and "refined build" after the refined levels."""
    n = pos.shape[0]
    _check_range_dtype(n, pos.dtype)
    branch = 1 << dim
    l_deep = max_level + refine_levels
    limit = morton.MAX_LEVEL_3D if dim == 3 else morton.MAX_LEVEL_2D
    if l_deep > limit:
        raise ValueError(
            f"max_level + refine_levels = {l_deep} exceeds the {dim}D "
            f"Morton code depth limit ({limit})")
    n_leaf = branch ** max_level
    gb = grid_bounds(bounds, max_level)
    codes = morton.cell_codes(pos[:, :dim], gb, l_deep)
    # dead particles get the sentinel: they sort to the tail and match no
    # cell range
    codes = torch.where(mass > 0, codes, branch ** l_deep)
    if dim == 2:
        pos = torch.cat([pos, pos.new_zeros((n, 1))], dim=1)

    # a stable sort is the JAX package's payload-carrying lax.sort with an
    # iota payload: the same permutation
    deep_code_s, order = torch.sort(codes, stable=True)
    pos_s = pos[order]
    mass_s = mass[order]
    # leaf codes are the deep codes' prefixes (the sentinel
    # branch^l_deep maps to branch^L); with refine_levels == 0 this is the
    # identity
    code_s = deep_code_s >> (dim * refine_levels)

    # leaf cell c holds the sorted slots [start(c), start(c + 1)), start(c)
    # = #codes < c; a search needs no host sync, where torch.bincount reads
    # the largest code back to size its output
    leaf_starts = torch.searchsorted(
        code_s, torch.arange(n_leaf + 1, dtype=torch.int32,
                             device=pos.device)).to(torch.int32)
    leaf_counts = leaf_starts[1:] - leaf_starts[:-1]
    table, leaf_mass, leaf_mpos = _leaf_stats(pos_s, mass_s, leaf_starts)

    level_mass, level_mpos, level_table = _pyramid_tables(
        leaf_mass, leaf_mpos, leaf_counts, max_level, branch, pos.dtype)

    all_quad = None
    if quad:
        q, top = _build_quad(pos_s, mass_s, leaf_starts, max_level, branch,
                             quad_leaf)
        all_quad = _quad_pyramid(q, top, branch, pos.dtype)

    mark("build")
    refine = {}
    if refine_levels > 0:
        tables, slot_leaf, child_maps, rstats = _build_refined(
            table, deep_code_s, leaf_counts, max_level,
            refine_levels, refine_cap, refine_threshold, branch, dim,
            pos.dtype)
        refine = dict(refine_tables=tables, refine_slot_leaf=slot_leaf,
                      refine_child_slot=child_maps, refine_stats=rstats)
        mark("refined build")

    return LinearOctree(pos_s=pos_s, mass_s=mass_s, code_s=code_s,
                        order=order, leaf_starts=leaf_starts,
                        level_mass=level_mass, level_mpos=level_mpos,
                        level_table=level_table, all_quad=all_quad,
                        **refine)


def _slice_starts(leaf_starts, lo: int, n: int):
    """Global leaf boundaries ``leaf_starts`` clipped to the sorted slots
    [lo, lo + n) and made relative to lo: the leaf boundaries of one
    rank's contiguous sorted slice."""
    return torch.clamp(leaf_starts - lo, 0, n)


def build_octree_sharded(pos_loc, mass_loc, pos_all, mass_all, bounds,
                         max_level: int, mesh, dim: int = 3,
                         quad: bool = False, quad_leaf: bool = True,
                         refine_levels: int = 0, refine_cap: int = 8192,
                         refine_threshold: int = 512) -> LinearOctree:
    """The replicated octree built across the mesh
    (``nbody_tpu/ops/tree.py:626``): every rank gets the tree
    ``build_octree(pos_all, mass_all, ...)`` gives, with the same stable
    sort and exact integer counts.

    ``pos_loc`` / ``mass_loc`` are this rank's shard (dead particles at mass
    0), ``pos_all`` / ``mass_all`` the already all-gathered arrays.  Each
    rank Morton-encodes its shard and the codes are gathered; one stable
    sort of them (the index breaks ties, as ``lax.sort`` of (codes, iota)
    does) gives every rank the order; each rank gathers the sorted rows of
    its slice.  The leaf counts and the quadrupole moments are its slice's
    sums, merged by ``psum``.  Mass and m·pos follow JAX's two regimes:
    where 4N >= 8^L, the single-chip build's double-float range differences
    run replicated on the gathered sorted arrays, so the tree is
    ``build_octree``'s bit for bit on every rank; below it, each rank's
    segment sums, merged by ``psum``.  ``refine_levels > 0`` runs the
    refined build replicated on the gathered sorted arrays, bit-identical
    to ``build_octree``'s on every rank."""
    from nbody_tpu_torch.parallel import collectives as coll

    n_loc = pos_loc.shape[0]
    n_tot = pos_all.shape[0]
    _check_range_dtype(n_tot, pos_all.dtype)
    branch = 1 << dim
    l_deep = max_level + refine_levels
    limit = morton.MAX_LEVEL_3D if dim == 3 else morton.MAX_LEVEL_2D
    if l_deep > limit:
        raise ValueError(
            f"max_level + refine_levels = {l_deep} exceeds the {dim}D "
            f"Morton code depth limit ({limit})")
    n_leaf = branch ** max_level
    gb = grid_bounds(bounds, max_level)
    lo = mesh.rank * n_loc

    codes_loc = morton.cell_codes(pos_loc[:, :dim], gb, l_deep)
    codes_loc = torch.where(mass_loc > 0, codes_loc, branch ** l_deep)
    codes = coll.all_gather(codes_loc, mesh)
    deep_code_s, order = torch.sort(codes, stable=True)
    code_s = deep_code_s >> (dim * refine_levels)
    if dim == 2:
        pos_all = torch.cat([pos_all, pos_all.new_zeros((n_tot, 1))], dim=1)

    # the sorted-order gather, each rank its slice
    order_my = order[lo:lo + n_loc]
    pos_s_my, mass_s_my = pos_all[order_my], mass_all[order_my]
    pos_s = coll.all_gather(pos_s_my, mesh)
    mass_s = coll.all_gather(mass_s_my, mesh)

    leaf_starts = torch.searchsorted(
        code_s, torch.arange(n_leaf + 1, dtype=torch.int32,
                             device=pos_all.device)).to(torch.int32)
    starts_my = _slice_starts(leaf_starts, lo, n_loc)
    leaf_counts = coll.psum(starts_my[1:] - starts_my[:-1], mesh)
    table = None
    if n_tot * 4 >= n_leaf:  # build_octree's dense-regime gate in JAX
        table, leaf_mass, leaf_mpos = _leaf_stats(pos_s, mass_s, leaf_starts)
    else:
        leaf = coll.psum(_segment_leaf_stats(pos_s_my, mass_s_my, starts_my),
                         mesh).to(pos_all.dtype)
        leaf_mass, leaf_mpos = leaf[:, 0], leaf[:, 1:4]
    level_mass, level_mpos, level_table = _pyramid_tables(
        leaf_mass, leaf_mpos, leaf_counts, max_level, branch, pos_all.dtype)

    all_quad = None
    if quad:
        q, top = _build_quad(pos_s_my, mass_s_my, starts_my, max_level,
                             branch, quad_leaf)
        all_quad = _quad_pyramid(coll.psum(q, mesh), top, branch,
                                 pos_all.dtype)

    refine = {}
    if refine_levels > 0:
        if table is None:
            table = prefix_table(
                torch.cat([mass_s[:, None], pos_s * mass_s[:, None]], dim=1))
        tables, slot_leaf, child_maps, rstats = _build_refined(
            table, deep_code_s, leaf_starts[1:] - leaf_starts[:-1],
            max_level, refine_levels, refine_cap, refine_threshold, branch,
            dim, pos_all.dtype)
        refine = dict(refine_tables=tables, refine_slot_leaf=slot_leaf,
                      refine_child_slot=child_maps, refine_stats=rstats)

    return LinearOctree(pos_s=pos_s, mass_s=mass_s, code_s=code_s,
                        order=order, leaf_starts=leaf_starts,
                        level_mass=level_mass, level_mpos=level_mpos,
                        level_table=level_table, all_quad=all_quad,
                        **refine)


def refresh_octree(tree: LinearOctree, pos, mass, quad: bool = None,
                   quad_leaf: bool = True) -> LinearOctree:
    """Node statistics from the current positions over the frozen binning
    of ``tree`` (sort order, cell assignment, ranges): the lazy engine's
    and walk reuse's refresh (``nbody_tpu/ops/tree.py:782``).  No sort;
    particles that moved stay in their old cells until a rebuild, and dead
    particles inside stale ranges add zero mass.

    The leaf sums are the build's own double-float range differences over
    the frozen ``leaf_starts`` (the JAX package segment-sums by leaf code),
    so a refresh at the positions of the build equals the build bit for
    bit.  ``quad=None`` keeps whether the tree has a quadrupole table."""
    if pos.shape[1] < tree.pos_s.shape[1]:  # 2D state, 3-wide tree rows
        pos = torch.cat([pos, pos.new_zeros((pos.shape[0], 1))], dim=1)
    pos_s = pos[tree.order]
    mass_s = mass[tree.order]
    _table, leaf_mass, leaf_mpos = _leaf_stats(pos_s, mass_s,
                                               tree.leaf_starts)
    stats = _level_stats(leaf_mass, leaf_mpos, tree.max_level, tree.branch)
    ftype = tree.level_table[0].dtype
    level_table = tuple(
        torch.cat([st.to(ftype), old[:, 4:]], dim=1)  # frozen ranges
        for st, old in zip(stats, tree.level_table))
    want_quad = tree.all_quad is not None if quad is None else quad
    all_quad = None
    if want_quad:
        q, top = _build_quad(pos_s, mass_s, tree.leaf_starts, tree.max_level,
                             tree.branch, quad_leaf)
        all_quad = _quad_pyramid(q, top, tree.branch, pos_s.dtype)
    return dataclasses.replace(
        tree, pos_s=pos_s, mass_s=mass_s,
        level_mass=tuple(st[:, 0] for st in stats),
        level_mpos=tuple(st[:, 1:4] for st in stats),
        level_table=level_table, all_quad=all_quad)


def cell_ranges(tree: LinearOctree, cell_ids, level: int):
    """Sorted-particle ranges [start, end) for level-``level`` cell ids."""
    shift = tree.dim * (tree.max_level - level)
    cell_ids = cell_ids.long()
    return (tree.leaf_starts[cell_ids << shift],
            tree.leaf_starts[(cell_ids + 1) << shift])


def leaf_ranges(tree: LinearOctree, cell_ids):
    """Sorted-particle ranges [start, end) for leaf cell ids (any shape)."""
    start = torch.searchsorted(tree.code_s, cell_ids, side="left")
    end = torch.searchsorted(tree.code_s, cell_ids + 1, side="left")
    return start, end


def _boxes(ids, gb, level: int, dim: int):
    """(min [K, dim], max [K, dim], K) numpy boxes of level-``level`` cell
    ids on the grid ``gb``, as the JAX package computes them: centers in
    the grid's dtype, then the half width as a host float."""
    c = morton.cell_centers_from_codes(ids, gb, level, dim).cpu().numpy()
    half = float(gb.width) / (1 << level) / 2.0
    return c - half, c + half, int(ids.shape[0])


def tree_boxes(tree: LinearOctree, bounds, max_nodes_per_level: int = 4096):
    """Occupied-node AABBs per level for inspection and the visualizer (the
    counterpart of ``nbody_tpu/ops/tree.py:873-928``): a list over levels of
    (min [K, 3], max [K, 3], K) numpy arrays, the first
    ``max_nodes_per_level`` occupied cells of each level in id order (the
    clamp comes before the count).

    The occupied ids are found on the tree's device, so only the K kept
    rows cross to the host, not the 8^l masses.  A refined build
    (refine_levels > 0) adds one entry per refined level: each refined
    cell's Morton code at depth L + r is rebuilt by inverting the slot maps
    (``refine_slot_leaf`` for the first refined level, ``refine_child_slot``
    below)."""
    gb = grid_bounds(bounds, tree.max_level)
    out = []
    for l, m in enumerate(tree.level_mass):
        occ = torch.nonzero(m > 0).squeeze(1)[:max_nodes_per_level]
        out.append(_boxes(occ, gb, l, tree.dim))
    if tree.refine_tables is None:
        return out

    L, branch = tree.max_level, tree.branch
    slot_leaf = tree.refine_slot_leaf.long()
    dev = slot_leaf.device
    cap = tree.refine_tables[0].shape[0] // branch
    # parent slot -> parent cell code (-1: an empty slot), level by level
    parent_code = torch.full((cap,), -1, dtype=torch.int64, device=dev)
    flagged = torch.nonzero(slot_leaf >= 0).squeeze(1)
    parent_code[slot_leaf[flagged]] = flagged
    for r, table in enumerate(tree.refine_tables, start=1):
        j = torch.arange(table.shape[0], device=dev)
        parent = parent_code[j // branch]
        codes = parent * branch + j % branch
        ok = (table[:, 0] > 0) & (parent >= 0)
        occ = torch.nonzero(ok).squeeze(1)[:max_nodes_per_level]
        out.append(_boxes(codes[occ], gb, L + r, tree.dim))
        if r <= len(tree.refine_child_slot):
            child_slot = tree.refine_child_slot[r - 1].long()
            rows = torch.nonzero((child_slot >= 0) & (codes >= 0)).squeeze(1)
            parent_code = torch.full((cap,), -1, dtype=torch.int64,
                                     device=dev)
            parent_code[child_slot[rows]] = codes[rows]
    return out
