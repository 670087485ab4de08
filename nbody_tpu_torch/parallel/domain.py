"""Memory-scalable multi-rank Barnes-Hut: the Morton-range domain
decomposition of ``nbody_tpu/parallel/domain.py``, over ``torch.distributed``.

Every per-particle array stays O(N / world + halo) on a rank; the only
replicated structure is the dense level pyramid, O(8^max_level).  The build
and the force call are the JAX module's steps, with its collectives mapped
by ``parallel/collectives.py``:

1. **Exact-split sort** (histogram sort).  Each rank stably sorts its shard
   by leaf Morton code and the leaf histograms are gathered; a particle's
   global sorted slot is then

       p = cell_start[c] + count_on_lower_ranks[c] + local_rank_in_cell

   and, because rank k holds the k-th contiguous block of original
   indices, the (code, rank, local stable rank) order is the (code,
   original index) order: the single-chip stable sort's permutation.
   Dead rows carry the sentinel code 8^L and sort to the global tail.
2. **Ring routing** (``_ring_route``): rows travel the ring for ``world``
   hops; each rank keeps those whose sorted slot it owns.
3. **Leaf statistics**: each rank's segment sums over its contiguous
   sorted slice, merged by ``psum``, as JAX's (``ops/tree.py``
   ``_segment_leaf_stats``: each leaf summed in row order in float64, no
   float atomics on the card); the pyramid above the leaves is
   replicated.
4. **Halo exchange**: one ring shift each way gives every rank the
   ``halo`` rows on either side of its slice, zeros at the global edges.
5. **Request/reply gather** (``_dist_gather``) of the Morton-seam cells'
   rows, bounded by ``far_particle_cap`` a group.
6. Forces return to their owners by a second ring route.

The walk (``ops/traversal.py`` ``_group_collect`` with ``local_bounds``)
and the slab evaluation (K3 and K4 on the card, through
``_dual_slab_eval`` and ``_quad_eval``) are the single-chip path's.

Density-adaptive runs (``refine_levels > 0``) re-sort each rank's routed
slice by deep Morton code and build the refined tables of
``ops/tree.py`` ``_build_refined`` replicated, each refined cell's range
and sums taken on the rank that owns it and merged by one ``psum`` a level
(``_build_refined_domain``); the walk's refined ranges outside the rank's
slab ride a second request/reply.  From ``WIDE_N`` particles on (f32), the
rows take the wide format (``ops/tree.py`` ``wide_ranges``): hi/lo node
ranges, the original index split (rank, slot) over two columns, the index
columns retired (-2 on targets, -1 on sources).

No step reads a value back to the host: shapes are static (the capped far
lists, the [world * R] request buffers, the ``world`` hops of a route).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from nbody_tpu_torch.ops import morton
from nbody_tpu_torch.ops.traversal import (
    BHConfig,
    _dual_slab_eval,
    _expand_from_ranges,
    _expand_ranges,
    _fb_all_quad,
    _fb_eval,
    _group_collect,
    _quad_eval,
    _quad_slab,
    _resolve_eval_mode,
    _window_rows,
    fit_chunks,
)
from nbody_tpu_torch.ops.prefix_scan import prefix_table
from nbody_tpu_torch.ops.tree import (
    _build_quad,
    _check_range_dtype,
    _compact,
    _pyramid_tables,
    _quad_pyramid,
    _range_sums_from_table,
    _segment_leaf_stats,
    _slot_map,
    grid_bounds,
    wide_ranges,
)
from nbody_tpu_torch.parallel import collectives as coll
from nbody_tpu_torch.utils.profiling import mark


def _ring_route(rows, dest, mesh):
    """Deliver ``rows[i]`` [n_loc, w] to global slot ``dest[i]`` of an array
    sharded in contiguous [n_loc] blocks; returns this rank's block.
    ``dest`` must be a global permutation.  ``world`` hops around the ring
    with an O(n_loc) buffer (``domain.py:76``)."""
    n_loc = rows.shape[0]
    my_start = mesh.rank * n_loc
    out = rows.new_zeros((n_loc + 1, rows.shape[1]))  # row n_loc: trash
    buf_rows, buf_dest = rows, dest
    for hop in range(mesh.world):
        rel = buf_dest - my_start
        mine = (rel >= 0) & (rel < n_loc)
        out[torch.where(mine, rel, n_loc).long()] = buf_rows
        if hop < mesh.world - 1:
            buf_rows, buf_dest = coll.ring_shift([buf_rows, buf_dest], mesh)
    return out[:n_loc]


def _dist_gather(rows_loc, idx, mesh):
    """Rows at global indices ``idx`` [R] of an array sharded in contiguous
    [n_loc] blocks: the (integer) requests are gathered, each rank answers
    the ones it owns with zeros elsewhere, and one ``psum_scatter`` gives
    every rank its own [R] answers (``domain.py:99``)."""
    n_loc = rows_loc.shape[0]
    req = coll.all_gather(idx, mesh) - mesh.rank * n_loc  # [world * R]
    own = (req >= 0) & (req < n_loc)
    got = torch.where(own[:, None],
                      rows_loc[torch.clamp(req, 0, n_loc - 1).long()], 0.0)
    return coll.psum_scatter(got, mesh)


def _build_refined_domain(rows_s, deep_s, leaf_starts, max_level: int,
                          refine_levels: int, refine_cap: int, threshold: int,
                          branch: int, dim: int, ftype, mesh):
    """The density-adaptive refined tables of the domain build
    (``domain.py:115``), in ``ops/tree.py`` ``_build_refined``'s layout:
    (refine_tables, refine_slot_leaf, refine_child_slot, refine_stats),
    replicated on every rank.

    The decisions (which cells flag, the slot compaction) run on
    replicated inputs (``leaf_starts``, the psum'd child ranges), so every
    rank takes the same ones.  A refined cell's range and sums are taken
    only on the rank whose slice holds its whole sorted range (``rows_s``
    is deep-sorted there, ``deep_s`` its deep codes); one ``psum`` a level
    merges them, every other rank adding zeros.  A flagged leaf whose range
    straddles a rank boundary is only piecewise deep-sorted, so it keeps
    the unrefined path and is counted in ``refine_stats[1]`` with the cap
    overflow; descendants inherit their leaf's owner."""
    n_loc = rows_s.shape[0]
    n_leaf = branch ** max_level
    l_deep = max_level + refine_levels
    rows_per = refine_cap * branch
    my_start = mesh.rank * n_loc
    i32 = dict(dtype=torch.int32, device=rows_s.device)
    kids = torch.arange(branch, **i32)
    # my slice's double-float prefix table of (m, m x, m y, m z)
    table = prefix_table(torch.cat(
        [rows_s[:, 3:4], rows_s[:, :3] * rows_s[:, 3:4]], dim=1))

    starts, ends = leaf_starts[:-1], leaf_starts[1:]
    owner = torch.div(starts, n_loc, rounding_mode="floor")
    # an empty cell (ends - 1 < starts) fails the threshold test anyway
    intact = torch.div(ends - 1, n_loc, rounding_mode="floor") == owner
    over = (ends - starts) > threshold
    flagged = over & intact
    p_codes, p_valid, dropped = _compact(torch.arange(n_leaf, **i32),
                                         flagged, refine_cap)
    p_owner = torch.where(p_valid, owner[p_codes.long()], -1)
    total_flagged = flagged.sum(dtype=torch.int32)
    total_dropped = dropped.to(torch.int32) + (over & ~intact).sum(
        dtype=torch.int32)
    slot_leaf = _slot_map(p_codes, p_valid, n_leaf, refine_cap)

    tables, child_maps = [], []
    for r in range(1, refine_levels + 1):
        child_codes = (p_codes[:, None] * branch + kids).reshape(rows_per)
        child_valid = p_valid.repeat_interleave(branch)
        child_owner = p_owner.repeat_interleave(branch)
        mine = child_valid & (child_owner == mesh.rank)
        shift = dim * (l_deep - (max_level + r))
        lo = torch.where(child_valid, child_codes << shift, 0)
        hi = torch.where(child_valid, (child_codes + 1) << shift, 0)
        # a local search is right exactly for the ranges I own (my slice
        # is deep-sorted)
        found = torch.searchsorted(deep_s, torch.cat([lo, hi]),
                                   side="left").to(torch.int32)
        ls = torch.where(mine, found[:rows_per], 0)
        le = torch.where(mine, found[rows_per:], 0)
        cs = coll.psum(torch.where(mine, ls + my_start, 0), mesh)
        ce = coll.psum(torch.where(mine, le + my_start, 0), mesh)
        sums = coll.psum(torch.where(
            mine[:, None], _range_sums_from_table(table, ls, le, 4), 0.0),
            mesh)
        m = torch.where(child_valid & (ce > cs), sums[:, 0], 0.0)
        zero = torch.zeros_like(m)
        tables.append(torch.stack(
            [m, sums[:, 1], sums[:, 2], sums[:, 3], cs.to(m.dtype),
             ce.to(m.dtype), zero, zero], dim=1).to(ftype))
        if r < refine_levels:
            # replicated after the psum: the same flags on every rank
            flag_r = child_valid & (ce - cs > threshold)
            p_rows, p_valid, dropped = _compact(
                torch.arange(rows_per, **i32), flag_r, refine_cap)
            total_flagged = total_flagged + flag_r.sum(dtype=torch.int32)
            total_dropped = total_dropped + dropped.to(torch.int32)
            child_maps.append(_slot_map(p_rows, p_valid, rows_per,
                                        refine_cap))
            p_codes = torch.where(p_valid, child_codes[p_rows.long()], 0)
            p_owner = torch.where(p_valid, child_owner[p_rows.long()], -1)

    stats = torch.stack([total_flagged, total_dropped])
    return tuple(tables), slot_leaf, tuple(child_maps), stats


@dataclass(frozen=True)
class DomainTree:
    """This rank's slice of the distributed octree (``domain.py:237``):
    every field O(n_loc) but the replicated pyramid.  ``level_table`` and
    ``all_quad`` have the layout of ``ops/tree.py``'s ``LinearOctree``, so
    the walk reads them unchanged."""

    #: [n_loc, 8] my sorted rows (x, y, z, m, original index, leaf code, 0,
    #: 0); the indices and codes are exact integers in the float dtype.
    #: Wide rows split the original index: its slot in column 4, its rank
    #: in column 6
    rows_s: torch.Tensor
    #: [n_loc + 2 halo, 8] the halo-extended slab, column 4 the global
    #: sorted index (the source-row layout of K3; -1 in wide rows)
    ext8: torch.Tensor
    level_table: Tuple[torch.Tensor, ...]
    halo: int
    #: the replicated quadrupole table, None for multipole="mono"
    all_quad: Optional[torch.Tensor] = None
    #: the refined tables (refine_levels > 0), replicated, in the layout of
    #: ``LinearOctree``'s fields of the same names (``_build_refined_domain``)
    refine_tables: Optional[Tuple[torch.Tensor, ...]] = None
    refine_slot_leaf: Optional[torch.Tensor] = None
    refine_child_slot: Optional[Tuple[torch.Tensor, ...]] = None
    refine_stats: Optional[torch.Tensor] = None


def build_domain_tree(pos_loc, mass_loc, bounds, max_level: int, mesh,
                      halo: int, dim: int = 3, quad: bool = False,
                      quad_leaf: bool = True, refine_levels: int = 0,
                      refine_cap: int = 8192,
                      refine_threshold: int = 512) -> DomainTree:
    """The distributed octree over this rank's shard
    (``domain.py:259``), steps 1-4 of the module docstring.  Its sorted
    permutation is the single-chip ``build_octree``'s; its leaf statistics
    are JAX's segment sums, where ``build_octree`` takes double-float range
    differences.

    ``refine_levels > 0`` re-sorts the routed slice by deep Morton code, a
    permutation within leaf cells only (the leaf codes are the deep codes'
    prefixes, and a stable sort keeps the original index as the tie-break,
    as the single-chip deep sort does), and adds the refined tables
    (``_build_refined_domain``)."""
    n_loc = pos_loc.shape[0]
    n_tot = n_loc * mesh.world
    wide = wide_ranges(n_tot, pos_loc.dtype)
    _check_range_dtype(n_tot, pos_loc.dtype, wide=wide)
    if wide and dim * max_level > 24:
        # the leaf codes ride an f32 row column and must stay exact
        raise ValueError(
            f"wide mode leaf codes need dim*max_level <= 24, got "
            f"{dim}*{max_level}")
    if wide and n_loc >= 1 << 24:
        # the (rank, slot) return route keeps the slot in an f32 column
        raise ValueError(
            f"wide mode needs per-chip shard < 2^24 rows for the exact f32 "
            f"(chip, slot) route, got {n_loc}; use more devices")
    if halo > n_loc:
        raise ValueError(f"halo {halo} exceeds the shard of {n_loc} rows")
    branch = 1 << dim
    n_leaf = branch ** max_level
    gb = grid_bounds(bounds, max_level)
    my = mesh.rank
    ftype, dev = pos_loc.dtype, pos_loc.device

    codes = morton.cell_codes(pos_loc[:, :dim], gb, max_level)
    codes = torch.where(mass_loc > 0, codes, n_leaf)  # dead: the tail
    if dim == 2:
        pos_loc = torch.cat([pos_loc, pos_loc.new_zeros((n_loc, 1))], dim=1)

    # 1. local stable sort, the original global index riding along
    code_s, perm = torch.sort(codes, stable=True)
    orig_s = my * n_loc + perm

    # 2. the exact global slot from the gathered histograms of the n_leaf
    #    + 1 cells (the sentinel cell collects the dead tail)
    cells = torch.arange(n_leaf + 2, dtype=code_s.dtype, device=dev)
    bounds_loc = torch.searchsorted(code_s, cells)  # [n_leaf + 2]
    local_start = bounds_loc[:-1]
    h = bounds_loc[1:] - local_start
    hall = coll.all_gather(h[None], mesh)  # [world, n_leaf + 1]
    total = hall.sum(dim=0)
    cell_start = torch.cumsum(total, dim=0) - total
    on_lower = hall[:my].sum(dim=0)
    c = code_s.long()
    j = torch.arange(n_loc, device=dev)
    p = cell_start[c] + on_lower[c] + (j - local_start[c])

    # 3. route the rows to their sorted owners (index and code as exact
    #    integers in the float columns, guarded by _check_range_dtype); wide
    #    rows split the index (slot in column 4, rank in column 6), each
    #    part below 2^24
    zero = pos_loc.new_zeros((n_loc,))
    idx_col, rank_col = ((perm.to(ftype), torch.full_like(zero, my)) if wide
                         else (orig_s.to(ftype), zero))
    rows = torch.stack([pos_loc[perm, 0], pos_loc[perm, 1],
                        pos_loc[perm, 2], mass_loc[perm], idx_col,
                        code_s.to(ftype), rank_col, zero], dim=1)
    rows_s = _ring_route(rows, p, mesh)

    # 3b. density-adaptive runs: my slice re-sorted by deep code, dead rows
    #     (the sentinel leaf code) keeping a sentinel deep code
    deep_s = None
    if refine_levels:
        l_deep = max_level + refine_levels
        if l_deep > (morton.MAX_LEVEL_3D if dim == 3
                     else morton.MAX_LEVEL_2D):
            raise ValueError(
                f"max_level + refine_levels = {l_deep} exceeds the "
                f"{dim}D Morton code depth limit")
        if wide:
            raise ValueError(
                "refine_levels does not support the wide row format "
                "(N >= 2^24)")
        deep = morton.cell_codes(rows_s[:, :dim], gb, l_deep)
        deep = torch.where(rows_s[:, 5] < n_leaf, deep, branch ** l_deep)
        deep_s, order = torch.sort(deep, stable=True)
        rows_s = rows_s[order]

    # 4. leaf statistics: my slice's segment sums, merged by psum; the
    #    sentinel rows lie past the last offset and drop out
    code_my = rows_s[:, 5].to(torch.int64)
    starts_my = torch.searchsorted(
        code_my, torch.arange(n_leaf + 1, dtype=torch.int64, device=dev))
    leaf = coll.psum(_segment_leaf_stats(rows_s[:, :3], rows_s[:, 3],
                                         starts_my), mesh).to(ftype)
    leaf_counts = coll.psum((starts_my[1:] - starts_my[:-1]).to(torch.int32),
                            mesh)
    _m, _p, level_table = _pyramid_tables(leaf[:, 0], leaf[:, 1:4],
                                          leaf_counts, max_level, branch,
                                          ftype, wide=wide)
    all_quad = None
    if quad:
        q, top = _build_quad(rows_s[:, :3], rows_s[:, 3], starts_my,
                             max_level, branch, quad_leaf)
        all_quad = _quad_pyramid(coll.psum(q, mesh), top, branch, ftype)

    # 5. halo exchange for the window pass; the global edges get zeros (the
    #    ring's wraparound must not leak the far end of the sort)
    from_left, = coll.ring_shift([rows_s[n_loc - halo:]], mesh, 1)
    from_right, = coll.ring_shift([rows_s[:halo]], mesh, -1)
    if my == 0:
        from_left = torch.zeros_like(from_left)
    if my == mesh.world - 1:
        from_right = torch.zeros_like(from_right)
    ext = torch.cat([from_left, rows_s, from_right])
    if wide:
        # the index column retired (the maskless eval): a -1 that never
        # equals a target's
        ext_idx = torch.full_like(ext[:, 4], -1.0)
    else:
        ext_idx = (my * n_loc - halo
                   + torch.arange(n_loc + 2 * halo, device=dev)).to(ftype)
    ext8 = torch.cat([ext[:, :4], ext_idx[:, None], ext[:, 5:]], dim=1)

    refine = {}
    if refine_levels:
        leaf_starts = torch.cat([leaf_counts.new_zeros((1,)),
                                 torch.cumsum(leaf_counts, 0,
                                              dtype=torch.int32)])
        tables, slot_leaf, child_maps, rstats = _build_refined_domain(
            rows_s, deep_s, leaf_starts, max_level, refine_levels,
            refine_cap, refine_threshold, branch, dim, ftype, mesh)
        refine = dict(refine_tables=tables, refine_slot_leaf=slot_leaf,
                      refine_child_slot=child_maps, refine_stats=rstats)
    return DomainTree(rows_s=rows_s, ext8=ext8, level_table=level_table,
                      halo=halo, all_quad=all_quad, **refine)


def _masked_rows(rows8, pidx, pvalid, wide: bool = False):
    """Gathered slab rows [G, P, 8] with masses zeroed past each group's
    list and column 4 the global sorted index (-1 on empty slots, which
    never equals a target's; -1 everywhere in wide rows, whose index
    column is retired)."""
    idx = (torch.full_like(rows8[..., 4], -1.0) if wide
           else torch.where(pvalid, pidx.to(rows8.dtype), -1.0))
    return torch.cat([rows8[..., :3],
                      torch.where(pvalid, rows8[..., 3], 0.0)[..., None],
                      idx[..., None], rows8[..., 5:]], dim=-1)


def _local_rows(ext8, pidx, pvalid, local_lo: int, wide: bool):
    """Slab rows [G, P, 8] of global sorted indices ``pidx`` that lie in
    this rank's halo-extended slab ``ext8`` (the walk admitted only such
    cells and ranges to the local lists)."""
    rows = ext8[torch.clamp(pidx - local_lo, 0, ext8.shape[0] - 1).long()]
    return _masked_rows(rows, pidx, pvalid, wide)


def _far_rows(rows_s, pidx, pvalid, mesh, wide: bool):
    """Slab rows [G, P, 8] of global sorted indices ``pidx`` held anywhere
    on the mesh, by one request/reply (``_dist_gather``)."""
    G, P = pidx.shape
    far4 = _dist_gather(rows_s[:, :4], pidx.reshape(-1), mesh)
    far8 = torch.cat([far4.reshape(G, P, 4), far4.new_zeros((G, P, 4))],
                     dim=-1)
    return _masked_rows(far8, pidx, pvalid, wide)


def domain_accel(pos_loc, mass_loc, bounds, theta2, g, g_soft,
                 cfg: BHConfig, mesh):
    """Barnes-Hut acceleration of this rank's shard over the domain tree
    (``domain.py:455``).  Returns (acc [n_loc, 3] in this shard's original
    order, stats: the walk's counters summed over this rank's groups, the
    near totals [G] of near + far particles a group, ``far_totals`` [G],
    ``dual_tiles``, and with ``refine_levels`` the refined-near and
    refined-far particles a group, ``refine_near_totals`` /
    ``refine_far_totals`` [G], and the build's ``refine_build_dropped``).
    Each phase ends in a ``mark`` of the span recorder, as in
    ``traverse_tree``, and the forces' route to their owners in "route"."""
    mode = _resolve_eval_mode(cfg, pos_loc)
    # grid frame, as bh_accel: every f32 sum bounded by the half-width
    pos_loc = pos_loc - bounds.center
    bounds = bounds.centered()
    n_loc = pos_loc.shape[0]
    n_tot = n_loc * mesh.world
    if wide_ranges(n_tot, pos_loc.dtype) and not cfg.wide:
        cfg = dataclasses.replace(cfg, wide=True)
    if cfg.near_sym:
        # the domain slab is assembled here and has no split-window self
        # square: the asymmetric eval, as in the JAX package
        cfg = dataclasses.replace(cfg, near_sym=False)
    B = cfg.group_size
    if n_loc % B:
        raise ValueError(f"the shard of {n_loc} rows is not a multiple of "
                         f"group_size {B}")
    cg_fit = fit_chunks(cfg.chunk_groups, n_loc // B)
    if cg_fit != cfg.chunk_groups:
        cfg = dataclasses.replace(cfg, chunk_groups=cg_fit)
    # windows are capped to the shard, and halo = window covers every
    # clamped window of my groups only if wstart cannot fall below
    # my_start - halo, which window_pad > n_loc breaks
    if cfg.window_pad > n_loc:
        raise ValueError(
            f"window_pad ({cfg.window_pad}) exceeds the per-chip shard "
            f"({n_loc}); lower window_pad/group_size or use fewer devices")
    if cfg.window > n_loc:
        # a window capped to the shard keeps its group in the middle: the
        # pad shrinks to what the shard leaves.  The JAX package caps the
        # width and keeps the pad, so a window of n_loc rows starting
        # window_pad before its group can miss the group itself, whose
        # cells then overflow the walk's frontier (a port divergence)
        cfg = dataclasses.replace(cfg, window_pad=(n_loc - B) // 2)
    window = cfg.window
    halo = window
    my_start = mesh.rank * n_loc
    dtype, dev = pos_loc.dtype, pos_loc.device
    eps2 = float(torch.tensor(float(g_soft), dtype=dtype) ** 2)
    wide = cfg.wide

    tree = build_domain_tree(pos_loc, mass_loc, bounds, cfg.max_level, mesh,
                             halo, dim=cfg.dim,
                             quad=cfg.multipole == "quad",
                             quad_leaf=cfg.quad_leaf,
                             refine_levels=cfg.refine_levels,
                             refine_cap=cfg.refine_cap,
                             refine_threshold=cfg.refine_threshold_resolved)
    mark("build")

    G = n_loc // B
    gidx = (my_start + torch.arange(n_loc, dtype=torch.int32, device=dev)
            ).reshape(G, B)
    # wide: the target index column retired (-2 never equals a source
    # row's -1); the fallback containment takes the targets' leaf codes
    tcol = (torch.full((G, B, 1), -2.0, dtype=dtype, device=dev) if wide
            else gidx[..., None].to(dtype))
    tgt8 = torch.cat([tree.rows_s[:, :4].reshape(G, B, 4), tcol,
                      tree.rows_s[:, 5:].reshape(G, B, 3)], dim=-1)
    tcell = tree.rows_s[:, 5].to(torch.int32).reshape(G, B) if wide else None
    local_lo, local_hi = my_start - halo, my_start + n_loc + halo
    walk = _group_collect(tree, n_tot, bounds.width, theta2, cfg, window,
                          tgt8[..., :3], tgt8[..., 3], gidx,
                          local_bounds=(local_lo, local_hi),
                          grid=(grid_bounds(bounds, cfg.max_level)
                                if cfg.accept_offset else None))
    mark("walk")
    acc_fb = _fb_eval(tgt8[..., :3], gidx, tgt8[..., 3], walk["fb"], g, eps2,
                      _fb_all_quad(tree, cfg), cfg.branch, tcell,
                      cfg.max_level)
    mark("fb")

    leaf_table = tree.level_table[cfg.max_level]
    pidx, pvalid, ntot_near = _expand_ranges(
        leaf_table, walk["near_ids"], walk["near_valid"],
        cfg.near_particle_cap, wide)
    pidx_f, pfvalid, ntot_far = _expand_ranges(
        leaf_table, walk["far_ids"], walk["far_valid"], cfg.far_particle_cap,
        wide)

    # slab: window rows and local near rows from the halo slab, far rows
    # by request/reply (the one per-particle collective not O(n_loc))
    wrows = _window_rows(tree.ext8, walk["wstart"] - local_lo, walk["wmask"],
                         window)
    parts = [wrows, _local_rows(tree.ext8, pidx, pvalid, local_lo, wide),
             _far_rows(tree.rows_s, pidx_f, pfvalid, mesh, wide)]
    if cfg.refine_levels:
        # refined-near ranges gather from the halo slab like the near rows;
        # the refined-far list rides a second request/reply, bounded by
        # refine_far_particle_cap
        rnear, rfar = walk["rnear"], walk["rfar"]
        pidx_r, pvalid_r, _ = _expand_from_ranges(
            rnear[..., 0], rnear[..., 1], walk["rnear_valid"],
            cfg.refine_near_particle_cap)
        pidx_rf, pvalid_rf, _ = _expand_from_ranges(
            rfar[..., 0], rfar[..., 1], walk["rfar_valid"],
            cfg.refine_far_particle_cap)
        parts += [_local_rows(tree.ext8, pidx_r, pvalid_r, local_lo, wide),
                  _far_rows(tree.rows_s, pidx_rf, pvalid_rf, mesh, wide)]
    if cfg.multipole != "quad":
        parts.append(walk["mono"])
    slab = torch.cat(parts, dim=1)
    acc, n_dual = _dual_slab_eval(slab, tgt8, walk["center"], theta2, g,
                                  eps2, g_soft, cfg, mode)
    if cfg.multipole == "quad":
        qslab = _quad_slab(walk["mono"], tree.all_quad,
                           -1 if cfg.quad_leaf else cfg.max_level,
                           cfg.branch)
        acc = acc + _quad_eval(qslab, tgt8, g, eps2, g_soft, cfg, mode)
        mark("K4")
    acc_sorted = (acc + acc_fb).reshape(n_loc, 3)

    # forces back to their owners (no gather of the forces); wide rows
    # carry the original index as (rank, slot)
    orig = tree.rows_s[:, 4].long()
    if wide:
        orig = tree.rows_s[:, 6].long() * n_loc + orig
    acc4 = torch.cat([acc_sorted, acc_sorted.new_zeros((n_loc, 1))], dim=1)
    out = _ring_route(acc4, orig, mesh)[:, :cfg.dim]
    mark("route")
    stats = {
        "accept_dropped": walk["accept_dropped"].sum(),
        "frontier_fallback": walk["frontier_fallback"].sum(),
        "near_fallback": walk["near_fallback"].sum(),
        "fb_spill": walk["fb_spill"].sum(),
        "near_totals": ntot_near + ntot_far,
        "far_totals": ntot_far,
        "dual_tiles": n_dual,
    }
    if cfg.refine_levels:
        stats["refine_near_totals"] = walk["refine_near_totals"]
        stats["refine_far_totals"] = walk["refine_far_totals"]
        stats["refine_build_dropped"] = tree.refine_stats[1]
    return out, stats
