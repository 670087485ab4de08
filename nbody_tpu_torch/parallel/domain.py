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
``_dual_slab_eval`` and ``_quad_eval``) are the single-chip path's.  Left
out, each refused by name: the wide row format for N >= 2^24 (ROADMAP.md,
queue 1, item 17c) and the density-adaptive refined levels (item 17e).
No step reads a value back to the host: shapes are static (the capped far
lists, the [world * R] request buffer, the ``world`` hops of a route).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from nbody_tpu_torch.ops import morton
from nbody_tpu_torch.ops.traversal import (
    BHConfig,
    ROADMAP_REFINED_DOMAIN,
    _dual_slab_eval,
    _expand_ranges,
    _fb_all_quad,
    _fb_eval,
    _group_collect,
    _no_mark,
    _quad_eval,
    _quad_slab,
    _resolve_eval_mode,
    _unported,
    _window_rows,
    fit_chunks,
)
from nbody_tpu_torch.ops.tree import (
    _build_quad,
    _check_range_dtype,
    _pyramid_tables,
    _quad_pyramid,
    _segment_leaf_stats,
    grid_bounds,
)
from nbody_tpu_torch.parallel import collectives as coll


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


@dataclass(frozen=True)
class DomainTree:
    """This rank's slice of the distributed octree (``domain.py:237``):
    every field O(n_loc) but the replicated pyramid.  ``level_table`` and
    ``all_quad`` have the layout of ``ops/tree.py``'s ``LinearOctree``, so
    the walk reads them unchanged."""

    #: [n_loc, 8] my sorted rows (x, y, z, m, original index, leaf code, 0,
    #: 0); the indices and codes are exact integers in the float dtype
    rows_s: torch.Tensor
    #: [n_loc + 2 halo, 8] the halo-extended slab, column 4 the global
    #: sorted index (the source-row layout of K3)
    ext8: torch.Tensor
    level_table: Tuple[torch.Tensor, ...]
    halo: int
    #: the replicated quadrupole table, None for multipole="mono"
    all_quad: Optional[torch.Tensor] = None


def build_domain_tree(pos_loc, mass_loc, bounds, max_level: int, mesh,
                      halo: int, dim: int = 3, quad: bool = False,
                      quad_leaf: bool = True) -> DomainTree:
    """The distributed octree over this rank's shard
    (``domain.py:259``), steps 1-4 of the module docstring.  Its sorted
    permutation is the single-chip ``build_octree``'s; its leaf statistics
    are JAX's segment sums, where ``build_octree`` takes double-float range
    differences."""
    n_loc = pos_loc.shape[0]
    n_tot = n_loc * mesh.world
    _check_range_dtype(n_tot, pos_loc.dtype)
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
    #    integers in the float columns, guarded by _check_range_dtype)
    zero = pos_loc.new_zeros((n_loc,))
    rows = torch.stack([pos_loc[perm, 0], pos_loc[perm, 1],
                        pos_loc[perm, 2], mass_loc[perm], orig_s.to(ftype),
                        code_s.to(ftype), zero, zero], dim=1)
    rows_s = _ring_route(rows, p, mesh)

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
                                          ftype)
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
    ext_idx = my * n_loc - halo + torch.arange(n_loc + 2 * halo, device=dev)
    ext8 = torch.cat([ext[:, :4], ext_idx.to(ftype)[:, None], ext[:, 5:]],
                     dim=1)
    return DomainTree(rows_s=rows_s, ext8=ext8, level_table=level_table,
                      halo=halo, all_quad=all_quad)


def _masked_rows(rows8, pidx, pvalid):
    """Gathered slab rows [G, P, 8] with masses zeroed past each group's
    list and column 4 the global sorted index (-1 on empty slots, which
    never equals a target's)."""
    return torch.cat([rows8[..., :3],
                      torch.where(pvalid, rows8[..., 3], 0.0)[..., None],
                      torch.where(pvalid, pidx.to(rows8.dtype),
                                  -1.0)[..., None],
                      rows8[..., 5:]], dim=-1)


def domain_accel(pos_loc, mass_loc, bounds, theta2, g, g_soft,
                 cfg: BHConfig, mesh, mark=None):
    """Barnes-Hut acceleration of this rank's shard over the domain tree
    (``domain.py:455``).  Returns (acc [n_loc, 3] in this shard's original
    order, stats: the walk's counters summed over this rank's groups, the
    near totals [G] of near + far particles a group, ``far_totals`` [G],
    ``dual_tiles``).  ``mark`` is called at phase boundaries (on-card
    timing), as in ``traverse_tree``."""
    mark = mark or _no_mark
    if cfg.refine_levels:
        _unported("density-adaptive refinement (refine_levels) on the "
                  "domain path", ROADMAP_REFINED_DOMAIN)
    mode = _resolve_eval_mode(cfg, pos_loc)
    # grid frame, as bh_accel: every f32 sum bounded by the half-width
    pos_loc = pos_loc - bounds.center
    bounds = bounds.centered()
    n_loc = pos_loc.shape[0]
    n_tot = n_loc * mesh.world
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
    window = min(cfg.window, n_loc)
    halo = window
    my_start = mesh.rank * n_loc
    dtype, dev = pos_loc.dtype, pos_loc.device
    eps2 = float(torch.tensor(float(g_soft), dtype=dtype) ** 2)

    tree = build_domain_tree(pos_loc, mass_loc, bounds, cfg.max_level, mesh,
                             halo, dim=cfg.dim,
                             quad=cfg.multipole == "quad",
                             quad_leaf=cfg.quad_leaf)
    mark("build")

    G = n_loc // B
    gidx = (my_start + torch.arange(n_loc, dtype=torch.int32, device=dev)
            ).reshape(G, B)
    tgt8 = torch.cat([tree.rows_s[:, :4], gidx.reshape(-1, 1).to(dtype),
                      tree.rows_s[:, 5:]], dim=1).reshape(G, B, 8)
    local_lo, local_hi = my_start - halo, my_start + n_loc + halo
    walk = _group_collect(tree, n_tot, cfg.cell_w2s(bounds.width), theta2,
                          cfg, window, tgt8[..., :3], tgt8[..., 3], gidx,
                          local_bounds=(local_lo, local_hi))
    mark("walk")
    acc_fb = _fb_eval(tgt8[..., :3], gidx, tgt8[..., 3], walk["fb"], g, eps2,
                      _fb_all_quad(tree, cfg), cfg.branch)
    mark("fb")

    leaf_table = tree.level_table[cfg.max_level]
    pidx, pvalid, ntot_near = _expand_ranges(
        leaf_table, walk["near_ids"], walk["near_valid"],
        cfg.near_particle_cap)
    pidx_f, pfvalid, ntot_far = _expand_ranges(
        leaf_table, walk["far_ids"], walk["far_valid"], cfg.far_particle_cap)

    # slab: window rows and local near rows from the halo slab, far rows
    # by request/reply (the one per-particle collective not O(n_loc))
    n_ext = n_loc + 2 * halo
    wrows = _window_rows(tree.ext8, walk["wstart"] - local_lo, walk["wmask"],
                         window)
    near = tree.ext8[torch.clamp(pidx - local_lo, 0, n_ext - 1).long()]
    nrows = _masked_rows(near, pidx, pvalid)
    far4 = _dist_gather(tree.rows_s[:, :4], pidx_f.reshape(-1), mesh)
    far8 = torch.cat([far4.reshape(G, cfg.far_particle_cap, 4),
                      far4.new_zeros((G, cfg.far_particle_cap, 4))], dim=-1)
    frows = _masked_rows(far8, pidx_f, pfvalid)
    parts = [wrows, nrows, frows]
    if cfg.multipole != "quad":
        parts.append(walk["mono"])
    slab = torch.cat(parts, dim=1)
    acc, n_dual = _dual_slab_eval(slab, tgt8, walk["center"], theta2, g,
                                  eps2, g_soft, cfg, mode, mark)
    if cfg.multipole == "quad":
        qslab = _quad_slab(walk["mono"], tree.all_quad,
                           -1 if cfg.quad_leaf else cfg.max_level,
                           cfg.branch)
        acc = acc + _quad_eval(qslab, tgt8, g, eps2, g_soft, cfg, mode)
        mark("K4")
    acc_sorted = (acc + acc_fb).reshape(n_loc, 3)

    # forces back to their owners (no gather of the forces)
    acc4 = torch.cat([acc_sorted, acc_sorted.new_zeros((n_loc, 1))], dim=1)
    out = _ring_route(acc4, tree.rows_s[:, 4].long(), mesh)[:, :cfg.dim]
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
    return out, stats
