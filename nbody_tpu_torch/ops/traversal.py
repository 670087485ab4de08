"""Vectorized Barnes-Hut traversal (the counterpart of
``nbody_tpu/ops/traversal.py``, single device, unrefined path).

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
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from nbody_tpu_torch.ops import group_force as gf
from nbody_tpu_torch.ops.tree import (
    BRANCH,
    LinearOctree,
    _compact,
    build_octree,
    decode_ranges,
)

# ROADMAP.md items of what this slice leaves out (queue 1)
ROADMAP_ADAPTIVE = "ROADMAP.md, queue 1, item 15"
ROADMAP_OPT_IN = "ROADMAP.md, queue 1, item 16"
ROADMAP_PARALLEL = "ROADMAP.md, queue 1, item 17"
ROADMAP_BH_OPTIONS = "ROADMAP.md, queue 1, item 18"

# profile='dense' field stack (auto_for / make_bh_engine / --dense), as in
# the JAX package (traversal.py:66)
DENSE_OVERRIDES = dict(max_level=8, near_particle_cap=2048,
                       frontier_cap=4096, accept_cap=4096,
                       near_cell_cap=4096, fb_cap=512)

#: contrast above this = steep-core scene (auto-detection threshold)
STEEP_CONTRAST = 40.0


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


def detect_scene_profile(pos, bounds_center, bounds_width, occupancy=None):
    """'fast' or 'adaptive' from the density-contrast statistic."""
    occ = occupancy or scene_occupancy(pos, bounds_center, bounds_width)
    return "adaptive" if occ["contrast"] > STEEP_CONTRAST else "fast"


def _unported(what: str, item: str):
    raise NotImplementedError(
        f"{what} is not yet ported to nbody_tpu_torch ({item})")


@dataclass(frozen=True)
class BHConfig:
    """Static traversal configuration: the JAX package's fields with the
    same defaults (``nbody_tpu/ops/traversal.py:266``; the comments there
    record how each default was tuned on a TPU v5e).  Fields of paths this
    package does not port yet raise ``NotImplementedError`` when set."""

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

    def __post_init__(self):
        if self.refine_levels:
            _unported("refine_levels > 0 (density-adaptive refinement)",
                      ROADMAP_ADAPTIVE)
        for name, on in (("sliding_window", self.sliding_window),
                         ("delta_onepass", self.delta_onepass)):
            if on:
                _unported(name, ROADMAP_OPT_IN)
        if self.wide:
            _unported("wide (the N >= 2^24 domain row format)",
                      ROADMAP_PARALLEL)
        for name, on in (("quad_leaf=True", self.quad_leaf),
                         ("fb_quad=True", self.fb_quad),
                         ("dim=2 (quadtree states)", self.dim != 3)):
            if on:
                _unported(name, ROADMAP_BH_OPTIONS)
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
                min(BRANCH ** l, self.frontier_cap,
                    max(512, self.frontier_cap >> (self.max_level - l)))
                for l in range(self.start_level + 1, self.max_level + 1))
        # slots must stay multiples of the branch factor (parent compaction)
        if any(s % BRANCH for s in sched):
            raise ValueError(f"frontier slots must be multiples of {BRANCH}: "
                             f"{sched}")
        return sched

    @property
    def window(self) -> int:
        return self.group_size + 2 * self.window_pad

    def cell_w2s(self, width):
        """Squared cell widths for every walk level, computed from the box
        width (a 0-d tensor) in its dtype."""
        return tuple((width / (1 << l)) * (width / (1 << l))
                     for l in range(self.max_level + 1))

    @staticmethod
    def auto_for(n: int, profile: str = "fast", **overrides) -> "BHConfig":
        """Size-adaptive preset: the JAX package's tiers
        (``traversal.py:570-721``), tuned on a TPU v5e and copied verbatim
        for parity; they are still to be decided again on the H100."""
        if profile == "adaptive":
            _unported("profile='adaptive'", ROADMAP_ADAPTIVE)
        if profile not in ("fast", "accurate", "dense"):
            raise ValueError(f"profile must be 'fast', 'accurate', 'dense' "
                             f"or 'adaptive', got {profile!r}")
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


def _fb_eval(gpos, gidx, gmass, fb, g, eps2):
    """Self-excluded monopole acceleration from the overflow-fallback slab
    fb [G, F, 8] (raw packed node rows: M, mass-weighted sums S, range
    start/end).  A cell whose sorted range holds the target has the
    target's own mass and position removed in closed form:
        M' = M - m_i,   com' = (S - m_i p_i) / M'
    Empty slots and self-only cells contribute nothing.  Chunked over groups
    so the [G', B, F] temporaries stay bounded."""
    G, B, _ = gpos.shape
    F = fb.shape[1]
    tiny = torch.finfo(gpos.dtype).tiny
    out = []
    step = max(1, (1 << 25) // max(B * F, 1))
    for c0 in range(0, G, step):
        p = gpos[c0:c0 + step][:, :, None, :]  # [C, B, 1, 3]
        f = fb[c0:c0 + step][:, None, :, :]  # [C, 1, F, 8]
        ti = gidx[c0:c0 + step].to(gpos.dtype)[:, :, None]
        inside = (f[..., 4] <= ti) & (ti < f[..., 5])  # [C, B, F]
        mi = torch.where(inside, gmass[c0:c0 + step][:, :, None], 0.0)
        m_eff = f[..., 0] - mi
        den = torch.clamp(m_eff, min=tiny)
        dx = (f[..., 1] - mi * p[..., 0]) / den - p[..., 0]
        dy = (f[..., 2] - mi * p[..., 1]) / den - p[..., 1]
        dz = (f[..., 3] - mi * p[..., 2]) / den - p[..., 2]
        r2 = dx * dx + dy * dy + dz * dz + eps2
        ok = (m_eff > 0.0) & (r2 > 0.0)
        inv_r = torch.rsqrt(torch.where(ok, r2, 1.0))
        s = torch.where(ok, inv_r * inv_r * inv_r * m_eff, 0.0)
        out.append(torch.stack([(s * dx).sum(-1), (s * dy).sum(-1),
                                (s * dz).sum(-1)], dim=-1))
    return g * torch.cat(out)


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


def _group_collect(tree: LinearOctree, n_total: int, cell_w2, theta2, cfg,
                   window: int, gpos, gmass, gidx):
    """The collect walk for all G groups at once.

    gpos [G, B, 3], gmass [G, B], gidx [G, B] (sorted indices, int32) ->
    dict with the multipole slab ``mono`` [G, accept_cap, 8] (com, M, -1,
    level or -1 for fb spill, cell id, level), the near cells ``near_ids`` /
    ``near_valid`` [G, near_cell_cap], the window coverage ``wmask`` [G, W]
    and start ``wstart`` [G], the group frame ``center`` [G, 3], the
    fallback slab ``fb`` [G, fb_cap, 8] and the four walk counters [G]."""
    G, B, _ = gpos.shape
    L = cfg.max_level
    W = window
    dtype, dev = gpos.dtype, gpos.device

    # per-subgroup boxes over alive members (their union covers the group
    # tightly even where it straddles a Morton seam)
    S = cfg.subgroups
    has = (gmass > 0).reshape(G, S, B // S)
    spos = gpos.reshape(G, S, B // S, 3)
    big = torch.finfo(dtype).max
    masked_lo = torch.where(has[..., None], spos, big)
    masked_hi = torch.where(has[..., None], spos, -big)
    lo = masked_lo.amin(dim=2)  # [G, S, 3]
    hi = masked_hi.amax(dim=2)
    any_alive = has.any(dim=2)[..., None]
    # empty subgroups: a point box parked far outside the domain
    lo = torch.where(any_alive, lo, 1e30)
    hi = torch.where(any_alive, hi, 1e30)
    gc = 0.5 * (lo + hi)
    gh = 0.5 * (hi - lo)

    # group frame of the norm-trick eval: midpoint of the alive members' box
    glo = masked_lo.amin(dim=(1, 2))
    ghi = masked_hi.amax(dim=(1, 2))
    center = torch.where(has.any(dim=(1, 2))[:, None], 0.5 * (glo + ghi), 0.0)

    # sorted-index window around each group, clamped into range
    wstart = torch.clamp(gidx[:, 0] - cfg.window_pad, 0, max(n_total - W, 0))
    wend = wstart + W

    sched = cfg.schedule()
    n0 = BRANCH ** cfg.start_level
    ids = torch.arange(n0, dtype=torch.int32, device=dev).expand(G, n0)
    valid = torch.ones((G, n0), dtype=torch.bool, device=dev)
    thr = _scalar(cfg.accept_margin, gpos) * _scalar(theta2, gpos)

    A, FB = cfg.accept_cap, cfg.fb_cap
    mono = torch.zeros((G, A + 1, 8), dtype=dtype, device=dev)
    fb = torch.zeros((G, FB + 1, 8), dtype=dtype, device=dev)
    i32 = dict(dtype=torch.int32, device=dev)
    mono_off = torch.zeros((G,), **i32)
    fb_off = torch.zeros((G,), **i32)
    a_dropped = torch.zeros((G,), **i32)
    f_fallback = torch.zeros((G,), **i32)
    n_fallback = torch.zeros((G,), **i32)
    fb_spill = torch.zeros((G,), **i32)
    # window-coverage diff array (+1 at a covered range's start, -1 past its
    # end); slot W is trash
    delta = torch.zeros((G, W + 1), **i32)

    for l in range(cfg.start_level, L + 1):
        # one packed-row gather per slot: (m, mx, my, mz, start, end, _, _)
        row = tree.level_table[l][ids.long()]  # [G, F, 8]
        m = torch.where(valid, row[..., 0], 0.0)
        row = torch.cat([m[..., None], row[..., 1:]], dim=-1)
        occupied = m > 0
        com = row[..., 1:4] / torch.where(occupied, m, 1.0)[..., None]
        cs, ce = decode_ranges(row)

        # cells wholly inside the window: summed exactly by the window pass
        covered = (occupied & (cs >= wstart[:, None])
                   & (ce <= wend[:, None]))
        inc = covered.to(torch.int32)
        delta.scatter_add_(
            1, torch.where(covered, cs - wstart[:, None], W).long(), inc)
        delta.scatter_add_(
            1, torch.where(covered, ce - wstart[:, None], W).long(), -inc)

        # exact distance from node COM to the union of subgroup boxes
        d = torch.clamp((com[:, :, None, :] - gc[:, None, :, :]).abs()
                        - gh[:, None, :, :], min=0.0)  # [G, F, S, 3]
        rmin2 = _sq3(d).amin(dim=2)
        accept = occupied & ~covered & (cell_w2[l] < thr * rmin2)
        expand = occupied & ~covered & ~accept

        if l < L:
            # cells that would expand past the parent cap degrade to
            # self-excluded monopoles (counted, never dropped)
            parent_cap = sched[l - cfg.start_level] // BRANCH
            overflowed = expand & (torch.cumsum(expand.to(torch.int32), 1)
                                   > parent_cap)
            f_fallback = f_fallback + overflowed.sum(dim=1, dtype=torch.int32)
            expand = expand & ~overflowed
        else:
            # leaf level: unexpandable cells join the exact near field while
            # they fit the particle and cell budgets (order-preserving
            # prefix); the rest degrade to self-excluded monopoles
            cnt = torch.where(expand, ce - cs, 0)
            inc_l = (expand
                     & (torch.cumsum(cnt, 1) <= cfg.near_particle_cap)
                     & (torch.cumsum(expand.to(torch.int32), 1)
                        <= cfg.near_cell_cap))
            overflowed = expand & ~inc_l
            n_fallback = overflowed.sum(dim=1, dtype=torch.int32)
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
        # and whose level -1 zeroes its quadrupole) -> multipole slab rows
        mono_mask = accept | fb_drop
        neg = torch.full_like(idf, -1.0)
        mrows = torch.stack(
            [com[..., 0], com[..., 1], com[..., 2], m, neg,
             torch.where(fb_drop, -1.0, lvlf), idf, lvlf], dim=-1)
        mono, mono_off, mono_drop = _push_rows(mono, mono_off, mrows,
                                               mono_mask, A)
        a_dropped = a_dropped + mono_drop.sum(dim=1, dtype=torch.int32)

        if l < L:
            parents, pvalid, _ = _compact(ids, expand, parent_cap)
            ids = (parents[:, :, None] * BRANCH
                   + torch.arange(BRANCH, dtype=torch.int32, device=dev)
                   ).reshape(G, parent_cap * BRANCH)
            valid = pvalid.repeat_interleave(BRANCH, dim=1)
        else:
            near_ids, near_valid, _ = _compact(ids, expand,
                                               cfg.near_cell_cap)

    wmask = torch.cumsum(delta, dim=1)[:, :W] > 0
    return dict(mono=mono[:, :A], near_ids=near_ids, near_valid=near_valid,
                wmask=wmask, wstart=wstart, center=center, fb=fb[:, :FB],
                accept_dropped=a_dropped, frontier_fallback=f_fallback,
                near_fallback=n_fallback, fb_spill=fb_spill)


def _expand_ranges(leaf_table, cell_ids, cell_valid, cap: int):
    """Expand leaf-cell particle ranges into padded flat index lists for all
    groups at once.  cell_ids [G, C], cell_valid [G, C] ->
    (pidx [G, cap] int32, pvalid [G, cap], total [G])."""
    nstart, nend = decode_ranges(leaf_table[cell_ids.long()])
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


def _quad_slab(mono, all_quad, excl_level: int = -1):
    """Expand the multipole slab mono [G, A, 8] into 16-wide quadrupole rows
    [G, A, 16]: raw second moments from ``all_quad`` centralized about the
    node COM (P = S2 - M c cᵀ, traceless Q = 3P - tr(P) I).  Rows of level
    -1 (fb spill) and of ``excl_level`` (leaf cells: quad_leaf=False) keep
    Q = 0."""
    lvl = mono[..., 5].to(torch.int32)
    cid = mono[..., 6].to(torch.int32)
    m = mono[..., 3]
    okq = (lvl >= 0) & (m > 0)
    if excl_level >= 0:
        okq = okq & (lvl != excl_level)
    # row of (level, cell id) in the all-level table: level_offset(l) + cid
    # with level_offset(l) = (8^l - 1) / 7, computed on the device
    lvl0 = torch.clamp(lvl, min=0).long()
    goff = (torch.ones_like(lvl0) << (3 * lvl0)) // (BRANCH - 1)
    gid = torch.where(okq, goff + cid, 0)
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
        ct = center[s0:s0 + cg] if cfg.mxu_blocks else None
        sli = sl[..., 4].to(torch.int32)
        if mask is None:
            out.append(_pair_block(
                t8[..., :3], t8[..., 4].to(torch.int32), sl[..., :3],
                sl[..., 3], sli, sl[..., 3] != 0.0, g, eps2, ct,
                p_block=pb))
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
            t8[..., 4].to(torch.int32).reshape(C * bt, ti),
            rep(sl[..., :3]), m_t, rep(sli), m_t != 0.0, g, eps2,
            None if ct is None else rep(ct), p_block=pb)
        out.append(acc.reshape(C, B, 3))
    return torch.cat(out)


def _dual_slab_eval(slab, tgt8, center, theta2, g, eps2, g_soft,
                    cfg: BHConfig, mode, mark):
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


def _split_window(pmass8, tgt8, wstart, wmask, W: int):
    """``near_sym`` assembly: the window minus the group's own B rows.
    The group sits at columns [off, off + B) of its window, off = group
    start - wstart (in [0, W - B] by the window clamp).  Returns the rim
    rows [G, W - B, 8] (masses under the window mask) and the group's own
    masses under the same mask, ``mcen`` [G, B], the weights of the self
    square."""
    G, B, _ = tgt8.shape
    dev = tgt8.device
    off = (torch.arange(G, device=dev) * B - wstart).to(torch.int32)
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


def _window_rows(pmass8, wstart, wmask, W: int):
    """The [G, W, 8] sorted-neighbour window rows at each group's clamped
    start, masses zeroed outside the covered cells."""
    idx = wstart[:, None].long() + torch.arange(W, device=pmass8.device)
    wrows = pmass8[idx]
    m = torch.where(wmask, wrows[..., 3], 0.0)
    return torch.cat([wrows[..., :3], m[..., None], wrows[..., 4:]], dim=-1)


def _assemble_eval(pmass8, tgt8, tree, walk, pidx, pvalid, acc_fb, theta2,
                   g, eps2, g_soft, cfg: BHConfig, W: int, mode, mark):
    """Slab assembly + force eval: window rows + near gather (+ the
    multipole slab for monopole runs) -> one pair pass with the block-dual
    far field (K3, K4 on the dual rows), the group's own square (K5, with
    ``near_sym``: the window rows are then the rim only), the accepted
    nodes' quadrupoles (K4) and the fallback term.  Returns (acc [G, B, 3]
    in sorted-group order, n_dual, slab_fill)."""
    nrows = pmass8[pidx.long()]
    nrows = torch.cat([nrows[..., :3],
                       torch.where(pvalid, nrows[..., 3], 0.0)[..., None],
                       nrows[..., 4:]], dim=-1)
    if cfg.near_sym:
        wrows, mcen = _split_window(pmass8, tgt8, walk["wstart"],
                                    walk["wmask"], W)
    else:
        wrows = _window_rows(pmass8, walk["wstart"], walk["wmask"], W)
    if cfg.multipole == "quad":
        # particle rows through K3; accepted nodes through K4
        slab = torch.cat([wrows, nrows], dim=1)
    else:
        slab = torch.cat([wrows, nrows, walk["mono"]], dim=1)
    acc, n_dual = _dual_slab_eval(slab, tgt8, walk["center"], theta2, g,
                                  eps2, g_soft, cfg, mode, mark)
    if cfg.near_sym:
        acc = acc + _self_square_eval(tgt8, mcen, g, eps2, g_soft, cfg, mode)
        mark("K5")
    if cfg.multipole == "quad":
        qslab = _quad_slab(walk["mono"], tree.all_quad, cfg.max_level)
        acc = acc + _quad_eval(qslab, tgt8, g, eps2, g_soft, cfg, mode)
        mark("K4")
    slab_fill = (slab[..., 3] != 0.0).to(slab.dtype).mean()
    return acc + acc_fb, n_dual, slab_fill


def _no_mark(_name):
    pass


def traverse_tree(tree, bounds, theta2, g, g_soft, cfg: BHConfig, n: int,
                  mark=None):
    """Group traversal + force over a built tree: collect walk -> slab
    assembly (window rows + near gather + multipole slab) -> one eval pass
    -> scatter back to the original particle order.

    Returns (acc [n, 3] in original order, stats).  ``mark``, if given, is
    called with a phase name at each phase boundary (on-card timing)."""
    mark = mark or _no_mark
    B = cfg.group_size
    block = B * cfg.chunk_groups
    pad = (-n) % block
    dtype, dev = tree.pos_s.dtype, tree.pos_s.device
    mode = _resolve_eval_mode(cfg, tree.pos_s)
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

    walk = _group_collect(tree, n_tot, cfg.cell_w2s(bounds.width), theta2,
                          cfg, W, tgt8[..., :3], tgt8[..., 3], gidx)
    mark("walk")
    acc_fb = _fb_eval(tgt8[..., :3], gidx, tgt8[..., 3], walk["fb"], g, eps2)
    mark("fb")

    # near cells -> flat particle lists, all groups at once
    pidx, pvalid, ntot = _expand_ranges(
        tree.level_table[cfg.max_level], walk["near_ids"],
        walk["near_valid"], cfg.near_particle_cap)
    acc, n_dual, slab_fill = _assemble_eval(
        pmass8, tgt8, tree, walk, pidx, pvalid, acc_fb, theta2, g, eps2,
        g_soft, cfg, W, mode, mark)

    # un-permute to the original particle order (order is a bijection)
    acc_s = acc.reshape(n_tot, 3)[:n]
    out = torch.empty_like(acc_s)
    out[tree.order] = acc_s
    mark("scatter")
    stats = {
        # true drops (should always be 0; raise accept_cap if not)
        "accept_dropped": walk["accept_dropped"].sum(),
        # graceful self-excluded-monopole fallbacks (accuracy, not
        # correctness)
        "frontier_fallback": walk["frontier_fallback"].sum(),
        "near_fallback": walk["near_fallback"].sum(),
        # fb-slab overflow, degraded further to a plain monopole
        "fb_spill": walk["fb_spill"].sum(),
        "near_totals": ntot,
        "dual_tiles": n_dual,
        "window_cov": walk["wmask"].to(dtype).mean(),
        "slab_fill": slab_fill,
    }
    return out, stats


def bh_accel(pos, mass, bounds, theta2, g, g_soft, cfg: BHConfig = None,
             mark=None):
    """Full Barnes-Hut acceleration: build + traverse + scatter back.

    pos [N, 3], mass [N] (zero for dead) -> (acc [N, 3], stats).  The
    pipeline runs in the grid frame (pos - bounds.center): acceleration is
    translation-invariant, and recentring bounds every accumulation by the
    domain half-width."""
    cfg = BHConfig() if cfg is None else cfg
    _resolve_eval_mode(cfg, pos)  # refuse a run the kernels cannot take
    pos_c = pos - bounds.center
    b0 = bounds.centered()
    tree = build_octree(pos_c, mass, b0, cfg.max_level,
                        quad=cfg.multipole == "quad",
                        quad_leaf=cfg.quad_leaf)
    if mark is not None:
        mark("build")
    return traverse_tree(tree, b0, theta2, g, g_soft, cfg, pos.shape[0],
                         mark=mark)
