"""Barnes-Hut group forces: wrappers of the CUDA kernels K3 and K4, their
plain torch twins, and the tile arithmetic the walk shares with them (the
counterpart of ``nbody_tpu/ops/group_force.py``).

Every group's B targets are evaluated against that group's assembled source
slab.  Rows are the walk's 8-wide ``(x, y, z, m, idx, 0, 0, 0)`` (targets
and pair sources) and 16-wide ``(x, y, z, M, Qxx, Qyy, Qzz, Qxy, Qxz, Qyz,
0...)`` (quadrupole sources), taken as [G, B, 8], [G, S, 8] and [G, A, 16]:
the JAX package's transposed [G, 8, S] slab existed for TPU lanes.

  * ``group_force`` (K3): a_i = G sum_j m_j d_ij / (|d_ij|^2 + eps^2)^{3/2}
    over the slab rows.  ``mask`` [G, B/TI, S/tile] (block-dual) skips the
    (target tile, source tile) pairs it marks: those ride the source tile's
    quadrupole instead.  TI and tile are the grid the mask was built on
    (``fit_target_tile``, traversal ``_fit_eval_tile``); the kernel looks the
    mask up once per (row, 128-row stage), so on the card ``tile`` is a
    multiple of 128.  Kernel: ``csrc/group_force.cu`` group_force_kernel.
  * ``quad_force`` (K4): a = G [M e/r^3 - Q e/r^5 + 5/2 (eᵀQe) e/r^7] over
    traceless-quadrupole rows.  A row of zero mass carries Q = 0 (the
    walk's do), so the kernel ends each 128-row stage at its last massive
    row.  Kernel: ``csrc/group_force.cu`` quad_force_kernel.
  * ``group_self_force`` (K5, ``BHConfig.near_sym``): each group against
    its own B rows, a_i = G sum_j msrc_j d_ij / (|d_ij|^2 + eps^2)^{3/2},
    with msrc [G, B] the window-masked source masses.  The kernel evaluates
    each unordered pair once and gives the mirrored term -msrc_i ir3 d_ij to
    j: a masked particle (msrc = 0) still feels a covered one.  Kernel:
    ``csrc/pairwise.cu`` acc_sym_tiles_kernel<8> + sym_reduce_kernel (K1's
    tiles with a grid dimension over groups).

No self-pair index test: a self or coincident pair has d = 0 and adds
exactly 0 (at eps = 0 once r^2 == 0 is replaced by 1).  Source tiles whose
masses are all zero are skipped, which changes no bit of the result.

A wrapper given CPU tensors runs its plain twin; given CUDA tensors it
launches its kernel or raises (float32, contiguous).  There is no fallback.
Each wrapper adds one to its entry of ``LAUNCHES`` where it launches its
kernel; the masked and unmasked K3 launches are counted apart
(``group_force_masked`` / ``group_force``).  Each reports its work to an
open ``flops_of`` count (``ops/work.py``), whether it launches its kernel
or runs its twin.
"""

from __future__ import annotations

import math

import torch

from nbody_tpu_torch.ops import _build, work
from nbody_tpu_torch.ops.pairwise import (_eps2, _on_cpu, _stream,
                                         sym_partial_shape)

# bound of the plain twins' [groups, targets, tile] temporaries, in
# elements (2^26 f32 = 256 MB each)
_PLAIN_BLOCK_ELEMS = 1 << 26

#: kernel launches per wrapper (reset_launch_counts zeroes them)
LAUNCHES = {"group_force": 0, "group_force_masked": 0, "quad_force": 0,
            "group_self_force": 0}


def fit_target_tile(B: int, tile: int, target_tile: int, cap: int) -> int:
    """The target-tile rows TI of the block-dual mask grid: divide B and keep
    TI * tile <= cap (the TPU kernel's scoped-VMEM budget, kept because it
    defines which (target, source) pairs one mask entry covers)."""
    ti = target_tile
    while ti > 8 and B % ti:
        ti //= 2
    while ti > 8 and ti * tile > cap:
        ti //= 2
    return min(ti, B)


def _group_chunk(G, B, tile):
    """Groups per chunk so the [groups, B, tile] temporaries stay bounded."""
    return max(1, min(G, _PLAIN_BLOCK_ELEMS // max(B * tile, 1)))


# ---------------------------------------------------------------------------
# Plain torch twins
# ---------------------------------------------------------------------------
#
# Both twins add the slab one source tile at a time, in tile order, so a
# tile of zero-mass padding adds exactly zero and a padded slab gives
# bitwise the same result, as it does in the kernels.


def group_force_plain(tgt8, slab, g, g_soft, *, tile, mask=None):
    """Plain torch K3: the same sum as the kernel, chunked over groups and
    source tiles so no temporary exceeds ~2^26 elements."""
    G, B, _ = tgt8.shape
    S = slab.shape[1]
    eps2 = _eps2(g_soft, tgt8.dtype)
    step = _group_chunk(G, B, tile)
    out = []
    for g0 in range(0, G, step):
        t = tgt8[g0:g0 + step]
        tx, ty, tz = t[..., 0:1], t[..., 1:2], t[..., 2:3]
        acc = torch.zeros((t.shape[0], B, 3), dtype=tgt8.dtype,
                          device=tgt8.device)
        for j in range(S // tile):
            src = slab[g0:g0 + step, j * tile:(j + 1) * tile]
            dx = src[:, None, :, 0] - tx
            dy = src[:, None, :, 1] - ty
            dz = src[:, None, :, 2] - tz
            r2 = dx * dx + dy * dy + dz * dz + eps2
            ir = torch.rsqrt(torch.where(r2 > 0.0, r2, 1.0))
            w = ir * ir * ir * src[:, None, :, 3]
            if mask is not None:
                # this source tile's mask entry for every target row
                skip = mask[g0:g0 + step, :, j].bool().repeat_interleave(
                    B // mask.shape[1], dim=1)
                w = torch.where(skip[..., None], 0.0, w)
            acc = acc + torch.stack(
                [(w * dx).sum(-1), (w * dy).sum(-1), (w * dz).sum(-1)], -1)
        out.append(acc)
    return torch.cat(out) * g


def quad_force_plain(tgt8, qslab, g, g_soft, *, tile):
    """Plain torch K4 (the guard masks of ``_quad_block``: r^2 == 0 zeroes
    the pair's w and 1/r^5), chunked like ``group_force_plain``, with 1/r
    correctly rounded as the kernel computes it."""
    G, B, _ = tgt8.shape
    A = qslab.shape[1]
    eps2 = _eps2(g_soft, tgt8.dtype)
    step = _group_chunk(G, B, tile)
    out = []
    for g0 in range(0, G, step):
        t = tgt8[g0:g0 + step]
        tx, ty, tz = t[..., 0:1], t[..., 1:2], t[..., 2:3]
        acc = torch.zeros((t.shape[0], B, 3), dtype=tgt8.dtype,
                          device=tgt8.device)
        for j in range(A // tile):
            q = qslab[g0:g0 + step, j * tile:(j + 1) * tile][:, None]
            ex, ey, ez = q[..., 0] - tx, q[..., 1] - ty, q[..., 2] - tz
            r2 = ex * ex + ey * ey + ez * ez + eps2
            ok = r2 > 0.0
            # 1/r correctly rounded (computed in float64): the quadrupole
            # terms raise it to the 7th power, which multiplies its error
            ir = torch.rsqrt(torch.where(ok, r2, 1.0).double()).to(r2.dtype)
            ir2 = ir * ir
            ir3 = ir2 * ir
            ir5 = ir3 * ir2
            ir7 = ir5 * ir2
            qxx, qyy, qzz = q[..., 4], q[..., 5], q[..., 6]
            qxy, qxz, qyz = q[..., 7], q[..., 8], q[..., 9]
            ux = qxx * ex + qxy * ey + qxz * ez
            uy = qxy * ex + qyy * ey + qyz * ez
            uz = qxz * ex + qyz * ey + qzz * ez
            qe = ex * ux + ey * uy + ez * uz
            w = torch.where(ok, q[..., 3] * ir3 + 2.5 * qe * ir7, 0.0)
            ir5 = torch.where(ok, ir5, 0.0)
            acc = acc + torch.stack(
                [(w * ex - ir5 * ux).sum(-1), (w * ey - ir5 * uy).sum(-1),
                 (w * ez - ir5 * uz).sum(-1)], -1)
        out.append(acc)
    return torch.cat(out) * g


def group_self_force_plain(tgt8, msrc, g, g_soft):
    """Plain torch K5: every group's rows against themselves with source
    masses ``msrc``, i.e. K3's sum over a slab made of the group's own rows
    carrying ``msrc`` (self-pairs add 0 through d = 0), one source tile of
    up to 2048 rows at a time."""
    B = tgt8.shape[1]
    slab = torch.cat([tgt8[..., :3], msrc[..., None], tgt8[..., 4:]], dim=-1)
    return group_force_plain(tgt8, slab, g, g_soft, tile=math.gcd(B, 2048))


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------


def _check_aligned(what, *tensors):
    """The kernels load rows as float4: 16-byte aligned rows."""
    if any(t.data_ptr() % 16 for t in tensors):
        raise ValueError(f"{what}: the CUDA kernel needs 16-byte aligned rows")


def _check_rows(tgt8, src, width, what):
    if tgt8.dim() != 3 or tgt8.shape[2] != 8:
        raise ValueError(f"{what}: targets must be [G, B, 8], got "
                         f"{tuple(tgt8.shape)}")
    if (src.dim() != 3 or src.shape[0] != tgt8.shape[0]
            or src.shape[2] != width):
        raise ValueError(f"{what}: sources must be [G, S, {width}] with "
                         f"G = {tgt8.shape[0]}, got {tuple(src.shape)}")


def group_force(tgt8, slab, g, g_soft, *, tile, mask=None):
    """tgt8 [G, B, 8], slab [G, S, 8] -> acc [G, B, 3] (kernel K3).
    ``tile`` divides S and is the source width of one mask entry; ``mask``
    [G, B/TI, S/tile] bool marks the (target tile, source tile) pairs to
    skip."""
    _check_rows(tgt8, slab, 8, "group_force")
    G, B, _ = tgt8.shape
    S = slab.shape[1]
    if S % tile:
        raise ValueError(f"group_force: tile {tile} does not divide S = {S}")
    if mask is not None:
        bt, st = mask.shape[1], mask.shape[2]
        if (mask.shape[0] != G or B % bt or st != S // tile):
            raise ValueError(f"group_force: mask {tuple(mask.shape)} does not "
                             f"fit B = {B}, S = {S}, tile = {tile}")
    cpu = _on_cpu(tgt8, slab)
    name = "group_force" if mask is None else "group_force_masked"
    work.record(name, "pair", work.group_work, tgt8, slab, tile, mask)
    if cpu:
        return work.plain(group_force_plain, tgt8, slab, g, g_soft,
                          tile=tile, mask=mask)
    _check_aligned("group_force", tgt8, slab)
    out = torch.empty((G, B, 3), dtype=torch.float32, device=tgt8.device)
    if G == 0 or B == 0:
        return out
    lib = _build.load_library()
    stage = lib.nbody_k3_stage()
    if mask is None:
        mask_ptr, ti, st = None, B, 1
    else:
        if mask.device != tgt8.device:
            raise ValueError("group_force: mask lies on another device")
        if tile % stage:
            raise ValueError(f"group_force: a masked call on the card needs "
                             f"tile to be a multiple of {stage}, got {tile}")
        mask_u8 = mask.to(torch.uint8).contiguous()
        mask_ptr, ti, st = mask_u8.data_ptr(), B // mask.shape[1], S // tile
    with torch.cuda.device(tgt8.device):
        rc = lib.nbody_group_force(
            tgt8.data_ptr(), slab.data_ptr(), mask_ptr, G, B, S, ti, tile, st,
            _eps2(g_soft, torch.float32), float(g), out.data_ptr(),
            _stream(tgt8.device))
    _build.check(lib, rc, "group_force")
    _launched(name)
    return out


def quad_force(tgt8, qslab, g, g_soft, *, tile):
    """tgt8 [G, B, 8], qslab [G, A, 16] -> acc [G, B, 3] (kernel K4).
    ``tile`` divides A (the JAX package's skip granularity; kept as a shape
    check)."""
    _check_rows(tgt8, qslab, 16, "quad_force")
    G, B, _ = tgt8.shape
    A = qslab.shape[1]
    if A % tile:
        raise ValueError(f"quad_force: tile {tile} does not divide A = {A}")
    cpu = _on_cpu(tgt8, qslab)
    work.record("quad_force", "quad", work.quad_work, tgt8, qslab)
    if cpu:
        return work.plain(quad_force_plain, tgt8, qslab, g, g_soft, tile=tile)
    _check_aligned("quad_force", tgt8, qslab)
    out = torch.empty((G, B, 3), dtype=torch.float32, device=tgt8.device)
    if G == 0 or B == 0:
        return out
    lib = _build.load_library()
    with torch.cuda.device(tgt8.device):
        rc = lib.nbody_quad_force(
            tgt8.data_ptr(), qslab.data_ptr(), G, B, A,
            _eps2(g_soft, torch.float32), float(g), out.data_ptr(),
            _stream(tgt8.device))
    _build.check(lib, rc, "quad_force")
    _launched("quad_force")
    return out


def quad_rsqrt_sweep(device=None) -> tuple:
    """K4's 1/r (``csrc/group_force.cu`` rsqrt_rn) against
    ``(float)rsqrt((double)x)``, the twin's, over every positive normal
    float, on the card: (mismatches, largest difference in ulps).  A check
    of the kernel's arithmetic (chip_smoke.py, tests/test_torch_cuda.py)."""
    device = torch.device("cuda") if device is None else torch.device(device)
    out = torch.zeros(2, dtype=torch.int64, device=device)
    lib = _build.load_library()
    with torch.cuda.device(device):
        rc = lib.nbody_rsqrt_sweep(out.data_ptr(), _stream(device))
    _build.check(lib, rc, "quad_rsqrt_sweep")
    bad, ulps = out.tolist()
    return bad, ulps


def group_self_force(tgt8, msrc, g, g_soft):
    """tgt8 [G, B, 8], msrc [G, B] -> acc [G, B, 3] (kernel K5): each
    group's Newton-3 self square.  Deterministic run to run.  Scratch: a
    ``sym_partial_shape(B, nbody_sym_tile(), G)`` float32 buffer of
    per-tile-pair partial sums ([G, B/256, B, 3]: 0.4 GB at the 1M tier)."""
    if tgt8.dim() != 3 or tgt8.shape[2] != 8:
        raise ValueError(f"group_self_force: rows must be [G, B, 8], got "
                         f"{tuple(tgt8.shape)}")
    if tuple(msrc.shape) != tuple(tgt8.shape[:2]):
        raise ValueError(f"group_self_force: msrc must be "
                         f"{tuple(tgt8.shape[:2])}, got {tuple(msrc.shape)}")
    cpu = _on_cpu(tgt8, msrc)
    work.record("group_self_force", "sym", work.self_work, tgt8, msrc)
    if cpu:
        return work.plain(group_self_force_plain, tgt8, msrc, g, g_soft)
    G, B, _ = tgt8.shape
    out = torch.empty((G, B, 3), dtype=torch.float32, device=tgt8.device)
    if G == 0 or B == 0:
        return out
    lib = _build.load_library()
    partial = torch.empty(sym_partial_shape(B, lib.nbody_sym_tile(), G),
                          dtype=torch.float32, device=tgt8.device)
    with torch.cuda.device(tgt8.device):
        rc = lib.nbody_self_force(
            tgt8.data_ptr(), msrc.data_ptr(), G, B,
            _eps2(g_soft, torch.float32), float(g), partial.data_ptr(),
            partial.numel(), out.data_ptr(), _stream(tgt8.device))
    _build.check(lib, rc, "group_self_force")
    _launched("group_self_force")
    return out


def _launched(name):
    with work.LOCK:
        LAUNCHES[name] += 1


def reset_launch_counts():
    with work.LOCK:
        for k in LAUNCHES:
            LAUNCHES[k] = 0


def launch_counts() -> dict:
    with work.LOCK:
        return dict(LAUNCHES)
