"""All-pairs gravity: wrappers of the CUDA kernels K1, K2 and K6, their
plain torch twins, and the ``brute-pallas`` / ``brute-pallas-sym`` /
``brute-pallas-mxu`` engines (the counterpart of
``nbody_tpu/ops/pairwise.py``; the engine names are kept so users and tests
find them, though no Pallas runs here).

Every function computes, for every target i (alive or not),

    a_i = G * sum_j m_j (p_j - p_i) / (|p_j - p_i|^2 + eps^2)^{3/2}

with m_j = 0 for dead/padding sources; a self or coincident pair contributes
exactly 0 (d = 0, and r2 == 0 is replaced by 1 before the rsqrt).

  * ``pairwise_acc_targets`` (K2): K targets x N sources.  ``pairwise_acc``
    is its K = N case.  Kernel: ``csrc/pairwise.cu`` acc_targets_kernel.
  * ``pairwise_acc_sym`` (K1): the same sums with each unordered pair
    evaluated once (Newton's third law).  Kernel: ``csrc/pairwise.cu``
    acc_sym_tiles_kernel + sym_reduce_kernel.
  * ``pairwise_acc_mxu`` (K6): the same sums with r^2 from the norm trick
    about an anchor per (target tile, source tile) pair, on Morton-sorted
    input (the ``brute-pallas-mxu`` engine sorts).  Kernel:
    ``csrc/pairwise_mxu.cu`` acc_mxu_kernel.

A wrapper given CPU tensors runs its plain twin (``*_plain``); given CUDA
tensors it launches its kernel or raises.  There is no fallback from one to
the other.  The kernels take float32 only.  Each wrapper counts its kernel
launches in its entry of ``LAUNCHES`` (``reset_launch_counts`` zeroes them),
and reports its work to an open ``flops_of`` count (``ops/work.py``)
whichever of the two it runs.
"""

from __future__ import annotations

import math

import torch

from nbody_tpu_torch.core.state import SimParams
from nbody_tpu_torch.engines import Engine, register
from nbody_tpu_torch.ops import _build, work

# Newton-3 kernel range of the brute-pallas engine, kept from the JAX package
# (nbody_tpu/ops/pairwise.py:175).  The bounds were tuned on a TPU: below
# 4096 its tile grid degenerated, and above 262144 its mirror accumulator no
# longer fit VMEM.  They are still to be decided again for the H100.
_SYM_MIN_N = 4096
_SYM_MAX_N = 262144


def _eps2(g_soft, dtype) -> float:
    """epsilon^2 computed in ``dtype``, as the JAX package does."""
    e = torch.tensor(float(g_soft), dtype=dtype)
    return float(e * e)


def _check_3d(*pos):
    for p in pos:
        if p.dim() != 2 or p.shape[1] != 3:
            raise ValueError(
                f"the brute-pallas engines support 3D states only, got shape "
                f"{tuple(p.shape)}; use engine='brute' for 2D"
            )


def _on_cpu(*tensors) -> bool:
    """True for CPU tensors; False for CUDA tensors that the kernels take;
    raises for anything else (other devices, mixed devices, other dtypes,
    non-contiguous memory)."""
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"inputs lie on different devices: {devices}")
    device = devices.pop()
    if device.type == "cpu":
        return True
    if device.type != "cuda":
        raise ValueError(f"unsupported device {device}; use cpu or cuda")
    for t in tensors:
        if t.dtype != torch.float32:
            raise TypeError(f"the CUDA kernels take float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError("the CUDA kernels take contiguous tensors")
    return False


def _stream(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


# ---------------------------------------------------------------------------
# Plain torch twins
# ---------------------------------------------------------------------------


def pairwise_acc_targets_plain(pos_t, pos, mass, g, g_soft, *, tile=1024):
    """Plain torch K2: broadcast (T, 1) targets against (1, N) sources over
    row tiles of T targets, with the kernel's r2 guard."""
    eps2 = _eps2(g_soft, pos.dtype)
    xj, yj, zj, mj = pos[:, 0], pos[:, 1], pos[:, 2], mass[None, :]
    rows = []
    for s in range(0, pos_t.shape[0], tile):
        pt = pos_t[s:s + tile]
        dx = xj[None, :] - pt[:, 0:1]
        dy = yj[None, :] - pt[:, 1:2]
        dz = zj[None, :] - pt[:, 2:3]
        r2 = dx * dx + dy * dy + dz * dz + eps2
        inv_r = torch.rsqrt(torch.where(r2 > 0.0, r2, 1.0))
        w = inv_r * inv_r * inv_r * mj
        rows.append(torch.stack(
            [(w * dx).sum(dim=1), (w * dy).sum(dim=1), (w * dz).sum(dim=1)],
            dim=1))
    return torch.cat(rows) * g


def pairwise_acc_plain(pos, mass, g, g_soft):
    """Plain torch twin of ``pairwise_acc``."""
    return pairwise_acc_targets_plain(pos, pos, mass, g, g_soft)


def pairwise_acc_sym_plain(pos, mass, g, g_soft):
    """Plain torch twin of ``pairwise_acc_sym``: the same function.  Newton's
    third law is how the kernel halves its work, not a different result, so
    the twin is the direct sum itself."""
    return pairwise_acc_targets_plain(pos, pos, mass, g, g_soft)


def mxu_tiles(n: int, tile_i: int = 512, tile_j: int = 1024):
    """The anchor grid of K6: the JAX wrapper's shrink rule
    (``nbody_tpu/ops/pairwise.py:472-477``).  Above 128 rows an N that is
    not a multiple of 128 leaves the grid short of N there (its last rows
    are never written, ROADMAP.md queue 3); here it raises."""
    while tile_i > 128 and n % tile_i:
        tile_i //= 2
    while tile_j > 128 and n % tile_j:
        tile_j //= 2
    tile_i, tile_j = min(tile_i, n), min(tile_j, n)
    if n % tile_i or n % tile_j:
        raise ValueError(
            f"brute-pallas-mxu needs N divisible by its tiles: N = {n} gives "
            f"tiles ({tile_i}, {tile_j}); the JAX kernel leaves the last "
            f"{n % tile_i} rows unwritten there.  Pad N to a multiple of 128")
    return tile_i, tile_j


def pairwise_acc_mxu_plain(pos, mass, g, g_soft, *, tile_i=512, tile_j=1024):
    """Plain torch K6: the TPU kernel's arithmetic per (target tile I,
    source tile J), all target tiles at once for one J:
        c = (p[I ti] + p[J tj]) / 2,  r^2 = n2_i + n2_j - 2 cross + eps^2,
        skip j == i or r^2 <= 0,  s = m_j / r^3,
        out_I += s @ (p_J - c) - (p_I - c) sum_j s
    with the source tiles added in order.  r^2 is built from element-wise
    ops (each rounded once), the sequence the kernel reproduces."""
    _check_3d(pos)
    n = pos.shape[0]
    ti, tj = mxu_tiles(n, tile_i, tile_j)
    eps2 = _eps2(g_soft, pos.dtype)
    ni = n // ti
    p_i = pos.reshape(ni, ti, 3)
    rows = torch.arange(n, device=pos.device).reshape(ni, ti, 1)
    out = torch.zeros_like(p_i)
    for j0 in range(0, n, tj):
        c = (pos[::ti] + pos[j0]) * 0.5  # [ni, 3]: each I's anchor with J
        pc = p_i - c[:, None, :]  # [ni, ti, 3]
        qc = pos[None, j0:j0 + tj, :] - c[:, None, :]  # [ni, tj, 3]
        x, y, z = pc[..., 0:1], pc[..., 1:2], pc[..., 2:3]
        u, v, w = qc[:, None, :, 0], qc[:, None, :, 1], qc[:, None, :, 2]
        n2i = x * x + y * y + z * z
        n2j = u * u + v * v + w * w
        cross = x * u + y * v + z * w
        r2 = n2i + n2j - 2.0 * cross + eps2  # [ni, ti, tj]
        cols = torch.arange(j0, j0 + tj, device=pos.device)
        skip = (rows == cols) | (r2 <= 0.0)
        ir = torch.rsqrt(torch.where(skip, 1.0, r2))
        s = torch.where(skip, 0.0, ir * ir * ir * mass[j0:j0 + tj])
        out = out + (torch.bmm(s, qc) - pc * s.sum(dim=2, keepdim=True))
    return out.reshape(n, 3) * g


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------


# K2's launch (csrc/pairwise.cu): blocks of 64 threads of 4 targets
# (kTargetsThreads, kTargetsPerThread there) and 128-source stages
# (kStage), and the source range cut into at most 64 chunks of at least 256
# sources.  Above one chunk the targets go through in batches of
# _K2_BATCH, whose [splits, batch, 3] partial sums (50 MB at 64 chunks) are
# the scratch, whatever N and K are
_K2_THREADS = 64
_K2_TARGETS = 4
_K2_STAGE = 128
_K2_MIN_CHUNK = 256
_K2_MAX_SPLITS = 64
_K2_BATCH = 1 << 16


def targets_launch(n: int) -> tuple:
    """K2's source chunks for N sources: (chunk, splits).  Chunk c holds
    sources [c * chunk, min(N, (c + 1) * chunk)): every target sums a chunk
    stage by stage (128 sources each, in order), and the chunks in order,
    so the plan, a function of N alone, fixes every target's summation
    order whatever K is.  At N = 2^20, 64 chunks of 16384 (the 4096-row
    oracle: 16 target blocks x 64 = 1024 blocks, ~7.8 an SM); at 65536, 64
    of 1024 (the full call: 16384 blocks); at 2048, 8 of 256 (64 blocks)."""
    n = max(n, 1)
    splits = min(_K2_MAX_SPLITS, -(-n // _K2_MIN_CHUNK))
    chunk = -(-n // splits)
    chunk = -(-chunk // _K2_STAGE) * _K2_STAGE
    return chunk, -(-n // chunk)


def pairwise_acc_targets(pos_t, pos, mass, g, g_soft):
    """Exact direct sum onto a target set: pos_t [K, 3] targets vs pos [N, 3]
    / mass [N] sources -> acc [K, 3] (kernel K2).  A sampled-row call gives
    bitwise the rows of the full call: the sampled exact oracle.  Scratch:
    the packed sources [splits * chunk, 4] and, above one chunk, the
    chunks' partial sums of a batch of targets [splits, min(K, 65536), 3]
    (``targets_launch``)."""
    _check_3d(pos_t, pos)
    cpu = _on_cpu(pos_t, pos, mass)
    work.record("pairwise_acc_targets", "pair", work.targets_work, pos_t,
                pos, mass)
    if cpu:
        return work.plain(pairwise_acc_targets_plain, pos_t, pos, mass, g,
                          g_soft)
    k, n = pos_t.shape[0], pos.shape[0]
    out = torch.empty((k, 3), dtype=torch.float32, device=pos.device)
    if k == 0 or n == 0:
        return out.zero_()
    chunk, splits = targets_launch(n)
    src4 = torch.empty((splits * chunk, 4), dtype=torch.float32,
                       device=pos.device)
    partial = (torch.empty((splits, min(k, _K2_BATCH), 3),
                           dtype=torch.float32, device=pos.device)
               if splits > 1 else None)
    lib = _build.load_library()
    with torch.cuda.device(pos.device):
        rc = lib.nbody_acc_targets(
            pos_t.data_ptr(), k, pos.data_ptr(), mass.data_ptr(), n, chunk,
            splits, _eps2(g_soft, torch.float32), float(g), src4.data_ptr(),
            src4.numel(),
            None if partial is None else partial.data_ptr(),
            0 if partial is None else partial.numel(), out.data_ptr(),
            _stream(pos.device))
    _build.check(lib, rc, "pairwise_acc_targets")
    _launched("pairwise_acc_targets")
    return out


def pairwise_acc(pos, mass, g, g_soft):
    """pos [N, 3], mass [N] -> acc [N, 3] (kernel K2 with K = N)."""
    return pairwise_acc_targets(pos, pos, mass, g, g_soft)


def sym_partial_shape(n: int, tile: int, groups=None) -> tuple:
    """The scratch of K1 (``groups`` None: [nt, n, 3]) and K5 ([groups,
    nt, n, 3]): one [n, 3] slot of partial sums per tile of ``tile`` rows
    (``nbody_sym_tile()``), nt = ceil(n / tile)."""
    nt = -(-n // tile)
    return (nt, n, 3) if groups is None else (groups, nt, n, 3)


def pairwise_acc_sym(pos, mass, g, g_soft):
    """Newton-3 all-pairs (kernel K1): same result as ``pairwise_acc`` up to
    f32 summation order, deterministic run to run.  Scratch: a
    ``sym_partial_shape(N, nbody_sym_tile())`` float32 buffer of
    per-tile-pair partial sums ([N/256, N, 3]: 0.2 GB at N = 65536)."""
    _check_3d(pos)
    cpu = _on_cpu(pos, mass)
    work.record("pairwise_acc_sym", "sym", work.sym_work, pos, mass)
    if cpu:
        return work.plain(pairwise_acc_sym_plain, pos, mass, g, g_soft)
    n = pos.shape[0]
    out = torch.empty((n, 3), dtype=torch.float32, device=pos.device)
    if n == 0:
        return out
    lib = _build.load_library()
    partial = torch.empty(sym_partial_shape(n, lib.nbody_sym_tile()),
                          dtype=torch.float32, device=pos.device)
    with torch.cuda.device(pos.device):
        rc = lib.nbody_acc_sym(
            pos.data_ptr(), mass.data_ptr(), n, _eps2(g_soft, torch.float32),
            float(g), partial.data_ptr(), partial.numel(), out.data_ptr(),
            _stream(pos.device))
    _build.check(lib, rc, "pairwise_acc_sym")
    _launched("pairwise_acc_sym")
    return out


# K6's launch (csrc/pairwise_mxu.cu): blocks of up to 128 threads of 4
# targets, 128-source stages, and the source range split until the grid has
# about _MXU_WANT_BLOCKS blocks
_MXU_ROWS = 512
_MXU_TARGETS = 4
_MXU_STAGE = 128
_MXU_WANT_BLOCKS = 2048


def mxu_launch(n: int, tile_i: int, tile_j: int) -> tuple:
    """K6's launch on the anchor grid (tile_i, tile_j) of N rows: (threads
    a block, source splits).  A block's threads * 4 rows lie in one target
    tile: 512 rows, or the largest power of two dividing tile_i below that
    (512 when the whole of N is one target tile).  The source tiles are split into
    the fewest equal runs that give the grid ~2048 blocks (15.5 blocks an
    SM on an H100's 132): at N = 65536, 128 target blocks x 16 splits of
    4 source tiles.  On the card tile_j must be a multiple of the kernel's
    128-source stage, unless N < 128."""
    if n >= _MXU_STAGE and tile_j % _MXU_STAGE:
        raise ValueError(f"pairwise_acc_mxu: on the card tile_j must be a "
                         f"multiple of {_MXU_STAGE}, got {tile_j}")
    rows = _MXU_ROWS if tile_i == n else math.gcd(tile_i, _MXU_ROWS)
    if rows % _MXU_TARGETS:
        raise ValueError(f"pairwise_acc_mxu: on the card tile_i must be a "
                         f"multiple of {_MXU_TARGETS} or N, got {tile_i}")
    n_tiles = n // tile_j
    blocks = -(-n // rows)
    splits = max(1, min(n_tiles, _MXU_WANT_BLOCKS // blocks))
    while n_tiles % splits:
        splits -= 1
    return rows // _MXU_TARGETS, splits


def pairwise_acc_mxu(pos, mass, g, g_soft, *, tile_i=512, tile_j=1024):
    """pos [N, 3], mass [N] (Morton-sorted by the caller) -> acc [N, 3]
    (kernel K6): the norm-trick all-pairs sum on the anchor grid
    ``mxu_tiles(N, tile_i, tile_j)``.  Deterministic run to run.  Scratch:
    above one source split (``mxu_launch``) a [splits, N, 3] float32 buffer
    of per-split partial sums (12.6 MB at N = 65536)."""
    _check_3d(pos)
    n = pos.shape[0]
    if tuple(mass.shape) != (n,):
        raise ValueError(f"pairwise_acc_mxu: mass must be ({n},), got "
                         f"{tuple(mass.shape)}")
    ti, tj = mxu_tiles(n, tile_i, tile_j)
    cpu = _on_cpu(pos, mass)
    work.record("pairwise_acc_mxu", "mxu", work.mxu_work, pos, mass)
    if cpu:
        return work.plain(pairwise_acc_mxu_plain, pos, mass, g, g_soft,
                          tile_i=ti, tile_j=tj)
    if pos.data_ptr() % 16 or mass.data_ptr() % 16:
        raise ValueError("pairwise_acc_mxu: the CUDA kernel needs 16-byte "
                         "aligned pos and mass")
    threads, splits = mxu_launch(n, ti, tj)
    out = torch.empty((n, 3), dtype=torch.float32, device=pos.device)
    partial = (torch.empty((splits, n, 3), dtype=torch.float32,
                           device=pos.device) if splits > 1 else None)
    lib = _build.load_library()
    with torch.cuda.device(pos.device):
        rc = lib.nbody_acc_mxu(
            pos.data_ptr(), mass.data_ptr(), n, ti, tj, threads, splits,
            _eps2(g_soft, torch.float32), float(g),
            None if partial is None else partial.data_ptr(), out.data_ptr(),
            _stream(pos.device))
    _build.check(lib, rc, "pairwise_acc_mxu")
    _launched("pairwise_acc_mxu")
    return out


#: kernel launches per wrapper (reset_launch_counts zeroes them)
LAUNCHES = {"pairwise_acc_sym": 0, "pairwise_acc_targets": 0,
            "pairwise_acc_mxu": 0}


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


# ---------------------------------------------------------------------------
# Engines
# ---------------------------------------------------------------------------


def _force(pos, mass, params: SimParams):
    if _SYM_MIN_N <= pos.shape[0] <= _SYM_MAX_N:
        return pairwise_acc_sym(pos, mass, params.g, params.g_soft)
    return pairwise_acc(pos, mass, params.g, params.g_soft)


def _force_sym(pos, mass, params: SimParams):
    if pos.shape[0] > _SYM_MAX_N:
        return pairwise_acc(pos, mass, params.g, params.g_soft)
    return pairwise_acc_sym(pos, mass, params.g, params.g_soft)


register(
    Engine(
        name="brute-pallas",
        force=_force,
        description="O(N^2) direct sum, hand-written CUDA kernels: Newton-3 "
        "symmetric (K1) for 4096 <= N <= 262144, plain (K2) otherwise",
    )
)


def mxu_order(pos, mass, bounds):
    """The order in which ``brute-pallas-mxu`` hands particles to K6:
    Morton codes at level 10 on the tree grid, dead (zero-mass) particles
    last, ties in index order (the JAX engine's ``argsort``)."""
    from nbody_tpu_torch.ops import morton
    from nbody_tpu_torch.ops.tree import grid_bounds

    codes = morton.cell_codes(pos, grid_bounds(bounds, 10), 10)
    return torch.argsort(torch.where(mass > 0, codes, 1 << 30), stable=True)


def _force_mxu(pos, mass, params: SimParams):
    """Morton-sort (``mxu_order``), run K6 on the sorted particles, scatter
    back: sorting keeps the tiles compact, so close pairs sit near their
    anchor and the norm trick stays accurate."""
    _check_3d(pos)
    order = mxu_order(pos, mass, params.bounds)
    acc_s = pairwise_acc_mxu(pos[order], mass[order], params.g,
                             params.g_soft)
    out = torch.empty_like(acc_s)
    out[order] = acc_s
    return out


register(
    Engine(
        name="brute-pallas-sym",
        force=_force_sym,
        description="O(N^2) direct sum, Newton-3 symmetric CUDA kernel (K1; "
        "plain K2 above N = 262144)",
    )
)

register(
    Engine(
        name="brute-pallas-mxu",
        force=_force_mxu,
        description="O(N^2) direct sum, norm-trick CUDA kernel (K6) on "
        "Morton-sorted particles, r^2 about per-tile-pair anchors",
    )
)
