"""The work of the kernels K1-K6: the FP32 operations a pair of each kernel
family, the pairs and bytes a call's inputs need, the lock of the wrappers'
launch counters, and the thread-local count that
``utils.profiling.flops_of`` opens.

A wrapper reports its work through ``record``, whether it then launches its
kernel or runs its plain twin on the CPU.  Nothing is computed while no
count is open: the pair counts read the masses back to the host, which a
step must not wait for.
"""

from __future__ import annotations

import contextlib
import threading

# FP32 arithmetic a pair (an FMA counts two; compares, selects and integer
# work are not FP32 operations and are not counted), read off the kernels:
#   d-form, one direction (K2, K3): 3 sub, |d|^2 + eps^2 6, ir^3 2,
#     * m 1, three FMAs 6                                             = 18
#   Newton-3 (K1, K5) per unordered pair: those 18, m_i * ir^3 1, three
#     column FMAs 6                                                   = 25
#   quadrupole (K4): e 3, r^2 6, ir^2..ir^7 4, Q e 15, e.Qe 5, w 4,
#     three (w e - ir^5 u) 12                                         = 49
#     (its 1/r: one MUFU rsqrt, and the seven FP32 instructions that
#     round it as the twin's float64 rsqrt does, outside this count)
#   norm trick (K6): cross 5, r^2 4, ir^3 2, * m 1, four sums 7       = 19
PAIR_OPS = {"pair": 18, "sym": 25, "quad": 49, "mxu": 19}

#: guards the wrappers' launch counters: two threads that step and serve
#: the same simulation launch kernels at once, and ``+= 1`` on a shared
#: counter is a read-modify-write
LOCK = threading.Lock()

_local = threading.local()


class WorkCount:
    """The work of one thread's kernel wrapper calls while a count is open:
    FP32 operations by wrapper name, and bytes.  ``aten`` is the
    ``FlopCounterMode`` counting the ops around the wrappers, if any, and
    ``twin_aten`` its flops that came from plain twins run in place of a
    kernel (already counted by the pair table)."""

    def __init__(self, aten=None):
        self.flops = {}
        self.bytes = 0
        self.aten = aten
        self.twin_aten = 0


@contextlib.contextmanager
def counting(aten=None):
    """Open a count for this thread (nested counts each see only their own
    calls); yields the ``WorkCount``."""
    prev = getattr(_local, "count", None)
    _local.count = count = WorkCount(aten)
    try:
        yield count
    finally:
        _local.count = prev


def record(name: str, kind: str, needs, *args):
    """Add ``needs(*args)`` = (pairs, bytes) of one ``name`` call, at
    ``PAIR_OPS[kind]`` operations a pair, to this thread's open count; no-op
    (``needs`` not called) when none is open."""
    count = getattr(_local, "count", None)
    if count is None:
        return
    pairs, nbytes = needs(*args)
    count.flops[name] = count.flops.get(name, 0) + pairs * PAIR_OPS[kind]
    count.bytes += nbytes


def plain(fn, *args, **kwargs):
    """Run a plain twin in place of its kernel: its own aten operations are
    kept out of the open count's aten total, which the pair table counts
    already."""
    count = getattr(_local, "count", None)
    if count is None or count.aten is None:
        return fn(*args, **kwargs)
    before = count.aten.get_total_flops()
    out = fn(*args, **kwargs)
    count.twin_aten += count.aten.get_total_flops() - before
    return out


# ---------------------------------------------------------------------------
# Pairs and bytes a call needs: every (target, massive source) pair once
# (K1, K5: every unordered pair with a massive member once); each input
# read once, each output written once
# ---------------------------------------------------------------------------


def _nnz(x) -> int:
    return int((x != 0).sum())


def targets_work(pos_t, pos, mass):
    """K2: K x N; a target set that is the source positions is read once."""
    k, n = pos_t.shape[0], pos.shape[0]
    same = pos_t.data_ptr() == pos.data_ptr() and k == n
    return k * _nnz(mass), (0 if same else 12 * k) + 16 * n + 12 * k


def sym_work(pos, mass):
    """K1: each unordered pair with a massive member once."""
    n, nm = pos.shape[0], _nnz(mass)
    return nm * (nm - 1) // 2 + nm * (n - nm), 28 * n


def mxu_work(pos, mass):
    """K6: N x massive sources."""
    n = pos.shape[0]
    return n * _nnz(mass), 28 * n


def group_work(tgt8, slab, tile, mask):
    """K3: each target against each massive slab row outside the source
    tiles its mask entry skips."""
    G, B = tgt8.shape[:2]
    S = slab.shape[1]
    nbytes = G * B * 24 + G * S * 16
    if mask is None:
        return B * _nnz(slab[..., 3]), nbytes
    nz = (slab[..., 3] != 0).reshape(G, S // tile, tile).sum(-1)  # [G, S/t]
    kept = (~mask.bool()).to(nz.dtype) * nz[:, None, :]
    return (B // mask.shape[1]) * int(kept.sum()), nbytes + mask.numel()


def quad_work(tgt8, qslab):
    """K4: each target against each massive quadrupole row."""
    G, B = tgt8.shape[:2]
    return B * _nnz(qslab[..., 3]), G * B * 24 + G * qslab.shape[1] * 40


def self_work(tgt8, msrc):
    """K5: each group's unordered pairs with a massive member once."""
    G, B = msrc.shape
    ng = (msrc != 0).sum(dim=1).tolist()
    return sum(m * (m - 1) // 2 + m * (B - m) for m in ng), G * B * 28
