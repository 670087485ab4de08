"""The work of the kernels K1-K6: the FP32 operations a pair of each kernel
family, the pairs and bytes a call's inputs need, the lock of the wrappers'
launch counters, and the thread-local count that
``utils.profiling.flops_of`` opens.

A wrapper reports its work through ``record``, whether it then launches its
kernel or runs its plain twin on the CPU, and K3's wrapper also through
``tally``.  The pair counts are tensors on the inputs' device, computed
only while a count is open or (``tally``) the span recorder is on
(``utils/profiling.py`` ``SPANS``): a few small kernels a call, and no host
read.  An open count reads its sums back once, when it closes; ``TALLY``
keeps them on the device.  Beside it, ``SENT`` counts the bytes the
sharded path's collectives send (``sent``), on the host.
"""

from __future__ import annotations

import contextlib
import threading

import torch

from nbody_tpu_torch.utils import profiling

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


#: while the span recorder is on, the K3 wrapper's calls (``tally``) by
#: name, ``group_force`` and ``group_force_masked``: ``{"pairs": the pairs
#: they needed (a 0-d int64 tensor on their device, never read back here),
#: "bytes": their bytes, "calls": their number}`` (the benchmark copies it
#: at both ends of its traced slice)
TALLY = {}

#: while the span recorder is on, the bytes each kind of collective of
#: ``parallel/collectives.py`` sent from this rank (``all_gather``,
#: ``psum``, ``psum_scatter``, ``ring_shift``): ``{"bytes": int, "calls":
#: int}``, host integers known from the shapes (nothing is read back from
#: the card; the benchmark copies it at both ends of its traced slice)
SENT = {}


class WorkCount:
    """The work of one thread's kernel wrapper calls while a count is open:
    FP32 operations by wrapper name (ints once the count has closed), and
    bytes.  ``aten`` is the ``FlopCounterMode`` counting the ops around the
    wrappers, if any, and ``twin_aten`` its flops that came from plain twins
    run in place of a kernel (already counted by the pair table)."""

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
        count.flops = {k: int(v) for k, v in count.flops.items()}


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


def tally(name: str, needs, *args):
    """With the span recorder on, add ``needs(*args)`` = (pairs, bytes) of
    one ``name`` call to ``TALLY``; a flag test when it is off."""
    if not profiling.SPANS.on:
        return
    pairs, nbytes = needs(*args)
    with LOCK:
        t = TALLY.get(name)
        TALLY[name] = ({"pairs": pairs, "bytes": nbytes, "calls": 1}
                       if t is None else
                       {"pairs": t["pairs"] + pairs,
                        "bytes": t["bytes"] + nbytes,
                        "calls": t["calls"] + 1})


def sent(kind: str, nbytes: int):
    """With the span recorder on, add one ``kind`` call that sent
    ``nbytes`` from this rank to ``SENT``; a flag test when it is off."""
    if not profiling.SPANS.on:
        return
    with LOCK:
        t = SENT.setdefault(kind, {"bytes": 0, "calls": 0})
        t["bytes"] += int(nbytes)
        t["calls"] += 1


def reset_tally():
    """Empty ``TALLY`` and ``SENT``."""
    with LOCK:
        TALLY.clear()
        SENT.clear()


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


def _nnz(x):
    return (x != 0).sum()


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
    kept = torch.where(mask.bool(), 0, nz[:, None, :]).sum()
    return (B // mask.shape[1]) * kept, nbytes + mask.numel()


def quad_work(tgt8, qslab):
    """K4: each target against each massive quadrupole row."""
    G, B = tgt8.shape[:2]
    return B * _nnz(qslab[..., 3]), G * B * 24 + G * qslab.shape[1] * 40


def self_work(tgt8, msrc):
    """K5: each group's unordered pairs with a massive member once."""
    G, B = msrc.shape
    m = (msrc != 0).sum(dim=1)
    return (m * (m - 1) // 2 + m * (B - m)).sum(), G * B * 28
