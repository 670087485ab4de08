"""The benchmark's frozen roofline arithmetic: the card's published peaks,
the FP32 operations a pair of each kernel family, and the pairs and bytes a
kernel call's inputs need.  Copied here so that a change to the program
cannot move the yardstick it is measured by.

Peaks: NVIDIA H100 SXM data sheet, dense rates at the 700 W limit: 67
TFLOP/s FP32 outside the tensor cores, 3.35 TB/s HBM3.  A run records the
card's ``power.limit`` beside every share (``harness/device.py``).

Operations a pair: ``nbody_tpu_torch/ops/work.py`` ``PAIR_OPS`` as the
kernels compute them (an FMA counts two; compares, selects and integer work
are not counted):
  d-form, one direction (K2, K3): 3 sub, |d|^2 + eps^2 6, ir^3 2, * m 1,
    three FMAs 6                                                    = 18
  Newton-3 (K1, K5) per unordered pair: those 18, m_i * ir^3 1, three
    column FMAs 6                                                   = 25
  quadrupole (K4): e 3, r^2 6, ir^2..ir^7 4, Q e 15, e.Qe 5, w 4,
    three (w e - ir^5 u) 12                                         = 49
  norm trick (K6): cross 5, r^2 4, ir^3 2, * m 1, four sums 7       = 19

Pairs: only those the inputs need (each target against each massive
source row the call does not skip), each input byte read once and each
output byte written once.
"""

from __future__ import annotations

FP32_PER_S = 67e12
BYTES_PER_S = 3.35e12
PAIR_OPS = {"pair": 18, "sym": 25, "quad": 49, "mxu": 19}


def bound_s(pairs: int, kind: str, nbytes: int):
    """The least time the card could take for ``pairs`` pairs of ``kind``
    moving ``nbytes`` bytes: (seconds, "operations" or "bytes")."""
    t_ops = pairs * PAIR_OPS[kind] / FP32_PER_S
    t_bytes = nbytes / BYTES_PER_S
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def k3_work(tgt8, slab, tile, mask):
    """K3 (group force): each of a group's ``B`` targets against each
    massive row of its slab [G, S, 8] outside the source tiles its mask
    [G, B / rows, S / tile] entry skips.  Bytes: each target's position
    read and its force written (24), each slab row's position and mass
    read (16), the mask once.  Returns (pairs, bytes)."""
    G, B = tgt8.shape[:2]
    S = slab.shape[1]
    nbytes = G * B * 24 + G * S * 16
    massive = slab[..., 3] != 0
    if mask is None:
        return B * int(massive.sum()), nbytes
    nz = massive.reshape(G, S // tile, tile).sum(-1)           # [G, S/t]
    kept = (~mask.bool()).to(nz.dtype) * nz[:, None, :]
    return (B // mask.shape[1]) * int(kept.sum()), nbytes + mask.numel()
