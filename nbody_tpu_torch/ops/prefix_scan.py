"""The double-float prefix table of the Barnes-Hut build: the wrapper of the
CUDA kernel ``csrc/prefix_scan.cu`` and its plain torch twin.

``prefix_table(vals)`` takes sorted per-particle values [N, K] (1 <= K <= 4,
float32 or float64, contiguous) and returns the [N + 1, 8] table the build
reads its range sums off (``ops/tree.py`` ``_range_sums_from_table``): row 0
zero, row i + 1 the sum of rows 0..i as a hi + lo pair a column, hi in
columns 0..K-1, lo in K..2K-1, zeros after.  Every partial is accurate to
~2^-46 of its size in f32, so a boundary difference (hi_e - hi_s) + (lo_e -
lo_s) keeps that accuracy where a plain f32 cumsum difference would put
~ulp(total) on every range (a one-particle leaf's COM could move by the
whole domain).

A CPU tensor runs the plain twin, the JAX package's TwoSum combiner
(``nbody_tpu/ops/tree.py:235-258``) as an eager log-step scan.  A CUDA tensor
launches the kernel (one launch up to 1024 rows, three above) or raises;
there is no fallback.  The kernel adds in its own fixed order, so its bits
differ from the twin's within that accuracy, and are the same on every run.
The wrapper adds one to ``LAUNCHES["prefix_table"]`` a table it launches.
"""

from __future__ import annotations

import torch

from nbody_tpu_torch.ops import _build, work
from nbody_tpu_torch.ops.pairwise import _stream

#: kernel wrapper calls (reset_launch_counts zeroes them)
LAUNCHES = {"prefix_table": 0}


def prefix_table_plain(vals):
    """Plain torch twin: a log-step (Hillis-Steele) scan with the TwoSum
    combiner, every partial a hi + lo pair; [N, K] -> [N + 1, 8]."""
    n, k = vals.shape
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


def prefix_table(vals):
    """vals [N, K] -> the [N + 1, 8] double-float prefix table (the twin's
    on the CPU, the kernel's on the card)."""
    if vals.dim() != 2 or not 1 <= vals.shape[1] <= 4:
        raise ValueError(f"prefix tables take [N, K] values with 1 <= K <= 4, "
                         f"got {tuple(vals.shape)}")
    if vals.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"prefix tables take float32 or float64, got "
                        f"{vals.dtype}")
    if not vals.is_contiguous():
        raise ValueError("prefix tables take contiguous values")
    if vals.device.type == "cpu":
        return prefix_table_plain(vals)
    if vals.device.type != "cuda":
        raise ValueError(f"unsupported device {vals.device}; use cpu or cuda")
    n, k = vals.shape
    if n >= 1 << 31:
        raise ValueError(f"prefix tables take fewer than 2^31 rows, got {n}")
    lib = _build.load_library()
    out = torch.empty((n + 1, 8), dtype=vals.dtype, device=vals.device)
    scratch = torch.empty((lib.nbody_prefix_scratch(n, k),),
                          dtype=vals.dtype, device=vals.device)
    with torch.cuda.device(vals.device):
        rc = lib.nbody_prefix_table(
            vals.data_ptr(), n, k, int(vals.dtype == torch.float64),
            out.data_ptr(), scratch.data_ptr(), _stream(vals.device))
    _build.check(lib, rc, "prefix_table")
    with work.LOCK:
        LAUNCHES["prefix_table"] += 1
    return out


def reset_launch_counts():
    with work.LOCK:
        for k in LAUNCHES:
            LAUNCHES[k] = 0


def launch_counts() -> dict:
    with work.LOCK:
        return dict(LAUNCHES)
