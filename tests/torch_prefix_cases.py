"""Seeded inputs of the double-float prefix table (``ops/prefix_scan.py``)
and its error against the exact prefix sums, shared by the CPU tests
(tests/test_torch_prefix_scan.py) and the card's (tests/test_torch_cuda.py,
which must not import jax).

The values sit on a grid 2^-s, so every prefix sum is an exact integer
multiple of 2^-s and so is every hi and lo word of a table (sums and TwoSum
errors of grid values stay on the grid): the error of a partial is an exact
integer.  The grid is fine enough that the double-float pairs do round: 61
bits below the largest column total in float32, 149 in float64 (a pair
holds ~48 and ~106 bits)."""

import math

import numpy as np

#: the double-float pair's unit of rounding: where the twin comes out exact,
#: a table is held to this
DF_UNIT = {np.float32: 2.0 ** -48, np.float64: 2.0 ** -106}


def prefix_case(n, k, dtype, seed=0):
    """[n, k] values of mixed signs (the m x, m y, m z columns of a build;
    column 0 positive, a mass) over 12 octaves in float32 and 60 in float64
    (enough that the exact sums outgrow a double-float pair), on the grid
    2^-s: returns (values, s)."""
    rng = np.random.default_rng(seed)
    octaves = 12 if dtype == np.float32 else 60
    v = 2e-6 * rng.uniform(-1, 1, (n, k)) * 2.0 ** rng.integers(
        -octaves, 1, (n, k))
    v[:, 0] = np.abs(v[:, 0])
    v = v.astype(dtype)
    total = max(float(np.abs(v.astype(np.float64)).sum(0).max()), 1e-30)
    s = 61 - math.ceil(math.log2(total)) + (88 if dtype == np.float64 else 0)
    v = (np.round(v.astype(np.float64) * 2.0 ** s) / 2.0 ** s).astype(dtype)
    return v, s


def _ints(a, s):
    """Exact integers a * 2^s (int64 in float32, Python ints in float64)."""
    x = a.astype(np.float64) * 2.0 ** s
    if a.dtype == np.float32:
        out = x.astype(np.int64)
    else:
        out = np.array([int(f) for f in x.ravel().tolist()],
                       dtype=object).reshape(x.shape)
    assert np.all(out == x), "a value off the 2^-s grid"
    return out


def exact_error(vals, s, table):
    """The largest |hi + lo - exact prefix| over every partial and column
    of ``table`` [n + 1, 8] (numpy), over the prefix of |vals| there (the
    scale that bounds a summation error)."""
    n, k = vals.shape
    iv = _ints(vals, s)
    zero = np.zeros((1, k), dtype=iv.dtype)
    exact = np.concatenate([zero, np.cumsum(iv, axis=0)])
    scale = np.concatenate([zero, np.cumsum(np.abs(iv), axis=0)])
    err = np.abs(_ints(table[:, :k], s) + _ints(table[:, k:2 * k], s) - exact)
    scale = np.maximum(scale.astype(np.float64), 1.0)
    return float((err.astype(np.float64) / scale).max())


def hillis_steele(vals):
    """The twin's scan restated in numpy: log-step partials, each combine a
    TwoSum of the hi words and a plain sum of the lo words; [n, k] ->
    [n + 1, 8]."""
    n, k = vals.shape
    hi, lo = vals.copy(), np.zeros_like(vals)
    shift = 1
    while shift < n:
        ah, al, bh, bl = hi[:-shift], lo[:-shift], hi[shift:], lo[shift:]
        s = ah + bh
        z = s - ah
        e = (ah - (s - z)) + (bh - z)
        hi = np.concatenate([hi[:shift], s])
        lo = np.concatenate([lo[:shift], e + al + bl])
        shift *= 2
    out = np.zeros((n + 1, 8), vals.dtype)
    out[1:, :k], out[1:, k:2 * k] = hi, lo
    return out
