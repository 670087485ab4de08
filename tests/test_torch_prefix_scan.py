"""The build's double-float prefix table (``ops/prefix_scan.py``) on the CPU:
a CPU tensor takes the plain twin, bitwise the log-step TwoSum scan restated
in numpy and within its own error of the exact sums, and launches nothing;
the wrapper refuses what the kernel does not take, on either device.  The
kernel itself runs on the card (tests/test_torch_cuda.py)."""

import numpy as np
import pytest
import torch

from nbody_tpu_torch.ops import prefix_scan as ps
from nbody_tpu_torch.ops import tree as ttree
from torch_prefix_cases import exact_error, hillis_steele, prefix_case


@pytest.mark.parametrize("dtype", [np.float32, np.float64],
                         ids=["float32", "float64"])
@pytest.mark.parametrize("k", [1, 3, 4])
@pytest.mark.parametrize("n", [1, 2, 1023, 1025, 5000])
def test_cpu_takes_the_twin_bitwise(n, k, dtype):
    v, s = prefix_case(n, k, dtype, seed=n + k)
    ps.reset_launch_counts()
    got = ps.prefix_table(torch.from_numpy(v))
    assert ps.launch_counts() == {"prefix_table": 0}
    assert got.dtype == torch.from_numpy(v).dtype and got.shape == (n + 1, 8)
    np.testing.assert_array_equal(got.numpy(), hillis_steele(v))
    # the twin's own error: a few 2^-48 (f32) / 2^-106 (f64) of the
    # prefix of |values| at most
    unit = 2.0 ** (-48 if dtype == np.float32 else -106)
    assert exact_error(v, s, got.numpy()) < 2 * np.log2(n + 1) * unit


def test_build_reads_the_table_through_the_wrapper(monkeypatch):
    """``build_octree`` and ``refresh_octree`` take their three tables (the
    leaf stats and the two second-moment halves, each contiguous) from
    ``prefix_table``."""
    from nbody_tpu_torch.core.state import Bounds

    calls = []

    def spy(vals):
        calls.append(tuple(vals.shape))
        return ps.prefix_table(vals)

    monkeypatch.setattr(ttree, "prefix_table", spy)
    rng = np.random.default_rng(0)
    pos = torch.from_numpy(rng.uniform(-4, 4, (3000, 3)).astype(np.float32))
    mass = torch.full((3000,), 1.0 / 3000)
    b = Bounds.cube([0.0, 0.0, 0.0], 10.0, device="cpu")
    tree = ttree.build_octree(pos, mass, b, 4, quad=True, quad_leaf=False)
    ttree.refresh_octree(tree, pos, mass)
    assert calls == [(3000, 4), (3000, 3), (3000, 3)] * 2


@pytest.mark.parametrize("case", ["k5", "k0", "one-dim", "non-contiguous",
                                  "int32", "int64", "float16"])
def test_wrapper_refuses(case):
    x = torch.ones((64, 4))
    bad, err = {
        "k5": (torch.ones((64, 5)), ValueError),
        "k0": (torch.ones((64, 0)), ValueError),
        "one-dim": (torch.ones(64), ValueError),
        "non-contiguous": (torch.ones((64, 6))[:, :3], ValueError),
        "int32": (x.to(torch.int32), TypeError),
        "int64": (x.to(torch.int64), TypeError),
        "float16": (x.half(), TypeError),
    }[case]
    with pytest.raises(err):
        ps.prefix_table(bad)
