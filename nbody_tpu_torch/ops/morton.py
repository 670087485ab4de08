"""Morton (Z-order) cell codes on integer grids (the counterpart of
``nbody_tpu/ops/morton.py``): 3D octree codes and 2D quadtree codes.

A 3D cell id at level l interleaves the per-axis grid indices as
``x | y << 1 | z << 2`` per level, so ``child = parent * 8 + orthant`` and
``parent = child >> 3``: the level-l ids of the dense pyramid are contiguous
ranges with 8 children per parent.  2D codes interleave ``x | y << 1`` with
4 children per parent.

Torch has no uint32 arithmetic, so the bit interleave runs in int64 with
explicit masks.  The codes hold at most 30 bits (level 10 in 3D, 15 in 2D),
so every mask and shift stays inside int64 and the codes equal the JAX
package's uint32 codes bit for bit.
"""

from __future__ import annotations

import torch

MAX_LEVEL_3D = 10  # 30-bit codes
MAX_LEVEL_2D = 15  # 30-bit codes


def _spread3(v):
    """Spread the low 10 bits of v so bit i lands at bit 3i (int64)."""
    v = v.to(torch.int64) & 0x3FF
    v = (v | (v << 16)) & 0x030000FF
    v = (v | (v << 8)) & 0x0300F00F
    v = (v | (v << 4)) & 0x030C30C3
    v = (v | (v << 2)) & 0x09249249
    return v


def _squash3(v):
    """Inverse of _spread3: collect every 3rd bit into the low 10 bits."""
    v = v & 0x09249249
    v = (v | (v >> 2)) & 0x030C30C3
    v = (v | (v >> 4)) & 0x0300F00F
    v = (v | (v >> 8)) & 0x030000FF
    v = (v | (v >> 16)) & 0x000003FF
    return v


def encode3(ix, iy, iz):
    """Interleave three integer grids (each < 2^10) into Morton codes
    (int64)."""
    return _spread3(ix) | (_spread3(iy) << 1) | (_spread3(iz) << 2)


def decode3(code):
    """Morton codes -> (ix, iy, iz), int64."""
    code = code.to(torch.int64) & 0xFFFFFFFF
    return _squash3(code), _squash3(code >> 1), _squash3(code >> 2)


def _spread2(v):
    """Spread the low 15 bits of v so bit i lands at bit 2i (int64;
    ``morton.py:61``)."""
    v = v.to(torch.int64) & 0x7FFF
    v = (v | (v << 8)) & 0x00FF00FF
    v = (v | (v << 4)) & 0x0F0F0F0F
    v = (v | (v << 2)) & 0x33333333
    v = (v | (v << 1)) & 0x55555555
    return v


def _squash2(v):
    """Inverse of _spread2: collect every 2nd bit into the low 15 bits."""
    v = v & 0x55555555
    v = (v | (v >> 1)) & 0x33333333
    v = (v | (v >> 2)) & 0x0F0F0F0F
    v = (v | (v >> 4)) & 0x00FF00FF
    v = (v | (v >> 8)) & 0x0000FFFF
    return v


def encode2(ix, iy):
    """Interleave two integer grids (each < 2^15) into Morton codes
    (int64)."""
    return _spread2(ix) | (_spread2(iy) << 1)


def decode2(code):
    """Morton codes -> (ix, iy), int64."""
    code = code.to(torch.int64) & 0xFFFFFFFF
    return _squash2(code), _squash2(code >> 1)


def quantize(pos, bounds, level):
    """Positions [N, D] -> D integer grids at ``level`` (2^level per axis),
    clamped into the box (out-of-box and dead particles land on the boundary
    cell; callers rely on their zero mass, not their cell).  Clamping in
    float before the truncating cast gives the same cells as the JAX
    package's cast-then-clip for every in-range value."""
    n = 1 << level
    u = bounds.normalize(pos)
    i = torch.clamp(u * n, 0, n - 1).to(torch.int32)
    return tuple(i[..., d] for d in range(pos.shape[-1]))


def cell_codes(pos, bounds, level):
    """Positions [N, D] -> level-``level`` Morton cell ids, int32 in
    [0, (2^D)^level)."""
    axes = quantize(pos, bounds, level)
    if len(axes) == 3:
        return encode3(*axes).to(torch.int32)
    if len(axes) == 2:
        return encode2(*axes).to(torch.int32)
    raise ValueError(f"unsupported dimension {len(axes)}")


def cell_centers_from_codes(codes, bounds, level, dim: int = 3):
    """Cell ids (level ``level``) -> geometric centers [N, dim]."""
    if dim == 3:
        axes = decode3(codes)
    elif dim == 2:
        axes = decode2(codes)
    else:
        raise ValueError(f"unsupported dimension {dim}")
    w = bounds.width / (1 << level)
    lo = bounds.min
    return torch.stack(
        [lo[d] + (a.to(w.dtype) + 0.5) * w for d, a in enumerate(axes)],
        dim=-1)
