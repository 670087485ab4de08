"""The Barnes-Hut collect walk's frame and dense levels on the card: the
wrapper of the CUDA kernel ``csrc/collect_walk.cu``, whose plain twin is
``ops/traversal.py`` ``_collect_dense``.

``group_collect`` takes the twin's arguments and returns the twin's walk
state bit for bit (the slabs with their trash rows, their fill, the
coverage diff array, the counters, the window starts, the group frame,
the near, far and descend lists), plus the window coverage mask where
the walk has no refined levels.  With ``refine_levels > 0`` it also
returns the subgroup boxes, and ``traversal._collect_refined`` continues
from the state in plain torch.  One launch a walk, whatever the levels:
the wrapper adds one to ``LAUNCHES["group_collect"]`` a launch.

It takes CUDA tensors of float32 or float64 and raises for anything the
kernel cannot run (``plan``): there is no fallback.  ``_group_collect``
sends CPU tensors to the twin.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from nbody_tpu_torch.ops import _build, work
from nbody_tpu_torch.ops.pairwise import _stream

#: kernel wrapper calls (reset_launch_counts zeroes them)
LAUNCHES = {"group_collect": 0}

#: the kernel's level slots (kMaxLevels in the source)
MAX_LEVELS = 16
#: dynamic shared memory a block may take on an H100 (232448 bytes), less
#: the kernel's static shared memory
SMEM_LIMIT = 232448 - 4096
#: rows of the kernel's [len(COUNTS), G] int32 output
COUNTS = ("accept_dropped", "frontier_fallback", "near_fallback", "fb_spill",
          "mono_off", "fb_off", "wstart")

_p, _i, _ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


class Params(ctypes.Structure):
    """The kernel's ``Params<T>``, field for field (pointers are the same
    size for both element types)."""

    _fields_ = [
        ("table", _p * MAX_LEVELS), ("parent_cap", _i * MAX_LEVELS),
        ("gpos", _p), ("gpos_g", _ll), ("gpos_b", _ll), ("gpos_c", _ll),
        ("gmass", _p), ("gmass_g", _ll), ("gmass_b", _ll),
        ("gidx", _p), ("gidx_g", _ll),
        ("width", _p), ("grid_min", _p), ("grid_width", _p),
        ("refine_slot_leaf", _p),
        ("thr", ctypes.c_double),
        *((name, _i) for name in (
            "G", "B", "S", "L", "start_level", "dim", "wide", "sliding",
            "accept_offset", "n_total", "W", "window_pad", "A", "FB", "NC",
            "NPC", "local", "local_lo", "local_hi", "FC", "FPC",
            "rf_parent_cap", "max_parents")),
        *((name, _p) for name in (
            "mono", "fb", "near_ids", "near_valid", "far_ids", "far_valid",
            "rids", "rvalid", "delta", "wmask", "center", "boxes",
            "counts")),
    ]


def plan(cfg, dtype) -> dict:
    """The kernel's static arguments for ``cfg``: each dense level's
    parent cap (the frontier slots of the next level over the branch
    factor), the largest of them (the frontier buffers), the refined
    frontier's parents, and the dynamic shared memory (the S subgroup
    boxes, two frontier buffers).  Raises where the kernel cannot run
    ``cfg`` in ``dtype``."""
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"the collect walk kernel takes float32 or float64, "
                        f"got {dtype}")
    L, start = cfg.max_level, cfg.start_level
    if not 0 <= start <= L < MAX_LEVELS:
        raise ValueError(f"the collect walk kernel takes levels "
                         f"{start}..{L} within 0..{MAX_LEVELS - 1}")
    sched = cfg.schedule()
    caps = [0] * MAX_LEVELS
    for l in range(start, L):
        caps[l] = sched[l - start] // cfg.branch
    max_parents = max(caps + [1])
    smem = (6 * cfg.subgroups * torch.finfo(dtype).bits // 8
            + 2 * max_parents * 4)
    if smem > SMEM_LIMIT:
        raise ValueError(
            f"the collect walk kernel's {cfg.subgroups} subgroup boxes and "
            f"{max_parents}-parent frontier take {smem} bytes of shared "
            f"memory, over {SMEM_LIMIT}")
    return dict(parent_cap=caps, max_parents=max_parents, smem=smem,
                rf_parent_cap=(cfg.refine_frontier // cfg.branch
                               if cfg.refine_levels else 0))


def _ptr(t) -> int:
    return 0 if t is None else t.data_ptr()


@functools.cache
def _check_layout(lib):
    """The packed ``Params`` against the library's, once a library."""
    for dbl in (0, 1):
        got = lib.nbody_collect_params_bytes(dbl)
        if got != ctypes.sizeof(Params):
            raise RuntimeError(f"collect walk Params: {got} bytes in the "
                               f"library, {ctypes.sizeof(Params)} packed")


def pack(tree, n_total: int, width, thr, cfg, window: int, gpos, gmass,
         gidx, sliding: bool = False, local_bounds=None, grid=None):
    """The kernel's arguments for ``traversal._collect_dense``'s (``thr``
    a 0-d CPU tensor), on any device: (``Params``, its dynamic shared
    memory bytes, the walk state whose tensors the launch fills, and the
    temporaries ``Params`` points at, to keep until the launch is
    enqueued).  The state holds ``wmask`` [G, W] where
    ``cfg.refine_levels`` is 0 and the subgroup boxes ``gc`` / ``gh`` [G,
    S, 3] where it is not."""
    dtype, dev = gpos.dtype, gpos.device
    pl = plan(cfg, dtype)
    L = cfg.max_level
    tables = [t if t.is_contiguous() else t.contiguous()
              for t in tree.level_table[:L + 1]]
    if len(tables) != L + 1 or any(
            t.dtype != dtype or t.device != dev or t.shape[1:] != (8,)
            for t in tables):
        raise ValueError(f"the tree's level tables must be {L + 1} [n, 8] "
                         f"{dtype} tensors on {dev}")
    if gmass.dtype != dtype or gidx.dtype != torch.int32 \
            or gmass.device != dev or gidx.device != dev:
        raise ValueError("gmass must share gpos's dtype and device, gidx "
                         "be int32 on it")
    G, B, _ = gpos.shape
    S, W, A, FB = cfg.subgroups, window, cfg.accept_cap, cfg.fb_cap
    NC, branch = cfg.near_cell_cap, cfg.branch
    local = local_bounds is not None
    FC = cfg.far_cell_cap if local else 0
    R, rpc = cfg.refine_levels, pl["rf_parent_cap"]
    width = width.to(dtype).reshape(())
    slot_leaf = None
    if R:
        slot_leaf = tree.refine_slot_leaf
        if slot_leaf.dtype != torch.int32 or not slot_leaf.is_contiguous():
            raise ValueError("refine_slot_leaf must be contiguous int32")
    gmin = gwidth = None
    if cfg.accept_offset:
        gmin = grid.min.to(dtype).contiguous()
        gwidth = grid.width.to(dtype).reshape(())

    f = dict(dtype=dtype, device=dev)
    i32 = dict(dtype=torch.int32, device=dev)
    b8 = dict(dtype=torch.bool, device=dev)
    counts = torch.empty((len(COUNTS), G), **i32)
    st = dict(zip(COUNTS, counts.unbind(0)),
              mono=torch.empty((G, A + 1, 8), **f),
              fb=torch.empty((G, FB + 1, 8), **f),
              near_ids=torch.empty((G, NC), **i32),
              near_valid=torch.empty((G, NC), **b8),
              delta=torch.empty((G, W + 1), **i32),
              center=torch.empty((G, 3), **f))
    if local:
        st.update(far_ids=torch.empty((G, FC), **i32),
                  far_valid=torch.empty((G, FC), **b8))
    boxes = None
    if R:
        boxes = torch.empty((2, G, S, 3), **f)
        st.update(rids=torch.empty((G, rpc * branch), **i32),
                  rvalid=torch.empty((G, rpc * branch), **b8),
                  gc=boxes[0], gh=boxes[1])
    else:
        st["wmask"] = torch.empty((G, W), **b8)

    p = Params()
    for l, t in enumerate(tables):
        p.table[l] = t.data_ptr()
    for l, c in enumerate(pl["parent_cap"]):
        p.parent_cap[l] = c
    p.gpos, (p.gpos_g, p.gpos_b, p.gpos_c) = gpos.data_ptr(), gpos.stride()
    p.gmass, (p.gmass_g, p.gmass_b) = gmass.data_ptr(), gmass.stride()
    p.gidx, p.gidx_g = gidx.data_ptr(), gidx.stride(0)
    p.width, p.grid_min, p.grid_width = (width.data_ptr(), _ptr(gmin),
                                         _ptr(gwidth))
    p.refine_slot_leaf = _ptr(slot_leaf)
    p.thr = float(thr)
    p.G, p.B, p.S, p.L, p.start_level, p.dim = (G, B, S, L, cfg.start_level,
                                                cfg.dim)
    p.wide, p.sliding, p.accept_offset = (int(cfg.wide), int(sliding),
                                          int(cfg.accept_offset))
    p.n_total, p.W, p.window_pad = n_total, W, cfg.window_pad
    p.A, p.FB, p.NC, p.NPC = A, FB, NC, cfg.near_particle_cap
    p.local, p.FC, p.FPC = int(local), FC, cfg.far_particle_cap
    if local:
        p.local_lo, p.local_hi = int(local_bounds[0]), int(local_bounds[1])
    p.rf_parent_cap, p.max_parents = rpc, pl["max_parents"]
    p.counts, p.boxes = counts.data_ptr(), _ptr(boxes)
    for name in ("mono", "fb", "near_ids", "near_valid", "far_ids",
                 "far_valid", "rids", "rvalid", "delta", "wmask", "center"):
        setattr(p, name, _ptr(st.get(name)))
    return p, pl["smem"], st, (tables, width, gmin, gwidth)


def group_collect(tree, n_total: int, width, thr, cfg, window: int, gpos,
                  gmass, gidx, sliding: bool = False, local_bounds=None,
                  grid=None) -> dict:
    """``traversal._collect_dense`` in one launch of the kernel, for CUDA
    tensors (its arguments; ``pack`` says what it returns)."""
    dev = gpos.device
    if dev.type != "cuda":
        raise ValueError(f"the collect walk kernel takes CUDA tensors, got "
                         f"{dev}; the plain twin is traversal._collect_dense")
    p, smem, st, _keep = pack(tree, n_total, width, thr, cfg, window, gpos,
                              gmass, gidx, sliding, local_bounds, grid)
    lib = _build.load_library()
    _check_layout(lib)
    with torch.cuda.device(dev):
        rc = lib.nbody_group_collect(ctypes.byref(p),
                                     int(gpos.dtype == torch.float64), smem,
                                     _stream(dev))
    _build.check(lib, rc, "group_collect")
    with work.LOCK:
        LAUNCHES["group_collect"] += 1
    return st


def reset_launch_counts():
    with work.LOCK:
        for k in LAUNCHES:
            LAUNCHES[k] = 0


def launch_counts() -> dict:
    with work.LOCK:
        return dict(LAUNCHES)
