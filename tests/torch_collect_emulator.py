"""A numpy restatement of the collect walk kernel (``csrc/collect_walk.cu``)
that reads the kernel's packed arguments (``ops/collect_walk.py``
``Params``) from host memory and writes its outputs there, for CPU tensors.

It follows the kernel's own structure: one group at a time, each level's
frontier in rounds of ``THREADS`` slots, each round's block scans as a
cumsum over the round plus the level's running totals, the overflow,
spill and drop ranks in the kernel's closed form, and the float tests in
the kernel's operation order in the dtype (numpy rounds every operation,
as the kernel's round-to-nearest intrinsics do).  ``collect`` runs the
wrapper's packing and ``launch`` in place of the library's
``nbody_group_collect``, so the CPU tests hold the packing and the
kernel's algorithm against the plain twin ``traversal._collect_dense``
bit for bit without a card.
"""

import ctypes

import numpy as np
import torch

from nbody_tpu_torch.ops import collect_walk as cw

THREADS = 512  # kThreads in the source


def _array(ptr, n, dtype):
    """n elements of ``dtype`` at host address ``ptr`` (a writable view)."""
    ct = np.ctypeslib.as_ctypes_type(np.dtype(dtype))
    return np.ctypeslib.as_array((ct * n).from_address(ptr))


def _squash(v, dim):
    v = np.uint32(v)
    if dim == 3:
        v &= np.uint32(0x09249249)
        for sh, m in ((2, 0x030C30C3), (4, 0x0300F00F), (8, 0x030000FF),
                      (16, 0x000003FF)):
            v = (v | (v >> np.uint32(sh))) & np.uint32(m)
    else:
        v &= np.uint32(0x55555555)
        for sh, m in ((1, 0x33333333), (2, 0x0F0F0F0F), (4, 0x00FF00FF),
                      (8, 0x0000FFFF)):
            v = (v | (v >> np.uint32(sh))) & np.uint32(m)
    return int(v)


def launch(params_ref, dbl: int, smem: int, stream) -> int:
    """The library entry point's contract: one "launch" over the packed
    ``Params``; returns 0."""
    p = ctypes.cast(params_ref, ctypes.POINTER(cw.Params)).contents
    T = np.float64 if dbl else np.float32
    G, B, S, L, W = p.G, p.B, p.S, p.L, p.W
    branch = 1 << p.dim
    with np.errstate(over="ignore"):  # the empty subgroups' 1e30 boxes
        for g in range(G):
            _group(p, T, g, G, B, S, L, W, branch)
    return 0


def _group(p, T, g, G, B, S, L, W, branch):
    f = T
    per = B // S
    # strided reads of the group's rows
    span = (B - 1) * p.gpos_b + 2 * p.gpos_c + 1
    gpos = _array(p.gpos + g * p.gpos_g * np.dtype(T).itemsize, span, T)
    gmass = _array(p.gmass + g * p.gmass_g * np.dtype(T).itemsize,
                   (B - 1) * p.gmass_b + 1, T)
    pos = np.stack([gpos[np.arange(B) * p.gpos_b + c * p.gpos_c]
                    for c in range(3)], axis=1)
    mass = gmass[np.arange(B) * p.gmass_b]
    alive = mass > 0
    gc = np.empty((S, 3), T)
    gh = np.empty((S, 3), T)
    for s in range(S):
        rows = slice(s * per, (s + 1) * per)
        a = alive[rows]
        if a.any():
            lo = pos[rows][a].min(axis=0)
            hi = pos[rows][a].max(axis=0)
        else:
            lo = hi = np.full(3, f(1e30), T)
        gc[s] = f(0.5) * (lo + hi)
        gh[s] = f(0.5) * (hi - lo)
    if p.boxes:
        boxes = _array(p.boxes, 2 * G * S * 3, T).reshape(2, G, S, 3)
        boxes[0, g], boxes[1, g] = gc, gh
    center = _array(p.center, G * 3, T).reshape(G, 3)
    if alive.any():
        center[g] = f(0.5) * (pos[alive].min(axis=0) + pos[alive].max(axis=0))
    else:
        center[g] = 0
    ws = int(_array(p.gidx + g * p.gidx_g * 4, 1, np.int32)[0]) \
        - p.window_pad
    if not p.sliding:
        ws = min(max(ws, 0), max(p.n_total - W, 0))
    we = ws + W
    delta = _array(p.delta, G * (W + 1), np.int32).reshape(G, W + 1)[g]
    delta[:] = 0
    mono = _array(p.mono, G * (p.A + 1) * 8, T).reshape(G, p.A + 1, 8)[g]
    fb = _array(p.fb, G * (p.FB + 1) * 8, T).reshape(G, p.FB + 1, 8)[g]
    near_ids = _array(p.near_ids, G * p.NC, np.int32).reshape(G, p.NC)[g]
    near_valid = _array(p.near_valid, G * p.NC, np.bool_).reshape(
        G, p.NC)[g]
    thr = f(p.thr)
    width = _array(p.width, 1, T)[0]
    if p.accept_offset:
        gmin = _array(p.grid_min, p.dim, T)
        gwidth = _array(p.grid_width, 1, T)[0]

    par_in, par_out = [], []
    npar = mono_off = fb_off = 0
    a_dropped = f_fallback = n_fallback = fb_spill = 0
    n_near = n_far = n_desc = 0
    for l in range(p.start_level, L + 1):
        leaf, first = l == L, l == p.start_level
        n_slots = (1 << (p.dim * l)) if first else npar * branch
        nrows = 1 << (p.dim * l)
        table = _array(p.table[l], nrows * 8, T).reshape(nrows, 8)
        wl = width / f(1 << l)
        cw2 = wl * wl
        cwo = gwidth / f(1 << l) if p.accept_offset else f(0)
        pc = 0 if leaf else p.parent_cap[l]
        c = dict(exp=0, acc=0, ovf=0, desc=0, ncnt=0, nc=0, fcnt=0, fc=0,
                 inl=0, inf=0)
        mono0, fb0 = mono_off, fb_off
        par_out = [0] * p.max_parents
        for base in range(0, n_slots, THREADS):
            n = min(THREADS, n_slots - base)
            slots = []
            for i in range(base, base + n):
                id_ = i if first else (par_in[i >> p.dim] << p.dim) \
                    + (i & (branch - 1))
                row = table[id_]
                if p.wide:
                    part = row[4:8].astype(np.int32)
                    cs = int((part[0] << 12) | part[1])
                    ce = int((part[2] << 12) | part[3])
                else:
                    cs, ce = int(row[4]), int(row[5])
                acc = expand = False
                com = np.zeros(3, T)
                m = row[0]
                if m > 0:
                    com = row[1:4] / m
                    if cs >= ws and ce <= we:
                        delta[cs - ws] += 1
                        delta[ce - ws] -= 1
                    else:
                        d = np.abs(com[None, :] - gc) - gh
                        d = np.where(d > 0, d, f(0))
                        d2 = (d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1]) \
                            + d[:, 2] * d[:, 2]
                        r2 = d2.min()
                        if p.accept_offset:
                            off2 = f(0)
                            for k in range(p.dim):
                                a = f(_squash(id_ >> k, p.dim))
                                ctr = gmin[k] + (a + f(0.5)) * cwo
                                dd = com[k] - ctr
                                off2 = dd * dd if k == 0 else off2 + dd * dd
                            reach = np.sqrt(r2) - np.sqrt(off2)
                            reach = reach if reach > 0 else f(0)
                            r2 = reach * reach
                        acc = bool(cw2 < thr * r2)
                        expand = not acc
                slots.append(dict(id=id_, row=row, com=com, cs=cs, ce=ce,
                                  acc=acc, exp=expand))

            def push(s, ovf, o_incl, a_incl):
                room = p.FB - fb0
                d_incl = max(o_incl - room, 0)
                spill = False
                if ovf:
                    slot = fb0 + o_incl - 1
                    if slot < p.FB:
                        fb[slot] = [*s["row"][:6], l, s["id"]]
                    else:
                        spill = True
                if s["acc"] or spill:
                    slot = mono0 + a_incl + d_incl - 1
                    if slot < p.A:
                        mono[slot] = [*s["com"], s["row"][0], -1,
                                      -1 if spill else l, s["id"], l]

            if not leaf:
                ex = np.cumsum([s["exp"] for s in slots])
                ac = np.cumsum([s["acc"] for s in slots])
                for k, s in enumerate(slots):
                    e = c["exp"] + int(ex[k])
                    if s["exp"] and e <= pc:
                        par_out[e - 1] = s["id"]
                    push(s, s["exp"] and e > pc, max(e - pc, 0),
                         c["acc"] + int(ac[k]))
                c["exp"] += int(ex[-1])
                c["acc"] += int(ac[-1])
                continue
            desc = [False] * n
            if p.rf_parent_cap:
                slot_leaf = _array(p.refine_slot_leaf, nrows, np.int32)
                rb = [int(slot_leaf[s["id"]]) if s["exp"] else -1
                      for s in slots]
                dc = np.cumsum([r >= 0 for r in rb])
                rpc = p.rf_parent_cap
                rids = _array(p.rids, G * rpc * branch, np.int32).reshape(
                    G, rpc * branch)[g]
                rvalid = _array(p.rvalid, G * rpc * branch,
                                np.bool_).reshape(G, rpc * branch)[g]
                for k in range(n):
                    d = c["desc"] + int(dc[k])
                    if rb[k] >= 0 and d <= rpc:
                        desc[k] = True
                        at = (d - 1) * branch
                        rids[at:at + branch] = rb[k] * branch + np.arange(
                            branch)
                        rvalid[at:at + branch] = True
                c["desc"] += int(dc[-1])
            flags = []
            for k, s in enumerate(slots):
                e2 = s["exp"] and not desc[k]
                is_local = (not p.local) or (s["cs"] >= p.local_lo
                                             and s["ce"] <= p.local_hi)
                el, ef = e2 and is_local, e2 and not is_local
                flags.append((e2, el, ef, s["ce"] - s["cs"]))
            v = np.array([(cn if el else 0, el, cn if ef else 0, ef)
                          for _, el, ef, cn in flags], np.int64)
            inc = np.cumsum(v, axis=0)
            sel = []
            for k, (e2, el, ef, _) in enumerate(flags):
                in_l = el and c["ncnt"] + inc[k, 0] <= p.NPC \
                    and c["nc"] + inc[k, 1] <= p.NC
                in_f = ef and c["fcnt"] + inc[k, 2] <= p.FPC \
                    and c["fc"] + inc[k, 3] <= p.FC
                sel.append((bool(in_l), bool(in_f),
                            bool(e2 and not in_l and not in_f)))
            for j, key in enumerate(("ncnt", "nc", "fcnt", "fc")):
                c[key] += int(inc[-1, j])
            v = np.array([(a, b, o, s["acc"])
                          for (a, b, o), s in zip(sel, slots)], np.int64)
            inc = np.cumsum(v, axis=0)
            for k, ((in_l, in_f, ovf), s) in enumerate(zip(sel, slots)):
                if in_l:
                    near_ids[c["inl"] + inc[k, 0] - 1] = s["id"]
                if in_f:
                    far = _array(p.far_ids, G * p.FC, np.int32).reshape(
                        G, p.FC)[g]
                    far[c["inf"] + inc[k, 1] - 1] = s["id"]
                push(s, ovf, c["ovf"] + int(inc[k, 2]),
                     c["acc"] + int(inc[k, 3]))
            for j, key in enumerate(("inl", "inf", "ovf", "acc")):
                c[key] += int(inc[-1, j])
        if not leaf:
            c["ovf"] = max(c["exp"] - pc, 0)
        room = p.FB - fb0
        spilled = max(c["ovf"] - room, 0)
        fb_off = min(fb0 + c["ovf"], p.FB)
        fb_spill += spilled
        pushed = c["acc"] + spilled
        a_dropped += max(pushed - (p.A - mono0), 0)
        mono_off = min(mono0 + pushed, p.A)
        if leaf:
            n_fallback, n_near, n_far = c["ovf"], c["inl"], c["inf"]
            n_desc = min(c["desc"], p.rf_parent_cap)
        else:
            f_fallback += c["ovf"]
            npar = min(c["exp"], pc)
            par_in = par_out

    mono[mono_off:p.A] = 0
    fb[fb_off:p.FB] = 0
    near_ids[n_near:] = 0
    near_valid[:] = np.arange(p.NC) < n_near
    if p.local:
        far = _array(p.far_ids, G * p.FC, np.int32).reshape(G, p.FC)[g]
        far[n_far:] = 0
        _array(p.far_valid, G * p.FC, np.bool_).reshape(G, p.FC)[g][:] = \
            np.arange(p.FC) < n_far
    if p.rf_parent_cap:
        n = p.rf_parent_cap * branch
        rids = _array(p.rids, G * n, np.int32).reshape(G, n)[g]
        rvalid = _array(p.rvalid, G * n, np.bool_).reshape(G, n)[g]
        rids[n_desc * branch:] = np.arange(n_desc * branch, n) % branch
        rvalid[n_desc * branch:] = False
    counts = _array(p.counts, len(cw.COUNTS) * G, np.int32).reshape(-1, G)
    counts[:, g] = [a_dropped, f_fallback, n_fallback, fb_spill, mono_off,
                    fb_off, ws]
    if p.wmask:
        _array(p.wmask, G * W, np.bool_).reshape(G, W)[g][:] = \
            np.cumsum(delta[:W]) > 0


def collect(*args):
    """``collect_walk.group_collect`` for CPU tensors (its arguments): the
    wrapper's packing, then ``launch`` in place of the kernel."""
    p, smem, st, _keep = cw.pack(*args)
    launch(ctypes.byref(p), int(args[6].dtype == torch.float64), smem, None)
    return st
