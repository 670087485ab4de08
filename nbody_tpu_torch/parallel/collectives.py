"""The four collectives of the sharded path, one for each JAX collective the
JAX package's ``nbody_tpu/parallel`` uses, over ``torch.distributed``:

    lax.all_gather(tiled=True)   -> all_gather      (all_gather_into_tensor)
    lax.psum                     -> psum            (all_reduce)
    lax.psum_scatter(tiled=True) -> psum_scatter    (reduce_scatter_tensor)
    lax.ppermute around the ring -> ring_shift      (batch_isend_irecv)

Each takes the ``Mesh`` (``parallel/mesh.py``) and works on dim 0.  At world
size 1 each is the identity (no rank sends to itself).  ``bool`` tensors
travel as ``uint8``, which NCCL needs.  None of them reads a value back to
the host: on the card they enqueue on the current stream like a kernel.

Above world size 1, while the span recorder is on (``utils/profiling.py``
``SPANS``), each call is a ``collective`` span (``profiling.within``: on
the card's timeline from the stream reaching the call to the stream
having its result, inside whatever phase of the step it serves) and adds
the bytes it sends from this rank to ``ops/work.py`` ``SENT``: those of
the bandwidth-optimal ring algorithm, from the shapes alone, with ``S``
the bytes of this rank's input and ``w`` the world size:

    all_gather     S (w - 1)        (this rank's block to every other)
    psum           2 S (w - 1) / w  (a reduce-scatter, then an all-gather)
    psum_scatter   S (w - 1) / w    (every block but its own, once)
    ring_shift     S                (each tensor to one neighbour)
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from nbody_tpu_torch.ops import work
from nbody_tpu_torch.utils.profiling import within

SPAN = "collective"


def _wire(x):
    """``x`` in a dtype every backend takes, contiguous."""
    return (x.to(torch.uint8) if x.dtype == torch.bool else x).contiguous()


def _bytes(t) -> int:
    return t.numel() * t.element_size()


def all_gather(x, mesh):
    """The ranks' ``x`` concatenated along dim 0 in rank order."""
    if mesh.world == 1:
        return x
    with within(SPAN):
        w = _wire(x)
        work.sent("all_gather", _bytes(w) * (mesh.world - 1))
        out = w.new_empty((mesh.world * w.shape[0], *w.shape[1:]))
        dist.all_gather_into_tensor(out, w, group=mesh.group)
        return out.to(x.dtype)


def psum(x, mesh):
    """The sum of the ranks' ``x`` (a new tensor on every rank)."""
    if mesh.world == 1:
        return x
    with within(SPAN):
        out = _wire(x).clone()
        work.sent("psum", 2 * _bytes(out) * (mesh.world - 1) // mesh.world)
        dist.all_reduce(out, group=mesh.group)
        return out


def psum_scatter(x, mesh):
    """The sum of the ranks' ``x`` [world * R, ...]; this rank keeps its
    block of R rows."""
    if mesh.world == 1:
        return x
    with within(SPAN):
        w = _wire(x)
        out = w.new_empty((w.shape[0] // mesh.world, *w.shape[1:]))
        work.sent("psum_scatter", _bytes(out) * (mesh.world - 1))
        dist.reduce_scatter_tensor(out, w, group=mesh.group)
        return out


def ring_shift(tensors, mesh, shift: int = 1):
    """Each rank's ``tensors`` to rank ``rank + shift`` (mod world), in one
    batch of sends and receives; returns what rank ``rank - shift`` sent."""
    if mesh.world == 1:
        return list(tensors)
    with within(SPAN):
        dst = (mesh.rank + shift) % mesh.world
        src = (mesh.rank - shift) % mesh.world
        sends = [_wire(t) for t in tensors]
        work.sent("ring_shift", sum(_bytes(s) for s in sends))
        recvs = [torch.empty_like(s) for s in sends]
        ops = ([dist.P2POp(dist.isend, s, dst, group=mesh.group)
                for s in sends]
               + [dist.P2POp(dist.irecv, r, src, group=mesh.group)
                  for r in recvs])
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        return [r.to(t.dtype) for r, t in zip(recvs, tensors)]
