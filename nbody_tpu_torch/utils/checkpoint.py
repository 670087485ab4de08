"""The ``format="orbax"`` checkpoints of ``Simulation`` and
``ShardedSimulation``, written with ``torch.distributed.checkpoint`` (DCP).

The JAX package writes an orbax checkpoint directory there
(``nbody_tpu/api.py:345``, ``nbody_tpu/parallel/sharded.py:536``): the
payload tree with each array's sharding, restored straight into the
caller's current layout.  This module writes the same tree as a DCP
directory: the nested dicts ``{"state": {...}, "params": {...}}`` (and
``"lo"`` for a compensated run), every leaf a tensor.  On a mesh the
per-particle arrays are each rank's shard as a ``DTensor`` with ``Shard(0)``
placement over the mesh's own process group; the rest is replicated.
``load`` reads the global shapes from the directory's metadata and restores
into the current world size's shards, so a checkpoint of 2 ranks loads
into 4, as orbax reshards.

Neither package reads the other's directory (this one never imports
orbax); the pickle stays the format both read.
"""

from __future__ import annotations

import os

import numpy as np
import torch


def _device_mesh(mesh):
    """The ``DeviceMesh`` over the process group of ``mesh``
    (``parallel/mesh.py``), no new group made."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    group = mesh.group if mesh.group is not None else dist.group.WORLD
    return DeviceMesh.from_group(group, mesh.device.type)


def _shard0(local, dmesh):
    from torch.distributed.tensor import DTensor, Shard

    return DTensor.from_local(local.contiguous(), dmesh, [Shard(0)],
                              run_check=False)


def _dcp_args(mesh) -> dict:
    return (dict(no_dist=True) if mesh is None
            else dict(process_group=mesh.group))


def save(tree: dict, path, mesh=None, sharded=frozenset()):
    """Write ``tree`` ({section: {name: array or tensor}}) as a DCP
    directory at ``path``, replacing what a checkpoint there held.  Without
    ``mesh`` this process writes alone; with it every rank of the mesh
    calls this, and the leaves named ``"section.name"`` in ``sharded`` are
    this rank's contiguous block of the global array."""
    import torch.distributed.checkpoint as dcp
    from torch.distributed.checkpoint import FileSystemWriter

    dmesh = _device_mesh(mesh) if sharded else None

    def leaf(key, v):
        t = v if torch.is_tensor(v) else torch.as_tensor(np.asarray(v))
        return _shard0(t, dmesh) if key in sharded else t

    state_dict = {top: {name: leaf(f"{top}.{name}", v)
                        for name, v in section.items()}
                  for top, section in tree.items()}
    # overwrite named: torch has announced a False default
    dcp.save(state_dict,
             storage_writer=FileSystemWriter(os.path.abspath(path),
                                             overwrite=True),
             **_dcp_args(mesh))


def load(path, mesh=None, sharded=frozenset()) -> dict:
    """Read a directory written by ``save``: {section: {name: tensor}},
    the ``sharded`` leaves as this rank's block of ``mesh.world`` equal
    blocks on the mesh's device (the global length must split evenly), the
    rest whole on the CPU."""
    import torch.distributed.checkpoint as dcp
    from torch.distributed.checkpoint import FileSystemReader

    path = os.path.abspath(path)
    meta = FileSystemReader(path).read_metadata().state_dict_metadata
    dmesh = _device_mesh(mesh) if sharded else None
    target = {}
    for key, md in meta.items():
        top, name = key.split(".", 1)
        size, dtype = tuple(md.size), md.properties.dtype
        if key in sharded:
            if size[0] % mesh.world:
                raise ValueError(
                    f"{key} of {size[0]} rows does not split over "
                    f"{mesh.world} ranks")
            t = _shard0(torch.empty((size[0] // mesh.world, *size[1:]),
                                    dtype=dtype, device=mesh.device), dmesh)
        else:
            t = torch.empty(size, dtype=dtype)
        target.setdefault(top, {})[name] = t
    dcp.load(target, checkpoint_id=path, **_dcp_args(mesh))
    return {top: {name: (t.to_local() if f"{top}.{name}" in sharded else t)
                  for name, t in section.items()}
            for top, section in target.items()}
