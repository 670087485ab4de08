"""The particle mesh over ``torch.distributed`` (the counterpart of
``nbody_tpu/parallel/mesh.py``).

The JAX package shards particles over a 1-D device mesh and runs the step
under ``shard_map``.  Here each rank is one process holding its contiguous
shard of the particle arrays, as each chip holds it under ``shard_map``:
``Mesh.rank`` is ``lax.axis_index``, ``Mesh.world`` the mesh size, and the
collectives of ``parallel/collectives.py`` take the place of JAX's.

``make_mesh`` uses the process group the caller initialized (``torchrun``
sets one up from its environment; tests and the CLI may initialize one
themselves).  With none initialized it makes a one-rank group on a
``file://`` store, so the sharded path runs at world size 1 with no
launcher.  The backend is NCCL for the card and gloo for the CPU.
"""

from __future__ import annotations

import os
import tempfile
from dataclasses import dataclass
from datetime import timedelta

import torch
import torch.distributed as dist

from nbody_tpu_torch.core.state import resolve_device

PARTICLE_AXIS = "p"

#: how long a collective waits for the other ranks before it raises
GROUP_TIMEOUT = timedelta(seconds=120)


@dataclass(frozen=True)
class Mesh:
    """This process's place on the particle mesh: its rank, the world
    size, the process group (None: the default group) and the device its
    shard lives on."""

    rank: int
    world: int
    group: object
    device: torch.device

    @property
    def shape(self) -> dict:
        """``{PARTICLE_AXIS: world}``, as a JAX mesh's ``shape``."""
        return {PARTICLE_AXIS: self.world}


def backend_for(device) -> str:
    """The collective backend for tensors on ``device``."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def _launch_hint(n: int) -> str:
    return (f"launch {n} ranks with torchrun --nproc-per-node {n} (or call "
            "torch.distributed.init_process_group with world_size="
            f"{n} first)")


def init_one_rank(device) -> None:
    """A one-rank default process group on a ``file://`` store in a fresh
    temporary directory (no TCP port)."""
    store = os.path.join(tempfile.mkdtemp(prefix="nbody_pg_"), "store")
    dist.init_process_group(backend_for(device), init_method=f"file://{store}",
                            rank=0, world_size=1, timeout=GROUP_TIMEOUT)


def make_mesh(n_devices: int | None = None, device="cuda") -> Mesh:
    """The mesh of the initialized process group, whose world size
    ``n_devices`` must equal (``None``: whatever it is).  Without a group,
    ``n_devices`` of 1 or None makes a one-rank group; any other count
    raises, naming the launcher.  On the card each rank takes
    ``cuda:{local rank}`` (``LOCAL_RANK``, else the rank modulo the cards
    it sees)."""
    device = resolve_device(device)
    if dist.is_initialized():
        world, rank = dist.get_world_size(), dist.get_rank()
        if n_devices not in (None, world):
            raise ValueError(
                f"n_devices={n_devices} but the process group has world size "
                f"{world}; {_launch_hint(n_devices)}")
    else:
        if n_devices not in (None, 1):
            raise ValueError(
                f"n_devices={n_devices} needs a process group of world size "
                f"{n_devices}, and none is initialized; "
                f"{_launch_hint(n_devices)}")
        init_one_rank(device)
        world, rank = 1, 0
    if device.type == "cuda":
        local = int(os.environ.get("LOCAL_RANK",
                                   rank % torch.cuda.device_count()))
        device = torch.device("cuda", local)
    return Mesh(rank=rank, world=world, group=None, device=device)
