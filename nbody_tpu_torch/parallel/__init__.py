"""The sharded path over ``torch.distributed`` (the counterpart of
``nbody_tpu/parallel``): one rank a process, each holding its contiguous
shard of the particles."""

from nbody_tpu_torch.parallel.mesh import make_mesh
from nbody_tpu_torch.parallel.sharded import (ShardedSimulation,
                                              make_sharded_step)

__all__ = ["make_mesh", "ShardedSimulation", "make_sharded_step"]
