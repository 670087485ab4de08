"""nbody_tpu_torch — the PyTorch / CUDA port of ``nbody_tpu``.

Softened Newtonian gravity integrated with a drift-kick-drift leapfrog inside
an open box, on fixed-capacity tensors with an alive mask.  Ported: scenes,
state, integrators, the stepper and its compensated (TwoSum) variant, the
exact and tree-estimated energy, conserved-quantity diagnostics and the
trajectory recorder, the float64 C++ oracle's bindings, the profiler
surface, the ``brute`` and ``brute-pallas*`` engines, whose all-pairs sums
run in hand-written CUDA kernels for Hopper (``csrc/pairwise.cu``; the
norm-trick ``brute-pallas-mxu`` in ``csrc/pairwise_mxu.cu``), and the
Barnes-Hut engines ``bh`` / ``bh-deep`` (Morton octree, vectorized group
walk; their group and quadrupole sums run in ``csrc/group_force.cu``, each
group's own square with ``near_sym`` in ``csrc/pairwise.cu``), their
stateful variants (walk reuse with ``walk_every``, the lazy-rebuild
``bh-lazy``) and 2D quadtree states, the visualizer server with its
octree boxes (``vis/``), and the sharded path over ``torch.distributed``
(``parallel/``: ``ShardedSimulation``, one rank a process).  Tensors go to the card unless the caller asks
for the CPU; there the same engines run plain torch.  The JAX package
``nbody_tpu`` stays beside it as the reference the port is tested against;
this package never imports jax.
"""

from nbody_tpu_torch.core.state import ParticleState, SimParams, Bounds
from nbody_tpu_torch.core.integrators import (get_integrator, LEAPFROG, EULER,
                                              INTEGRATORS)
from nbody_tpu_torch.core.stepper import make_step, make_run
from nbody_tpu_torch.core.energy import (total_energy, kinetic_energy,
                                         potential_energy)
from nbody_tpu_torch.api import Simulation
from nbody_tpu_torch.engines import get_engine, ENGINES

__version__ = "0.1.0"

__all__ = [
    "ParticleState",
    "SimParams",
    "Bounds",
    "Simulation",
    "make_step",
    "make_run",
    "get_engine",
    "get_integrator",
    "ENGINES",
    "INTEGRATORS",
    "LEAPFROG",
    "EULER",
    "total_energy",
    "kinetic_energy",
    "potential_energy",
    "__version__",
]
