"""Shared inputs for the port's parity tests (tests/test_torch_*.py): the same
numpy data, made from a seed, handed to the JAX package and to the port.

``tests/conftest.py`` turns on ``jax_enable_x64`` for the whole suite, so the
JAX side is given float32 explicitly; otherwise its reference would run in
float64 while the port runs in float32."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nbody_tpu.core.state import ParticleState as JaxState
from nbody_tpu.core.state import SimParams as JaxParams
from nbody_tpu.scenes import self_gravitating_disc

G, EPS = 1.0, 0.02

# The matmul formulation of the brute engines (S@P - p_i*S@1) cancels
# ~|p_i|/separation digits: on the disc at eps 0.02 that amplifies f32
# roundoff ~1e3-fold, and two libraries' summation orders then differ by up
# to ~6e-4 in the worst row (each ~1e-4 from a float64 truth).  Bugs this
# guards (a missing recentre, a wrong softening) show as 5e-3 and more.
MATMUL_TOL = 1e-3


#: the port's ``BHConfig`` fields that the JAX package has not (ROADMAP
#: "Deliberate divergences"), with the value each takes in every
#: configuration held to the JAX package's
PORT_ONLY = {"accept_offset": False}


def jax_fields(cfg) -> dict:
    """The port's ``BHConfig`` (or its ``dataclasses.asdict``) as the JAX
    package's dict of fields: its own fields taken off, each asserted at
    its ``PORT_ONLY`` value."""
    d = dict(cfg) if isinstance(cfg, dict) else dataclasses.asdict(cfg)
    for k, v in PORT_ONLY.items():
        assert d.pop(k) == v, k
    return d


def disc(n, capacity, kill=0, g_soft=EPS):
    """The disc at ``capacity`` with particles 1..kill dead (zero effective
    mass, left where they are).  Returns (jax_state, jax_params, pos, mass,
    alive), the last three as float32 torch tensors of the same bits."""
    p, v, m = self_gravitating_disc(n, seed=7)
    state = JaxState.create(p, v, m, capacity=capacity, dtype=jnp.float32)
    if kill:
        state = dataclasses.replace(
            state, alive=state.alive.at[1:1 + kill].set(False))
    params = JaxParams.create(dt=3e-2, g_soft=g_soft, theta2=1.0,
                              bounds_width=10.0, dtype=jnp.float32)
    pos = torch.from_numpy(np.array(state.pos))
    mass = torch.from_numpy(np.array(state.effective_mass()))
    alive = torch.from_numpy(np.array(state.alive))
    return state, params, pos, mass, alive


def rel_err(got, ref) -> float:
    """max-row |got - ref| over the mean row |ref| (the metric of
    tests/test_pallas_kernels.py)."""
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    scale = np.linalg.norm(ref, axis=1).mean()
    return float(np.linalg.norm(got - ref, axis=1).max() / scale)


@pytest.fixture(autouse=True, scope="module")
def one_intra_op_thread():
    """One intra-op thread for a module of long eager loops of small ops:
    with the suite's parallel workers each pulling the whole thread pool
    into every op, such a module runs tens of times slower than alone.
    Import it into the module to apply it; the count is restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
