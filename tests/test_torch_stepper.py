"""``make_step`` / ``make_run`` of the port against the JAX package's, with
particles crossing the box faces so the open-boundary cull acts."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nbody_tpu.core.state import ParticleState as JaxState
from nbody_tpu.core.state import SimParams as JaxParams
from nbody_tpu.core.stepper import make_run as jax_make_run
from nbody_tpu.engines.brute_force import force_tiled as jax_force
from nbody_tpu_torch.core.state import ParticleState, SimParams
from nbody_tpu_torch.core.stepper import make_run, make_step
from nbody_tpu_torch.engines.brute_force import force_tiled

WIDTH = 6.0


def _scene(n=256, seed=0):
    """A hot cube inside a box of width 6: a share of the particles leaves
    through the faces within a few steps."""
    rng = np.random.default_rng(seed)
    pos = rng.uniform(-2.5, 2.5, (n, 3))
    vel = rng.normal(size=(n, 3)) * 1.5
    mass = rng.uniform(0.5, 1.5, n) / n
    return pos, vel, mass


@pytest.mark.parametrize("integrator", ["leapfrog", "euler"])
def test_make_run_matches_jax_across_box_faces(integrator):
    pos, vel, mass = _scene()
    kw = dict(dt=0.05, g_soft=0.05, bounds_width=WIDTH)
    js = JaxState.create(pos, vel, mass, dtype=jnp.float32)
    ref = jax_make_run(jax_force, integrator)(
        js, JaxParams.create(dtype=jnp.float32, **kw), 10)
    got = make_run(force_tiled, integrator)(
        ParticleState.create(pos, vel, mass, device="cpu"),
        SimParams.create(**kw, device="cpu"), 10)
    alive = np.asarray(ref.alive)
    assert 0 < alive.sum() < len(pos)  # the cull acted
    # the cull is a comparison: it must decide identically
    np.testing.assert_array_equal(got.alive.numpy(), alive)
    # pos/vel carry f32 force roundoff of two libraries through 10 steps:
    # 1e-5 of the box width is ~100x that and far below any face decision
    for k in ("pos", "vel", "acc"):
        diff = np.abs(getattr(got, k).numpy() - np.asarray(getattr(ref, k)))
        assert diff.max() < 1e-5 * WIDTH, k
    assert float(got.time) == float(ref.time)


def test_dead_particles_frozen_with_zero_acceleration():
    pos, vel, mass = _scene(seed=1)
    step = make_step(force_tiled)
    params = SimParams.create(dt=0.05, g_soft=0.05, bounds_width=WIDTH,
                              device="cpu")
    st = ParticleState.create(pos, vel, mass, device="cpu")
    for _ in range(8):
        new = step(st, params)
        dead = ~new.alive
        assert not bool((new.alive & ~st.alive).any())  # nobody revives
        assert bool((new.acc[dead] == 0).all())
        was_dead = ~st.alive
        assert torch.equal(new.pos[was_dead], st.pos[was_dead])
        assert torch.equal(new.vel[was_dead], st.vel[was_dead])
        st = new
    assert int((~st.alive[:len(pos)]).sum()) > 0


def test_run_equals_repeated_steps():
    pos, vel, mass = _scene(64, seed=2)
    params = SimParams.create(dt=0.05, g_soft=0.05, bounds_width=WIDTH,
                              device="cpu")
    st = ParticleState.create(pos, vel, mass, device="cpu")
    a = make_run(force_tiled)(st, params, 4)
    b = st
    for _ in range(4):
        b = make_step(force_tiled)(b, params)
    for k in ("pos", "vel", "acc", "alive", "time"):
        assert torch.equal(getattr(a, k), getattr(b, k)), k
