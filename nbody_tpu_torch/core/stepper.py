"""The simulation step: integrator + open-boundary cull + force engine (the
counterpart of ``make_step`` / ``make_run`` in ``nbody_tpu/core/stepper.py``).

The step_by sequence is the reference's and is load-bearing for parity:

    1. integrator pre-force (leapfrog half drift)
    2. cull particles outside the domain box (mask clearing)
    3. update forces (engine-specific)
    4. integrator after-force (kick + half drift); time += dt

Dead particles are frozen: position and velocity stop updating, their
acceleration is zeroed and their effective mass is zero.

``make_run`` stands in for the JAX package's ``lax.scan``: a Python loop of
eager steps.  Nothing in a step reads a device value on the host, so the
loop only enqueues work and never waits for the card.

``make_step_comp`` / ``make_run_comp`` are the compensated (double-float)
variants: a second word per position and velocity component carries what
f32 addition drops.  ``make_step_stateful`` / ``make_run_stateful`` thread
a stateful engine's carry (``bh-lazy``, ``bh`` with ``walk_every > 1``):
those engines read one value back to the host a step (the moved fraction
that decides a rebuild or a full walk, ``ops/traversal.py`` ``HOST_READS``);
every other engine's step reads none.

Each step is a span of the span recorder (``utils/profiling.py``):
``step`` > ``drift`` (the half drift, the cull, the effective masses),
``force`` (the engine's call, whose phases the Barnes-Hut path marks) and
``kick`` (the kick and the last half drift).  With the recorder off, as by
default, each costs a flag test.
"""

from __future__ import annotations

from typing import Callable

import torch

from nbody_tpu_torch.core.integrators import Integrator, get_integrator
from nbody_tpu_torch.core.state import ParticleState, SimParams
from nbody_tpu_torch.utils.profiling import annotate


def _carry_step(force_carry: Callable, integrator) -> Callable:
    """``step(state, carry, params, dt=None) -> (state, carry)`` around
    ``force_carry(pos, mass_eff, params, carry) -> (acc, carry)``: the
    step_by sequence shared by the plain and the stateful steppers."""
    integ: Integrator = get_integrator(integrator)

    def step(state: ParticleState, carry, params: SimParams, dt=None):
        with annotate("step", state.pos.device):
            return _step(state, carry, params, dt)

    def _step(state: ParticleState, carry, params: SimParams, dt):
        dt = params.dt if dt is None else float(dt)
        alive_col = state.alive[:, None]

        with annotate("drift"):
            # 1. half drift (only alive particles move)
            pos = torch.where(alive_col,
                              integ.pre_force(state.pos, state.vel, dt),
                              state.pos)

            # 2. open boundary: particles outside the box die
            alive = state.alive & params.bounds.contains(pos)
            alive_col = alive[:, None]
            mass_eff = torch.where(alive, state.mass,
                                   torch.zeros_like(state.mass))

        # 3. forces
        with annotate("force"):
            acc, carry = force_carry(pos, mass_eff, params, carry)

        # 4. kick + half drift
        with annotate("kick"):
            acc = torch.where(alive_col, acc, torch.zeros_like(acc))
            new_pos, new_vel = integ.after_force(pos, state.vel, acc, dt)
            return ParticleState(
                pos=torch.where(alive_col, new_pos, pos),
                vel=torch.where(alive_col, new_vel, state.vel),
                acc=acc,
                mass=state.mass,
                alive=alive,
                time=state.time + dt,
            ), carry

    return step


def make_step(force_fn: Callable, integrator="leapfrog") -> Callable:
    """Build ``step(state, params, dt=None) -> state``.

    ``dt`` defaults to ``params.dt``; pass an explicit (possibly negative)
    host float for ``step_by`` / rewind semantics."""
    step_c = _carry_step(lambda pos, m, p, c: (force_fn(pos, m, p), c),
                         integrator)

    def step(state: ParticleState, params: SimParams, dt=None) -> ParticleState:
        return step_c(state, None, params, dt)[0]

    return step


def make_step_stateful(engine, integrator="leapfrog") -> Callable:
    """``make_step`` for an engine that carries a cache between steps:
    ``step(state, carry, params, dt=None) -> (state, carry)``
    (``nbody_tpu/core/stepper.py:204``)."""
    return _carry_step(engine.force_carry, integrator)


def make_run_stateful(engine, integrator="leapfrog") -> Callable:
    """``run(state, carry, params, n_steps, dt=None) -> (state, carry)``:
    ``n_steps`` stateful steps back to back."""
    step = make_step_stateful(engine, integrator)

    def run(state: ParticleState, carry, params: SimParams, n_steps: int,
            dt=None):
        for _ in range(n_steps):
            state, carry = step(state, carry, params, dt)
        return state, carry

    return run


def make_run(force_fn: Callable, integrator="leapfrog") -> Callable:
    """Build ``run(state, params, n_steps, dt=None) -> state``: ``n_steps``
    steps enqueued back to back with no host round-trip."""
    step = make_step(force_fn, integrator)

    def run(state: ParticleState, params: SimParams, n_steps: int, dt=None):
        for _ in range(n_steps):
            state = step(state, params, dt)
        return state

    return run


# ---------------------------------------------------------------------------
# Compensated (double-float) stepping.
#
# The f32 energy drift at the benchmark dt is the integrator's state update
# losing the low bits of vel*dt against pos every step, not force error.
# A second f32 "low word" per component, accumulated with an error-free
# TwoSum, keeps them.  The force still sees the high word only: its own
# error floor is far above the 2^-24 the low word carries.
#
# Every operation below must round on its own: eager torch runs each as its
# own kernel, which is what the TwoSum needs.  Neither torch.compile this
# nor fuse the drift product into the add that follows: a fused
# multiply-add there breaks the error-free property.
# ---------------------------------------------------------------------------


def two_sum_add(hi, lo, d):
    """Add ``d`` to the double-float value (hi, lo): branch-free TwoSum and
    renormalisation, in the JAX package's operation order.  Exact:
    hi' + lo' == fl(hi + lo + d) to ~2^-48 relative."""
    s = hi + d
    bb = s - hi
    err = (hi - (s - bb)) + (d - bb)
    lo = lo + err
    hi2 = s + lo
    return hi2, lo - (hi2 - s)


def init_comp(state: ParticleState):
    """Zero low words for (pos, vel): the compensated step's side carry."""
    return (torch.zeros_like(state.pos), torch.zeros_like(state.vel))


def make_step_comp(force_fn: Callable, integrator="leapfrog") -> Callable:
    """Compensated variant of ``make_step``: ``step(state, lo, params,
    dt=None) -> (state, lo)`` with ``lo = (pos_lo, vel_lo)`` (``init_comp``).

    The same sequence (drift, cull, force, kick, drift) with every position
    and velocity accumulation through ``two_sum_add``.  Dead particles
    freeze both words.  The drift increment includes the velocity's low
    word, ``(vel + vel_lo) * (dt * frac)``, rounded on its own, so the
    kick's compensation reaches the positions.  The cull and the force see
    the high word only."""
    integ: Integrator = get_integrator(integrator)
    pre_f, post_f = integ.pre_drift_frac, integ.post_drift_frac

    def drift(pos, pos_lo, vel, vel_lo, dt, frac, alive_col):
        d = (vel + vel_lo) * (dt * frac)
        p2, pl2 = two_sum_add(pos, pos_lo, d)
        return (torch.where(alive_col, p2, pos),
                torch.where(alive_col, pl2, pos_lo))

    def step(state: ParticleState, lo, params: SimParams, dt=None):
        with annotate("step", state.pos.device):
            return _step(state, lo, params, dt)

    def _step(state: ParticleState, lo, params: SimParams, dt):
        dt = params.dt if dt is None else float(dt)
        pos_lo, vel_lo = lo
        pos, vel = state.pos, state.vel

        with annotate("drift"):
            # 1. pre drift (compensated)
            if pre_f:
                pos, pos_lo = drift(pos, pos_lo, vel, vel_lo, dt, pre_f,
                                    state.alive[:, None])

            # 2. open boundary cull on the high word (the low word is
            #    ~2^-24 relative, far below the box-face quantum)
            alive = state.alive & params.bounds.contains(pos)
            alive_col = alive[:, None]
            mass_eff = torch.where(alive, state.mass,
                                   torch.zeros_like(state.mass))

        # 3. forces (high word only)
        with annotate("force"):
            acc = force_fn(pos, mass_eff, params)

        # 4. kick + post drift (compensated)
        with annotate("kick"):
            acc = torch.where(alive_col, acc, torch.zeros_like(acc))
            v2, vl2 = two_sum_add(vel, vel_lo, acc * dt)
            vel = torch.where(alive_col, v2, vel)
            vel_lo = torch.where(alive_col, vl2, vel_lo)
            if post_f:
                pos, pos_lo = drift(pos, pos_lo, vel, vel_lo, dt, post_f,
                                    alive_col)
        new_state = ParticleState(pos=pos, vel=vel, acc=acc, mass=state.mass,
                                  alive=alive, time=state.time + dt)
        return new_state, (pos_lo, vel_lo)

    return step


def make_run_comp(force_fn: Callable, integrator="leapfrog") -> Callable:
    """``run(state, lo, params, n_steps, dt=None) -> (state, lo)``: the
    compensated ``make_run``, enqueued with no host round-trip."""
    step = make_step_comp(force_fn, integrator)

    def run(state: ParticleState, lo, params: SimParams, n_steps: int,
            dt=None):
        for _ in range(n_steps):
            state, lo = step(state, lo, params, dt)
        return state, lo

    return run
