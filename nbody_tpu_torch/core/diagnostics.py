"""Conserved-quantity diagnostics beyond energy: momentum, angular momentum,
centre of mass, and a trajectory recorder (the counterpart of
``nbody_tpu/core/diagnostics.py``).

Leapfrog conserves momentum exactly in exact arithmetic, and angular
momentum up to the softened force's central symmetry; on f32 state both
move by rounding only.  Dead particles (zero effective mass) count for
nothing.
"""

from __future__ import annotations

from typing import Callable

import torch

from nbody_tpu_torch.core.energy import kinetic_energy, potential_energy
from nbody_tpu_torch.core.state import ParticleState, SimParams
from nbody_tpu_torch.core.stepper import make_step


def momentum(state: ParticleState) -> torch.Tensor:
    m = state.effective_mass()
    return (state.vel * m[:, None]).sum(dim=0)


def angular_momentum(state: ParticleState) -> torch.Tensor:
    """L = sum m (r x v) about the origin (3D states)."""
    m = state.effective_mass()
    return (torch.linalg.cross(state.pos, state.vel, dim=-1)
            * m[:, None]).sum(dim=0)


def center_of_mass(state: ParticleState) -> torch.Tensor:
    m = state.effective_mass()
    # dtype-aware guard: a float64 literal like 1e-300 underflows to 0 in f32
    tiny = torch.finfo(m.dtype).tiny
    return ((state.pos * m[:, None]).sum(dim=0)
            / torch.clamp(m.sum(), min=tiny))


def diagnostics(state: ParticleState, params: SimParams) -> dict:
    """Energies (exact pair potential), momentum, angular momentum, centre
    of mass, alive count and time, as tensors on the state's device."""
    ke = kinetic_energy(state)
    pe = potential_energy(state, params)
    return {
        "kinetic": ke,
        "potential": pe,
        "energy": ke + pe,
        "momentum": momentum(state),
        "angular_momentum": angular_momentum(state),
        "com": center_of_mass(state),
        "n_alive": state.n_alive(),
        "time": state.time,
    }


def make_recorder(force_fn: Callable, integrator="leapfrog", every: int = 1,
                  with_energy: bool = False) -> Callable:
    """Build ``record(state, params, n_steps) -> (final_state, trajectory)``:
    ``n_steps`` steps enqueued back to back with a snapshot every ``every``
    steps, and no host round-trip.  Trajectory entries (pos, vel, time,
    n_alive, and kinetic and potential with ``with_energy``) are stacked
    along a leading axis of ``n_steps // every``, as the JAX package's
    ``lax.scan`` stacks them."""
    step = make_step(force_fn, integrator)

    def snapshot(state, params):
        snap = {"pos": state.pos, "vel": state.vel, "time": state.time,
                "n_alive": state.n_alive()}
        if with_energy:
            snap["kinetic"] = kinetic_energy(state)
            snap["potential"] = potential_energy(state, params)
        return snap

    def record(state: ParticleState, params: SimParams, n_steps: int):
        if n_steps % every:
            raise ValueError(f"n_steps {n_steps} is not a multiple of "
                             f"every = {every}")
        snaps = []
        for _ in range(n_steps // every):
            for _ in range(every):
                state = step(state, params)
            snaps.append(snapshot(state, params))
        if not snaps:  # no steps: empty stacks, as the scan's
            return state, {k: v[None][:0]
                           for k, v in snapshot(state, params).items()}
        return state, {k: torch.stack([s[k] for s in snaps])
                       for k in snaps[0]}

    return record
