"""Energy diagnostics: kinetic + Plummer-softened pair potential (the
counterpart of ``nbody_tpu/core/energy.py``).  The potential's gradient is
exactly the force law the engines compute:

    U = -G * sum_{i<j} m_i m_j / sqrt(|r_ij|^2 + eps^2)

Dead particles (zero effective mass) contribute nothing.  The pair sum is
row-tiled so memory stays O(tile * N) at any N.  Above a capacity of 262144
``method='auto'`` takes the tree estimator (``potential_energy_bh``): the
Barnes-Hut walk with a potential accumulator, O(N log N).
"""

from __future__ import annotations

import torch

from nbody_tpu_torch.core.state import ParticleState, SimParams

# exact pair PE above this capacity costs more than a sim step
_BH_ENERGY_THRESHOLD = 1 << 18


def kinetic_energy(state: ParticleState) -> torch.Tensor:
    m = state.effective_mass()
    v2 = (state.vel * state.vel).sum(dim=-1)
    return 0.5 * (m * v2).sum()


def _pe_row_tile(pos_tile, m_tile, row_ids, pos, mass, g, eps2):
    """Potential energy of one row tile against all particles, counting each
    unordered pair once via a strict upper-triangle mask."""
    col_ids = torch.arange(pos.shape[0], device=pos.device)
    d = pos_tile[:, None, :] - pos[None, :, :]  # [T, N, D]
    r2 = (d * d).sum(dim=-1) + eps2  # [T, N]
    # count each unordered pair once; skip exactly-coincident pairs at eps=0
    take = (col_ids[None, :] > row_ids[:, None]) & (r2 > 0.0)
    inv_r = torch.rsqrt(torch.where(take, r2, 1.0))
    pair_m = m_tile[:, None] * mass[None, :]
    return -g * torch.where(take, pair_m * inv_r, 0.0).sum()


def potential_energy(state: ParticleState, params: SimParams,
                     tile: int = 512) -> torch.Tensor:
    pos = state.pos
    mass = state.effective_mass()
    ids = torch.arange(pos.shape[0], device=pos.device)
    partials = [
        _pe_row_tile(pos[s:s + tile], mass[s:s + tile], ids[s:s + tile],
                     pos, mass, params.g, params.eps2)
        for s in range(0, pos.shape[0], tile)
    ]
    return torch.stack(partials).sum()


def potential_energy_bh(state: ParticleState, params: SimParams,
                        theta2=None, cfg=None) -> torch.Tensor:
    """Tree-approximated potential energy, O(N log N) where the exact pair
    pass is O(N^2) (``ops/traversal.py`` ``bh_potential``).

    Window and near pairs are exact; accepted nodes contribute
    self-excluded monopoles.  Its bias against the exact pair PE (~1e-4
    relative at 8k, θ² = 1, in the JAX package's tests) is of the size of
    the f32 drift of the flagship runs and depends on the walk's accept
    set, so it does not cancel between two calls: good for one-shot energy
    magnitudes, not for drift (see ``resolve_energy_method``).  ``theta2``
    defaults to the run's own opening angle; pass a smaller one for a
    tighter estimate."""
    # imported here: the walk's modules import the engine registry, whose
    # package imports this one
    from nbody_tpu_torch.ops.traversal import BHConfig, bh_potential

    if cfg is None:
        # a generous fallback budget: spilled rows degrade to plain
        # (self-including) monopoles, the one uncontrolled term
        cfg = BHConfig.auto_for(state.capacity, multipole="mono",
                                fb_cap=2048)
    t2 = params.theta2 if theta2 is None else theta2
    u, _stats = bh_potential(state.pos, state.effective_mass(),
                             params.bounds, t2, params.g, params.g_soft, cfg)
    return u


def resolve_energy_method(capacity: int, method: str = "auto") -> str:
    """What 'auto' picks: exact up to a capacity of 262144, the tree
    estimator above (as in the JAX package).

    Caveat for drift measurements: the tree estimator's ~1e-4 relative bias
    depends on the configuration (the walk's accept set changes as the
    particles move), so it does not fully cancel between two evaluations:
    drift readings below ~1e-4 from method='bh' can be estimator artifact.
    Use method='exact' to measure drift; 'bh' is for one-shot energy
    magnitudes at N where the O(N^2) pass is prohibitive."""
    if method == "auto":
        return "bh" if capacity > _BH_ENERGY_THRESHOLD else "exact"
    if method not in ("exact", "bh"):
        raise ValueError(f"unknown energy method {method!r}")
    return method


def total_energy(state: ParticleState, params: SimParams, tile: int = 512,
                 method: str = "auto") -> torch.Tensor:
    """method: 'exact' (O(N^2) pair PE), 'bh' (the tree estimator) or
    'auto' (``resolve_energy_method``, with its drift caveat)."""
    if resolve_energy_method(state.capacity, method) == "bh":
        pe = potential_energy_bh(state, params)
    else:
        pe = potential_energy(state, params, tile=tile)
    return kinetic_energy(state) + pe
