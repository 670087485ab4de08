"""Shared inputs of the port's ``near_sym`` tests
(tests/test_torch_near_sym.py, tests/test_torch_near_sym_paths.py): the
configurations of tests/test_near_sym.py, its seeded disc handed to both
packages, and the two packages' ``bh_accel`` on it."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import torch

from nbody_tpu.core.state import ParticleState as JaxState
from nbody_tpu.core.state import SimParams as JaxParams
from nbody_tpu.ops import traversal as jt
from nbody_tpu.scenes import self_gravitating_disc
from nbody_tpu_torch.core.state import Bounds
from nbody_tpu_torch.ops import traversal as tt

STATS = ("accept_dropped", "frontier_fallback", "near_fallback", "fb_spill",
         "dual_tiles")

# tests/test_near_sym.py:22-24
SYM_CFG = dict(group_size=512, subgroups=8, window_pad=128, eval_tile=256,
               near_particle_cap=1024, near_cell_cap=512, frontier_cap=2048,
               accept_cap=2048, chunk_groups=2, max_level=6)
# tests/test_near_sym.py:127-130: one group, n_tot == group_size
SINGLE_CFG = dict(group_size=512, subgroups=8, window_pad=128, eval_tile=256,
                  near_particle_cap=512, near_cell_cap=256, frontier_cap=1024,
                  accept_cap=1024, chunk_groups=1, max_level=5)
# small groups under a wide window: block-dual accepts 150 tile pairs of
# the near_sym slab here, none with SYM_CFG's
DUAL_CFG = dict(SYM_CFG, group_size=128, subgroups=8, window_pad=1024,
                eval_tile=128)


def disc_inputs(dtype, n=8000, capacity=8192, kill=0):
    """tests/test_near_sym.py's disc (seed 11), particles 2..2+kill dead,
    as numpy arrays of ``dtype``."""
    pos, vel, mass = self_gravitating_disc(n, seed=11)
    jd = getattr(jnp, dtype)
    st = JaxState.create(pos, vel, mass, capacity=capacity, dtype=jd)
    if kill:
        st = dataclasses.replace(st, alive=st.alive.at[2:2 + kill].set(False))
    return np.array(st.pos), np.array(st.effective_mass())


def jax_bh(dtype, cfg, g_soft=0.02, **inputs):
    pos, mass = disc_inputs(dtype, **inputs)
    jd = getattr(jnp, dtype)
    p = JaxParams.create(g_soft=g_soft, theta2=1.0, bounds_width=10.0,
                         dtype=jd)
    acc, stats = jt.bh_accel(jnp.asarray(pos), jnp.asarray(mass), p.bounds,
                             p.theta2, p.g, p.g_soft,
                             jt.BHConfig(eval_mode="xla", mxu_blocks=False,
                                         **cfg))
    return np.asarray(acc), {k: int(stats[k]) for k in STATS}, mass


def port_bh(dtype, cfg, g_soft=0.02, **inputs):
    pos, mass = disc_inputs(dtype, **inputs)
    td = getattr(torch, dtype)
    acc, stats = tt.bh_accel(
        torch.from_numpy(pos), torch.from_numpy(mass),
        Bounds.cube([0.0, 0.0, 0.0], 10.0, dtype=td, device="cpu"), 1.0, 1.0,
        float(torch.tensor(g_soft, dtype=td)),
        tt.BHConfig(mxu_blocks=False, **cfg))
    return acc.numpy(), {k: int(stats[k]) for k in STATS}, mass


def row_rel(a, b, m):
    """Per alive row |a - b| / |b| (tests/test_near_sym.py:39)."""
    alive = m > 0
    bn = np.linalg.norm(b, axis=1)
    return (np.linalg.norm(a - b, axis=1)[alive]
            / np.maximum(bn[alive], 1e-30))
