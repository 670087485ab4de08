"""Energy diagnostics of the port against the JAX package's."""

import dataclasses

import numpy as np
import pytest
import torch

from nbody_tpu.core import energy as jenergy
from nbody_tpu_torch.core import energy
from nbody_tpu_torch.core.state import ParticleState, SimParams
from torch_parity import disc


def _port_state(jstate):
    return ParticleState(**{
        f.name: torch.from_numpy(np.array(getattr(jstate, f.name)))
        for f in dataclasses.fields(ParticleState)})


@pytest.mark.parametrize("kill", [0, 37])
@pytest.mark.parametrize("g_soft", [0.0, 0.02])
def test_energy_matches_jax(kill, g_soft):
    jstate, jparams, *_ = disc(700, 768, kill, g_soft=g_soft)
    st = _port_state(jstate)
    params = SimParams.create(dt=3e-2, g_soft=g_soft)
    ke = float(energy.kinetic_energy(st))
    pe = float(energy.potential_energy(st, params, tile=256))
    assert ke == pytest.approx(float(jenergy.kinetic_energy(jstate)), rel=1e-6)
    assert pe == pytest.approx(
        float(jenergy.potential_energy(jstate, jparams)), rel=1e-5)
    assert float(energy.total_energy(st, params)) == pytest.approx(
        ke + pe, rel=1e-6)


def test_energy_method_resolution():
    """'auto' takes the exact pair PE up to a capacity of 262144 and the
    tree estimator above; unknown methods raise."""
    assert energy.resolve_energy_method((1 << 18) + 128) == "bh"
    assert energy.resolve_energy_method(1 << 18) == "exact"
    assert energy.resolve_energy_method(128, "bh") == "bh"
    assert energy.resolve_energy_method(1 << 20, "exact") == "exact"
    with pytest.raises(ValueError):
        energy.resolve_energy_method(128, "tree")
