"""The port's Barnes-Hut potential estimator (``bh_potential``,
``potential_energy_bh``, ``total_energy(method="bh")``) against the JAX
package's, on the same seeded numpy inputs.

Tolerances: U to 1e-10 relative at float64 and 1e-5 at float32 (the same
walk, the same pair set; only the summation order of the tiles and of the
final ½ Σ m φ differs); the walk's four counters exactly."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nbody_tpu.core import energy as jenergy
from nbody_tpu.core.state import ParticleState as JState
from nbody_tpu.core.state import SimParams as JParams
from nbody_tpu.ops import traversal as jtrav
from nbody_tpu_torch import Simulation
from nbody_tpu_torch.core import energy
from nbody_tpu_torch.core.state import ParticleState, SimParams
from nbody_tpu_torch.ops import traversal
from nbody_tpu_torch.scenes import self_gravitating_disc
from torch_parity import one_intra_op_thread  # noqa: F401  (autouse)

COUNTERS = ("accept_dropped", "frontier_fallback", "near_fallback",
            "fb_spill")
REL = {"f64": 1e-10, "f32": 1e-5}
# walk budgets small enough that all four counters fire on the 2047 disc
STARVED = dict(group_size=256, subgroups=64, window_pad=128,
               near_particle_cap=32, near_cell_cap=8, fb_cap=16,
               frontier_schedule=(128, 256, 256, 256), accept_cap=64)


def _pair(n, seed, dt, shift=(0.0, 0.0, 0.0), dead=0):
    """(jax state, jax params, port state, port params) of the disc at n +
    the star, translated by ``shift``, with particles [0, dead) dead."""
    jdt, tdt = ((jnp.float64, torch.float64) if dt == "f64"
                else (jnp.float32, torch.float32))
    pos, vel, mass = self_gravitating_disc(n, seed=seed)
    js = JState.create(pos + np.asarray(shift), vel, mass, dtype=jdt)
    if dead:
        js = dataclasses.replace(js, alive=js.alive.at[:dead].set(False))
    kw = dict(g_soft=0.02, theta2=1.0, bounds_width=10.0,
              bounds_center=tuple(shift))
    st = ParticleState(**{
        f.name: torch.from_numpy(np.array(getattr(js, f.name)))
        for f in dataclasses.fields(ParticleState)})
    return (js, JParams.create(dtype=jdt, **kw), st,
            SimParams.create(dtype=tdt, **kw, device="cpu"))


def _both(js, jp, st, pr, cfg_kw):
    """U and the four counters of both packages' bh_potential."""
    cap = st.capacity
    ju, jstats = jtrav.bh_potential(
        js.pos, js.effective_mass(), jp.bounds, jp.theta2, jp.g, jp.g_soft,
        jtrav.BHConfig.auto_for(cap, multipole="mono", **cfg_kw))
    tu, tstats = traversal.bh_potential(
        st.pos, st.effective_mass(), pr.bounds, pr.theta2, pr.g, pr.g_soft,
        traversal.BHConfig.auto_for(cap, multipole="mono", **cfg_kw))
    return (float(ju), {k: int(jstats[k]) for k in COUNTERS}, float(tu),
            {k: int(tstats[k]) for k in COUNTERS})


@pytest.mark.parametrize("dt", ["f64", "f32"])
def test_bh_potential_matches_jax_disc(dt):
    """The 8191 disc at θ² = 1 with the estimator's default budgets."""
    ju, jc, tu, tc = _both(*_pair(8191, 0, dt), dict(fb_cap=2048))
    assert tu == pytest.approx(ju, rel=REL[dt])
    assert tc == jc


@pytest.mark.parametrize("dt", ["f64", "f32"])
def test_bh_potential_matches_jax_translated_dead(dt):
    """tests/test_energy.py's scene: the 2047 disc far from the origin
    (grid-frame recentring) with a band of 200 dead particles."""
    args = _pair(2047, 1, dt, shift=(2048.0, -4096.0, 1024.0), dead=200)
    ju, jc, tu, tc = _both(*args, dict(fb_cap=2048))
    assert tu == pytest.approx(ju, rel=REL[dt])
    assert tc == jc
    # the energy-level wrapper is the same call
    _, _, st, pr = args
    assert float(energy.potential_energy_bh(st, pr)) == tu


def test_bh_potential_matches_jax_starved_budgets():
    """Budgets so small that nodes are dropped, the frontier and the near
    field fall back and the fallback slab spills: the counters still equal
    JAX's, and so does U."""
    ju, jc, tu, tc = _both(*_pair(2047, 1, "f32"), STARVED)
    assert all(v > 0 for v in jc.values()), jc
    assert tc == jc
    assert tu == pytest.approx(ju, rel=REL["f32"])


@pytest.mark.parametrize("theta2", [None, 0.5])
def test_total_energy_bh_matches_jax(theta2):
    js, jp, st, pr = _pair(2047, 3, "f64")
    assert float(energy.total_energy(st, pr, method="bh")) == pytest.approx(
        float(jenergy.total_energy(js, jp, method="bh")), rel=1e-10)
    assert float(energy.potential_energy_bh(st, pr, theta2=theta2)) == \
        pytest.approx(float(jenergy.potential_energy_bh(js, jp,
                                                        theta2=theta2)),
                      rel=1e-10)


def test_auto_takes_the_estimator_above_262144(monkeypatch):
    """'auto' above a capacity of 262144 routes to potential_energy_bh (the
    call is recorded, not run: a walk at that capacity is minutes on the
    CPU), as the JAX package resolves it."""
    cap = (1 << 18) + 128
    st = ParticleState.create(np.zeros((3, 3)), np.zeros((3, 3)), np.ones(3),
                              capacity=cap, device="cpu")
    pr = SimParams.create(device="cpu")
    calls = []

    def spy(state, params, theta2=None, cfg=None):
        calls.append(state.capacity)
        return torch.zeros(())

    monkeypatch.setattr(energy, "potential_energy_bh", spy)
    assert jenergy.resolve_energy_method(cap) == "bh"
    assert energy.resolve_energy_method(cap) == "bh"
    assert float(energy.total_energy(st, pr)) == 0.0  # KE 0 + the spy's 0
    assert calls == [cap]


def test_simulation_energy_bh_and_cli_note(monkeypatch, capsys):
    """Simulation.energy('bh') is the estimator; the CLI's text output
    carries the tree-estimator note when --energy resolves to it (the
    threshold lowered here so a small CPU run reaches it)."""
    from nbody_tpu_torch import cli

    pos, vel, mass = self_gravitating_disc(300, seed=2)
    sim = Simulation(pos, vel, mass, engine="brute", device="cpu",
                     dtype=torch.float64, g_soft=0.02, theta2=1.0)
    e_bh, e_ex = sim.energy(method="bh"), sim.energy(method="exact")
    assert e_bh == pytest.approx(e_ex, rel=1e-10)  # one group: all exact
    monkeypatch.setattr(energy, "_BH_ENERGY_THRESHOLD", 256)
    res = cli.main(["-n", "300", "--steps", "2", "--engine", "brute",
                    "--device", "cpu", "--f64", "--energy"])
    out = capsys.readouterr().out
    assert res["energy_method"] == "bh"
    assert "tree estimator" in out and "--energy-exact" in out
