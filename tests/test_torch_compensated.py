"""The port's compensated (double-float, TwoSum) stepper against the JAX
package's, and the properties tests/test_compensated.py pins, run on the
port: the compensated orbit tracks float64 far closer than plain f32, the
energy drift closes most of the f32 gap, dead particles freeze both words,
and ``Simulation(compensated=True)`` carries the low words through reset
and checkpoints (which cross between the packages both ways).

Tolerances: bitwise where no reduction is involved (``two_sum_add``, a
step under an elementwise force); 1e-12 relative for float64 runs through
the direct sum (matrix products in another summation order)."""


import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nbody_tpu
from nbody_tpu.core import stepper as jstepper
from nbody_tpu.core.state import ParticleState as JState
from nbody_tpu.core.state import SimParams as JParams
from nbody_tpu.engines import get_engine as jget_engine
from nbody_tpu_torch import Simulation, cli
from nbody_tpu_torch.core.energy import total_energy
from nbody_tpu_torch.core.state import ParticleState, SimParams
from nbody_tpu_torch.core.stepper import (
    init_comp,
    make_run,
    make_run_comp,
    make_step_comp,
    two_sum_add,
)
from nbody_tpu_torch.engines import Engine, get_engine
from nbody_tpu_torch.scenes import self_gravitating_disc
from torch_parity import one_intra_op_thread  # noqa: F401  (autouse)

DTYPES = {"f32": (jnp.float32, torch.float32, np.float32),
          "f64": (jnp.float64, torch.float64, np.float64)}


def elementwise(p, m, prm):
    return -p


@pytest.mark.parametrize("dt", ["f32", "f64"])
def test_two_sum_add_bitwise_equal_to_jax(dt):
    jdt, _, npdt = DTYPES[dt]
    rng = np.random.default_rng(0)
    hi = rng.normal(size=4096).astype(npdt)
    lo = (hi * rng.normal(size=4096) * 1e-8).astype(npdt)
    d = (rng.normal(size=4096) * 10.0 ** rng.integers(-12, 2, 4096)
         ).astype(npdt)
    want = jax.jit(jstepper.two_sum_add)(*(jnp.asarray(a, jdt)
                                           for a in (hi, lo, d)))
    got = two_sum_add(*(torch.from_numpy(a) for a in (hi, lo, d)))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    if dt == "f32":
        # error-free: hi' + lo' is the exact sum to ~2^-48 relative
        exact = hi.astype(np.float64) + lo + d
        back = got[0].double().numpy() + got[1].double().numpy()
        assert np.abs(back - exact).max() <= 2.0 ** -44 * np.abs(exact).max()


def test_two_sum_add_keeps_increments_below_an_ulp():
    """10000 additions of 1e-8 to 1.0 in f32: plain addition keeps nothing
    (the increment is below half an ulp), the TwoSum keeps all 1e-4."""
    hi, lo = torch.tensor(1.0), torch.tensor(0.0)
    d = torch.tensor(1e-8)
    plain = torch.tensor(1.0)
    for _ in range(10_000):
        hi, lo = two_sum_add(hi, lo, d)
        plain = plain + d
    assert float(plain) == 1.0
    assert abs(float(hi) + float(lo) - (1.0 + 1e-4)) < 1e-9


def _states(dt, n=500, seed=3, bounds_width=3.0):
    """JAX and port states of the disc (bounds narrow enough that some
    particles leave in the first step) and random low words."""
    jdt, tdt, npdt = DTYPES[dt]
    pos, vel, mass = self_gravitating_disc(n, seed=seed)
    kw = dict(dt=3e-2, g_soft=0.02, bounds_width=bounds_width)
    js, jp = JState.create(pos, vel, mass, dtype=jdt), JParams.create(
        dtype=jdt, **kw)
    st, pr = ParticleState.create(pos, vel, mass, dtype=tdt), \
        SimParams.create(dtype=tdt, **kw)
    rng = np.random.default_rng(1)
    lo = [(rng.normal(size=st.pos.shape) * 1e-9).astype(npdt)
          for _ in range(2)]
    return js, jp, st, pr, lo


@pytest.mark.parametrize("dt", ["f32", "f64"])
@pytest.mark.parametrize("integrator", ["leapfrog", "euler"])
def test_step_comp_bitwise_equal_to_jax(dt, integrator):
    """One compensated step under an elementwise force: every word equal to
    JAX's, culled particles included."""
    js, jp, st, pr, lo = _states(dt)
    jlo = tuple(jnp.asarray(a) for a in lo)
    tlo = tuple(torch.from_numpy(a) for a in lo)
    ja, (jpl, jvl) = jax.jit(jstepper.make_step_comp(elementwise,
                                                     integrator))(js, jlo, jp)
    ta, (tpl, tvl) = make_step_comp(elementwise, integrator)(st, tlo, pr)
    assert 0 < int(ta.alive.sum()) < int(st.alive.sum())  # some culled
    for got, want in ((ta.pos, ja.pos), (ta.vel, ja.vel), (ta.acc, ja.acc),
                      (ta.alive, ja.alive), (tpl, jpl), (tvl, jvl),
                      (ta.time, ja.time)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_run_comp_matches_jax_f64_brute():
    js, jp, st, pr, _ = _states("f64", n=300, bounds_width=10.0)
    (ja, (jpl, jvl)) = jstepper.make_run_comp(jget_engine("brute").force)(
        js, jstepper.init_comp(js), jp, 20)
    ta, (tpl, tvl) = make_run_comp(get_engine("brute").force)(
        st, init_comp(st), pr, 20)
    for got, want in ((ta.pos, ja.pos), (ta.vel, ja.vel)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-12,
                                   atol=1e-14)
    # the low words of a float64 run are float64 rounding residues
    for got, want in ((tpl, jpl), (tvl, jvl)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=1e-14)
    assert torch.equal(ta.alive, torch.from_numpy(np.asarray(ja.alive)))


def test_comp_tracks_f64_closer_than_plain_orbit():
    """tests/test_compensated.py's two-body circular orbit (G = 1, m = 0.5
    each at separation 1, eps = 0, dt 1e-3, 10000 steps): against a float64
    leapfrog at the same dt the discretisation error cancels, and what is
    left is rounding, which the compensation removes."""
    pos = np.array([[-0.5, 0.0, 0.0], [0.5, 0.0, 0.0]])
    vel = np.array([[0.0, -0.5, 0.0], [0.0, 0.5, 0.0]])
    mass = np.array([0.5, 0.5])

    def make(dtype):
        # capacity 2: no padding rows, the cheapest eager step
        return (ParticleState.create(pos, vel, mass, capacity=2,
                                     dtype=dtype),
                SimParams.create(dt=1e-3, g_soft=0.0, bounds_width=10.0,
                                 dtype=dtype))

    force = get_engine("brute").force
    st32, pr32 = make(torch.float32)
    st64, pr64 = make(torch.float64)
    out_p = make_run(force)(st32, pr32, 10_000)
    out_c, _ = make_run_comp(force)(st32, init_comp(st32), pr32, 10_000)
    ref = make_run(force)(st64, pr64, 10_000).pos.numpy()
    err_p = np.abs(out_p.pos.double().numpy() - ref).max()
    err_c = np.abs(out_c.pos.double().numpy() - ref).max()
    assert err_c < 0.2 * err_p, (err_p, err_c)


def test_comp_energy_drift_improves():
    """tests/test_compensated.py's drift test: 500 benchmark-dt steps; the
    compensated f32 drift closes most of the gap between plain f32 and the
    float64 envelope.  The disc is cut from 2048 to 256 (255 + the star)
    for the CPU budget (the 2048 run takes minutes in eager torch); at
    either size the chaotic float64 envelope is the larger term."""
    force = get_engine("brute").force
    pos, vel, mass = self_gravitating_disc(255, seed=4)
    kw = dict(dt=3e-2, g_soft=0.02, theta2=1.0, bounds_width=10.0)
    state = ParticleState.create(pos, vel, mass)
    params = SimParams.create(**kw)

    def drift(s0, s1, p):
        e0 = float(total_energy(s0, p))
        return abs(float(total_energy(s1, p)) - e0) / abs(e0)

    ep = drift(state, make_run(force)(state, params, 500), params)
    out_c, _ = make_run_comp(force)(state, init_comp(state), params, 500)
    ec = drift(state, out_c, params)
    s64 = ParticleState.create(pos, vel, mass, dtype=torch.float64)
    p64 = SimParams.create(dtype=torch.float64, **kw)
    e64 = drift(s64, make_run(force)(s64, p64, 500), p64)
    assert ec < max(0.5 * ep, 3.0 * e64 + 1e-7), (ep, ec, e64)


def test_comp_dead_particles_frozen():
    """A particle leaving the box dies; its pos/vel and low words freeze."""
    pos = np.array([[0.0, 0.0, 0.0], [4.9, 0.0, 0.0]])
    vel = np.array([[0.0, 0.0, 0.0], [50.0, 0.0, 0.0]])
    state = ParticleState.create(pos, vel, np.ones(2))
    params = SimParams.create(dt=1e-2, bounds_width=10.0)
    step = make_step_comp(get_engine("brute").force)
    s1, lo1 = step(state, init_comp(state), params)
    assert not bool(s1.alive[1])
    s2, lo2 = step(s1, lo1, params)
    assert torch.equal(s1.pos[1], s2.pos[1])
    assert torch.equal(s1.vel[1], s2.vel[1])
    assert torch.equal(lo1[0][1], lo2[0][1])
    assert torch.equal(lo1[1][1], lo2[1][1])


def _sim(**kw):
    pos, vel, mass = self_gravitating_disc(512, seed=1)
    kw.setdefault("compensated", True)
    kw.setdefault("engine", "brute")
    return Simulation(pos, vel, mass, device="cpu", dt=3e-2, g_soft=0.02,
                      bounds_width=10.0, **kw)


def test_simulation_compensated_api(tmp_path):
    """tests/test_compensated.py's API test: runs, resets, and checkpoint
    round-trips carry the low words; load makes the restored point the
    reset target, carry included."""
    sim = _sim()
    sim.run(50)
    lo_mag = float(sim._lo[0].abs().max())
    assert lo_mag > 0.0  # the carry is accumulating
    p = str(tmp_path / "ck.pkl")
    sim.save(p)
    sim.run(10)
    sim.load(p)
    assert float(sim._lo[0].abs().max()) == lo_mag
    sim.run(10)
    sim.reset()
    assert float(sim._lo[0].abs().max()) == lo_mag
    # init() snapshots the words; step_by carries them
    sim = _sim()
    sim.step_by(1e-2)
    assert float(sim._lo[1].abs().max()) > 0.0
    sim.reset()
    assert float(sim._lo[1].abs().max()) == 0.0 and sim.elapsed == 0.0


def test_checkpoints_cross_between_the_packages(tmp_path):
    """A compensated checkpoint of either package restores in the other with
    its low words; a plain Simulation ignores them; a file without them
    restores zeros."""
    pos, vel, mass = self_gravitating_disc(512, seed=1)
    kw = dict(dt=3e-2, g_soft=0.02, bounds_width=10.0)
    port = _sim()
    port.run(7)
    a = str(tmp_path / "port.pkl")
    port.save(a)
    ref = nbody_tpu.Simulation(pos, vel, mass, engine="brute",
                               dtype=jnp.float32, compensated=True, **kw)
    ref.load(a)
    for got, want in zip(ref._lo, port._lo):
        np.testing.assert_array_equal(np.asarray(got), want.numpy())
    np.testing.assert_array_equal(np.asarray(ref.state.pos),
                                  port.state.pos.numpy())

    ref.run(5)
    b = str(tmp_path / "jax.pkl")
    ref.save(b)
    back = _sim().load(b)
    for got, want in zip(back._lo, ref._lo):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(back.state.vel.numpy(),
                                  np.asarray(ref.state.vel))
    assert back.elapsed == pytest.approx(float(ref.state.time))

    plain = _sim(compensated=False).load(b)
    assert plain._lo is None
    c = str(tmp_path / "plain.pkl")
    plain.save(c)
    zeros = _sim()
    zeros.run(3)
    zeros.load(c)
    assert float(zeros._lo[0].abs().max()) == 0.0


def test_compensated_refuses_stateful_engines():
    stateful = Engine(name="cached", force=elementwise, stateful=True)
    with pytest.raises(ValueError, match="stateful"):
        _sim(engine=stateful)
    with pytest.raises(NotImplementedError, match="item 16"):
        _sim(engine=stateful, compensated=False)
    with pytest.raises(NotImplementedError, match="not yet ported"):
        _sim(engine="bh-lazy")


def test_cli_compensated(tmp_path):
    """--compensated through the CLI: a compensated Simulation (its
    checkpoint holds the low words) whose f32 exact-energy drift sits at
    the float64 run's (at this dt, 1.7e-5 of time discretisation)."""
    import pickle

    ck = str(tmp_path / "ck.pkl")
    base = ["-n", "300", "--steps", "40", "--engine", "brute", "--device",
            "cpu", "--energy", "--energy-exact", "--json"]
    res = cli.main([*base, "--compensated", "--save", ck])
    ref = cli.main([*base, "--f64"])
    assert res["energy_method"] == "exact"
    assert abs(res["energy_drift"] - ref["energy_drift"]) < 1e-6
    with open(ck, "rb") as f:
        lo = pickle.load(f)["lo"]
    assert np.abs(lo["pos_lo"]).max() > 0.0
