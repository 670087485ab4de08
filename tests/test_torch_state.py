"""State parity: ``nbody_tpu_torch.core.state`` against ``nbody_tpu.core.state``
on the same numpy inputs, and checkpoints carried across both packages."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nbody_tpu
from nbody_tpu.core.state import Bounds as JaxBounds
from nbody_tpu.core.state import ParticleState as JaxState
from nbody_tpu.core.state import SimParams as JaxParams
from nbody_tpu_torch import Simulation
from nbody_tpu_torch.core.state import Bounds, ParticleState, SimParams
from nbody_tpu_torch.scenes import self_gravitating_disc


def _fields(state):
    """A state's arrays as numpy, whichever package made it."""
    return {k: np.asarray(v.cpu().numpy() if torch.is_tensor(v) else v)
            for k, v in ((f, getattr(state, f)) for f in
                         ("pos", "vel", "acc", "mass", "alive", "time"))}


def _assert_same(port_state, jax_state):
    a, b = _fields(port_state), _fields(jax_state)
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_bounds_contains_exact_on_faces():
    """Inclusive on both faces, exactly as the JAX package: points on a face,
    one ulp inside and one ulp outside."""
    center, width = (1.0, -2.0, 0.5), 6.0
    lo = np.float32(np.array(center, np.float32) - np.float32(3.0))
    hi = np.float32(np.array(center, np.float32) + np.float32(3.0))
    pts = []
    for axis in range(3):
        for face, away in ((lo, -np.inf), (hi, np.inf)):
            for val in (face[axis], np.nextafter(face[axis], away),
                        np.nextafter(face[axis], -away)):
                p = np.array(center, np.float32)
                p[axis] = val
                pts.append(p)
    pts = np.stack(pts)
    ref = np.asarray(JaxBounds.cube(center, width, dtype=jnp.float32)
                     .contains(jnp.asarray(pts)))
    got = Bounds.cube(center, width, device="cpu").contains(
        torch.from_numpy(pts)).numpy()
    np.testing.assert_array_equal(got, ref)
    assert got.sum() == 12 and (~got).sum() == 6  # on-face and inside count


def test_bounds_normalize_and_centered():
    b = Bounds.cube((1.0, 2.0, 3.0), 4.0, device="cpu")
    jb = JaxBounds.cube((1.0, 2.0, 3.0), 4.0, dtype=jnp.float32)
    p = np.random.default_rng(0).normal(size=(50, 3)).astype(np.float32)
    np.testing.assert_array_equal(
        b.normalize(torch.from_numpy(p)).numpy(),
        np.asarray(jb.normalize(jnp.asarray(p))))
    assert b.centered().center.abs().sum() == 0
    assert float(b.centered().half_width) == 2.0


@pytest.mark.parametrize("n,pad,capacity", [(300, 128, None), (300, 2048, None),
                                             (2048, 2048, None),
                                             (10, 128, 40)])
def test_capacity_and_padding(n, pad, capacity):
    pos, vel, mass = self_gravitating_disc(n - 1, seed=3)
    got = ParticleState.create(pos, vel, mass, pad_multiple=pad,
                               capacity=capacity, device="cpu")
    ref = JaxState.create(pos, vel, mass, pad_multiple=pad, capacity=capacity,
                          dtype=jnp.float32)
    _assert_same(got, ref)
    assert got.capacity == ref.capacity
    assert int(got.n_alive()) == n
    assert got.mass[n:].abs().sum() == 0 and not got.alive[n:].any()
    np.testing.assert_array_equal(got.effective_mass().numpy(),
                                  np.asarray(ref.effective_mass()))


def test_capacity_below_n_raises():
    pos, vel, mass = self_gravitating_disc(9, seed=0)
    with pytest.raises(ValueError):
        ParticleState.create(pos, vel, mass, capacity=5, device="cpu")


def test_add_remove_get_points_match_jax():
    pos, vel, mass = self_gravitating_disc(100, seed=1)
    got = ParticleState.create(pos, vel, mass, device="cpu")
    ref = JaxState.create(pos, vel, mass, dtype=jnp.float32)
    for op in (("add", [2.0, 0.1, 0.0], [0.0, 0.5, 0.0], 1e-3),
               ("remove", 5), ("remove", 0),
               ("add", [-1.0, 1.0, 0.2], [0.1, 0.0, 0.0], 2e-3),
               ("remove", 100)):
        if op[0] == "add":
            got, ref = got.add_point(*op[1:]), ref.add_point(*op[1:])
        else:
            got, ref = got.remove_point(op[1]), ref.remove_point(op[1])
        _assert_same(got, ref)
        for a, b in zip(got.get_points(), ref.get_points()):
            np.testing.assert_array_equal(a, np.asarray(b))


def test_add_point_when_full_raises():
    pos, vel, mass = self_gravitating_disc(127, seed=1)
    st = ParticleState.create(pos, vel, mass, device="cpu")
    with pytest.raises(ValueError):
        st.add_point([0.0, 0.0, 0.0], [0.0, 0.0, 0.0], 1.0)


def test_params_are_host_floats_rounded_like_jax():
    got = SimParams.create(g=1.3, g_soft=0.02, dt=3e-2, theta2=0.7,
                           device="cpu")
    ref = JaxParams.create(g=1.3, g_soft=0.02, dt=3e-2, theta2=0.7,
                           dtype=jnp.float32)
    for k in ("g", "g_soft", "dt", "theta2"):
        assert type(getattr(got, k)) is float
        assert getattr(got, k) == float(getattr(ref, k)), k
    assert got.eps2 == float(ref.g_soft * ref.g_soft)
    r2 = got.replace(dt=1e-2, bounds_width=4.0)
    assert r2.dt == float(np.float32(1e-2)) and float(r2.bounds.width) == 4.0
    assert r2.g == got.g


def _jax_sim(n=150):
    pos, vel, mass = self_gravitating_disc(n, seed=0)
    return nbody_tpu.Simulation(pos, vel, mass, engine="brute", dt=3e-2,
                                g_soft=0.02, dtype=jnp.float32)


def _port_sim(n=150):
    pos, vel, mass = self_gravitating_disc(n, seed=0)
    return Simulation(pos, vel, mass, engine="brute", dt=3e-2, g_soft=0.02,
                      device="cpu")


def test_jax_checkpoint_loads_in_port(tmp_path):
    """The JAX package's pickle is the port's "weights carried across": the
    port loads it into identical arrays and settings."""
    jsim = _jax_sim()
    jsim.run(3)
    jsim.set_settings(g=1.25, bounds_width=12.0)
    path = os.path.join(tmp_path, "jax.pkl")
    jsim.save(path)
    sim = _port_sim().load(path)
    _assert_same(sim.state, jsim.state)
    for k in ("g", "g_soft", "dt", "theta2"):
        assert getattr(sim.settings, k) == float(getattr(jsim.settings, k))
    np.testing.assert_array_equal(sim.settings.bounds.center.numpy(),
                                  np.asarray(jsim.settings.bounds.center))
    assert float(sim.settings.bounds.half_width) == float(
        jsim.settings.bounds.half_width)
    assert sim.elapsed == jsim.elapsed


def test_port_checkpoint_loads_in_jax(tmp_path):
    sim = _port_sim()
    sim.run(3)
    sim.remove_point(2)
    path = os.path.join(tmp_path, "port.pkl")
    sim.save(path)
    jsim = _jax_sim().load(path)
    _assert_same(sim.state, jsim.state)
    assert float(jsim.settings.dt) == sim.settings.dt
    assert jsim.n_alive == sim.n_alive


def test_constructors_default_to_the_card():
    """The public constructors put their tensors on the card unless the
    caller asks for the CPU, as Simulation does: with no CUDA the default
    raises the same error as Simulation's, and device="cpu" gives CPU
    tensors."""
    pos, vel, mass = self_gravitating_disc(9, seed=0)
    state = ParticleState.create(pos, vel, mass, device="cpu")
    params = SimParams.create(device="cpu")
    makers = {
        "ParticleState.create": lambda **kw: ParticleState.create(
            pos, vel, mass, **kw),
        "SimParams.create": lambda **kw: SimParams.create(**kw),
        "Bounds.cube": lambda **kw: Bounds.cube((0.0, 0.0, 0.0), 10.0, **kw),
        "ParticleState.from_numpy": lambda **kw: ParticleState.from_numpy(
            state.to_numpy(), **kw),
        "SimParams.from_numpy": lambda **kw: SimParams.from_numpy(
            params.to_numpy(), **kw),
    }
    def tensors(out):
        if isinstance(out, ParticleState):
            return [out.pos, out.mass, out.alive, out.time]
        if isinstance(out, Bounds):
            return [out.center, out.half_width]
        return [out.bounds.center, out.bounds.half_width]

    for name, make in makers.items():
        assert all(t.device.type == "cpu"
                   for t in tensors(make(device="cpu"))), name
        if torch.cuda.is_available():
            assert all(t.device.type == "cuda" for t in tensors(make())), name
            continue
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make()
