"""The port's conserved-quantity diagnostics and trajectory recorder against
the JAX package's, at float64 and float32.

Tolerances: the four reductions to 1e-12 relative at float64 and 1e-5 at
float32 (another summation order over 700 rows); the recorder's states
to 1e-12 relative at float64 and 1e-6 at float32, under an elementwise
force and under the float64 direct sum (XLA may contract the leapfrog's
multiply-add into one rounding where eager torch rounds twice: an ulp a
step); its energies as the reductions."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nbody_tpu.core import diagnostics as jdiag
from nbody_tpu.engines.brute_force import force_dense as jforce_dense
from nbody_tpu_torch.core import diagnostics as diag
from nbody_tpu_torch.core.state import ParticleState, SimParams
from nbody_tpu_torch.engines.brute_force import force_dense
from torch_parity import disc

REL = {jnp.float64: 1e-12, jnp.float32: 1e-5}


def _port(jstate, jparams):
    st = ParticleState(**{
        f.name: torch.from_numpy(np.array(getattr(jstate, f.name)))
        for f in dataclasses.fields(ParticleState)})
    dtype = torch.float64 if jstate.dtype == jnp.float64 else torch.float32
    pr = SimParams.create(dt=float(jparams.dt), g_soft=float(jparams.g_soft),
                          theta2=1.0, bounds_width=10.0, dtype=dtype)
    return st, pr


def _state(dtype, n=700, cap=768, kill=37):
    jstate, jparams, *_ = disc(n, cap, kill)
    cast = lambda a: jnp.asarray(np.asarray(a, np.float64), dtype)
    jstate = dataclasses.replace(
        jstate, pos=cast(jstate.pos), vel=cast(jstate.vel),
        acc=cast(jstate.acc), mass=cast(jstate.mass), time=cast(jstate.time))
    return jstate, type(jparams).create(dt=3e-2, g_soft=0.02, theta2=1.0,
                                        bounds_width=10.0, dtype=dtype)


@pytest.mark.parametrize("dtype", [jnp.float64, jnp.float32])
def test_conserved_quantities_match_jax(dtype):
    jstate, jparams = _state(dtype)
    st, pr = _port(jstate, jparams)
    rel = REL[dtype]
    for name in ("momentum", "angular_momentum", "center_of_mass"):
        got = getattr(diag, name)(st).numpy()
        want = np.asarray(getattr(jdiag, name)(jstate))
        scale = np.abs(want).max()
        np.testing.assert_allclose(got, want, rtol=0, atol=rel * scale,
                                   err_msg=name)
    d, jd = diag.diagnostics(st, pr), jdiag.diagnostics(jstate, jparams)
    assert d.keys() == jd.keys()
    for k in d:
        got, want = d[k].numpy(), np.asarray(jd[k])
        scale = max(np.abs(want).max(), 1e-30)
        np.testing.assert_allclose(got, want, rtol=0, atol=rel * scale,
                                   err_msg=k)
    assert int(d["n_alive"]) == 700 + 1 - 37


def test_center_of_mass_guard_in_float32():
    """All particles dead: the f32 guard (finfo.tiny, not a float64 literal
    that underflows to 0) keeps the centre of mass finite, as in JAX."""
    jstate, jparams = _state(jnp.float32)
    jstate = dataclasses.replace(jstate, alive=jnp.zeros_like(jstate.alive))
    st, _ = _port(jstate, jparams)
    got = diag.center_of_mass(st).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_array_equal(got, np.asarray(jdiag.center_of_mass(jstate)))


@pytest.mark.parametrize("dtype,force", [(jnp.float32, "elementwise"),
                                         (jnp.float64, "elementwise"),
                                         (jnp.float64, "brute")])
def test_recorder_matches_jax(dtype, force):
    jstate, jparams = _state(dtype, n=300, cap=384, kill=11)
    st, pr = _port(jstate, jparams)
    if force == "elementwise":
        jf, tf = (lambda p, m, prm: -p), (lambda p, m, prm: -p)
    else:
        jf, tf = jforce_dense, force_dense
    jfinal, jtraj = jdiag.make_recorder(jf, every=3, with_energy=True)(
        jstate, jparams, 6)
    final, traj = diag.make_recorder(tf, every=3, with_energy=True)(st, pr, 6)
    assert traj.keys() == jtraj.keys()
    for k in traj:
        assert tuple(traj[k].shape) == tuple(jtraj[k].shape), k
    rtol = 1e-12 if dtype == jnp.float64 else 1e-6
    np.testing.assert_array_equal(traj["n_alive"].numpy(),
                                  np.asarray(jtraj["n_alive"]))
    for k in ("pos", "vel", "time"):
        got, want = traj[k].numpy(), np.asarray(jtraj[k])
        np.testing.assert_allclose(got, want, rtol=rtol,
                                   atol=rtol * np.abs(want).max(), err_msg=k)
    for k in ("kinetic", "potential"):
        np.testing.assert_allclose(traj[k].numpy(), np.asarray(jtraj[k]),
                                   rtol=REL[dtype], err_msg=k)
    # the last snapshot is the final state
    assert torch.equal(traj["pos"][-1], final.pos)
    assert torch.equal(traj["vel"][-1], final.vel)
    np.testing.assert_allclose(final.vel.numpy(), np.asarray(jfinal.vel),
                               rtol=rtol, atol=rtol * 10)


def test_recorder_refuses_a_ragged_count():
    jstate, jparams = _state(jnp.float64, n=50, cap=128, kill=0)
    st, pr = _port(jstate, jparams)
    with pytest.raises(ValueError, match="multiple"):
        diag.make_recorder(force_dense, every=4)(st, pr, 6)
    with pytest.raises(AssertionError):  # the JAX package asserts
        jdiag.make_recorder(jforce_dense, every=4)(jstate, jparams, 6)
    _, traj = diag.make_recorder(force_dense, every=2)(st, pr, 4)
    assert traj["pos"].shape == (2, 128, 3)
    # no steps: empty stacks of the same layout as JAX's
    final, traj = diag.make_recorder(force_dense, every=2,
                                     with_energy=True)(st, pr, 0)
    _, jtraj = jdiag.make_recorder(jforce_dense, every=2, with_energy=True)(
        jstate, jparams, 0)
    assert final is st
    assert {k: tuple(v.shape) for k, v in traj.items()} == \
        {k: tuple(v.shape) for k, v in jtraj.items()}
