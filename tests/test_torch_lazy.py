"""The lazy-rebuild Barnes-Hut engine of the port (``refresh_octree``,
``bh_accel_lazy``, ``bh-lazy``) against the JAX package's, on the config of
``tests/test_lazy_bh.py``.

``refresh_octree``'s integer tables equal the JAX package's exactly and its
node statistics to float64 rounding, and at the build's positions it is the
build bit for bit; the rebuild flag and the moved fraction equal JAX's;
float64 forces agree to 1e-10; the stateful ``Simulation`` tracks the JAX
package's ``bh-lazy`` run; the CLI takes ``--engine bh-lazy`` and refuses
the flag combinations the JAX CLI refuses, with its texts."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nbody_tpu.api import Simulation as JaxSimulation
from nbody_tpu.core.state import ParticleState as JaxState
from nbody_tpu.core.state import SimParams as JaxParams
from nbody_tpu.ops import traversal as jt
from nbody_tpu.ops import tree as jtree
from nbody_tpu_torch import Simulation, cli
from nbody_tpu_torch.core.state import ParticleState, SimParams
from nbody_tpu_torch.ops import traversal as tt
from nbody_tpu_torch.ops import tree as ttree
from nbody_tpu_torch.scenes import self_gravitating_disc
from test_walk_reuse import OPTS

CENTER = (0.3, -0.2, 0.1)


def _both(n, seed, center=(0.0, 0.0, 0.0)):
    pos, vel, mass = self_gravitating_disc(n, seed=seed)
    kw = dict(g_soft=0.02, theta2=0.5, bounds_center=center)
    return ((JaxState.create(pos, vel, mass, dtype=jnp.float64),
             JaxParams.create(dtype=jnp.float64, **kw)),
            (ParticleState.create(pos, vel, mass, dtype=torch.float64,
                                  device="cpu"),
             SimParams.create(dtype=torch.float64, device="cpu", **kw)))


def _moved(pos, shift):
    """Positions moved by ``shift`` for every third particle."""
    out = np.array(pos)
    out[::3] += shift
    return out


@pytest.mark.parametrize("quad_leaf", [False, True])
def test_refresh_matches_jax_and_equals_the_build(quad_leaf):
    (js, jp), (ts, tp) = _both(800, seed=1)
    jm, tm = js.effective_mass(), ts.effective_mass()
    jtr = jtree.build_octree(js.pos, jm, jp.bounds, 5, quad=True,
                             quad_leaf=quad_leaf)
    ttr = ttree.build_octree(ts.pos, tm, tp.bounds, 5, quad=True,
                             quad_leaf=quad_leaf)
    fresh = ttree.refresh_octree(ttr, ts.pos, tm, quad_leaf=quad_leaf)
    for name in ("pos_s", "mass_s", "all_quad"):
        assert torch.equal(getattr(fresh, name), getattr(ttr, name)), name
    for a, b in zip(fresh.level_table, ttr.level_table):
        assert torch.equal(a, b)
    moved = _moved(np.asarray(js.pos), 0.05)
    want = jtree.refresh_octree(jtr, jnp.asarray(moved), jm, quad=True,
                                quad_leaf=quad_leaf)
    got = ttree.refresh_octree(ttr, torch.from_numpy(moved), tm,
                               quad_leaf=quad_leaf)
    for name in ("order", "code_s", "leaf_starts"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)))
    for a, b in zip(got.level_table, want.level_table):
        np.testing.assert_array_equal(a[:, 4:].numpy(), np.asarray(b)[:, 4:])
        np.testing.assert_allclose(a[:, :4].numpy(), np.asarray(b)[:, :4],
                                   rtol=1e-12, atol=1e-13)
    np.testing.assert_allclose(got.all_quad.numpy(), np.asarray(want.all_quad),
                               rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("shift,rebuilt", [(0.0, 0), (0.05, 0), (1.0, 1)])
def test_bh_accel_lazy_matches_jax(shift, rebuilt):
    """Static, small and bulk motion in an off-origin box: the rebuild flag
    and the moved fraction equal the JAX package's, the forces agree to
    1e-10, and a static call equals bh_accel."""
    (js, jp), (ts, tp) = _both(500, seed=2, center=CENTER)
    jcfg = jt.BHConfig(eval_mode="xla", **OPTS)
    tcfg = tt.BHConfig(**OPTS)
    jm, tm = js.effective_mass(), ts.effective_mass()
    jtr = jtree.build_octree(js.pos - jp.bounds.center, jm,
                             jp.bounds.centered(), 5, quad=True,
                             quad_leaf=False)
    ttr = ttree.build_octree(ts.pos - tp.bounds.center, tm,
                             tp.bounds.centered(), 5, quad=True)
    moved = np.array(js.pos)
    moved[:, 0] += shift
    want, wstats, _ = jt.bh_accel_lazy(
        jnp.asarray(moved), jm, jp.bounds, jp.theta2, jp.g, jp.g_soft, jtr,
        jcfg)
    got, stats, tree = tt.bh_accel_lazy(
        torch.from_numpy(moved), tm, tp.bounds, tp.theta2, tp.g, tp.g_soft,
        ttr, tcfg)
    assert stats["rebuilt"] == int(wstats["rebuilt"]) == rebuilt
    assert stats["moved_frac"] == pytest.approx(float(wstats["moved_frac"]),
                                                rel=1e-12)
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-10 * np.abs(want).max())
    if shift == 0.0:
        ref, _ = tt.bh_accel(ts.pos, tm, tp.bounds, tp.theta2, tp.g,
                             tp.g_soft, tcfg)
        np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=1e-12,
                                   atol=1e-14)
    assert torch.equal(tree.code_s, ttr.code_s) == (not rebuilt)


def test_lazy_simulation_tracks_jax_reset_load_compile(tmp_path):
    """bh-lazy through Simulation for four steps tracks the JAX package's
    run to 1e-10 (float64); compile leaves the carried tree as it was,
    reset restores the initial one, load rebuilds it from the restored
    state."""
    pos, vel, mass = self_gravitating_disc(300, seed=4)
    common = dict(engine="bh-lazy", engine_options=OPTS, dt=3e-2,
                  g_soft=0.02)
    sim = Simulation(pos, vel, mass, dtype=torch.float64, device="cpu",
                     **common)
    ref = JaxSimulation(pos, vel, mass, dtype=jnp.float64, **common)
    assert sim.engine.stateful and ref.engine.stateful
    assert sim.engine.aux is None
    p0 = sim.get_points()[0]
    sim.run(4)
    ref.run(4)
    np.testing.assert_allclose(sim.get_points()[0],
                               np.asarray(ref.get_points()[0]), rtol=0,
                               atol=1e-10)
    tree = sim._carry
    sim.compile(3)
    assert sim._carry is tree
    path = str(tmp_path / "lazy.pkl")
    sim.save(path)
    sim.reset()
    np.testing.assert_array_equal(sim.get_points()[0], p0)
    assert sim.elapsed == 0.0 and sim._carry is sim._initial_carry
    back = Simulation(pos, vel, mass, dtype=torch.float64, device="cpu",
                      **common).load(path)
    rebuilt = ttree.build_octree(
        back.state.pos - back.settings.bounds.center,
        back.state.effective_mass(), back.settings.bounds.centered(),
        OPTS["max_level"], quad=True)
    assert torch.equal(back._carry.order, rebuilt.order)
    assert back._initial_carry is back._carry


def test_cli_bh_lazy_and_walk_every(capsys):
    """--engine bh-lazy and --walk-every run through the CLI on the CPU;
    --walk-every on bh-lazy, and --refine or --adaptive beside
    --walk-every, exit with the JAX CLI's texts."""
    base = ["-n", "600", "--steps", "2", "--chunk", "1", "--device", "cpu",
            "--json"]
    res = cli.main(base + ["--engine", "bh-lazy"])
    assert res["engine"] == "bh-lazy" and res["n_alive"] > 0
    res = cli.main(base + ["--engine", "bh", "--walk-every", "3",
                           "--energy"])
    assert res["engine"] == "bh" and np.isfinite(res["energy_drift"])
    for flags, text in (
            (["--engine", "bh-lazy", "--walk-every", "2"],
             "--walk-every applies to bh/bh-deep only"),
            (["--engine", "bh", "--refine", "1", "--walk-every", "2"],
             "--refine and --walk-every are exclusive"),
            (["--engine", "bh", "--adaptive", "--walk-every", "2"],
             "--adaptive and --walk-every are exclusive"),
            (["--engine", "bh-lazy", "--refine", "1"],
             "--refine applies to bh/bh-deep only")):
        with pytest.raises(SystemExit, match=text):
            cli.main(base + flags)
