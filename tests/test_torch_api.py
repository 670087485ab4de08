"""The port's ``Simulation`` surface and CLI flags, on the CPU path."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nbody_tpu
from nbody_tpu.engines import Engine as JaxEngine
from nbody_tpu.ops.pairwise import pairwise_acc_pallas
from nbody_tpu_torch import Simulation, cli
from nbody_tpu_torch.api import resolve_auto_engine
from nbody_tpu_torch.scenes import self_gravitating_disc


def make(n=200, **kw):
    pos, vel, mass = self_gravitating_disc(n, seed=0)
    kw.setdefault("engine", "brute")
    kw.setdefault("dt", 3e-2)
    kw.setdefault("g_soft", 0.02)
    kw.setdefault("device", "cpu")
    return Simulation(pos, vel, mass, **kw)


def test_step_elapsed_and_rewind():
    """Leapfrog is time-reversible: step_by(-dt) undoes step_by(dt) to f64
    roundoff."""
    sim = make(dtype=torch.float64)
    p0, v0, _, _ = sim.get_points()
    assert sim.elapsed == 0.0
    sim.step()
    assert np.isclose(sim.elapsed, 3e-2)
    sim.step_by(1e-3)
    assert np.isclose(sim.elapsed, 3.1e-2)
    sim.step_by(-1e-3)
    sim.step_by(-3e-2)
    assert abs(sim.elapsed) < 1e-15
    p1, v1, _, _ = sim.get_points()
    np.testing.assert_allclose(p1, p0, atol=1e-12)
    np.testing.assert_allclose(v1, v0, atol=1e-12)


def test_determinism_and_reset():
    a, b = make(300), make(300)
    a.run(6)
    b.run(6)
    for x, y in zip(a.get_points(), b.get_points()):
        np.testing.assert_array_equal(x, y)
    a.reset()
    assert a.elapsed == 0.0
    np.testing.assert_array_equal(a.get_points()[0], make(300).get_points()[0])


def test_add_remove_points_mid_run():
    sim = make(100)
    sim.run(3)
    n0 = sim.n_alive
    sim.add_point([2.0, 0.0, 0.0], [0.0, 0.5, 0.0], 1e-3)
    assert sim.n_alive == n0 + 1
    sim.run(3)
    assert sim.n_alive <= n0 + 1
    sim.remove_point(0)
    assert sim.n_alive <= n0


def test_update_forces_matches_jax():
    """The main path's direct sum on both sides: the port's brute-pallas
    (its plain twin on the CPU) against the JAX package's Pallas kernel in
    interpret mode."""
    pos, vel, mass = self_gravitating_disc(250, seed=2)
    kw = dict(dt=3e-2, g_soft=0.02)
    interp = JaxEngine(name="brute-pallas-interp", force=lambda p, m, prm:
                       pairwise_acc_pallas(p, m, prm.g, prm.g_soft,
                                           interpret=True))
    ref = nbody_tpu.Simulation(pos, vel, mass, engine=interp,
                               dtype=jnp.float32, **kw)
    sim = Simulation(pos, vel, mass, engine="brute-pallas", device="cpu", **kw)
    ref.update_forces()
    sim.update_forces()
    got, want = sim.get_points()[2], np.asarray(ref.get_points()[2])
    assert np.abs(got).max() > 0
    scale = np.linalg.norm(want, axis=1).mean()
    assert np.linalg.norm(got - want, axis=1).max() / scale < 1e-4


def test_set_settings_live():
    sim = make(100)
    sim.run(2)
    sim.set_settings(theta2=0.7, g=1.5, dt=1e-2)
    assert sim.settings.g == 1.5 and sim.settings.dt == float(np.float32(1e-2))
    t = sim.elapsed
    sim.run(2)
    assert sim.elapsed == pytest.approx(t + 2e-2, rel=1e-5)


@pytest.mark.parametrize("kw", [dict(engine="bh",
                                     engine_options=dict(walk_every=2)),
                                dict(engine="bh",
                                     engine_options=dict(profile="adaptive")),
                                dict(engine="bh-lazy"),
                                dict(engine="bh", engine_options=dict(
                                    sliding_window=True))])
def test_unported_options_raise(kw):
    """These options are all ported now (ROADMAP items 15 and 16).
    profile='adaptive' without max_level / refine_levels resolves the
    scene's stack as the JAX package does (the 51-particle disc: mid-N);
    walk_every > 1 and bh-lazy make the engine stateful, as in the JAX
    package; each runs two steps on the CPU and keeps every particle."""
    sim = make(50, **kw)
    if kw.get("engine_options") == dict(profile="adaptive"):
        from nbody_tpu.ops.traversal import ADAPTIVE_MIDN_OVERRIDES

        assert sim.engine_options == dict(profile="adaptive",
                                          **ADAPTIVE_MIDN_OVERRIDES)
        assert "refine_levels=4" in sim.engine.description
        return
    stateful = kw["engine"] == "bh-lazy" or "walk_every" in kw.get(
        "engine_options", {})
    assert sim.engine.stateful == stateful
    sim.run(2)
    assert sim.n_alive == 51
    assert np.isfinite(sim.get_points()[2]).all()


def test_auto_engine():
    assert resolve_auto_engine(60000, "cpu") == "brute"
    assert resolve_auto_engine(60000, "cuda") == "brute-pallas"
    assert resolve_auto_engine(60001, "cuda") == "bh"
    assert resolve_auto_engine(60001, "cpu") == "bh"
    assert make(50, engine="auto").engine.name == "brute"


def test_unknown_device_and_engine():
    with pytest.raises(ValueError):
        make(10, device="meta")
    with pytest.raises(KeyError):
        make(10, engine="warp-drive")


@pytest.mark.parametrize("flag", [["--devices", "2"],
                                  ["--engine", "bh", "--adaptive"],
                                  ["--engine", "bh-deep", "--refine", "1"],
                                  ["--adaptive"],
                                  ["--refine", "2"], ["--walk-every", "3"]])
def test_cli_unported_flags_exit(flag):
    """The flag of the path not ported yet (--devices, item 17) exits
    naming the path.  --adaptive, --refine (item 15) and --walk-every
    (item 16) are ported: on the default engine 'auto' they exit with the
    JAX package's message, and on a bh engine they run 2 steps of a small
    Plummer sphere on the CPU."""
    argv = ["-n", "10", "--steps", "1", "--cpu", *flag]
    if "--devices" in flag:
        with pytest.raises(SystemExit, match="not yet ported"):
            cli.main(argv)
        return
    if "--engine" not in flag:
        with pytest.raises(SystemExit, match="applies to bh/bh-deep only"):
            cli.main(argv)
        flag = ["--engine", "bh", *flag]
    res = cli.main(["-n", "1000", "--steps", "2", "--chunk", "1",
                    "--scene", "plummer", "--box-width", "40", "--device",
                    "cpu", "--energy", "--json", *flag])
    assert res["engine"] == flag[1] and res["steps"] == 2
    assert res["n_alive"] > 0 and np.isfinite(res["energy_drift"])


def test_cli_text_output_f64_cpu(capsys):
    res = cli.main(["-n", "100", "--steps", "3", "--engine", "brute-pallas",
                    "--device", "cpu", "--f64", "--energy"])
    out = capsys.readouterr().out
    assert "Running simulation without rendering..." in out
    assert "steps/second" in out and "Elapsed:" in out and "Energy:" in out
    assert res["engine"] == "brute-pallas" and res["n_alive"] == 101
    assert res["energy_drift"] < 1e-6


@pytest.mark.parametrize("flag", ["--accurate", "--dense"])
def test_cli_bh_profiles_need_a_bh_engine(flag):
    with pytest.raises(SystemExit, match="applies to bh engines only"):
        cli.main(["-n", "10", "--steps", "1", "--cpu", flag])


def test_auto_engine_refuses_steep_core_scenes():
    """engine='auto' above N = 60000 detects a steep core as the JAX package
    does and routes it to profile='adaptive' with the scene's stack (ROADMAP
    item 15, ported); the disc keeps the fast profile.  Constructing the
    Simulation runs no step."""
    from nbody_tpu.ops.traversal import ADAPTIVE_MIDN_OVERRIDES
    from nbody_tpu_torch.scenes import SCENES

    disc = Simulation(*SCENES["disc"](70000, seed=0), engine="auto",
                      device="cpu")
    assert disc.engine.name == "bh" and disc.engine_options == {}
    plummer = Simulation(*SCENES["plummer"](70000, seed=0), engine="auto",
                         bounds_width=40.0, device="cpu")
    assert plummer.engine.name == "bh"
    assert plummer.engine_options == dict(profile="adaptive",
                                          **ADAPTIVE_MIDN_OVERRIDES)


def test_bh_engines_and_their_limits():
    """bh / bh-deep bind their leaf depth and options; a 2D state on bh
    raises naming its ROADMAP item instead of running."""
    from nbody_tpu_torch import get_engine

    assert "max_level=7" in get_engine("bh").description
    assert "max_level=8" in get_engine("bh-deep").description
    assert "window_pad=2048" in get_engine(
        "bh", profile="accurate").description
    assert get_engine("bh", walk_every=2).stateful
    assert not get_engine("bh").stateful
    rng = np.random.default_rng(0)
    flat = Simulation(rng.uniform(-3, 3, (50, 2)), np.zeros((50, 2)),
                      np.ones(50), engine="bh", bounds_center=(0.0, 0.0),
                      device="cpu")
    flat.run(1)
    assert flat.state.pos.shape == (128, 2) and flat.n_alive == 50


@pytest.mark.parametrize("compensated", [False, True])
def test_compile_runs_one_step_and_keeps_the_state(compensated):
    """compile executes one step of the configured stepper and discards it:
    the state, the low words, the clock and the reset target are bitwise
    what they were, and it returns the Simulation."""
    sim = make(200, compensated=compensated)
    sim.run(2)
    before = {k: getattr(sim.state, k).clone()
              for k in ("pos", "vel", "acc", "mass", "alive", "time")}
    lo = None if sim._lo is None else [t.clone() for t in sim._lo]
    elapsed = sim.elapsed
    steps = []
    step = sim._step
    sim._step = lambda *a: steps.append(1) or step(*a)
    assert sim.compile(10) is sim
    assert sim.compile(10, dt=-1e-3) is sim
    assert len(steps) == 2
    for k, t in before.items():
        assert torch.equal(getattr(sim.state, k), t), k
    if compensated:
        assert all(torch.equal(a, b) for a, b in zip(sim._lo, lo))
    assert sim.elapsed == elapsed
    sim.reset()
    fresh = make(200, compensated=compensated)
    for k in before:
        assert torch.equal(getattr(sim.state, k), getattr(fresh.state, k)), k
    if compensated:
        assert all(torch.equal(a, b) for a, b in zip(sim._lo, fresh._lo))


@pytest.mark.parametrize("fmt", ["pickle", "orbax", "npz"])
def test_save_load_take_the_jax_format_argument(fmt, tmp_path):
    """save/load take the JAX signature's ``format``: the pickle is
    ported (and read by the JAX package), orbax raises naming its ROADMAP
    item, anything else is refused."""
    sim = make(100)
    sim.run(2)
    path = str(tmp_path / "ckpt")
    if fmt == "pickle":
        sim.save(path, format=fmt)
        other = make(100).load(path, format=fmt)
        assert torch.equal(other.state.pos, sim.state.pos)
        assert other.elapsed == sim.elapsed
        jsim = nbody_tpu.Simulation(*self_gravitating_disc(100, seed=0),
                                    dtype=jnp.float32)
        jsim.load(path, format=fmt)
        np.testing.assert_array_equal(np.asarray(jsim.state.pos),
                                      sim.state.pos.numpy())
        return
    err = NotImplementedError if fmt == "orbax" else ValueError
    match = "item 17" if fmt == "orbax" else "'pickle' or 'orbax'"
    with pytest.raises(err, match=match):
        sim.save(path, format=fmt)
    with pytest.raises(err, match=match):
        sim.load(path, format=fmt)
