"""The ported slices as a whole against the JAX package: the ``brute-pallas``
and ``bh`` Simulations and the CLI, plus the port's two promises about its
boundary: it never imports jax, and it never falls back from the card to
the CPU."""

import json
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nbody_tpu
import nbody_tpu.cli
from nbody_tpu.engines import Engine as JaxEngine
from nbody_tpu.ops.pairwise import pairwise_acc_pallas_sym
from nbody_tpu_torch import Simulation, cli
from nbody_tpu_torch.ops import _build
from nbody_tpu_torch.scenes import self_gravitating_disc
from torch_parity import rel_err

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# The JAX reference for the slice: its Newton-3 Pallas kernel in interpret
# mode, under a name that is not registered but contains "pallas", so the
# JAX Simulation pads the capacity to 2048 exactly as the port does.
_INTERP = JaxEngine(
    name="brute-pallas-interp",
    force=lambda pos, mass, params: pairwise_acc_pallas_sym(
        pos, mass, params.g, params.g_soft, interpret=True),
)


def test_brute_pallas_simulation_matches_jax():
    pos, vel, mass = self_gravitating_disc(999, seed=4)
    kw = dict(dt=3e-2, g_soft=0.02, theta2=1.0)
    ref = nbody_tpu.Simulation(pos, vel, mass, engine=_INTERP,
                               dtype=jnp.float32, **kw)
    sim = Simulation(pos, vel, mass, engine="brute-pallas", device="cpu", **kw)
    assert sim.state.capacity == ref.state.capacity == 2048
    e0_ref, e0 = ref.energy(method="exact"), sim.energy(method="exact")
    assert e0 == pytest.approx(e0_ref, rel=1e-5)
    ref.run(4)
    sim.run(4)
    assert sim.n_alive == ref.n_alive == 1000
    assert sim.elapsed == pytest.approx(ref.elapsed, rel=1e-6)
    assert sim.energy(method="exact") == pytest.approx(
        ref.energy(method="exact"), rel=1e-5)
    for a, b in zip(sim.get_points(), ref.get_points()):
        # f32 roundoff of two summation orders through 4 steps; 1e-5 of the
        # box width (10)
        assert np.abs(a - np.asarray(b)).max() < 1e-4


def test_cli_matches_jax_cli(capsys):
    args = ["-n", "300", "--steps", "5", "--engine", "brute", "--json",
            "--energy"]
    ref = nbody_tpu.cli.main(args + ["--cpu"])
    got = cli.main(args + ["--device", "cpu"])
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert printed == got
    assert set(ref) <= set(got)  # same keys, plus the device name
    assert got["device"] == "cpu"
    for k in ("engine", "n", "steps", "n_alive", "energy_method"):
        assert got[k] == ref[k], k
    assert got["energy_initial"] == pytest.approx(ref["energy_initial"],
                                                  rel=1e-6)
    assert got["energy_final"] == pytest.approx(ref["energy_final"], rel=1e-5)
    assert got["energy_drift"] < 1e-5


def test_port_never_imports_jax():
    code = ("import sys, nbody_tpu_torch, nbody_tpu_torch.cli, "
            "nbody_tpu_torch.ops.pairwise, nbody_tpu_torch.ops._build, "
            "nbody_tpu_torch.ops.group_force, nbody_tpu_torch.ops.traversal, "
            "nbody_tpu_torch.engines.barnes_hut; "
            "bad = sorted(m for m in sys.modules "
            "if m.split('.')[0] in ('jax', 'jaxlib', 'nbody_tpu')); "
            "print(bad); sys.exit(1 if bad else 0)")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


# a small-N bh configuration (test_pallas_kernels.py:255-258's walk).  The
# pair slab is evaluated in the d-form the kernels compute: the f32 norm
# trick (mxu_blocks=True) puts ~7e-4 of rounding on the rows near the
# heavy central star in both packages (JAX's mxu vs its own d-form on this
# scene: 6.9e-4), which would hide any difference of the port's
BH_OPTIONS = dict(max_level=4, group_size=512, subgroups=16, window_pad=256,
                  frontier_cap=2048, accept_cap=1024, near_cell_cap=512,
                  near_particle_cap=1024, start_level=1, chunk_groups=1,
                  eval_tile=256, mxu_blocks=False)


def test_bh_simulation_matches_jax():
    """The bh engine in the step loop: the port (plain torch eval on the
    CPU) against the JAX package's XLA eval, f32, 3 steps."""
    pos, vel, mass = self_gravitating_disc(2999, seed=4)
    kw = dict(dt=3e-2, g_soft=0.02, theta2=1.0)
    ref = nbody_tpu.Simulation(pos, vel, mass, engine="bh",
                               engine_options=dict(BH_OPTIONS,
                                                   eval_mode="xla"),
                               dtype=jnp.float32, **kw)
    sim = Simulation(pos, vel, mass, engine="bh", engine_options=BH_OPTIONS,
                     device="cpu", **kw)
    assert sim.state.capacity == ref.state.capacity == 3072
    ref.run(3)
    sim.run(3)
    assert sim.n_alive == ref.n_alive
    (p, v, a, m), (rp, rv, ra, rm) = sim.get_points(), ref.get_points()
    # f32 roundoff of two summation orders through 3 steps: 1e-5 of the box
    # width for positions; the forces by the row metric of the kernel tests
    assert np.abs(p - np.asarray(rp)).max() < 1e-4
    assert np.abs(v - np.asarray(rv)).max() < 1e-4
    assert rel_err(a, ra) < 1e-4
    np.testing.assert_array_equal(m, np.asarray(rm))


def test_bh_cli_matches_jax_cli(capsys):
    args = ["-n", "3000", "--steps", "1", "--engine", "bh", "--json",
            "--energy"]
    ref = nbody_tpu.cli.main(args + ["--cpu"])
    got = cli.main(args + ["--device", "cpu"])
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert printed == got
    assert set(got) == set(ref) | {"device"}
    for k in ("engine", "n", "steps", "n_alive", "energy_method"):
        assert got[k] == ref[k], k
    assert got["energy_initial"] == pytest.approx(ref["energy_initial"],
                                                  rel=1e-6)
    assert got["energy_final"] == pytest.approx(ref["energy_final"], rel=1e-5)


def test_cuda_without_a_card_raises(monkeypatch, tmp_path):
    """No fallback: asking for the card where there is none raises, in the
    Simulation, the loader and the build, instead of running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    pos, vel, mass = self_gravitating_disc(10, seed=0)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Simulation(pos, vel, mass, engine="brute-pallas", device="cuda")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        _build.load_library()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(["-n", "10", "--steps", "1", "--device", "cuda"])
    # no nvcc: the build raises rather than skipping the kernels
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build()
    assert not (tmp_path / "build").exists()
