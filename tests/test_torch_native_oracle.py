"""The port against the native C++ oracle (``native/oracle.cpp``, a serial
strict-FP float64 implementation of the same physics), built through the
port's own binding (``nbody_tpu_torch/utils/native.py``), with the bounds of
tests/test_native_oracle.py; and the build leaves ``native/`` as it is."""

import hashlib
from pathlib import Path

import numpy as np
import pytest
import torch

from nbody_tpu_torch.core.energy import total_energy
from nbody_tpu_torch.core.state import ParticleState, SimParams
from nbody_tpu_torch.core.stepper import make_run
from nbody_tpu_torch.engines.brute_force import force_dense, force_tiled
from nbody_tpu_torch.scenes import self_gravitating_disc
from nbody_tpu_torch.utils import native
from torch_parity import one_intra_op_thread  # noqa: F401  (autouse)

NATIVE = Path(native.SOURCE).parent


def _f64(pos, vel, mass, **kw):
    return (ParticleState.create(pos, vel, mass, dtype=torch.float64),
            SimParams.create(dtype=torch.float64, g_soft=0.02, **kw))


@pytest.mark.parametrize("force", [force_dense, force_tiled])
def test_forces_match_oracle(force):
    pos, vel, mass = self_gravitating_disc(300, seed=4)
    want = native.oracle_forces(pos, mass, method="brute", g_soft=0.02)
    st, params = _f64(pos, vel, mass)
    got = force(st.pos, st.effective_mass(), params).numpy()
    alive = st.alive.numpy()
    np.testing.assert_allclose(got[alive], want, rtol=1e-12, atol=1e-14)


def test_energy_matches_oracle():
    pos, vel, mass = self_gravitating_disc(200, seed=5)
    want = native.oracle_energy(pos, vel, mass, g_soft=0.02)
    st, params = _f64(pos, vel, mass)
    got = float(total_energy(st, params, tile=64))
    np.testing.assert_allclose(got, want, rtol=1e-12)


def _drift_pair(n, dt, steps, seed):
    """Energy drift of the port's float64 leapfrog and of the oracle's over
    the same run, and the survivors' centres of mass."""
    pos, vel, mass = self_gravitating_disc(n, seed=seed)
    p1, v1, m1 = native.oracle_run(pos, vel, mass, method="brute",
                                   steps=steps, dt=dt, g_soft=0.02)
    e0 = native.oracle_energy(pos, vel, mass, g_soft=0.02)
    e_oracle = native.oracle_energy(p1, v1, m1, g_soft=0.02)
    st, params = _f64(pos, vel, mass, dt=dt, bounds_width=10.0)
    out = make_run(force_tiled)(st, params, steps)
    e_ours = float(total_energy(out, params))
    assert int(out.n_alive()) == len(m1), "culling parity"
    pp, _, _, mm = out.get_points()
    return (abs((e_ours - e0) / e0), abs((e_oracle - e0) / e0),
            (pp * mm[:, None]).sum(0) / mm.sum(),
            (p1 * m1[:, None]).sum(0) / m1.sum())


def test_energy_drift_parity_resolved_1000_steps():
    """The drift of the port and of the oracle agree to 1e-6 over 1000
    resolved-dt steps, where the drift belongs to the scheme."""
    ours, oracle, com_p, com_o = _drift_pair(300, 1e-3, 1000, seed=6)
    assert abs(ours - oracle) < 1e-6, (ours, oracle)
    np.testing.assert_allclose(com_p, com_o, atol=1e-9)


def test_energy_drift_parity_benchmark_config():
    """At dt 3e-2 the disc is chaotic: the drift level still agrees to 5%."""
    ours, oracle, com_p, com_o = _drift_pair(300, 3e-2, 1000, seed=6)
    assert abs(ours - oracle) / max(oracle, 1e-12) < 0.05, (ours, oracle)
    np.testing.assert_allclose(com_p, com_o, atol=1e-3)


def test_build_leaves_native_untouched(tmp_path, monkeypatch):
    """A fresh build (into a temporary build directory) compiles
    ``native/oracle.cpp`` and writes nothing under ``native/``."""
    def snapshot():
        return {p.name: (p.stat().st_mtime_ns,
                         hashlib.sha256(p.read_bytes()).hexdigest())
                for p in sorted(NATIVE.iterdir())}

    before = snapshot()
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    lib = Path(native.build())
    assert lib.parent == tmp_path and lib.exists()
    assert native.build() == str(lib)  # keyed by the source: reused
    assert snapshot() == before
