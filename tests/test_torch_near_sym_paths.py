"""``BHConfig.near_sym`` through the paths around the walk: block-dual
(against the dense sum and the JAX package), the rim assembly at the
clamped window edges, the kernel-mode glue (the wrappers' plain twins on
the CPU) and the ``Simulation`` surface.  The parity of the walk itself is
tests/test_torch_near_sym.py."""

import numpy as np
import pytest
import torch

from nbody_tpu_torch import Simulation
from nbody_tpu_torch.core.state import SimParams
from nbody_tpu_torch.engines.brute_force import force_dense
from nbody_tpu_torch.ops import group_force as gf
from nbody_tpu_torch.ops import traversal as tt
from nbody_tpu_torch.scenes import self_gravitating_disc
from torch_near_sym_cases import (DUAL_CFG, SYM_CFG, disc_inputs, jax_bh,
                                  port_bh, row_rel)


@pytest.mark.parametrize("base", [SYM_CFG, DUAL_CFG], ids=["sym", "wide"])
def test_near_sym_with_block_dual_against_dense(base):
    """With block_dual the slab tiling changes (rim + near instead of
    window + near), so the accepted tile sets legitimately differ: both
    walks against the dense sum, in the envelope of
    tests/test_near_sym.py:84-105, and the near_sym walk equal to JAX's."""
    cfg = dict(base, multipole="quad", block_dual=True, dual_margin=1.2)
    pos, mass = disc_inputs("float32")
    params = SimParams.create(dt=3e-2, g_soft=0.02, theta2=1.0,
                              bounds_width=10.0, device="cpu")
    ref = force_dense(torch.from_numpy(pos), torch.from_numpy(mass),
                      params).numpy()
    a0, _, m = port_bh("float32", cfg)
    a1, s1, _ = port_bh("float32", dict(cfg, near_sym=True))
    j1, js1, _ = jax_bh("float32", dict(cfg, near_sym=True))
    assert s1 == js1
    assert (s1["dual_tiles"] > 0) == (base is DUAL_CFG)
    assert np.isfinite(a1).all()
    e0, e1 = row_rel(a0, ref, m), row_rel(a1, ref, m)
    p99_0 = float(np.percentile(e0, 99))
    assert float(np.percentile(e1, 99)) <= max(1.3 * p99_0, p99_0 + 1e-3)
    assert float(np.median(e1)) <= max(3 * float(np.median(e0)), 1e-4)
    assert float(np.median(row_rel(a1, j1, m))) < 1e-5


def test_split_window_edges():
    """The rim and the group's own columns partition each window: at the
    clamped first and last groups the group sits at the window's two ends,
    off = 0 and off = 2 * window_pad."""
    B, W, G = 8, 16, 4
    pmass8 = torch.arange(G * B * 8, dtype=torch.float64).reshape(G * B, 8)
    pmass8[:, 3] = 1.0
    tgt8 = pmass8.reshape(G, B, 8)
    wstart = torch.tensor([0, 4, 12, 16], dtype=torch.int32)
    wmask = torch.ones((G, W), dtype=torch.bool)
    wmask[1, 0] = False  # the first rim row of group 1
    wmask[2, 5] = False  # a central row of group 2 (off = 4)
    rim, mcen = tt._split_window(pmass8, tgt8, wstart, wmask, W)
    rows = rim[..., 0].long() // 8
    assert rows.tolist() == [[8, 9, 10, 11, 12, 13, 14, 15],
                             [4, 5, 6, 7, 16, 17, 18, 19],
                             [12, 13, 14, 15, 24, 25, 26, 27],
                             [16, 17, 18, 19, 20, 21, 22, 23]]
    assert rim[1, 0, 3] == 0.0 and rim[..., 3].sum() == G * (W - B) - 1
    assert mcen[2, 1] == 0.0 and mcen.sum() == G * B - 1


@pytest.mark.parametrize("multipole", ["mono", "quad"])
def test_kernel_mode_glue_near_sym(multipole, monkeypatch):
    """eval_mode 'pallas' forced on CPU tensors: the wrappers (K5 among
    them) run their plain twins, which exercises the kernel path's glue; it
    must agree with the 'xla' d-form eval and take the same walk."""
    cfg = dict(SYM_CFG, multipole=multipole, near_sym=True)
    ref, ref_stats, m = port_bh("float32", cfg)
    monkeypatch.setattr(tt, "_resolve_eval_mode", lambda cfg, t: "pallas")
    calls = []
    monkeypatch.setattr(gf, "group_self_force",
                        lambda *a: calls.append(a) or
                        gf.group_self_force_plain(*a))
    got, stats, _ = port_bh("float32", cfg)
    assert len(calls) == 1 and tuple(calls[0][0].shape) == (16, 512, 8)
    assert stats == ref_stats
    assert float(np.median(row_rel(got, ref, m))) < 1e-5
    assert float(row_rel(got, ref, m).max()) < 5e-3


def test_near_sym_simulation_matches_plain_bh():
    """The user surface: Simulation(engine='bh', engine_options=
    {'near_sym': True}) steps as the plain bh engine does."""
    pos, vel, mass = self_gravitating_disc(3999, seed=4)
    opts = dict(SYM_CFG, mxu_blocks=False)
    kw = dict(engine="bh", device="cpu", dt=3e-2, g_soft=0.02,
              dtype=torch.float64)
    sym = Simulation(pos, vel, mass, engine_options=dict(opts, near_sym=True),
                     **kw)
    base = Simulation(pos, vel, mass, engine_options=opts, **kw)
    assert "near_sym=True" in sym.engine.description
    sym.run(3)
    base.run(3)
    assert sym.n_alive == base.n_alive
    for a, b in zip(sym.get_points(), base.get_points()):
        np.testing.assert_allclose(a, b, rtol=1e-9, atol=1e-12)
