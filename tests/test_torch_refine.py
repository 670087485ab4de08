"""The port's density-adaptive Barnes-Hut path against the JAX package's:
the refined build (``ops/tree.py`` ``_build_refined``) output by output,
the refined walk's counters and forces (``bh_accel`` with
``refine_levels``), the refined potential, the config checks, the adaptive
presets and their routing (``resolve_adaptive_overrides``,
``auto_for(profile='adaptive')``, ``Simulation(engine='auto')``), and the
properties ``tests/test_refine.py`` holds the JAX package to, run on the
port.  The scenes are ``tests/test_refine.py``'s."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nbody_tpu.core.state import Bounds as JaxBounds
from nbody_tpu.ops import traversal as jt
from nbody_tpu.ops import tree as jtree
from nbody_tpu_torch.core.state import Bounds
from nbody_tpu_torch.ops import traversal as tt
from nbody_tpu_torch.ops import tree as ttree
from torch_parity import one_intra_op_thread, rel_err  # noqa: F401

STATS = ("accept_dropped", "frontier_fallback", "near_fallback", "fb_spill",
         "refine_build_dropped")
# tests/test_refine.py's starved budgets: the unrefined walk overflows on
# the core, so refinement has something to fix
STARVED = dict(max_level=4, group_size=512, subgroups=16, window_pad=128,
               near_particle_cap=256, near_cell_cap=256, frontier_cap=2048,
               accept_cap=2048, fb_cap=256, chunk_groups=1, start_level=2)
REFINED = dict(STARVED, refine_levels=2, refine_cap=512, refine_frontier=512)
EPS = 1e-2


def clustered_scene(n=4096, seed=0, sigma=0.03):
    """Half the particles in a tight core, half uniform background
    (tests/test_refine.py), float64."""
    rng = np.random.default_rng(seed)
    pos = np.concatenate([rng.normal(0, sigma, (n // 2, 3)),
                          rng.uniform(-4, 4, (n // 2, 3))])
    return pos, np.full(n, 1.0 / n)


def _both(pos, mass, dtype):
    """(JAX args, port args) of the same bits: pos, mass, bounds."""
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    p, m = pos.astype(dtype), mass.astype(dtype)
    return ((jnp.asarray(p), jnp.asarray(m),
             JaxBounds.cube((0.0, 0.0, 0.0), 10.0, dtype=jd)),
            (torch.from_numpy(p), torch.from_numpy(m),
             Bounds.cube((0.0, 0.0, 0.0), 10.0, dtype=td, device="cpu")))


# ---------------------------------------------------------------------------
# the refined build
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("cap", [64, 2])
def test_refined_build_matches_jax(cap, dtype):
    """Integer outputs equal; mass and m·pos within the double-float
    prefix sums' rounding (the port's log-step scan and JAX's
    associative_scan may differ by an ulp).  cap 2 drops flagged cells."""
    (jp, jm, jb), (tp, tm, tb) = _both(*clustered_scene(), dtype)
    kw = dict(max_level=3, refine_levels=2, refine_cap=cap,
              refine_threshold=64)
    ref = jtree.build_octree(jp, jm, jb, **kw)
    got = ttree.build_octree(tp, tm, tb, **kw)
    for name in ("order", "code_s", "leaf_starts", "refine_slot_leaf",
                 "refine_stats"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(ref, name)), name)
    assert len(got.refine_child_slot) == len(ref.refine_child_slot) == 1
    np.testing.assert_array_equal(got.refine_child_slot[0].numpy(),
                                  np.asarray(ref.refine_child_slot[0]))
    rtol = 1e-12 if dtype == "float64" else 1e-6
    for g, r in zip(got.refine_tables, ref.refine_tables):
        g, r = g.numpy(), np.asarray(r)
        np.testing.assert_array_equal(g[:, 4:], r[:, 4:])
        np.testing.assert_allclose(g[:, :4], r[:, :4], rtol=rtol,
                                   atol=rtol * np.abs(r[:, :4]).max())
    flagged, dropped = got.refine_stats.tolist()
    assert flagged > 0 and (dropped > 0) == (cap == 2)
    # the dense pyramid is the unrefined build's
    plain = ttree.build_octree(tp, tm, tb, max_level=3)
    np.testing.assert_array_equal(got.code_s.numpy(), plain.code_s.numpy())
    for g, r in zip(got.level_table, plain.level_table):
        np.testing.assert_allclose(g.numpy(), r.numpy(), rtol=rtol,
                                   atol=rtol * np.abs(r.numpy()).max())


def test_refined_children_tile_their_parents():
    """Each refined parent's eight children tile its sorted range, and a
    further-refined row's children tile that row's."""
    _, (tp, tm, tb) = _both(*clustered_scene(), "float64")
    t = ttree.build_octree(tp, tm, tb, max_level=3, refine_levels=2,
                           refine_cap=64, refine_threshold=64)
    ls = t.leaf_starts.numpy()
    parents = [(np.nonzero(t.refine_slot_leaf.numpy() >= 0)[0],
                t.refine_slot_leaf.numpy(), lambda c: (ls[c], ls[c + 1]))]
    tab0 = t.refine_tables[0].numpy()
    cm = t.refine_child_slot[0].numpy()
    parents.append((np.nonzero(cm >= 0)[0], cm,
                    lambda j: (tab0[j, 4], tab0[j, 5])))
    for (keys, slot, rng_of), tab in zip(parents, t.refine_tables):
        assert len(keys) > 0
        tab = tab.numpy()
        for c in keys:
            rows = tab[slot[c] * 8:(slot[c] + 1) * 8]
            assert (rows[0, 4], rows[-1, 5]) == rng_of(c)
            assert np.all(rows[1:, 4] == rows[:-1, 5])
            np.testing.assert_allclose(
                rows[:, 0], [t.mass_s[int(a):int(b)].sum() for a, b in
                             rows[:, 4:6]], rtol=1e-12, atol=1e-15)


def test_refine_depth_limit():
    with pytest.raises(ValueError, match="Morton code depth limit"):
        ttree.build_octree(torch.zeros((8, 3)), torch.ones(8),
                           Bounds.cube((0.0, 0.0, 0.0), 1.0, device="cpu"),
                           max_level=8, refine_levels=3)


# ---------------------------------------------------------------------------
# the refined walk
# ---------------------------------------------------------------------------

_JAX = {}


def jax_refined(dtype, mxu_blocks):
    """The JAX package's refined bh_accel on the clustered scene (XLA
    backend), cached per module: (acc, per-group and total counters)."""
    key = (dtype, mxu_blocks)
    if key not in _JAX:
        (jp, jm, jb), _ = _both(*clustered_scene(), dtype)
        jd = getattr(jnp, dtype)
        acc, st = jt.bh_accel(jp, jm, jb, jd(1.0), jd(1.0), jd(EPS),
                              jt.BHConfig(eval_mode="xla",
                                          mxu_blocks=mxu_blocks, **REFINED))
        _JAX[key] = (np.asarray(acc),
                     {k: np.asarray(v) for k, v in st.items()})
    return _JAX[key]


def port_refined(dtype, mxu_blocks):
    _, (tp, tm, tb) = _both(*clustered_scene(), dtype)
    g_soft = float(torch.tensor(EPS, dtype=getattr(torch, dtype)))
    acc, st = tt.bh_accel(tp, tm, tb, 1.0, 1.0, g_soft,
                          tt.BHConfig(mxu_blocks=mxu_blocks, **REFINED))
    return acc.numpy(), {k: v.numpy() for k, v in st.items()}


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_refined_walk_matches_jax(dtype):
    """Every walk counter equal, per group where JAX reports per group.
    float64 forces to 1e-10; float32 compares the d-form pair blocks (what
    the kernels compute): the f32 norm trick rounds ~1e-2 of the median
    |a| next to this scene's core in both packages, so their difference
    there says nothing about the port."""
    mxu = dtype == "float64"
    ref, ref_st = jax_refined(dtype, mxu)
    got, st = port_refined(dtype, mxu)
    for k in STATS + ("near_totals", "refine_near_totals"):
        np.testing.assert_array_equal(st[k], ref_st[k], k)
    assert st["refine_near_totals"].sum() > 0
    assert min(st["near_fallback"], st["fb_spill"]) > 0
    if dtype == "float64":
        np.testing.assert_allclose(got, ref, rtol=1e-10,
                                   atol=1e-10 * np.abs(ref).max())
    else:
        scale = np.median(np.linalg.norm(ref, axis=1))
        assert np.linalg.norm(got - ref, axis=1).max() / scale < 1e-5


# the refined budgets binding with three refined levels: (a) the
# refined-near particle cap (512; groups reach 502-512), (b) the refined
# frontier (2 parents a level against up to 8 wanted) and the refined-near
# cell cap (4 ranges a group)
OVERFLOW = dict(STARVED, fb_cap=64, chunk_groups=4, refine_levels=3,
                refine_cap=512, refine_threshold=32)
OVERFLOWS = {"particle-cap": dict(refine_frontier=256,
                                  refine_near_particle_cap=512,
                                  refine_near_cell_cap=16),
             "frontier-and-cell-cap": dict(refine_frontier=16,
                                           refine_near_particle_cap=4096,
                                           refine_near_cell_cap=4)}


@pytest.mark.parametrize("case", list(OVERFLOWS))
def test_refined_budget_overflow_matches_jax(case):
    """Where the refined budgets overflow (cells degrade to the fallback
    slab, and from there spill), the counters and float64 forces are the
    JAX package's."""
    (jp, jm, jb), (tp, tm, tb) = _both(*clustered_scene(), "float64")
    kw = dict(OVERFLOW, **OVERFLOWS[case])
    ref, ref_st = jt.bh_accel(jp, jm, jb, 1.0, 1.0, EPS,
                              jt.BHConfig(eval_mode="xla", **kw))
    got, st = tt.bh_accel(tp, tm, tb, 1.0, 1.0, EPS, tt.BHConfig(**kw))
    for k in STATS + ("near_totals", "refine_near_totals"):
        np.testing.assert_array_equal(st[k].numpy(), np.asarray(ref_st[k]),
                                      k)
    assert min(int(st["near_fallback"]), int(st["fb_spill"])) > 0
    ref = np.asarray(ref)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-10,
                               atol=1e-10 * np.abs(ref).max())


def test_refined_kernel_glue_matches_plain_eval(monkeypatch):
    """eval_mode 'pallas' forced on CPU tensors runs the kernel wrappers'
    plain twins on the refined slab (near list + refined-near rows): the
    same walk and the d-form forces of the 'xla' eval, within
    test_torch_traversal.py's glue bound (max row over mean row: the twins
    sum by tiles, another f32 order)."""
    ref, ref_st = port_refined("float32", False)
    monkeypatch.setattr(tt, "_resolve_eval_mode", lambda cfg, t: "pallas")
    got, st = port_refined("float32", True)
    for k in STATS + ("refine_near_totals",):
        np.testing.assert_array_equal(st[k], ref_st[k], k)
    assert rel_err(got, ref) < 1e-5


def test_refined_potential_matches_jax():
    (jp, jm, jb), (tp, tm, tb) = _both(*clustered_scene(n=2048), "float64")
    u_ref, s_ref = jt.bh_potential(jp, jm, jb, 1.0, 1.0, 0.1,
                                   jt.BHConfig(**REFINED))
    u, s = tt.bh_potential(tp, tm, tb, 1.0, 1.0, 0.1, tt.BHConfig(**REFINED))
    assert abs(float(u) - float(u_ref)) <= 1e-10 * abs(float(u_ref))
    assert {k: int(v) for k, v in s.items()} == {
        k: int(v) for k, v in s_ref.items()}


def _brute(pos, mass, eps):
    d = pos[None, :, :] - pos[:, None, :]
    r2 = (d * d).sum(-1) + eps * eps
    np.fill_diagonal(r2, np.inf)
    return (d * (mass[None, :, None] * r2[:, :, None] ** -1.5)).sum(1)


def test_refinement_fixes_dense_core_error():
    """tests/test_refine.py's property, on the port: the starved walk's
    core error is catastrophic, two refined levels bring its p99 under
    1e-2, with nothing dropped."""
    pos, mass = clustered_scene()
    ref = _brute(pos.astype(np.float32).astype(np.float64), mass, EPS)
    nref = np.linalg.norm(ref, axis=1)
    floor = 0.05 * np.median(nref)

    def p99(acc):
        return np.percentile(np.linalg.norm(acc - ref, axis=1)
                             / np.maximum(nref, floor), 99)

    _, (tp, tm, tb) = _both(pos, mass, "float32")
    a0, _ = tt.bh_accel(tp, tm, tb, 1.0, 1.0, EPS, tt.BHConfig(**STARVED))
    a2, s2 = port_refined("float32", True)
    assert p99(a0.numpy()) > 0.5
    assert p99(a2) < 1e-2
    assert s2["refine_near_totals"].sum() > 0
    assert int(s2["refine_build_dropped"]) == 0
    assert int(s2["accept_dropped"]) == 0


def test_refined_matches_unrefined_on_uniform_scene():
    """No cell above the threshold: empty refined tables, and the forces
    of the unrefined walk to f32 roundoff (the deep sort reorders only
    within leaf cells)."""
    rng = np.random.default_rng(3)
    pos = torch.from_numpy(rng.uniform(-4, 4, (2048, 3)).astype(np.float32))
    mass = torch.full((2048,), 1.0 / 2048)
    b = Bounds.cube((0.0, 0.0, 0.0), 10.0, device="cpu")
    a0, _ = tt.bh_accel(pos, mass, b, 1.0, 1.0, EPS, tt.BHConfig(**STARVED))
    a1, s1 = tt.bh_accel(pos, mass, b, 1.0, 1.0, EPS, tt.BHConfig(
        **STARVED, refine_levels=2, refine_cap=256, refine_frontier=512,
        refine_threshold=4096))
    assert int(s1["refine_near_totals"].sum()) == 0
    scale = np.median(np.linalg.norm(a0.numpy(), axis=1))
    np.testing.assert_allclose(a1.numpy(), a0.numpy(), atol=1e-4 * scale,
                               rtol=1e-3)


def test_unrefined_tree_is_refused():
    _, (tp, tm, tb) = _both(*clustered_scene(n=1024), "float32")
    plain = ttree.build_octree(tp, tm, tb.centered(), 4)
    with pytest.raises(ValueError, match="without refinement"):
        tt.traverse_tree(plain, tb.centered(), 1.0, 1.0, EPS,
                         tt.BHConfig(**REFINED), 1024)


# ---------------------------------------------------------------------------
# config checks, presets and routing
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kw", [
    dict(max_level=8, refine_levels=3),
    dict(max_level=4, refine_levels=2, fb_quad=True, quad_leaf=True),
    dict(max_level=4, refine_levels=2, refine_frontier=100),
    dict(max_level=4, refine_levels=2, refine_frontier=0)])
def test_refine_config_errors_match_jax(kw):
    with pytest.raises(ValueError) as ref:
        jt.BHConfig(**kw)
    with pytest.raises(ValueError) as got:
        tt.BHConfig(**kw)
    assert str(got.value) == str(ref.value)


def test_refine_config_wide_and_threshold():
    """The wide-format refusal carries the JAX text; the threshold's auto
    resolution is the JAX package's."""
    with pytest.raises(ValueError) as ref:
        jt.BHConfig(max_level=4, refine_levels=2, wide=True)
    with pytest.raises(ValueError, match="wide row format") as got:
        tt.BHConfig(max_level=4, refine_levels=2, wide=True)
    assert str(got.value) == str(ref.value)
    for kw in (dict(near_particle_cap=777), dict(refine_threshold=9)):
        assert (tt.BHConfig(**kw).refine_threshold_resolved
                == jt.BHConfig(**kw).refine_threshold_resolved)
    cfg = dict(max_level=4, refine_levels=3)
    assert len(tt.BHConfig(**cfg).cell_w2s(torch.tensor(10.0))) == 8


def test_adaptive_presets_match_jax():
    for name in ("ADAPTIVE_OVERRIDES", "ADAPTIVE_TIGHT_OVERRIDES",
                 "ADAPTIVE_MIDN_OVERRIDES", "_ADAPTIVE_BIG_BUDGETS",
                 "ADAPTIVE_CUT_MIN_N", "DEEP_FRAC", "STEEP_CONTRAST"):
        assert getattr(tt, name) == getattr(jt, name), name
    for n in (4096, 131072, 262144, 262145, 1 << 20, 3 << 20):
        assert dataclasses.asdict(tt.BHConfig.auto_for(
            n, profile="adaptive")) == dataclasses.asdict(
                jt.BHConfig.auto_for(n, profile="adaptive")), n


@pytest.fixture(scope="module")
def plummers():
    """The bench's adaptive scenes: Plummer spheres (seed 0) at 131072 and
    2^20 with |pos| <= 20 kept (bench.py:181-189)."""
    from nbody_tpu_torch.scenes import plummer_sphere

    out = {}
    for n in (131072, 1 << 20):
        pos = plummer_sphere(n, seed=0)[0]
        out[n] = pos[np.all(np.abs(pos) <= 20.0, axis=1)]
    return out


@pytest.mark.parametrize("n,width,stack", [
    (131072, 10.0, "ADAPTIVE_MIDN_OVERRIDES"),
    (131072, 40.0, "ADAPTIVE_MIDN_OVERRIDES"),
    (1 << 20, 10.0, "ADAPTIVE_TIGHT_OVERRIDES"),
    (1 << 20, 40.0, "ADAPTIVE_OVERRIDES")])
def test_resolve_adaptive_overrides_matches_jax(plummers, n, width, stack):
    pos = plummers[n]
    occ = tt.scene_occupancy(pos, (0.0, 0.0, 0.0), width)
    assert occ == jt.scene_occupancy(pos, (0.0, 0.0, 0.0), width)
    assert tt.detect_scene_profile(pos, (0, 0, 0), width, occ) == "adaptive"
    got = tt.resolve_adaptive_overrides(pos, (0.0, 0.0, 0.0), width,
                                        occupancy=occ)
    assert got == jt.resolve_adaptive_overrides(pos, (0.0, 0.0, 0.0), width,
                                                occupancy=occ)
    assert got == getattr(tt, stack)


def test_auto_simulation_routes_as_jax(capsys):
    """Simulation(engine='auto') on a 70000 Plummer sphere resolves the
    same engine options as the JAX package's, with the same printed line;
    constructing either runs no step."""
    import nbody_tpu
    from nbody_tpu_torch import Simulation
    from nbody_tpu_torch.scenes import plummer_sphere

    pos, vel, mass = plummer_sphere(70000, seed=0)
    kw = dict(engine="auto", bounds_width=40.0)
    ref = nbody_tpu.Simulation(pos, vel, mass, dtype=jnp.float32, **kw)
    ref_out = capsys.readouterr().out
    sim = Simulation(pos, vel, mass, device="cpu", **kw)
    assert capsys.readouterr().out == ref_out
    assert "steep-core scene detected" in ref_out
    assert sim.engine.name == ref.engine.name == "bh"
    assert sim.engine_options == ref.engine_options
    # profile='adaptive' alone resolves the scene's stack, printed alike
    kw = dict(engine="bh", bounds_width=40.0,
              engine_options=dict(profile="adaptive"))
    ref = nbody_tpu.Simulation(pos, vel, mass, dtype=jnp.float32, **kw)
    ref_out = capsys.readouterr().out
    sim = Simulation(pos, vel, mass, device="cpu", **kw)
    assert capsys.readouterr().out == ref_out
    assert sim.engine_options == ref.engine_options


def test_adaptive_engine_runs_the_refined_walk():
    """The adaptive engine on the CPU: its config is the resolved stack at
    the state's capacity, and a step stays finite."""
    from nbody_tpu_torch import Simulation
    from nbody_tpu_torch.engines import get_engine

    eng = get_engine("bh", profile="adaptive")
    assert "refine_levels=3" in eng.description
    pos, mass = clustered_scene(n=2048)
    sim = Simulation(pos, np.zeros_like(pos), mass, engine="bh",
                     engine_options=dict(REFINED), device="cpu",
                     dt=1e-3, g_soft=EPS)
    sim.run(1)
    assert np.all(np.isfinite(sim.get_points()[0]))
