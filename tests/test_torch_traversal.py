"""The port's Barnes-Hut walk and evaluation (``ops/traversal.py``) against
the JAX package's on the same seeded disc: the ``auto_for`` presets field by
field, ``bh_accel`` forces and walk statistics, theta^2 = 0 against the
direct sum, and the kernel-mode glue (slab padding, mask grid, tile fitting)
run through the plain twins."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nbody_tpu.core.state import Bounds as JaxBounds
from nbody_tpu.ops import traversal as jt
from nbody_tpu_torch.core.state import Bounds, SimParams
from nbody_tpu_torch.engines.brute_force import force_dense
from nbody_tpu_torch.ops import collect_walk as cw
from nbody_tpu_torch.ops import traversal as tt
import torch_collect_emulator as emulator
import torch_walk_cases as walk_cases
from torch_parity import disc, jax_fields, rel_err

STATS = ("accept_dropped", "frontier_fallback", "near_fallback", "fb_spill")

# test_pallas_kernels.py:255-258 (N = 3000, capacity 4096)
BASE = dict(max_level=4, group_size=512, subgroups=16, window_pad=256,
            frontier_cap=2048, accept_cap=1024, near_cell_cap=512,
            near_particle_cap=1024, start_level=1, chunk_groups=1,
            eval_tile=256)
# small groups under a wide window: block-dual accepts tile pairs here (43
# of them), where BASE with block_dual accepts none
DUAL = dict(BASE, group_size=128, subgroups=8, window_pad=1024,
            eval_tile=128, block_dual=True, dual_margin=1.2)

CASES = {
    "quad": BASE,
    "mono": dict(BASE, multipole="mono"),
    "dual-quad": DUAL,
    "dual-mono": dict(DUAL, multipole="mono"),
    # starved budgets: frontier and near-field fallbacks, and fallback-slab
    # spills into the multipole slab (the 1M tier runs ~10k and ~2.7k a step)
    "budgets": dict(BASE, near_particle_cap=128, near_cell_cap=64,
                    fb_cap=8, frontier_schedule=(16, 64, 64)),
}


@pytest.mark.parametrize("n", [4096, 100096, 1 << 20, 3 << 20])
@pytest.mark.parametrize("profile", ["fast", "accurate", "dense"])
def test_auto_for_matches_jax(n, profile):
    ref = dataclasses.asdict(jt.BHConfig.auto_for(n, profile=profile))
    got = jax_fields(tt.BHConfig.auto_for(n, profile=profile))
    assert got == ref


def test_fit_chunks_matches_jax():
    for cg in (1, 3, 8):
        for n_groups in (1, 6, 25, 128):
            for multiple in (1, 2, 4):
                assert tt.fit_chunks(cg, n_groups, multiple) == \
                    jt.fit_chunks(cg, n_groups, multiple)


def _inputs(dtype):
    st, _, _, _, _ = disc(3000, 4096, kill=17)
    jd = getattr(jnp, dtype)
    return np.array(st.pos.astype(jd)), np.array(st.effective_mass().astype(jd))


_JAX = {}


def jax_bh(dtype, case, **over):
    """The JAX package's bh_accel (its XLA backend), cached per module."""
    key = (dtype, case, tuple(sorted(over.items())))
    if key not in _JAX:
        pos, mass = _inputs(dtype)
        jd = getattr(jnp, dtype)
        acc, stats = jt.bh_accel(
            jnp.asarray(pos), jnp.asarray(mass),
            JaxBounds.cube([0.0, 0.0, 0.0], 10.0, dtype=jd),
            jnp.asarray(1.0, jd), jnp.asarray(1.0, jd), jnp.asarray(0.02, jd),
            jt.BHConfig(eval_mode="xla", **CASES[case], **over))
        _JAX[key] = (np.asarray(acc),
                     {k: int(stats[k]) for k in STATS + ("dual_tiles",)})
    return _JAX[key]


def port_bh(dtype, case, **over):
    pos, mass = _inputs(dtype)
    td = getattr(torch, dtype)
    g_soft = float(torch.tensor(0.02, dtype=td))
    acc, stats = tt.bh_accel(
        torch.from_numpy(pos), torch.from_numpy(mass),
        Bounds.cube([0.0, 0.0, 0.0], 10.0, dtype=td, device="cpu"), 1.0, 1.0,
        g_soft,
        tt.BHConfig(**CASES[case], **over))
    return acc.numpy(), {k: int(stats[k]) for k in STATS + ("dual_tiles",)}


@pytest.mark.parametrize("case", list(CASES))
def test_bh_accel_matches_jax_f64(case):
    ref, ref_stats = jax_bh("float64", case)
    got, stats = port_bh("float64", case)
    assert stats == ref_stats
    assert (stats["dual_tiles"] > 0) == case.startswith("dual")
    if case == "budgets":
        assert min(stats["frontier_fallback"], stats["near_fallback"],
                   stats["fb_spill"]) > 0
    np.testing.assert_allclose(got, ref, rtol=1e-10, atol=1e-10 * np.abs(
        ref).max())


@pytest.mark.parametrize("case", list(CASES))
def test_bh_accel_matches_jax_f32(case):
    """Quadrupole runs use the default norm-trick pair blocks
    (mxu_blocks=True).  Monopole runs put the accepted nodes, far from the
    group frame's centre, into the same pair slab, where the f32 norm trick
    carries ~1e-3 rounding in both packages (measured against f64: JAX
    1.1e-3, port 6.4e-4), so their difference says nothing about the port;
    those runs compare the d-form (mxu_blocks=False), which the kernels
    compute."""
    over = dict(mxu_blocks=False) if "mono" in case else {}
    ref, ref_stats = jax_bh("float32", case, **over)
    got, stats = port_bh("float32", case, **over)
    assert stats == ref_stats
    assert rel_err(got, ref) < 1e-5


@pytest.mark.parametrize("case", list(CASES))
def test_kernel_mode_glue_matches_plain_eval(case, monkeypatch):
    """eval_mode 'pallas' runs the kernels on the card; forced on CPU
    tensors its wrappers run the plain twins, which exercises the slab
    padding, tile fitting and mask grid of the kernel path.  It must agree
    with the 'xla' d-form eval (held against the JAX package above) and
    take the same walk."""
    ref, ref_stats = port_bh("float32", case, mxu_blocks=False)
    monkeypatch.setattr(tt, "_resolve_eval_mode", lambda cfg, t: "pallas")
    got, stats = port_bh("float32", case)
    assert stats == ref_stats
    assert rel_err(got, ref) < 1e-5


def test_theta_zero_is_the_direct_sum():
    """theta^2 = 0 accepts no node: window + near field is the exact sum
    (test_barnes_hut.py:71-88)."""
    from nbody_tpu_torch.scenes import self_gravitating_disc
    from nbody_tpu_torch.core.state import ParticleState

    p, v, m = self_gravitating_disc(300, seed=0)
    st = ParticleState.create(p, v, m, dtype=torch.float64, device="cpu")
    params = SimParams.create(g_soft=0.02, theta2=0.0, dtype=torch.float64,
                              device="cpu")
    mass = st.effective_mass()
    cfg = tt.BHConfig(max_level=4, group_size=64, window_pad=64,
                      frontier_cap=4096, near_cell_cap=2048,
                      near_particle_cap=512, start_level=1, chunk_groups=2)
    acc, stats = tt.bh_accel(st.pos, mass, params.bounds, params.theta2,
                             params.g, params.g_soft, cfg)
    assert int(stats["frontier_fallback"]) == 0
    assert int(stats["near_fallback"]) == 0
    ref = force_dense(st.pos, mass, params)
    alive = st.alive.numpy()
    np.testing.assert_allclose(acc.numpy()[alive], ref.numpy()[alive],
                               rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("field,value,item", [
    ("refine_levels", 2, "item 15"), ("sliding_window", True, "item 16"),
    ("delta_onepass", True, "item 16"), ("wide", True, "item 17"),
    ("quad_leaf", True, "item 18"), ("fb_quad", True, "item 18"),
    ("dim", 2, "item 18")])
def test_unported_fields_raise(field, value, item):
    """Each field of ROADMAP items 15-18 is ported (the name is kept from
    when some were refused): each is accepted as the JAX package accepts
    it, the config equals the JAX package's, and JAX's own checks raise
    with JAX's texts (fb_quad without quad_leaf; the Morton depth limit,
    10 in 3D, 15 in 2D; refine_frontier a multiple of the branch factor;
    wide with refine_levels, and wide with walk reuse or on the
    single-chip walk, which has no target leaf codes)."""
    if item == "item 17":
        for cfg_cls in (tt.BHConfig, jt.BHConfig):
            with pytest.raises(ValueError) as e:
                cfg_cls(refine_levels=2, **{field: value})
            assert "refine_levels does not support the wide row format" \
                in str(e.value)
        for fn in (tt.traverse_tree_cached, jt.traverse_tree_cached):
            with pytest.raises(ValueError, match="walk reuse supports "
                               "neither wide mode nor near_sym"):
                fn(None, None, 1.0, 1.0, 0.02, fn.__globals__["BHConfig"](
                    wide=True), 8)
        _st, _p, pos, mass, _alive = disc(100, 128)
        with pytest.raises(ValueError, match="requires target leaf codes"):
            tt.bh_accel(pos, mass, Bounds.cube((0.0, 0.0, 0.0), 10.0,
                                               device="cpu"), 1.0, 1.0, 0.02,
                        tt.BHConfig(wide=True, max_level=3, group_size=64,
                                    subgroups=8, start_level=1))
    kw = {field: value}
    if field == "fb_quad":
        for cfg_cls in (tt.BHConfig, jt.BHConfig):
            with pytest.raises(ValueError,
                               match="fb_quad=True requires quad_leaf=True"):
                cfg_cls(**kw)
        kw["quad_leaf"] = True
    cfg = tt.BHConfig(**kw)
    assert getattr(cfg, field) == value
    assert jax_fields(cfg) == dataclasses.asdict(jt.BHConfig(**kw))
    if field == "refine_levels":
        with pytest.raises(ValueError, match="3D Morton depth limit"):
            tt.BHConfig(max_level=9, **kw)
    if field == "dim":
        refined = dict(kw, refine_levels=2, refine_frontier=36)
        assert tt.BHConfig(max_level=13, **refined).branch == 4
        for cfg_cls in (tt.BHConfig, jt.BHConfig):
            with pytest.raises(ValueError, match="2D Morton depth limit"):
                cfg_cls(max_level=14, **refined)
            with pytest.raises(ValueError, match="multiple of 4, got 38"):
                cfg_cls(**dict(refined, refine_frontier=38))


def test_eval_modes():
    pos, mass = _inputs("float32")
    args = (torch.from_numpy(pos), torch.from_numpy(mass),
            Bounds.cube([0.0, 0.0, 0.0], 10.0, device="cpu"), 1.0, 1.0, 0.02)
    with pytest.raises(ValueError, match="CUDA tensors"):
        tt.bh_accel(*args, tt.BHConfig(eval_mode="pallas", **BASE))
    with pytest.raises(ValueError, match="eval_mode"):
        tt.BHConfig(eval_mode="mosaic")
    assert jax_fields(tt.BHConfig.auto_for(
        1 << 20, profile="adaptive")) == dataclasses.asdict(
            jt.BHConfig.auto_for(1 << 20, profile="adaptive"))
    a, _ = tt.bh_accel(*args, tt.BHConfig(eval_mode="xla", **BASE))
    b, _ = tt.bh_accel(*args, tt.BHConfig(**BASE))  # auto on CPU = xla
    np.testing.assert_array_equal(a.numpy(), b.numpy())


@pytest.mark.parametrize("name", ["100k", "2d-sharded", "2d-offset-f64",
                                  "budgets"])
def test_walk_kernel_arguments_give_the_twins_walk(name):
    """The collect walk kernel's packed arguments (``collect_walk.pack``)
    run through the kernel's numpy restatement
    (tests/torch_collect_emulator.py) give the plain twin's dense walk bit
    for bit: the slabs, lists, counters, offsets, diff array, window mask
    and frame; on the 100k tier, a 2D state's group slice with the
    sliding window, a 2D float64 walk with accept_offset and
    delta_onepass, and budgets cut so every counter fires."""
    args = walk_cases.case(name, "cpu")
    twin = tt._collect_dense(*args)
    got = emulator.collect(*args)
    assert walk_cases.mismatches(got, twin, args[5]) == []
    assert "wmask" in got and "gc" not in got
    if name == "budgets":
        assert all(int(twin[k].sum()) > 0 for k in walk_cases.COUNTERS)


def test_walk_kernel_plan():
    """The kernel's static arguments: a dense level's parent cap is its
    schedule's next frontier over the branch, the shared memory holds the
    boxes and two frontier buffers, and what the kernel cannot run is
    refused before any launch."""
    cfg = tt.BHConfig.auto_for(100096)
    pl = cw.plan(cfg, torch.float32)
    assert pl["parent_cap"][3:7] == [s // 8 for s in cfg.schedule()]
    assert pl["parent_cap"][7:] == [0] * 9
    assert pl["max_parents"] == 256 and pl["rf_parent_cap"] == 0
    assert pl["smem"] == 6 * 64 * 4 + 2 * 256 * 4
    dom = cw.plan(tt.BHConfig.auto_for(1 << 23, profile="domain"),
                  torch.float64)
    assert dom["max_parents"] == 2048
    assert dom["smem"] == 6 * 128 * 8 + 2 * 2048 * 4
    with pytest.raises(TypeError, match="float32 or float64"):
        cw.plan(cfg, torch.float16)
    with pytest.raises(ValueError, match="levels"):
        cw.plan(tt.BHConfig(dim=2, max_level=16, start_level=3),
                torch.float32)
    with pytest.raises(ValueError, match="shared"):
        cw.plan(tt.BHConfig.auto_for(1 << 23, frontier_cap=1 << 19,
                                     max_level=9), torch.float32)
    with pytest.raises(ValueError, match="CUDA tensors"):
        cw.group_collect(*walk_cases.case("budgets", "cpu"))

