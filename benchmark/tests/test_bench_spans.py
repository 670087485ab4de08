"""The span readers on the CPU: a traced run of the small batch cell reads
the program's spans (the six span readers), while the readers that need
the card's trace (``engine_idle_ms``, ``k3_counted_roofline_pct``) read
nothing; the recorder is off after it and through a ``--trace 0`` run."""

from conftest import run_cell

SPAN_READERS = ("step_ms", "build_ms", "walk_ms", "fb_eval_ms",
                "assembly_ms", "kernels_ms")
CARD_READERS = ("engine_idle_ms", "k3_counted_roofline_pct",
                "k3_roofline_pct")


def test_a_traced_run_reads_the_spans_and_leaves_the_recorder_off(tree):
    from nbody_tpu_torch.utils import profiling

    try:
        rc, result, err = run_cell(tree, "disc-tiny.batch", seed=2**31 + 23,
                                   seconds=2.0, trace=1)
        assert rc == 0 and result["correct"], err
        got = result["metrics"]
        for name in SPAN_READERS:
            assert got[name]["value"] > 0 and got[name]["unit"] == "ms"
        parts = sum(got[n]["value"] for n in SPAN_READERS[1:])
        assert parts < got["step_ms"]["value"]
        for name in CARD_READERS:
            assert name not in got
        assert not profiling.SPANS.on
        rc, result, err = run_cell(tree, "disc-tiny.batch", seed=2**31 + 29,
                                   seconds=0.5, trace=0)
        assert rc == 0 and set(result["metrics"]) == {"steps_per_s",
                                                      "setup_s"}
        assert not profiling.SPANS.on
    finally:
        profiling.SPANS.disable()


def _run_with(counters, device_ops, steps=2):
    from harness.main import Run
    from harness.trace import Slice

    sl = Slice(steps=steps, wall_s=1.0, device_ops=device_ops, busy_s=0.0,
               counters=counters)
    return Run(cell={}, config={}, traffic={}, setup_s=1.0,
               window={"seconds": 1.0}, slice=sl)


def test_engine_idle_ms_lays_force_spans_over_the_gaps():
    """Gaps (10, 20) and (30, 50) us between three operations; two steps'
    force spans [5, 25] and [40, 55] us hold 10 us of each; a step whose
    force ends before the first operation is not the slice's."""
    from harness import manifest

    reader = manifest.reader("engine_idle_ms")
    base = 1790857026 * 10**9  # a multiple of 7889238 s

    def step(f0, f1):
        ns = lambda us: base + int(us * 1e3)  # noqa: E731
        return {"root": "step", "tid": 1, "spans": [
            ["step", -1, ns(f0 - 1), ns(f1 + 1), 1.0, False],
            ["force", 0, ns(f0), ns(f1), 1.0, False]]}

    ring = [step(-40, -20), step(5, 25), step(40, 55)]
    ops = [("k", "kernel", 0.0, 10.0), ("k", "kernel", 20.0, 10.0),
           ("k", "kernel", 50.0, 10.0)]
    key = "nbody_tpu_torch.utils.profiling:RECORDS"
    got = reader.read(_run_with({key: (ring, ring)}, ops))
    assert abs(got - 20e-3 / 2) < 1e-9


def test_k3_counted_roofline_reads_the_tally_growth():
    from harness import manifest, roofline

    reader = manifest.reader("k3_counted_roofline_pct")
    key = "nbody_tpu_torch.ops.work:TALLY"
    before = {"group_force_masked": {"pairs": 10**9, "bytes": 10**6,
                                     "calls": 1}}
    after = {"group_force_masked": {"pairs": 3 * 10**9, "bytes": 3 * 10**6,
                                    "calls": 3},
             "group_force": {"pairs": 10**9, "bytes": 10**6, "calls": 1}}
    ops = [("void group_force_kernel<true, true>(float const*)", "kernel",
            0.0, 1000.0), ("other_kernel", "kernel", 0.0, 5000.0)]
    got = reader.read(_run_with({key: (before, after)}, ops))
    want = 100 * roofline.bound_s(3 * 10**9, "pair", 3 * 10**6)[0] / 1e-3
    assert abs(got - want) < 1e-9
