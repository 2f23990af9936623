"""The per-layer metrics' arithmetic on recorded spans, stage spans,
kernel calls and device events; the trace's union and gaps; the frozen
yardsticks against the kernel table of PERF.md."""
from __future__ import annotations

import pytest

from pb_helpers import ROOT
from port_bench.harness import catalog, profile, recorder, yardsticks
from port_bench.harness.recorder import KernelCall, Recording, Span

BENCH = ROOT / "port_bench"


def metric(name):
    return catalog.load_metric(BENCH, name)


def recording() -> Recording:
    rec = Recording(trains=2, window=(10.0, 20.0))
    rec.spans = [
        Span("validate", 11.0, 15.0, None),
        Span("fit.linear", 11.5, 12.0, "validate"),
        Span("fit.tree", 12.0, 14.0, "validate"),
        Span("fit.tree", 15.0, 16.0, None),          # the refit
        Span("validate", 17.0, 18.0, None),
        Span("fit.linear", 17.1, 17.3, "validate"),
    ]
    rec.stage_spans = [
        ("transmogrifai_tpu_torch.ops.numeric", "fit", 10.1, 0.2),
        ("transmogrifai_tpu_torch.ops.categorical", "transform", 10.3, 0.4),
        ("transmogrifai_tpu_torch.preparators.sanity_checker", "fit", 10.8,
         0.1),
        ("transmogrifai_tpu_torch.selector.model_selector", "fit", 10.9, 5.0),
    ]
    rec.kernel_calls = [KernelCall("fused_moments", 1_000_000, 538),
                        KernelCall("fused_moments", 10_000_000, 39),
                        KernelCall("bin_matrix", 10_000_000, 39, 31, 1)]
    rec.device_events = [
        ("void moments_tiles_kernel(...)", 10.5, 0.5e-3),
        ("void moments_slabs_kernel(...)", 10.6, 0.7e-3),
        ("void bin_tiles_kernel<signed char, 4>(...)", 12.0, 1e-3),
        ("void at::native::elementwise", 12.5, 2.0),
        ("Memcpy HtoD", 13.0, 1.0),
    ]
    rec.busy_s = profile.busy_seconds(rec.device_events, *rec.window)
    return rec


def test_span_metrics_per_train():
    rec = recording()
    assert metric("linear_fits_ms").read(rec) == pytest.approx(
        1e3 * (0.5 + 0.2) / 2)
    assert metric("tree_fits_ms").read(rec) == pytest.approx(1e3 * 3.0 / 2)
    # validate 5 s less the 2.7 s of fits inside it
    assert metric("cv_scoring_ms").read(rec) == pytest.approx(1e3 * 2.3 / 2)
    assert metric("vectorize_ms").read(rec) == pytest.approx(1e3 * 0.6 / 2)
    assert metric("sanity_check_ms").read(rec) == pytest.approx(50.0)


def test_trace_metrics():
    rec = recording()
    k1 = (yardsticks.moments_bound_ms(1_000_000, 538)
          + yardsticks.moments_bound_ms(10_000_000, 39)) / 1.2
    assert metric("k1_roofline_pct").read(rec) == pytest.approx(100 * k1)
    k2 = yardsticks.bin_bound_ms(10_000_000, 39, 31, 1) / 1.0
    assert metric("k2_roofline_pct").read(rec) == pytest.approx(100 * k2)
    # the copy at 13.0 lies inside the 2 s kernel from 12.5
    assert rec.busy_s == pytest.approx(0.5e-3 + 0.7e-3 + 1e-3 + 2.0)
    assert metric("device_idle_pct").read(rec) == pytest.approx(
        100 * (1 - rec.busy_s / 10.0))


def test_a_reader_with_nothing_to_read_returns_nothing():
    empty = Recording(trains=1, window=(0.0, 1.0))
    for m in catalog.benchmark(ROOT)["per_layer"]:
        assert metric(m["name"]).read(empty) is None, m["name"]


def test_union_and_gaps():
    ev = [("a", 0.0, 1.0), ("b", 0.5, 1.0), ("c", 3.0, 0.5), ("d", 9.0, 5.0)]
    assert profile.busy_intervals(ev, 0.0, 10.0) == [[0.0, 1.5], [3.0, 3.5],
                                                     [9.0, 10.0]]
    assert profile.busy_seconds(ev, 0.0, 10.0) == pytest.approx(3.0)
    gaps = profile.idle_gaps(ev, 0.0, 10.0)
    assert gaps[0] == pytest.approx((3.5, 5.5))
    assert gaps[1] == pytest.approx((1.5, 1.5))
    assert profile.top_ops(ev, 2) == [["d", 5.0], ["a", 1.0]]


def test_frozen_bounds_match_the_kernel_table():
    """PERF.md's kernel table: K1 at 1M x 538 and 10M x 39, K2 at 10M x 39
    with int8 bins and 31 edges."""
    assert round(yardsticks.moments_bound_ms(1_000_000, 538), 4) == 0.6436
    assert round(yardsticks.moments_bound_ms(10_000_000, 39), 4) == 0.4776
    assert round(yardsticks.bin_bound_ms(10_000_000, 39, 31, 1), 4) == 0.5821


def test_kernel_names():
    assert yardsticks.is_k1_kernel("void moments_tiles_kernel(float const*)")
    assert not yardsticks.is_k1_kernel("void empty_kernel()")
    assert yardsticks.is_k2_kernel("void bin_small_kernel<int, 2>(...)")
    assert not yardsticks.is_k2_kernel("void moments_slabs_kernel()")


def test_nested_fits_count_once_and_shims_come_off():
    class Est:
        def outer(self):
            return self.inner() + 1

        def inner(self):
            return 1

    import types
    mod = types.ModuleType("pb_fake_mod")
    mod.Est = Est
    import sys
    sys.modules["pb_fake_mod"] = mod
    try:
        rec = Recording()
        shims = recorder.Shims(rec, lambda: None)
        shims.span("pb_fake_mod", "Est", "outer", "fit.a")
        shims.span("pb_fake_mod", "Est", "inner", "fit.b")
        assert Est().outer() == 2
        assert [s.group for s in rec.spans] == ["fit.a"]
        shims.remove()
        assert Est.outer is not None and "shim" not in Est.outer.__name__
        Est().outer()
        assert len(rec.spans) == 1
    finally:
        del sys.modules["pb_fake_mod"]
