"""The readers of the program's own spans (``tree_roofline_pct``,
``tree_idle_pct``, ``cv_score_ms``, ``k2_host_us``, ``k1_host_us``) on
synthetic recordings and rings; device time charged to the innermost span
open at its device start; the innermost span at a time; and the clock on
which the profiler stamps host events."""
from __future__ import annotations

import time

import pytest
import torch

from pb_helpers import ROOT
from port_bench.harness import attribution, catalog
from port_bench.harness.attribution import ProgramSpan
from port_bench.harness.recorder import Recording
from port_bench.harness.yardsticks import HBM_BYTES_PER_S

BENCH = ROOT / "port_bench"
NEW = ("tree_roofline_pct", "tree_idle_pct", "cv_score_ms", "k2_host_us",
       "k1_host_us")
#: the ring's clock (time.time()) less the window's (perf_counter)
EPOCH = 1_000.0 - 10.0
TREE = {"n": 1000, "d": 10, "bins": 32, "stats": 4, "depth": 2,
        "bin_bytes": 1}


def metric(name):
    return catalog.load_metric(BENCH, name)


def record(span, name, t0, wall_s, parent=None, **attrs):
    """A ring record of a span starting at window second ``t0``."""
    r = {"trace": "t", "span": span, "parent": parent, "name": name,
         "t_epoch": t0 + EPOCH, "wall_ms": 1e3 * wall_s}
    if attrs:
        r["attrs"] = attrs
    return r


def ring(program=True) -> list:
    """Two trains' spans in the window (10, 20); without ``program``, only
    the spans a program without the inner spans records."""
    out = [record(1, "workflow.train", 10.05, 9.9),
           record(2, "stage.fit", 10.1, 0.2, 1, uid="u")]
    if program:
        out += [
            record(3, "tree.fit", 11.0, 1.0, 1, **TREE),
            record(4, "tree.fit", 13.0, 1.0, 1, **TREE),
            record(5, "cv.score", 15.0, 0.5, 1, family="OpGBTClassifier",
                   fold=0, n_rows=10, mode="exact"),
            record(6, "cv.score", 16.0, 0.25, 1, family="OpGBTClassifier",
                   fold=1, n_rows=10, mode="exact"),
            record(7, "kernel.bin_matrix", 17.0, 20e-6, 1, route="cuda"),
            record(8, "kernel.bin_matrix", 17.5, 40e-6, 1, route="cuda"),
            record(9, "kernel.bin_matrix", 18.0, 1e-3, 1, route="plain"),
            record(10, "kernel.fused_moments", 10.15, 50e-6, 2,
                   route="cuda"),
            record(11, "kernel.fused_moments", 18.5, 1e-3, 1,
                   route="plain"),
        ]
    return out


def recording() -> Recording:
    rec = Recording(trains=2, window=(10.0, 20.0))
    rec.stage_spans = [("transmogrifai_tpu_torch.ops.numeric", "fit", 10.1,
                        0.2)]
    rec.device_events = [
        ("void indexing_backward_kernel_small_stride", 11.2, 0.3),
        ("void at::native::elementwise", 12.5, 0.2),     # between the trees
        ("void indexing_backward_kernel_small_stride", 13.1, 0.4),
    ]
    return rec


@pytest.fixture
def with_ring(monkeypatch):
    def use(records):
        monkeypatch.setattr(attribution, "ring", lambda: records)
    return use


def test_the_readers(with_ring):
    with_ring(ring())
    rec = recording()
    per_tree = 3 * 1000 * (10 + 4 + 16) + 7 * 10 * 32 * 4 * 4
    assert metric("tree_roofline_pct").read(rec) == pytest.approx(
        100 * 2 * per_tree / HBM_BYTES_PER_S / 0.7)
    # 2 s of fits, 0.7 s of them with a kernel running
    assert metric("tree_idle_pct").read(rec) == pytest.approx(65.0)
    assert metric("cv_score_ms").read(rec) == pytest.approx(375.0)
    # the cuda route's two calls only
    assert metric("k2_host_us").read(rec) == pytest.approx(30.0)
    assert metric("k1_host_us").read(rec) == pytest.approx(50.0)


@pytest.mark.parametrize("name", NEW)
def test_a_reader_with_nothing_to_read_returns_nothing(name, with_ring):
    # a program without the spans: stage spans but nothing to read
    with_ring(ring(program=False))
    assert metric(name).read(recording()) is None
    # a window without stage spans: the ring cannot be placed
    with_ring(ring())
    assert metric(name).read(Recording(trains=1, window=(0.0, 1.0))) is None


def test_place_ties_the_ring_to_the_stage_spans():
    spans = attribution.place(ring(), recording())
    assert [s.name for s in spans][:4] == [
        "workflow.train", "stage.fit", "kernel.fused_moments", "tree.fit"]
    tree = spans[3]
    assert (tree.t0, tree.t1) == pytest.approx((11.0, 12.0))
    assert tree.parent == 1 and tree.attrs == TREE
    # a ring whose stage spans are not the window's places nothing
    other = Recording(trains=1, window=(10.0, 20.0))
    assert attribution.place(ring(), other) is None


def test_a_span_outside_the_window_is_left_out():
    records = ring() + [record(12, "tree.fit", 19.9, 0.5, 1, **TREE)]
    spans = attribution.place(records, recording())
    assert 12 not in [s.span for s in spans]


def nest() -> list:
    return [ProgramSpan("outer", 0.0, 10.0, 1),
            ProgramSpan("mid", 1.0, 5.0, 2, 1),
            ProgramSpan("inner", 2.0, 3.0, 3, 2),
            ProgramSpan("sibling", 6.0, 7.0, 4, 1)]


@pytest.mark.parametrize("t, name", [
    (-1.0, None), (0.5, "outer"), (1.0, "mid"), (2.5, "inner"),
    (3.0, "mid"), (4.0, "mid"), (5.5, "outer"), (6.5, "sibling"),
    (8.0, "outer"), (10.0, None), (11.0, None)])
def test_the_innermost_span_labels_a_time(t, name):
    s = attribution.Innermost(nest()).at(t)
    assert (None if s is None else s.name) == name


def test_charging_by_device_start():
    spans = nest()
    events = [
        ("k", 2.2, 0.1),    # starts in "inner"
        ("k", 3.5, 0.2),    # launched in "inner", starts after it closed
        ("k", 6.2, 0.3),    # starts in "sibling"
        ("k", 12.0, 0.4),   # starts after every span
        ("other", 2.5, 1.0),
    ]
    charged = attribution.charge(spans, events)
    assert charged == pytest.approx({3: 0.1 + 1.0, 2: 0.2, 4: 0.3,
                                     None: 0.4})
    assert attribution.seconds(charged, [spans[2], spans[3]]) == \
        pytest.approx(1.4)


def test_union_and_overlap():
    spans = [ProgramSpan("a", 0.0, 2.0, 1), ProgramSpan("b", 1.0, 3.0, 2),
             ProgramSpan("c", 5.0, 6.0, 3)]
    fits = attribution.union(spans)
    assert fits == [[0.0, 3.0], [5.0, 6.0]]
    assert attribution.overlap(fits, [[2.5, 5.5], [5.8, 9.0]]) == \
        pytest.approx(0.5 + 0.5 + 0.2)


def test_the_cells_level_work():
    """The cell's 540 CV trees (180 each of depths 3, 6 and 12, at 88 245
    rows of 35 int8 columns, 32 bins, 4 channels) read and write about
    48 GB: 14.3 ms at the card's 3.35 TB/s."""
    work = metric("tree_roofline_pct").tree_level_bytes
    total = sum(180 * work(88_245, 35, 32, 4, depth, 1)
                for depth in (3, 6, 12))
    assert 47.5e9 < total < 48.5e9


def test_the_profilers_host_clock_is_the_spans_clock():
    """A ``record_function`` opened inside a program span, under a CPU-only
    profiler, lands inside that span on the window's timeline, within
    1 ms: the profiler stamps host events, kernel launches among them, on
    ``time.time()``'s clock, so a launch can be placed among the spans."""
    from transmogrifai_tpu_torch.obs import trace as obs_trace

    tracer = obs_trace.reset_tracer()
    try:
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            e0, p0 = time.time(), time.perf_counter()
            with obs_trace.span("stage.fit", uid="u"):
                time.sleep(0.003)
                with torch.profiler.record_function("inside"):
                    time.sleep(0.003)
                time.sleep(0.003)
        records = tracer.spans()
    finally:
        obs_trace.reset_tracer()
    rec = Recording(trains=1, window=(p0 - 1.0, p0 + 60.0))
    rec.stage_spans = [("m", "fit", p0 + (records[0]["t_epoch"] - e0),
                        1e-3 * records[0]["wall_ms"])]
    (span,) = attribution.place(records, rec)
    inside = next(e for e in prof.profiler.kineto_results.events()
                  if e.name() == "inside")
    t = 1e-9 * inside.start_ns() + (p0 - e0)
    assert span.t0 + 0.003 - 1e-3 <= t <= span.t0 + 0.003 + 1e-3 + 0.003
    assert span.t0 < t < span.t1
