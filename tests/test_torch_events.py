"""The event aggregators and readers: the torch package's copies held to
the reference's depth tests, and against the JAX package's on the same
events.

* ``features.aggregators``: the monoid laws of the JAX package's
  ``tests/test_aggregators_depth.py`` (grouping invariance, identity,
  no mutation of partials), its tie, falsy-value, geolocation and
  dispatch cases and the cutoff and window boundaries; every aggregate
  equal to the reference's on the same values.
* ``readers.events``: ``tests/test_readers_depth.py``'s conditional and
  joined readers and the reader half of ``tests/test_readers_and_testkit.
  py`` (aggregate, conditional, joined, simple, streaming); each dataset
  equal, column by column and row by row, to the reference reader's over
  the same events, with the same row keys.

Tolerances: exact everywhere (host copies of the same arithmetic), but
the float means of the grouping laws, compared to 9 decimals as the
reference's tests compare them.
"""
from __future__ import annotations

import copy
from collections import Counter

import numpy as np
import pytest

from torch_parity import PORT, REF, mod

AGG = {pkg: mod(pkg, "features.aggregators") for pkg in (REF, PORT)}
EV = {pkg: mod(pkg, "readers.events") for pkg in (REF, PORT)}
FT = {pkg: mod(pkg, "types.feature_types") for pkg in (REF, PORT)}
FB = {pkg: mod(pkg, "features.feature_builder").FeatureBuilder
      for pkg in (REF, PORT)}
A, ft = AGG[PORT], FT[PORT]

# (aggregator factory over a package's module, raw event values): values
# chosen so order or grouping would change the answer if a law broke
_CASES = [
    (lambda m: m.SumNumeric, [1.0, 2.5, -3.0, 4.0]),
    (lambda m: m.MaxNumeric, [3.0, 1.0, 9.0, 2.0]),
    (lambda m: m.LogicalOr, [False, False, True, False]),
    (lambda m: m.ConcatText, ["a", "b", "c", "d"]),
    (lambda m: m.UnionSet,
     [frozenset({"x"}), frozenset({"y"}), frozenset({"x", "z"})]),
    (lambda m: m.ConcatList, [(1,), (2, 3), (4,)]),
    (lambda m: m.MeanNumeric(), [1.0, 2.0, 4.0, 9.0]),
    (lambda m: m.ModeText(), ["a", "b", "a", "c", "b", "a"]),
    (lambda m: m.UnionMap(m.ModeText()),
     [{"k": "a"}, {"k": "b", "j": "x"}, {"k": "a"}]),
    (lambda m: m.UnionMap(m.SumNumeric),
     [{"k": 1.0}, {"k": 2.0, "j": 5.0}, {"j": -1.0}]),
    (lambda m: m.GeolocationMidpoint(),
     [[37.77, -122.42, 1.0], [40.71, -74.0, 3.0], [51.5, -0.13, 5.0]]),
]


def _norm(x):
    if isinstance(x, list) and x and isinstance(x[0], float):
        return np.round(x, 9).tolist()
    return x


def _fold_groupings(agg, values):
    """The same stream under three partition groupings: a flat fold, a
    merge of two halves' partial accumulators, and a right-heavy merge of
    singleton lifts."""
    def lift(vals):
        acc = agg.zero()
        for v in vals:
            acc = agg.plus(acc, v)
        return acc

    mid = len(values) // 2
    right = agg.zero()
    for v in reversed(values):
        right = agg.plus(lift([v]), right)
    return (agg.aggregate(values),
            agg.present(agg.plus(lift(values[:mid]), lift(values[mid:]))),
            agg.present(right))


@pytest.mark.parametrize("case_i", range(len(_CASES)))
def test_grouping_invariance(case_i):
    make, values = _CASES[case_i]
    flat, tree, right = _fold_groupings(make(A), values)
    assert _norm(tree) == _norm(flat)
    assert _norm(right) == _norm(flat)
    # the reference's aggregate of the same values, bit for bit
    assert flat == make(AGG[REF]).aggregate(values)


@pytest.mark.parametrize("case_i", range(len(_CASES)))
def test_identity_element(case_i):
    """plus with zero on either side presents like the single value."""
    make, values = _CASES[case_i]
    agg = make(A)
    v = values[0]
    single = _norm(agg.aggregate([v]))
    assert _norm(agg.present(agg.plus(agg.zero(), v))) == single
    assert _norm(agg.present(agg.plus(v, agg.zero()))) == single
    assert agg.aggregate([]) is None


@pytest.mark.parametrize("case_i", range(len(_CASES)))
def test_plus_does_not_mutate_arguments(case_i):
    make, values = _CASES[case_i]
    agg = make(A)
    acc_a = agg.zero()
    for v in values[:2]:
        acc_a = agg.plus(acc_a, v)
    acc_b = agg.zero()
    for v in values[2:]:
        acc_b = agg.plus(acc_b, v)
    snap_a, snap_b = copy.deepcopy(acc_a), copy.deepcopy(acc_b)
    agg.plus(acc_a, acc_b)

    def eq(x, y):
        if isinstance(x, np.ndarray):
            return np.array_equal(x, y)
        return x == y

    assert eq(acc_a, snap_a)
    assert eq(acc_b, snap_b)


def test_union_map_merge_keeps_left_accumulator_intact():
    agg = A.default_aggregator(ft.PickListMap)
    assert isinstance(agg, A.UnionMap)
    left = agg.plus(agg.plus(agg.zero(), {"color": "red"}), {"color": "red"})
    right = agg.plus(agg.zero(), {"color": "blue"})
    snapshot = {k: Counter(v) for k, v in left.items()}
    merged = agg.plus(left, right)
    assert {k: Counter(v) for k, v in left.items()} == snapshot
    assert agg.present(merged) == {"color": "red"}


def test_mode_ties_and_falsy_values():
    agg = A.ModeText()
    assert agg.aggregate(["b", "a", "b", "a"]) == "a"
    assert agg.aggregate(["z"]) == "z"
    assert agg.present(agg.plus(agg.zero(), "")) == ""
    assert agg.present(agg.plus(agg.zero(), 0)) == 0
    um = A.UnionMap(A.ModeText())
    assert um.present(um.plus(um.zero(), {"k": ""})) == {"k": ""}


def test_mean_and_geolocation_partials():
    mean = A.MeanNumeric()
    partial = mean.plus(mean.plus(None, 2.0), 4.0)
    assert mean.present(mean.plus(partial, 6.0)) == pytest.approx(4.0)
    assert mean.present(mean.plus(partial, partial)) == pytest.approx(3.0)
    geo = A.GeolocationMidpoint()
    out = geo.aggregate([np.array([10.0, 20.0, 1.0])])
    assert out[:2] == pytest.approx([10.0, 20.0], abs=1e-9)
    merged = geo.plus(geo.plus(None, [0.0, 10.0, 1.0]),
                      np.array([0.0, 20.0, 3.0]))
    assert geo.present(merged)[1] == pytest.approx(15.0, abs=1e-9)
    one = geo.aggregate([[12.5, 45.25, 3.0]])
    assert one == pytest.approx([12.5, 45.25, 3.0], abs=1e-9)
    two = geo.aggregate([[0.0, 10.0, 1.0], [0.0, 20.0, 3.0]])
    assert two == pytest.approx([0.0, 15.0, 2.0], abs=1e-9)
    # the 3-D unit-vector mean wraps the dateline
    wrap = geo.aggregate([[0.0, 179.0, 1.0], [0.0, -179.0, 1.0]])
    assert abs(wrap[1]) == pytest.approx(180.0, abs=1e-6)
    mid = geo.aggregate([[0.0, 0.0, 1.0], [0.0, 90.0, 1.0]])
    assert abs(mid[0]) < 1e-6 and abs(mid[1] - 45.0) < 1e-6
    ref = AGG[REF].GeolocationMidpoint()
    for pts in ([[0.0, 179.0, 1.0], [0.0, -179.0, 1.0]],
                [[37.77, -122.42, 1.0], [40.71, -74.0, 3.0]]):
        assert geo.aggregate(pts) == ref.aggregate(pts)


def test_default_aggregator_dispatch_table():
    """Per-type defaults (MonoidAggregatorDefaults.scala:56-118), type for
    type the reference's, and their aggregates on sample values."""
    assert A.default_aggregator(ft.Real) is A.SumNumeric
    assert A.default_aggregator(ft.Integral) is A.SumNumeric
    assert A.default_aggregator(ft.Currency) is A.SumNumeric
    assert isinstance(A.default_aggregator(ft.Percent), A.MeanNumeric)
    assert A.default_aggregator(ft.Binary) is A.LogicalOr
    assert A.default_aggregator(ft.Date) is A.MaxNumeric
    assert A.default_aggregator(ft.DateTime) is A.MaxNumeric
    assert isinstance(A.default_aggregator(ft.PickList), A.ModeText)
    assert A.default_aggregator(ft.Text) is A.ConcatText
    assert A.default_aggregator(ft.MultiPickList) is A.UnionSet
    assert A.default_aggregator(ft.TextList) is A.ConcatList
    assert A.default_aggregator(ft.DateList) is A.ConcatList
    assert isinstance(A.default_aggregator(ft.Geolocation),
                      A.GeolocationMidpoint)
    for map_t in (ft.RealMap, ft.PickListMap, ft.BinaryMap, ft.TextMap):
        agg = A.default_aggregator(map_t)
        assert isinstance(agg, A.UnionMap)
        assert type(agg.value_agg) is type(
            A.default_aggregator(map_t.value_type))
    samples = [("Real", [1.0, 2.0, None], 3.0),
               ("Percent", [0.2, 0.4], pytest.approx(0.3)),
               ("Binary", [False, True], True),
               ("Date", [5, 9, 7], 9),
               ("PickList", ["a", "b", "a"], "a"),
               ("Text", ["x", "y"], "x y"),
               ("MultiPickList", [frozenset({"a"}), frozenset({"b"})],
                {"a", "b"}),
               ("RealMap", [{"k": 1.0}, {"k": 2.0, "j": 5.0}],
                {"k": 3.0, "j": 5.0})]
    for name, values, want in samples:
        got = A.default_aggregator(getattr(ft, name)).aggregate(values)
        assert got == want, name
        assert got == AGG[REF].default_aggregator(
            getattr(FT[REF], name)).aggregate(values), name


def _events(*ts):
    return [A.Event(t, 1.0) for t in ts]


@pytest.mark.parametrize("is_response,window,times,want", [
    # the event AT the cutoff belongs to the response side
    (False, None, (98.0, 99.0, 100.0), 2.0),
    (True, None, (98.0, 99.0, 100.0), 1.0),
    # predictors keep [cutoff - window, cutoff)
    (False, 10.0, (89.999, 90.0, 95.0, 100.0), 2.0),
    # responses keep [cutoff, cutoff + window]
    (True, 10.0, (100.0, 110.0, 110.001), 2.0),
], ids=["predictor-before", "response-at", "predictor-window",
        "response-window"])
def test_cutoff_and_window_boundaries(is_response, window, times, want):
    cut = A.CutOffTime(100.0)
    fa = A.FeatureAggregator(ft.Real, is_response=is_response, window=window)
    assert fa.extract(_events(*times), cut) == want
    ref = AGG[REF]
    fa_ref = ref.FeatureAggregator(FT[REF].Real, is_response=is_response,
                                   window=window)
    assert fa_ref.extract([ref.Event(t, 1.0) for t in times],
                          ref.CutOffTime(100.0)) == want


def test_no_cutoff_and_empty_streams():
    cut = A.CutOffTime(None)
    ev = _events(0.0, 50.0, 1000.0)
    assert A.FeatureAggregator(ft.Real, window=5.0).extract(ev, cut) == 3.0
    assert A.FeatureAggregator(ft.Real, is_response=True,
                               window=5.0).extract(ev, cut) == 3.0
    fa = A.FeatureAggregator(ft.Real)
    assert fa.extract([], A.CutOffTime(10.0)) is None
    assert fa.extract([A.Event(1.0, None), A.Event(2.0, None)],
                      A.CutOffTime(10.0)) is None


# -- readers -------------------------------------------------------------------

def _same_dataset(ds_port, ds_ref):
    assert ds_port.column_names() == ds_ref.column_names()
    assert ds_port.to_pylists() == ds_ref.to_pylists()
    for name in ds_ref.column_names():
        assert type(ds_port[name]).__name__ == type(ds_ref[name]).__name__
        assert ds_port[name].feature_type.__name__ \
            == ds_ref[name].feature_type.__name__


def _both(build):
    """``build(pkg)`` -> (reader, dataset) in each package; the datasets
    must be equal; returns the port's (reader, dataset)."""
    (r_ref, d_ref), (r_port, d_port) = (build(pkg) for pkg in (REF, PORT))
    _same_dataset(d_port, d_ref)
    if hasattr(r_ref, "row_keys"):
        assert r_port.row_keys() == r_ref.row_keys()
    return r_port, d_port


DEPTH_EVENTS = [
    {"u": "a", "ts": 1.0, "page": "home", "spend": 1.0},
    {"u": "a", "ts": 5.0, "page": "buy", "spend": 10.0},   # condition
    {"u": "a", "ts": 6.0, "page": "home", "spend": 2.0},
    {"u": "a", "ts": 50.0, "page": "home", "spend": 4.0},  # beyond window
    {"u": "b", "ts": 2.0, "page": "home", "spend": 7.0},   # never converts
    {"u": "c", "ts": 3.0, "page": "buy", "spend": 5.0},    # at first event
    {"u": "c", "ts": 9.0, "page": "buy", "spend": 6.0},    # second match
]


def _conditional(**kw):
    def build(pkg):
        fb, f = FB[pkg], FT[pkg]
        pre = fb(f.Real, "spend").extract(lambda r: r["spend"]).as_predictor()
        post = fb(f.Real, "spend_after").extract(
            lambda r: r["spend"]).as_response()
        reader = EV[pkg].ConditionalReader(
            DEPTH_EVENTS, key_fn=lambda r: r["u"], time_fn=lambda r: r["ts"],
            target_condition=lambda r: r["page"] == "buy", **kw)
        return reader, reader.generate_dataset([pre, post])

    return _both(build)


def test_conditional_drops_keys_without_the_condition():
    reader, ds = _conditional()
    assert reader.row_keys() == ["a", "c"] and len(ds) == 2


def test_conditional_keeps_unmatched_keys_when_not_dropping():
    reader, ds = _conditional(drop_if_no_condition=False)
    assert reader.row_keys() == ["a", "b", "c"]
    # no cutoff for b: everything is predictor- and response-side
    assert ds["spend"].values[1] == 7.0


def test_conditional_cutoff_splits_predictors_and_responses():
    reader, ds = _conditional(response_window=10.0)
    a = reader.row_keys().index("a")
    assert ds["spend"].values[a] == 1.0          # strictly before ts=5
    assert ds["spend_after"].values[a] == 12.0   # [5, 15]: 10 + 2


def test_conditional_first_vs_last_match():
    reader, ds = _conditional(use_first=False, response_window=100.0)
    c = reader.row_keys().index("c")
    assert ds["spend"].values[c] == 5.0
    assert ds["spend_after"].values[c] == 6.0


def test_conditional_key_converting_at_its_first_event():
    reader, ds = _conditional(response_window=100.0)
    c = reader.row_keys().index("c")
    assert not ds["spend"].mask[c]
    assert ds["spend_after"].values[c] == 11.0


def _join(join_type: str):
    def build(pkg):
        fb, f, ev = FB[pkg], FT[pkg], EV[pkg]
        sends = [{"u": "a", "ts": 1.0, "n": 1.0},
                 {"u": "a", "ts": 2.0, "n": 1.0},
                 {"u": "b", "ts": 1.5, "n": 1.0}]
        clicks = [{"u": "a", "ts": 1.1, "c": 1.0},
                  {"u": "z", "ts": 1.2, "c": 1.0}]   # a clicker, no sends
        left = ev.AggregateReader(sends, key_fn=lambda r: r["u"],
                                  time_fn=lambda r: r["ts"])
        right = ev.AggregateReader(clicks, key_fn=lambda r: r["u"],
                                   time_fn=lambda r: r["ts"])
        n = fb(f.Real, "n").extract(lambda r: r.get("n")).as_predictor()
        c = fb(f.Real, "c").extract(lambda r: r.get("c")).as_predictor()
        reader = ev.JoinedReader(left, right, left_key="u",
                                 join_type=join_type)
        return reader, reader.generate_dataset([n, c])

    return _both(build)


@pytest.mark.parametrize("join_type,expect_pattern", [
    ("inner", [(True, True)]),
    ("left", [(True, False), (True, True)]),
    ("outer", [(False, True), (True, False), (True, True)]),
])
def test_join_types_null_patterns(join_type, expect_pattern):
    pytest.importorskip("pandas")
    _, ds = _join(join_type)
    pattern = sorted(zip(ds["n"].mask.tolist(), ds["c"].mask.tolist()))
    assert pattern == sorted(expect_pattern)


def test_aggregate_reader_cutoff_semantics():
    def build(pkg):
        fb, f = FB[pkg], FT[pkg]
        records = [{"id": "u1", "t": 1.0, "amount": 10.0, "label": 0.0},
                   {"id": "u1", "t": 2.0, "amount": 5.0, "label": 1.0},
                   {"id": "u1", "t": 9.0, "amount": 100.0, "label": 1.0},
                   {"id": "u2", "t": 1.5, "amount": 7.0, "label": 0.0}]
        reader = EV[pkg].AggregateReader(
            records, key_fn=lambda r: r["id"], time_fn=lambda r: r["t"],
            cutoff=AGG[pkg].CutOffTime(5.0))
        return reader, reader.generate_dataset(
            [fb(f.Real, "amount").as_predictor(),
             fb(f.Binary, "label").as_response()])

    _, ds = _both(build)
    assert ds["amount"].to_list() == [15.0, 7.0]
    assert ds["label"].to_list() == [1.0, None]


def test_conditional_reader_per_key_cutoff():
    def build(pkg):
        fb, f = FB[pkg], FT[pkg]
        records = [
            {"id": "a", "t": 1.0, "spend": 3.0, "visit": False,
             "converted": 0.0},
            {"id": "a", "t": 2.0, "spend": 4.0, "visit": True,
             "converted": 0.0},
            {"id": "a", "t": 3.0, "spend": 9.0, "visit": False,
             "converted": 1.0},
            {"id": "b", "t": 1.0, "spend": 2.0, "visit": False,
             "converted": 0.0},
        ]
        reader = EV[pkg].ConditionalReader(
            records, key_fn=lambda r: r["id"], time_fn=lambda r: r["t"],
            target_condition=lambda r: r["visit"], response_window=5.0)
        return reader, reader.generate_dataset(
            [fb(f.Real, "spend").as_predictor(),
             fb(f.Binary, "converted").as_response()])

    _, ds = _both(build)
    assert len(ds) == 1
    assert ds["spend"].to_list() == [3.0]
    assert ds["converted"].to_list() == [1.0]


def test_joined_reader_left_join_of_simple_readers():
    pytest.importorskip("pandas")

    def build(pkg):
        fb, f, ev = FB[pkg], FT[pkg], EV[pkg]
        left = ev.SimpleReader([{"k": "1", "x": 1.0}, {"k": "2", "x": 2.0}])
        right = ev.SimpleReader([{"k": "1", "z": "hi"}])
        reader = ev.JoinedReader(left, right, left_key="k")
        return reader, reader.generate_dataset(
            [fb(f.ID, "k").as_predictor(), fb(f.Real, "x").as_predictor(),
             fb(f.Text, "z").as_predictor()])

    _, ds = _both(build)
    assert ds["z"].to_list() == ["hi", None]


def test_streaming_reader_batches():
    batches = {}
    for pkg in (REF, PORT):
        fa = FB[pkg](FT[pkg].Real, "a").as_predictor()
        recs = ({"a": float(i)} for i in range(25))
        batches[pkg] = list(EV[pkg].StreamingReader(
            recs, batch_size=10).stream([fa]))
    assert [len(b) for b in batches[PORT]] == [10, 10, 5]
    for got, want in zip(batches[PORT], batches[REF]):
        _same_dataset(got, want)
