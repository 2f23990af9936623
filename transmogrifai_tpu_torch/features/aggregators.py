"""Event aggregation monoids.

Counterpart of the reference aggregators package (reference: features/.../
aggregators/ - MonoidAggregatorDefaults.scala:56-118, FeatureAggregator.
scala, Event[O] with timestamps, CutOffTime): collapse a key's event
sequence into one value per feature.  Default aggregator per type mirrors
MonoidAggregatorDefaults: sum for Real/Integral/Currency, mean for Percent,
logical-or for Binary, max for Date/DateTime, mode for PickList, concat for
other text, union for sets/lists/maps (with per-value-type merge inside
maps), geographic midpoint for Geolocation.
"""
from __future__ import annotations

from collections import Counter
from dataclasses import dataclass
from typing import Any, Callable, Optional, Sequence, Type

import numpy as np

from ..types import feature_types as ft


@dataclass(frozen=True)
class Event:
    """A timestamped raw value (reference: aggregators/Event.scala)."""

    timestamp: float
    value: Any


@dataclass(frozen=True)
class CutOffTime:
    """Predictor/response split point (reference: CutOffTime.scala;
    comparison semantics FeatureAggregator.scala:114-123): predictors
    aggregate events STRICTLY before the cutoff, responses from the
    cutoff on - so the event that set a conditional cutoff (the landing
    on the target page) belongs to the response side, not the
    predictors."""

    time: Optional[float] = None

    def is_predictor_event(self, ts: float) -> bool:
        return self.time is None or ts < self.time

    def is_response_event(self, ts: float) -> bool:
        return self.time is None or ts >= self.time


class MonoidAggregator:
    """zero + plus over raw python values; None = absent.

    ``plus`` is PURE — it never mutates or requires ownership of its
    arguments, so partition merges can re-use partial accumulators freely
    and raw values may appear on either side (``_lift`` normalizes them).
    ``aggregate`` folds through ``_fold_into`` over a locally-owned
    accumulator, which subclasses may mutate for O(N) flat folds.
    """

    name = "agg"

    def zero(self) -> Any:
        return None

    def _lift(self, v: Any) -> Any:
        """Normalize a raw value into accumulator representation
        (identity for aggregators whose accumulator IS the value)."""
        return v

    def plus(self, a: Any, b: Any) -> Any:
        a, b = self._lift(a), self._lift(b)
        if a is None:
            return b
        if b is None:
            return a
        return self._combine(a, b)

    def _combine(self, a, b):  # pragma: no cover - abstract
        raise NotImplementedError

    def present(self, acc: Any) -> Any:
        """Finalize the accumulator into the feature value."""
        return acc

    def _fold_into(self, acc: Any, v: Any) -> Any:
        """Fold one raw value into an accumulator OWNED by the caller;
        defaults to the pure ``plus``.  Subclasses whose pure combine
        copies (e.g. Counter-based mode) override this to mutate."""
        return self.plus(acc, v)

    def aggregate(self, values: Sequence[Any]) -> Any:
        acc = self.zero()
        for v in values:
            if v is not None:
                acc = self._fold_into(acc, v)
        return self.present(acc)


class _Fn(MonoidAggregator):
    def __init__(self, name: str, combine: Callable, present=None) -> None:
        self.name = name
        self._combine_fn = combine
        self._present = present

    def _combine(self, a, b):
        return self._combine_fn(a, b)

    def present(self, acc):
        return self._present(acc) if self._present and acc is not None else acc


SumNumeric = _Fn("Sum", lambda a, b: a + b)
LogicalOr = _Fn("LogicalOr", lambda a, b: bool(a) or bool(b))
MaxNumeric = _Fn("Max", max)
MinNumeric = _Fn("Min", min)
ConcatText = _Fn("ConcatText", lambda a, b: f"{a} {b}")
UnionSet = _Fn("UnionSet", lambda a, b: frozenset(a) | frozenset(b))
ConcatList = _Fn("ConcatList", lambda a, b: tuple(a) + tuple(b))


class MeanNumeric(MonoidAggregator):
    name = "Mean"

    def _lift(self, v):
        # accumulator repr is (sum, count); a raw value is one observation
        if v is None or (isinstance(v, tuple) and len(v) == 2
                         and isinstance(v[1], int)):
            return v
        return (float(v), 1)

    def _combine(self, a, b):
        return (a[0] + b[0], a[1] + b[1])

    def present(self, acc):
        if acc is None:
            return None
        s, n = self._lift(acc)
        return s / n if n else None


class ModeText(MonoidAggregator):
    name = "Mode"

    def _lift(self, x):
        # a raw value is a SINGLE observation — Counter([x]), never
        # Counter(x), which would letter-count a string.  UnionMap seeds
        # inner accumulators with raw values, so both plus sides lift.
        if x is None or isinstance(x, Counter):
            return x
        return Counter([x])

    def _combine(self, a: Counter, b: Counter) -> Counter:
        # pure: UnionMap's shallow dict copy shares the inner Counters
        # with the left accumulator, so an in-place update here would
        # corrupt `a` on partition merges
        out = Counter(a)
        out.update(b)
        return out

    def _fold_into(self, acc, v):
        # flat folds own their accumulator: mutate instead of copying
        # (pure _combine would make an N-event fold O(N * unique))
        if v is None:
            return acc
        if acc is None:
            acc = Counter()
        if isinstance(v, Counter):  # a partition partial
            acc.update(v)
        else:  # the common raw-event case: no per-event allocation
            acc[v] += 1
        return acc

    def present(self, acc):
        if acc is None:
            return None
        # guard AFTER lifting: a falsy raw value ('' / 0 / False) is a
        # real single observation, only an empty Counter means absent
        acc = self._lift(acc)
        if not acc:
            return None
        # min on ties like the reference's mode semantics
        top = max(acc.values())
        return min(v for v, c in acc.items() if c == top)


class GeolocationMidpoint(MonoidAggregator):
    """Geographic midpoint via 3D unit-vector mean (reference:
    aggregators/CustomMonoidAggregators GeolocationMidpoint)."""

    name = "GeoMidpoint"

    # raw (lat, lon[, accuracy]) inputs have 2-3 entries, never 5, so the
    # accumulator length discriminates even when a raw value arrives as an
    # ndarray
    _ACC_LEN = 5

    def _lift(self, v):
        # accumulator repr is the 5-vector [x, y, z, acc_sum, count];
        # a raw (lat, lon[, accuracy]) lifts to one unit vector
        if v is None or (isinstance(v, np.ndarray)
                         and v.shape == (self._ACC_LEN,)):
            return v
        lat, lon = np.radians(v[0]), np.radians(v[1])
        return np.array(
            [np.cos(lat) * np.cos(lon), np.cos(lat) * np.sin(lon),
             np.sin(lat), v[2] if len(v) > 2 else 0.0, 1.0]
        )

    def _combine(self, a, b):
        return a + b

    def present(self, acc):
        acc = self._lift(acc)
        if acc is None or acc[4] == 0:
            return None
        x, y, z = acc[0] / acc[4], acc[1] / acc[4], acc[2] / acc[4]
        lon = np.degrees(np.arctan2(y, x))
        lat = np.degrees(np.arctan2(z, np.sqrt(x * x + y * y)))
        return [float(lat), float(lon), float(acc[3] / acc[4])]


class UnionMap(MonoidAggregator):
    name = "UnionMap"

    def __init__(self, value_agg: MonoidAggregator) -> None:
        self.value_agg = value_agg

    def _combine(self, a: dict, b: dict) -> dict:
        out = dict(a)
        for k, v in b.items():
            out[k] = self.value_agg.plus(out.get(k), v)
        return out

    def present(self, acc):
        if acc is None:
            return None
        return {k: self.value_agg.present(v) for k, v in acc.items()}


def default_aggregator(t: Type[ft.FeatureType]) -> MonoidAggregator:
    """(reference: MonoidAggregatorDefaults.scala:56-118)"""
    if issubclass(t, ft.OPMap):
        return UnionMap(default_aggregator(t.value_type or ft.Real))
    if issubclass(t, ft.Geolocation):
        return GeolocationMidpoint()
    if issubclass(t, ft.MultiPickList):
        return UnionSet
    if issubclass(t, (ft.TextList, ft.DateList)):
        return ConcatList
    if issubclass(t, ft.Binary):
        return LogicalOr
    if issubclass(t, (ft.Date, ft.DateTime)):
        return MaxNumeric
    if issubclass(t, ft.Percent):
        return MeanNumeric()
    if issubclass(t, ft.OPNumeric):
        return SumNumeric
    if issubclass(t, ft.PickList):
        return ModeText()
    if issubclass(t, ft.Text):
        return ConcatText
    if issubclass(t, ft.OPVector):
        return _Fn("CombineVector", lambda a, b: [x + y for x, y in zip(a, b)])
    return _Fn("Last", lambda a, b: b)


class FeatureAggregator:
    """Aggregate a feature's event stream with cutoff/window semantics
    (reference: aggregators/FeatureAggregator.scala)."""

    def __init__(
        self,
        ftype: Type[ft.FeatureType],
        aggregator: Optional[MonoidAggregator] = None,
        is_response: bool = False,
        window: Optional[float] = None,
    ) -> None:
        self.ftype = ftype
        self.aggregator = aggregator or default_aggregator(ftype)
        self.is_response = is_response
        self.window = window

    def extract(self, events: Sequence[Event], cutoff: CutOffTime) -> Any:
        keep = []
        for e in events:
            if self.is_response:
                ok = cutoff.is_response_event(e.timestamp)
                if ok and self.window is not None and cutoff.time is not None:
                    ok = e.timestamp <= cutoff.time + self.window
            else:
                ok = cutoff.is_predictor_event(e.timestamp)
                if ok and self.window is not None and cutoff.time is not None:
                    ok = e.timestamp >= cutoff.time - self.window
            if ok:
                keep.append(e.value)
        return self.aggregator.aggregate(keep)
