"""Date/time vectorizers: circular encodings + DateList pivots.

Counterparts of DateToUnitCircleTransformer / DateListVectorizer (reference:
core/.../impl/feature/DateToUnitCircleTransformer.scala:117-130,
DateListVectorizer.scala:49-260, TimePeriod.scala).  Dates are epoch
milliseconds (Integral); each configured time period maps to (sin, cos) on
the unit circle so midnight is close to 23:59 (the whole point of the
encoding).  Period values are EXACT UTC calendar fields, matching the
reference's Joda lookups (dayOfMonth, ISO weekOfWeekyear, ...) — not
mean-month approximations — so the 1st of every month lands at angle 0 and
ISO week boundaries agree with the reference.  Defaults mirror
TransmogrifierDefaults.CircularDateRepresentations: HourOfDay, DayOfWeek,
DayOfMonth, WeekOfYear.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from ..types.columns import Column, ListColumn, NumericColumn
from ..types.dataset import Dataset
from ..types.feature_types import Date, DateList
from ..types.vector_metadata import NULL_STRING, VectorColumnMeta
from .vectorizer_base import SequenceVectorizer, SequenceVectorizerModel

MS_PER_HOUR = 3600 * 1000.0
MS_PER_DAY = 24 * MS_PER_HOUR

DEFAULT_PERIODS = ("HourOfDay", "DayOfWeek", "DayOfMonth", "WeekOfYear")

# period sizes mirror DateToUnitCircleTransformer.scala:117-130
PERIOD_SIZES = {
    "HourOfDay": 24,
    "DayOfWeek": 7,
    "DayOfMonth": 31,
    "DayOfYear": 366,
    "MonthOfYear": 12,
    "WeekOfMonth": 6,
    "WeekOfYear": 53,
}


def _resolve_reference_date(ref: Optional[float]) -> float:
    """None -> fit-time now (TransmogrifierDefaults.ReferenceDate =
    DateTimeUtils.now()); the captured value lives in the fitted model so
    save/load round-trips it."""
    if ref is not None:
        return float(ref)
    import time

    return time.time() * 1000.0


def _epoch_days(epoch_ms: np.ndarray) -> np.ndarray:
    safe = np.where(np.isfinite(epoch_ms), epoch_ms, 0.0)
    return np.floor(safe / MS_PER_DAY).astype(np.int64)


def day_of_week0(epoch_ms: np.ndarray) -> np.ndarray:
    """ISO day of week, 0-based (Monday=0 .. Sunday=6); epoch day 0 was a
    Thursday."""
    return (_epoch_days(epoch_ms) + 3) % 7


def hour_of_day(epoch_ms: np.ndarray) -> np.ndarray:
    safe = np.where(np.isfinite(epoch_ms), epoch_ms, 0.0)
    return np.floor(safe / MS_PER_HOUR).astype(np.int64) % 24


def day_of_month0(epoch_ms: np.ndarray) -> np.ndarray:
    """0-based day of month (reference uses dayOfMonth - 1)."""
    d = _epoch_days(epoch_ms).astype("datetime64[D]")
    return (d - d.astype("datetime64[M]").astype("datetime64[D]")).astype(
        np.int64
    )


def month_of_year0(epoch_ms: np.ndarray) -> np.ndarray:
    """0-based month (reference uses monthOfYear - 1)."""
    m = _epoch_days(epoch_ms).astype("datetime64[D]").astype("datetime64[M]")
    return (m - m.astype("datetime64[Y]").astype("datetime64[M]")).astype(
        np.int64
    )


def day_of_year0(epoch_ms: np.ndarray) -> np.ndarray:
    d = _epoch_days(epoch_ms).astype("datetime64[D]")
    return (d - d.astype("datetime64[Y]").astype("datetime64[D]")).astype(
        np.int64
    )


def iso_week_of_year(epoch_ms: np.ndarray) -> np.ndarray:
    """ISO-8601 week of weekyear, 1-based (the week containing the year's
    first Thursday is week 1) — Joda's weekOfWeekyear."""
    days = _epoch_days(epoch_ms)
    d = days.astype("datetime64[D]")
    monday0 = (days + 3) % 7
    thursday = d + (3 - monday0).astype("timedelta64[D]")
    year_start = thursday.astype("datetime64[Y]").astype("datetime64[D]")
    return (thursday - year_start).astype(np.int64) // 7 + 1


def _first_of_month_ms(epoch_ms: np.ndarray) -> np.ndarray:
    d = _epoch_days(epoch_ms).astype("datetime64[D]")
    first = d.astype("datetime64[M]").astype("datetime64[D]")
    return first.astype(np.int64) * MS_PER_DAY


def period_value(epoch_ms: np.ndarray, period: str) -> np.ndarray:
    """The 0-based period value the reference feeds into the circle
    (getPeriodWithSize's first element, DateToUnitCircleTransformer.scala:
    117-130)."""
    if period == "HourOfDay":
        return hour_of_day(epoch_ms)
    if period == "DayOfWeek":
        return day_of_week0(epoch_ms)
    if period == "DayOfMonth":
        return day_of_month0(epoch_ms)
    if period == "DayOfYear":
        return day_of_year0(epoch_ms)
    if period == "MonthOfYear":
        return month_of_year0(epoch_ms)
    if period == "WeekOfYear":
        return iso_week_of_year(epoch_ms) - 1
    if period == "WeekOfMonth":
        # reference: weekOfWeekyear - weekOfWeekyear(first of month), raw
        # (can exceed [0, 6) across ISO year boundaries — kept for parity)
        return iso_week_of_year(epoch_ms) - iso_week_of_year(
            _first_of_month_ms(epoch_ms)
        )
    raise ValueError(f"unknown time period {period!r}")


def period_fraction(epoch_ms: np.ndarray, period: str) -> np.ndarray:
    """Position within the period as a fraction (value / period size)."""
    return period_value(epoch_ms, period) / float(PERIOD_SIZES[period])


class DateVectorizerModel(SequenceVectorizerModel):
    def __init__(self, periods: Sequence[str], track_nulls: bool,
                 with_time_since: bool = False,
                 reference_date_ms: float = 0.0, **kw) -> None:
        super().__init__(**kw)
        self.periods = tuple(periods)
        self.track_nulls = track_nulls
        self.with_time_since = with_time_since
        self.reference_date_ms = float(reference_date_ms)

    def blocks_for(self, col: Column, i: int):
        assert isinstance(col, NumericColumn)
        feat = self.input_features[i]
        blocks = []
        for p in self.periods:
            frac = period_fraction(col.values, p)
            rad = 2.0 * np.pi * frac
            for trig in (np.sin, np.cos):
                blocks.append(np.where(col.mask, trig(rad), 0.0))
        if self.with_time_since:
            # the reference's Date vectorize combines the unit circles with
            # toDateList().vectorize(SinceLast): whole days between the
            # date and the reference date (RichDateFeature.scala:105-108)
            days = np.trunc(
                (self.reference_date_ms
                 - np.where(col.mask, col.values, 0.0)) / MS_PER_DAY
            )
            blocks.append(np.where(col.mask, days, 0.0))
        if self.track_nulls:
            blocks.append((~col.mask).astype(np.float64))

        def build():
            tname = feat.ftype.type_name()
            ms = [
                VectorColumnMeta(
                    parent_feature_name=feat.name,
                    parent_feature_type=tname,
                    descriptor_value=f"{p}_{name}",
                )
                for p in self.periods
                for name in ("sin", "cos")
            ]
            if self.with_time_since:
                ms.append(
                    VectorColumnMeta(
                        parent_feature_name=feat.name,
                        parent_feature_type=tname,
                        descriptor_value="SinceLast",
                    )
                )
            if self.track_nulls:
                ms.append(
                    VectorColumnMeta(
                        parent_feature_name=feat.name,
                        parent_feature_type=tname,
                        grouping=feat.name,
                        indicator_value=NULL_STRING,
                    )
                )
            return ms

        metas = self.cached_metas(
            i,
            (feat.name, feat.ftype.type_name(), self.periods,
             self.track_nulls, self.with_time_since),
            build,
        )
        return np.stack(blocks, axis=1), metas


class DateVectorizer(SequenceVectorizer):
    """Circular encodings of configured periods, optionally combined with
    the reference's days-since-reference column (reference:
    RichDateFeature.vectorize:97-110 = toUnitCircle per period ++
    toDateList().vectorize(SinceLast))."""

    input_types = [Date, ...]

    def __init__(
        self,
        periods: Sequence[str] = DEFAULT_PERIODS,
        track_nulls: bool = True,
        with_time_since: bool = False,
        reference_date_ms: Optional[float] = None,
        **kw,
    ) -> None:
        super().__init__(**kw)
        self.periods = tuple(periods)
        self.track_nulls = track_nulls
        self.with_time_since = with_time_since
        self.reference_date_ms = reference_date_ms

    def fit_model(self, cols: Sequence[Column], ds: Dataset):
        return DateVectorizerModel(
            self.periods, self.track_nulls,
            with_time_since=self.with_time_since,
            reference_date_ms=_resolve_reference_date(self.reference_date_ms),
        )


# ---------------------------------------------------------------------------
# DateList pivots (reference: DateListVectorizer.scala:49-260)

DATE_LIST_PIVOTS = ("SinceFirst", "SinceLast", "ModeDay", "ModeMonth",
                    "ModeHour")

_DAY_NAMES = ("Monday", "Tuesday", "Wednesday", "Thursday", "Friday",
              "Saturday", "Sunday")
_MONTH_NAMES = ("January", "February", "March", "April", "May", "June",
                "July", "August", "September", "October", "November",
                "December")


def _mode_onehot(vals: list, lens: np.ndarray, nonempty: np.ndarray,
                 field_fn, size: int) -> np.ndarray:
    """Per-row one-hot of the modal field value (ties -> smallest value,
    the reference's minBy((-count, value))); empty rows all-zero."""
    n = len(vals)
    onehot = np.zeros((n, size), dtype=np.float64)
    if nonempty.any():
        flat = np.concatenate(
            [np.asarray(v, dtype=np.float64) for v in vals if len(v)]
        )
        seg = np.repeat(np.arange(n), lens)
        field = np.clip(field_fn(flat), 0, size - 1)
        counts = np.zeros((n, size), dtype=np.float64)
        np.add.at(counts, (seg, field), 1.0)
        # argmax takes the FIRST max -> smallest field value on ties
        mode = counts.argmax(axis=1)
        onehot[nonempty, mode[nonempty]] = 1.0
    return onehot


class DateListVectorizerModel(SequenceVectorizerModel):
    def __init__(self, pivot: str, reference_date_ms: float,
                 fill_value: float, track_nulls: bool, **kw) -> None:
        super().__init__(**kw)
        self.pivot = pivot
        self.reference_date_ms = float(reference_date_ms)
        self.fill_value = float(fill_value)
        self.track_nulls = track_nulls

    def blocks_for(self, col: Column, i: int):
        assert isinstance(col, ListColumn)
        feat = self.input_features[i]
        vals = col.values
        n = len(vals)
        lens = np.fromiter((len(v) for v in vals), dtype=np.int64, count=n)
        nonempty = lens > 0
        tname = feat.ftype.type_name()
        if self.pivot in ("SinceFirst", "SinceLast"):
            pick = min if self.pivot == "SinceFirst" else max
            compare = np.array(
                [float(pick(v)) if len(v) else 0.0 for v in vals]
            )
            # Joda Days.daysBetween(event, reference).getDays: whole days,
            # truncated toward zero (negative when the event is after the
            # reference date)
            days = np.trunc(
                (self.reference_date_ms - compare) / MS_PER_DAY
            )
            out = np.where(nonempty, days, self.fill_value)[:, None]
            names: tuple = ()
        elif self.pivot == "ModeDay":
            out = _mode_onehot(vals, lens, nonempty, day_of_week0, 7)
            names = _DAY_NAMES
        elif self.pivot == "ModeMonth":
            out = _mode_onehot(vals, lens, nonempty, month_of_year0, 12)
            names = _MONTH_NAMES
        elif self.pivot == "ModeHour":
            out = _mode_onehot(vals, lens, nonempty, hour_of_day, 24)
            # reference names hour columns "0:00".."23:00"
            # (DateListVectorizer.scala:275)
            names = tuple(f"{h}:00" for h in range(24))
        else:  # pragma: no cover - validated at construction
            raise ValueError(self.pivot)
        if self.track_nulls:
            out = np.concatenate(
                [out, (~nonempty).astype(np.float64)[:, None]], axis=1
            )

        def build():
            ms = (
                [
                    VectorColumnMeta(
                        parent_feature_name=feat.name,
                        parent_feature_type=tname,
                        descriptor_value=self.pivot,
                    )
                ]
                if not names
                else [
                    VectorColumnMeta(
                        parent_feature_name=feat.name,
                        parent_feature_type=tname,
                        grouping=feat.name,
                        indicator_value=name,
                    )
                    for name in names
                ]
            )
            if self.track_nulls:
                ms.append(
                    VectorColumnMeta(
                        parent_feature_name=feat.name,
                        parent_feature_type=tname,
                        grouping=feat.name,
                        indicator_value=NULL_STRING,
                    )
                )
            return ms

        metas = self.cached_metas(
            i, (feat.name, tname, self.pivot, self.track_nulls), build
        )
        return out, metas


class DateListVectorizer(SequenceVectorizer):
    """Pivot DateList features (reference: DateListVectorizer.scala setPivot
    :173-186): SinceFirst/SinceLast -> whole days between the first/last
    event and a reference date; ModeDay/ModeMonth/ModeHour -> one-hot of
    the modal calendar field (ties to the smallest value).  The reference
    date defaults to fit-time now (TransmogrifierDefaults.ReferenceDate =
    DateTimeUtils.now()) and is captured into the model so save/load
    round-trips it."""

    input_types = [DateList, ...]

    def __init__(
        self,
        pivot: str = "SinceLast",
        reference_date_ms: Optional[float] = None,
        fill_value: float = 0.0,
        track_nulls: bool = True,
        **kw,
    ) -> None:
        super().__init__(**kw)
        if pivot not in DATE_LIST_PIVOTS:
            raise ValueError(
                f"pivot must be one of {DATE_LIST_PIVOTS}, got {pivot!r}"
            )
        self.pivot = pivot
        self.reference_date_ms = reference_date_ms
        self.fill_value = float(fill_value)
        self.track_nulls = track_nulls

    def fit_model(self, cols: Sequence[Column], ds: Dataset):
        return DateListVectorizerModel(
            self.pivot,
            _resolve_reference_date(self.reference_date_ms),
            self.fill_value,
            self.track_nulls,
        )
