"""The torch package's date stages (``ops/dates.py``) against the JAX
package's: the exact UTC calendar fields (with the ISO-week and month
boundaries of the JAX package's ``tests/test_dates_depth.py``), the
periods' fractions, ``DateVectorizer``'s circular representations and days
since the reference date, and ``DateListVectorizer``'s pivots, values and
metadata bit-equal.  The reference date is pinned on both sides: left at
None it is the time of the fit."""
import datetime as _dt

import numpy as np
import pytest

from torch_parity import (
    PORT, REF, REFERENCE_DATE_MS, assert_features_match, assert_same, mod,
)

FIELDS = ("hour_of_day", "day_of_week0", "day_of_month0", "month_of_year0",
          "day_of_year0", "iso_week_of_year")


def _ms(y, m, d, h=0, mi=0):
    return _dt.datetime(y, m, d, h, mi,
                        tzinfo=_dt.timezone.utc).timestamp() * 1000.0


def _boundary_dates() -> np.ndarray:
    """The JAX package's calendar cases: month starts, leap days, the
    epoch, the ISO-week turns (2019-12-30 is week 1 of 2020, 2021-01-01
    week 53 of 2020, 2016-01-01 week 53 of 2015), pre-epoch days, and
    500 random hours 1950-2050."""
    fixed = [_ms(2018, 1, 1, 6, 37), _ms(2019, 2, 1), _ms(2020, 12, 1),
             _ms(1969, 7, 1), _ms(2019, 12, 31, 13), _ms(2020, 2, 29, 13),
             _ms(2021, 3, 14, 13), _ms(1970, 1, 1), _ms(1969, 12, 31, 23, 59),
             _ms(2000, 2, 29), _ms(2024, 9, 30), _ms(2019, 12, 30),
             _ms(2021, 1, 1), _ms(2016, 1, 1), _ms(2021, 3, 1),
             _ms(1900, 3, 1), _ms(2099, 12, 31, 23)]
    rng = np.random.RandomState(11)
    days = rng.randint(-7305, 29220, size=500)
    hours = rng.randint(0, 24, size=500)
    return np.concatenate([fixed, days * 86_400_000.0 + hours * 3_600_000.0])


@pytest.mark.parametrize("field", FIELDS)
def test_calendar_fields(field):
    ts = _boundary_dates()
    want = getattr(mod(REF, "ops.dates"), field)(ts)
    got = getattr(mod(PORT, "ops.dates"), field)(ts)
    assert_same(got, want, field)
    if field == "iso_week_of_year":
        assert list(got[11:14]) == [1, 53, 53]


@pytest.mark.parametrize("period", sorted(
    mod(REF, "ops.dates").PERIOD_SIZES))
def test_period_value_and_fraction(period):
    ts = _boundary_dates()
    ref, port = mod(REF, "ops.dates"), mod(PORT, "ops.dates")
    assert port.PERIOD_SIZES == ref.PERIOD_SIZES
    assert_same(port.period_value(ts, period), ref.period_value(ts, period))
    assert_same(port.period_fraction(ts, period),
                ref.period_fraction(ts, period))


def _date_features(pkg: str) -> list:
    mod(pkg, "dsl")
    dates = mod(pkg, "ops.dates")
    fb = mod(pkg, "features.feature_builder").FeatureBuilder
    d, dt = fb.Date("f_date").as_predictor(), fb.DateTime("f_datetime").as_predictor()
    dl = fb.DateList("f_datelist").as_predictor()
    every = tuple(sorted(dates.PERIOD_SIZES))
    out = [
        dates.DateVectorizer(reference_date_ms=REFERENCE_DATE_MS)
        .set_input(d, dt).get_output(),
        dates.DateVectorizer(periods=every, track_nulls=False,
                             with_time_since=True,
                             reference_date_ms=REFERENCE_DATE_MS)
        .set_input(dt).get_output(),
        d.to_unit_circle(), dt.to_unit_circle("DayOfYear"),
        d.vectorize(reference_date_ms=REFERENCE_DATE_MS),
        d.to_date_list(),
    ]
    for pivot in dates.DATE_LIST_PIVOTS:
        out.append(dates.DateListVectorizer(
            pivot=pivot, reference_date_ms=REFERENCE_DATE_MS)
            .set_input(dl).get_output())
    out.append(dates.DateListVectorizer(
        pivot="SinceFirst", reference_date_ms=REFERENCE_DATE_MS,
        fill_value=-1.0, track_nulls=False).set_input(dl).get_output())
    out.append(dl.vectorize(reference_date_ms=REFERENCE_DATE_MS))
    return out


def test_date_stages_match_reference():
    got = assert_features_match(_date_features, n=400)
    # two dates: four periods as (sin, cos) and a null indicator each
    assert got[0][2].shape == (400, 2 * (2 * 4 + 1))


def test_fit_time_reference_date_is_captured():
    """``reference_date_ms=None`` captures the time of the fit, as in the
    JAX package: days since a date fitted now exceed those since the
    pinned date by the days between."""
    def build(pkg):
        dates = mod(pkg, "ops.dates")
        d = mod(pkg, "features.feature_builder").FeatureBuilder.Date(
            "f_date").as_predictor()
        return [dates.DateVectorizer(periods=(), with_time_since=True)
                .set_input(d).get_output(),
                dates.DateVectorizer(periods=(), with_time_since=True,
                                     reference_date_ms=REFERENCE_DATE_MS)
                .set_input(d).get_output()]

    from torch_parity import run_features

    now, pinned = run_features(PORT, build, 50)
    gap = (_dt.datetime.now(_dt.timezone.utc).timestamp() * 1e3
           - REFERENCE_DATE_MS) / 86_400_000.0
    present = now[2][:, 1] == 0.0  # the null indicator
    assert present.sum() > 40
    diff = (now[2][:, 0] - pinned[2][:, 0])[present]
    assert np.all(np.abs(diff - gap) < 1.0), (diff[:3], gap)


def test_invalid_pivot_rejected():
    with pytest.raises(ValueError, match="pivot"):
        mod(PORT, "ops.dates").DateListVectorizer(pivot="SinceForever")
