"""Joins + aggregates data-prep example.

Counterpart of the reference's helloworld dataprep app
(helloworld/src/main/scala/com/salesforce/hw/dataprep/
JoinsAndAggregates.scala): two event tables - email SENDS and email
CLICKS - composed into a training frame with a few feature declarations:

* ``numClicksYday``     - clicks in the day before the cutoff (predictor)
* ``numSendsLastWeek``  - sends in the week before the cutoff (predictor)
* ``numClicksTomorrow`` - clicks in the day after the cutoff (response)
* ``ctr``               - numClicksYday / (numSendsLastWeek + 1), with
  predictor nulls zero-filled before the arithmetic (the reference's
  joined-null handling)

Each table rides an AggregateReader keyed by user (predictors aggregate
events <= cutoff inside their window, responses after it -
readers/events.py), and the two per-user frames meet in a left outer
JoinedReader on the user key - users with sends but no click events keep
their send features and carry nulls for the click side.

The dataset here is synthesized in-code (the reference ships two tiny
CSVs; the composition, not the data, is the point).
"""
from __future__ import annotations

from datetime import datetime, timezone

from .. import dsl as _dsl  # noqa: F401 - import activates the feature DSL
from ..features.aggregators import CutOffTime, SumNumeric
from ..features.feature_builder import FeatureBuilder
from ..readers.events import AggregateReader, JoinedReader
from ..types import feature_types as ft
from ..workflow.workflow import OpWorkflow

DAY = 86400.0


def _ts(s: str) -> float:
    """'yyyy-mm-dd HH:MM' -> epoch seconds (the reference parses
    'yyyy-MM-dd::HH:mm:ss' with joda; same contract, stdlib parser)."""
    return datetime.strptime(s, "%Y-%m-%d %H:%M").replace(
        tzinfo=timezone.utc
    ).timestamp()


CUTOFF = _ts("2021-03-10 00:00")

# sendId, userId, emailId, timestamp
SENDS = [
    {"sendId": 1, "userId": "u1", "emailId": "e1", "ts": "2021-03-03 08:00"},
    {"sendId": 2, "userId": "u1", "emailId": "e2", "ts": "2021-03-09 08:00"},
    {"sendId": 3, "userId": "u2", "emailId": "e3", "ts": "2021-03-09 12:00"},
    {"sendId": 4, "userId": "u3", "emailId": "e1", "ts": "2021-03-05 09:00"},
]

# clickId, userId, emailId, timestamp
CLICKS = [
    {"clickId": 1, "userId": "u1", "emailId": "e1", "ts": "2021-03-09 09:30"},
    {"clickId": 2, "userId": "u1", "emailId": "e2", "ts": "2021-03-09 10:00"},
    {"clickId": 3, "userId": "u1", "emailId": "e2", "ts": "2021-03-10 09:00"},
    {"clickId": 4, "userId": "u2", "emailId": "e3", "ts": "2021-03-08 12:00"},
    {"clickId": 5, "userId": "u2", "emailId": "e3", "ts": "2021-03-10 13:00"},
]


def joins_and_aggregates_workflow(device: str = "cuda"):
    """Build the joined workflow on ``device`` (the card by default);
    returns (workflow, result_features)."""
    # counting features: each matching event contributes 1.0, summed
    # (reference: FeatureBuilder.Real.extract(_ => 1.toReal)
    #  .aggregate(SumReal).window(...))
    num_clicks_yday = (
        FeatureBuilder(ft.Real, "numClicksYday")
        .extract(lambda r: 1.0)
        .aggregate(SumNumeric)
        .window(1 * DAY)
        .as_predictor()
    )
    num_sends_last_week = (
        FeatureBuilder(ft.Real, "numSendsLastWeek")
        .extract(lambda r: 1.0)
        .aggregate(SumNumeric)
        .window(7 * DAY)
        .as_predictor()
    )
    num_clicks_tomorrow = (
        FeatureBuilder(ft.Real, "numClicksTomorrow")
        .extract(lambda r: 1.0)
        .aggregate(SumNumeric)
        .window(1 * DAY)
        .as_response()
    )
    # the reference zero-fills joined nulls before the ctr arithmetic;
    # .alias names the output column 'ctr' like its .alias
    def _zero_fill(f):
        return f.map_values(lambda v: 0.0 if v is None else float(v), ft.Real)

    ctr = (
        _zero_fill(num_clicks_yday)
        / (_zero_fill(num_sends_last_week) + 1.0)
    ).alias("ctr")

    clicks_reader = AggregateReader(
        CLICKS,
        key_fn=lambda r: r["userId"],
        time_fn=lambda r: _ts(r["ts"]),
        cutoff=CutOffTime(CUTOFF),
    )
    sends_reader = AggregateReader(
        SENDS,
        key_fn=lambda r: r["userId"],
        time_fn=lambda r: _ts(r["ts"]),
        cutoff=CutOffTime(CUTOFF),
    )
    # click-side features come from the clicks reader, send-side from the
    # sends reader; sends lead the left outer join (reference:
    # sendsReader.leftOuterJoin(clicksReader))
    sends_reader.feature_names = {"numSendsLastWeek"}
    joined = JoinedReader(
        sends_reader, clicks_reader, left_key="userId", join_type="left"
    )
    wf = (
        OpWorkflow(device=device)
        .set_reader(joined)
        .set_result_features(
            num_clicks_yday, num_clicks_tomorrow, num_sends_last_week, ctr
        )
    )
    return wf, (
        num_clicks_yday, num_clicks_tomorrow, num_sends_last_week, ctr
    )


def main(device: str = "cuda") -> None:
    wf, feats = joins_and_aggregates_workflow(device)
    model = wf.train()
    scored = model.score()
    names = [f.name for f in feats]
    cols = scored.columns()
    out_of = {f.name: f for f in feats}
    keys = wf._reader.left.row_keys()
    print("key  " + "  ".join(names))
    for i, k in enumerate(keys):
        row = []
        for n in names:
            col = cols.get(n) or cols.get(out_of[n].name)
            row.append(None if col is None else col.to_list()[i])
        print(k, " ", "  ".join(str(v) for v in row))


if __name__ == "__main__":
    main()
