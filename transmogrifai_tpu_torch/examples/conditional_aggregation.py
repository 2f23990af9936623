"""Conditional-aggregation data-prep example.

Counterpart of the reference's helloworld dataprep app
(helloworld/src/main/scala/com/salesforce/hw/dataprep/
ConditionalAggregation.scala): web-visit events, predicting the
likelihood of a purchase within a day of a user landing on a target
page.  The ConditionalReader sets a PER-KEY cutoff at the first event
matching ``target_condition`` (landing on /deals); predictors aggregate
before each user's own cutoff, responses within ``response_window``
after it; users who never meet the condition are dropped
(readers/events.py ConditionalReader, reference
ConditionalParams(dropIfTargetConditionNotMet = true)).

* ``numVisitsWeekPrior``  - visits in the 7 days before the user's
  landing (predictor)
* ``numPurchasesNextDay`` - purchases in the day after it (response)
"""
from __future__ import annotations

from datetime import datetime, timezone

from .. import dsl as _dsl  # noqa: F401 - import activates the feature DSL
from ..features.aggregators import SumNumeric
from ..features.feature_builder import FeatureBuilder
from ..readers.events import ConditionalReader
from ..types import feature_types as ft
from ..workflow.workflow import OpWorkflow

DAY = 86400.0
TARGET_URL = "https://shop.example.com/deals"


def _ts(s: str) -> float:
    return datetime.strptime(s, "%Y-%m-%d %H:%M").replace(
        tzinfo=timezone.utc
    ).timestamp()


# userId, url, productId (purchase marker), price, timestamp
VISITS = [
    # ann: 3 browse visits in the week before landing on /deals, then a
    # purchase 30 min after landing -> predictor 3, response 1
    {"userId": "ann", "url": "https://shop.example.com/grills",
     "productId": None, "price": None, "ts": "2021-03-01 10:00"},
    {"userId": "ann", "url": "https://shop.example.com/grills",
     "productId": None, "price": None, "ts": "2021-03-03 10:30"},
    {"userId": "ann", "url": "https://shop.example.com/patio",
     "productId": None, "price": None, "ts": "2021-03-03 10:45"},
    {"userId": "ann", "url": TARGET_URL,
     "productId": None, "price": None, "ts": "2021-03-04 08:00"},
    {"userId": "ann", "url": "https://shop.example.com/cart",
     "productId": 1234, "price": 100.0, "ts": "2021-03-04 08:30"},
    # bob: lands on /deals with NO prior visits, buys the next morning
    # (inside the 1-day response window) -> predictor None, response 1
    {"userId": "bob", "url": TARGET_URL,
     "productId": None, "price": None, "ts": "2021-03-02 09:00"},
    {"userId": "bob", "url": "https://shop.example.com/cart",
     "productId": 5678, "price": 30.0, "ts": "2021-03-03 07:00"},
    # cat: one visit before landing, buys three days later - OUTSIDE the
    # response window -> predictor 1, response None
    {"userId": "cat", "url": "https://shop.example.com/patio",
     "productId": None, "price": None, "ts": "2021-03-05 15:00"},
    {"userId": "cat", "url": TARGET_URL,
     "productId": None, "price": None, "ts": "2021-03-06 09:00"},
    {"userId": "cat", "url": "https://shop.example.com/cart",
     "productId": 9999, "price": 50.0, "ts": "2021-03-09 12:00"},
    # dan: never lands on /deals -> dropped entirely
    {"userId": "dan", "url": "https://shop.example.com/grills",
     "productId": None, "price": None, "ts": "2021-03-02 11:00"},
]


def conditional_aggregation_workflow(device: str = "cuda"):
    """Build the conditional workflow on ``device`` (the card by default);
    returns (workflow, features)."""
    num_visits_week_prior = (
        FeatureBuilder(ft.Real, "numVisitsWeekPrior")
        .extract(lambda r: 1.0)
        .aggregate(SumNumeric)
        .window(7 * DAY)
        .as_predictor()
    )
    # a purchase event carries a productId (reference:
    # visit.productId.map(_ => 1.0).toRealNN(0.0))
    num_purchases_next_day = (
        FeatureBuilder(ft.Real, "numPurchasesNextDay")
        .extract(lambda r: 1.0 if r.get("productId") is not None else None)
        .aggregate(SumNumeric)
        .as_response()
    )
    reader = ConditionalReader(
        VISITS,
        key_fn=lambda r: r["userId"],
        time_fn=lambda r: _ts(r["ts"]),
        target_condition=lambda r: r["url"] == TARGET_URL,
        response_window=1 * DAY,
        drop_if_no_condition=True,
    )
    wf = (
        OpWorkflow(device=device)
        .set_reader(reader)
        .set_result_features(num_visits_week_prior, num_purchases_next_day)
    )
    return wf, (num_visits_week_prior, num_purchases_next_day)


def main(device: str = "cuda") -> None:
    wf, feats = conditional_aggregation_workflow(device)
    model = wf.train()
    scored = model.score()
    cols = scored.columns()
    keys = wf._reader.row_keys()
    names = [f.name for f in feats]
    print("key  " + "  ".join(names))
    for i, k in enumerate(keys):
        print(k, " ", "  ".join(
            str(cols[n].to_list()[i]) if n in cols else "None" for n in names
        ))


if __name__ == "__main__":
    main()
