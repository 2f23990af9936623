"""Boston housing regression example.

Counterpart of the reference helloworld app (reference: helloworld/src/main/
scala/com/salesforce/hw/boston/OpBoston.scala + BostonFeatures.scala):
whitespace-delimited housing.data, RegressionModelSelector over the
transmogrified features (BASELINE.md config 3).
"""
from __future__ import annotations

import os
import re
from typing import Optional

from .. import dsl as _dsl  # noqa: F401
from ..features.feature_builder import FeatureBuilder
from ..ops.transmogrifier import transmogrify
from ..types import feature_types as ft
from ..types.dataset import Dataset
from ..types.columns import column_from_list
from ..workflow.workflow import OpWorkflow

#: whitespace-delimited housing.data; the default is its path in a
#: checkout of the upstream TransmogrifAI repository
BOSTON_DATA = os.environ.get(
    "BOSTON_DATA",
    os.path.join("helloworld", "src", "main", "resources", "BostonDataset",
                 "housing.data"),
)
COLUMNS = [
    "crim", "zn", "indus", "chas", "nox", "rm", "age", "dis", "rad",
    "tax", "ptratio", "b", "lstat", "medv",
]
TYPES = {
    **{c: ft.Real for c in COLUMNS},
    "chas": ft.PickList,  # reference types chas as categorical string
    "rad": ft.Integral,
    "medv": ft.RealNN,
}


def load_boston(path: Optional[str] = None) -> Dataset:
    rows = []
    with open(path or BOSTON_DATA) as f:
        for line in f:
            parts = re.split(r"\s+", line.strip())
            if len(parts) == len(COLUMNS):
                rows.append(parts)
    cols: dict[str, list] = {c: [] for c in COLUMNS}
    for r in rows:
        for c, v in zip(COLUMNS, r):
            cols[c].append(v if TYPES[c] is ft.PickList else float(v))
    return Dataset(
        {c: column_from_list(vals, TYPES[c]) for c, vals in cols.items()}
    )


def boston_workflow(path: Optional[str] = None, selector=None,
                    device: str = "cuda"):
    """Returns (workflow, label, prediction) on ``device`` (the card by
    default); a ``selector`` passed in is built for the same device."""
    medv = FeatureBuilder(ft.RealNN, "medv").as_response()
    predictors = [
        FeatureBuilder(TYPES[c], c).as_predictor()
        for c in COLUMNS
        if c != "medv"
    ]
    features = transmogrify(predictors)
    if selector is None:
        from ..selector.factories import RegressionModelSelector

        selector = RegressionModelSelector.with_cross_validation(
            num_folds=3,
            model_types_to_use=["OpLinearRegression", "OpGBTRegressor"],
            device=device,
        )
    prediction = selector.set_input(medv, features).get_output()
    wf = (
        OpWorkflow(device=device)
        .set_result_features(prediction)
        .set_input_dataset(load_boston(path))
    )
    return wf, medv, prediction
