"""Iris multiclass classification example.

Counterpart of the reference helloworld app (reference: helloworld/src/main/
scala/com/salesforce/hw/iris/OpIris.scala + IrisFeatures.scala):
MultiClassificationModelSelector (RF / NB per BASELINE.md config 4) over the
four measurements.  Mirrors the reference's label flow exactly: the STRING
class column is indexed in-workflow (`irisClass.indexed()`, the
OpStringIndexerNoFilter step) and the numeric prediction is de-indexed
back to label strings (PredictionDeIndexer) as a second result feature.
"""
from __future__ import annotations

import csv
import os
from typing import Optional

from .. import dsl as _dsl  # noqa: F401
from ..features.feature_builder import FeatureBuilder
from ..ops.transmogrifier import transmogrify
from ..preparators.deindexer import PredictionDeIndexer
from ..types import feature_types as ft
from ..types.columns import column_from_list
from ..types.dataset import Dataset
from ..workflow.workflow import OpWorkflow

#: iris.data (no header); the default is its path in a checkout of the
#: upstream TransmogrifAI repository
IRIS_DATA = os.environ.get(
    "IRIS_DATA",
    os.path.join("helloworld", "src", "main", "resources", "IrisDataset",
                 "iris.data"),
)
COLUMNS = ["sepal_length", "sepal_width", "petal_length", "petal_width", "irisClass"]


def load_iris(path: Optional[str] = None) -> tuple[Dataset, list[str]]:
    """Columnar iris with the RAW string class column (indexing happens in
    the workflow, like the reference).

    ``labels`` is the SORTED distinct class set for display/tests - it is
    NOT the class-index order, which the fitted StringIndexer determines
    by frequency (ties by value); decode predictions with the workflow's
    PredictionDeIndexer output, never with ``labels[int(pred)]``."""
    rows = []
    with open(path or IRIS_DATA, newline="") as f:
        for r in csv.reader(f):
            if len(r) == 5:
                rows.append(r)
    labels = sorted({r[4] for r in rows})
    cols: dict[str, list] = {
        "sepal_length": [float(r[0]) for r in rows],
        "sepal_width": [float(r[1]) for r in rows],
        "petal_length": [float(r[2]) for r in rows],
        "petal_width": [float(r[3]) for r in rows],
        "irisClass": [r[4] for r in rows],
    }
    types: dict = {c: ft.Real for c in COLUMNS}
    types["irisClass"] = ft.PickList
    return (
        Dataset({c: column_from_list(v, types[c]) for c, v in cols.items()}),
        labels,
    )


def iris_workflow(path: Optional[str] = None, selector=None,
                  device: str = "cuda"):
    """Returns (workflow, indexed_label_feature, prediction,
    deindexed_prediction, labels) on ``device`` (the card by default); a
    ``selector`` passed in is built for the same device."""
    iris_class = FeatureBuilder(ft.PickList, "irisClass").as_response()
    label = iris_class.indexed()  # frequency-ordered, like the reference
    predictors = [
        FeatureBuilder(ft.Real, c).as_predictor() for c in COLUMNS[:4]
    ]
    features = transmogrify(predictors)
    if selector is None:
        from ..selector.factories import MultiClassificationModelSelector

        selector = MultiClassificationModelSelector.with_cross_validation(
            num_folds=3,
            model_types_to_use=["OpRandomForestClassifier", "OpNaiveBayes"],
            device=device,
        )
    prediction = selector.set_input(label, features).get_output()
    deindexed = (
        PredictionDeIndexer().set_input(iris_class, prediction).get_output()
    )
    data, labels = load_iris(path)
    wf = (
        OpWorkflow(device=device)
        .set_result_features(prediction, deindexed)
        .set_input_dataset(data)
    )
    return wf, label, prediction, deindexed, labels
