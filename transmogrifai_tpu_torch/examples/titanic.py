"""Titanic binary-classification example.

Counterpart of the reference helloworld app (reference: helloworld/src/main/
scala/com/salesforce/hw/OpTitanicSimple.scala): same raw feature typing
(pClass/sex/cabin/embarked/ticket as PickList, age/fare Real, sibSp/parCh
Integral), same derived features (familySize, estimatedCostOfTickets,
pivotedSex, normedAge, ageGroup), transmogrify -> sanityCheck ->
model selection.
"""
from __future__ import annotations

import os
from typing import Optional

from .. import dsl as _dsl  # noqa: F401 - patches Feature operators
from ..features.feature_builder import FeatureBuilder
from ..ops.transmogrifier import transmogrify
from ..readers.csv_reader import CSVReader
from ..types import feature_types as ft
from ..workflow.workflow import OpWorkflow

#: the Titanic data, headerless (``TITANIC_COLUMNS``); the default is its
#: path in a checkout of the upstream TransmogrifAI repository
TITANIC_CSV = os.environ.get(
    "TITANIC_CSV", os.path.join("test-data", "PassengerDataAll.csv")
)
TITANIC_COLUMNS = [
    "id", "survived", "pClass", "name", "sex", "age",
    "sibSp", "parCh", "ticket", "fare", "cabin", "embarked",
]


def titanic_reader(path: Optional[str] = None) -> CSVReader:
    return CSVReader(
        path or TITANIC_CSV, headers=TITANIC_COLUMNS, has_header=False
    )


def titanic_features():
    """Raw + derived features, mirroring OpTitanicSimple."""
    survived = FeatureBuilder(ft.RealNN, "survived").as_response()
    p_class = FeatureBuilder(ft.PickList, "pClass").as_predictor()
    name = FeatureBuilder(ft.Text, "name").as_predictor()
    sex = FeatureBuilder(ft.PickList, "sex").as_predictor()
    age = FeatureBuilder(ft.Real, "age").as_predictor()
    sib_sp = FeatureBuilder(ft.Integral, "sibSp").as_predictor()
    par_ch = FeatureBuilder(ft.Integral, "parCh").as_predictor()
    ticket = FeatureBuilder(ft.PickList, "ticket").as_predictor()
    fare = FeatureBuilder(ft.Real, "fare").as_predictor()
    cabin = FeatureBuilder(ft.PickList, "cabin").as_predictor()
    embarked = FeatureBuilder(ft.PickList, "embarked").as_predictor()

    family_size = sib_sp + par_ch + 1
    estimated_cost = family_size * fare
    pivoted_sex = sex.pivot()
    normed_age = age.fill_missing_with_mean().z_normalize()
    age_group = age.map_values(
        lambda v: None if v is None else ("adult" if v > 18 else "child"),
        ft.PickList,
    )

    predictors = [
        p_class, name, age, sib_sp, par_ch, ticket, cabin, embarked,
        family_size, estimated_cost, pivoted_sex, age_group, normed_age,
    ]
    return survived, predictors


def titanic_workflow(
    path: Optional[str] = None,
    selector=None,
    reserve_test_fraction: float = 0.1,
    split_seed: int = 42,
    device: str = "cuda",
):
    """Build the full Titanic workflow on ``device`` (the card by default).
    ``selector=None`` fits a plain logistic regression (BASELINE.md config
    2); otherwise pass a ModelSelector stage factory result, built for the
    same device."""
    survived, predictors = titanic_features()
    feature_vector = transmogrify(predictors)
    checked = survived.sanity_check(feature_vector, remove_bad_features=True,
                                    device=device)

    if selector is None:
        from ..models.logistic_regression import OpLogisticRegression

        pred_stage = OpLogisticRegression(reg_param=0.01, device=device)
    else:
        pred_stage = selector
    prediction = pred_stage.set_input(survived, checked).get_output()

    wf = (
        OpWorkflow(device=device)
        .set_result_features(prediction, survived.copy())
        .set_reader(titanic_reader(path))
        .set_parameters(
            reserve_test_fraction=reserve_test_fraction, split_seed=split_seed
        )
    )
    return wf, survived, prediction
