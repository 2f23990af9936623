"""Carry a workflow's fitted state across from the JAX package.

``load_reference_state`` turns the fitted state of a workflow trained by
``transmogrifai_tpu`` into this package's fitted ``OpWorkflowModel`` for
the same code-defined workflow, so the same fitted model can be scored on
either side.  The state arrives as plain data - for each stage of the
fitted DAG, its class name and its ``stage_state(stage)`` dict of numpy
arrays and Python values (``serialization/model_io.py`` in either
package) - so this package never imports the other: the caller extracts
the state on the JAX side.
"""
from __future__ import annotations

from typing import Any, Mapping, Sequence

from .models.base import PredictorEstimator, PredictorModel
from .ops.bucketizers import DecisionTreeNumericBucketizer, NumericBucketizerModel
from .ops.categorical import OneHotModel, OneHotVectorizer
from .ops.numeric import (
    BinaryVectorizer,
    IntegralVectorizer,
    NumericVectorizerModel,
    RealNNVectorizer,
    RealVectorizer,
)
from .preparators.sanity_checker import SanityChecker, SanityCheckerModel
from .stages.base import Estimator
from .utils.device import resolve_device
from .workflow.dag import compute_dag, flatten
from .workflow.workflow import OpWorkflow, OpWorkflowModel

#: estimator class -> (its fitted class, the state fields that carry over)
_FITTED = {
    RealVectorizer: (NumericVectorizerModel, ("fill_values", "track_nulls")),
    IntegralVectorizer: (NumericVectorizerModel, ("fill_values", "track_nulls")),
    BinaryVectorizer: (NumericVectorizerModel, ("fill_values", "track_nulls")),
    RealNNVectorizer: (NumericVectorizerModel, ("fill_values", "track_nulls")),
    OneHotVectorizer: (
        OneHotModel, ("labels_per_feature", "track_nulls", "clean_text"),
    ),
    SanityChecker: (SanityCheckerModel, ("indices_to_keep",)),
    DecisionTreeNumericBucketizer: (
        NumericBucketizerModel, ("splits", "track_nulls"),
    ),
}


def _fitted_for(stage: Estimator, cls_name: str, state: Mapping[str, Any]):
    if isinstance(stage, PredictorEstimator):
        if cls_name != PredictorModel.__name__:
            raise ValueError(
                f"stage {stage.uid} ({type(stage).__name__}) pairs with a "
                f"fitted {cls_name}, expected {PredictorModel.__name__}"
            )
        return PredictorModel(stage, state["model_params"])
    fitted = _FITTED.get(type(stage))
    if fitted is None:
        raise NotImplementedError(
            f"no fitted-state carry-over for {type(stage).__name__}"
        )
    cls, fields = fitted
    if cls_name != cls.__name__:
        raise ValueError(
            f"stage {stage.uid} ({type(stage).__name__}) pairs with a "
            f"fitted {cls_name}, expected {cls.__name__}"
        )
    return cls(**{k: state[k] for k in fields})


def load_reference_state(
    workflow: OpWorkflow, states: Sequence[tuple[str, Mapping[str, Any]]]
) -> OpWorkflowModel:
    """Fitted model of ``workflow`` from reference-fitted stage states.

    ``states`` holds one ``(class name, stage_state dict)`` pair for each
    stage of the reference's fitted DAG, in DAG order; stages pair with
    ``workflow``'s DAG positionally, as the JAX package's ``load_model``
    pairs them.  Carried over: vectorizer fills and vocabularies,
    bucketizer splits, ``indices_to_keep``, and every predictor's
    ``model_params`` as they are (the logistic regression's ``beta`` and
    ``intercept``; the tree heaps, edges and GBT margin terms).  Estimators in the result score on ``workflow.device``.
    """
    resolve_device(workflow.device)
    stages = flatten(compute_dag(workflow.result_features))
    if len(stages) != len(states):
        raise ValueError(
            f"workflow has {len(stages)} stages but {len(states)} states were "
            "given; the states must come from the same code-defined workflow"
        )
    fitted = []
    for stage, (cls_name, state) in zip(stages, states):
        if not isinstance(stage, Estimator):
            if cls_name != type(stage).__name__:
                raise ValueError(
                    f"stage {stage.uid} ({type(stage).__name__}) pairs with "
                    f"a fitted {cls_name}"
                )
            fitted.append(stage)  # a transformer carries no fitted state
            continue
        if hasattr(stage, "device"):
            stage.device = workflow.device
        fitted.append(stage.adopt(_fitted_for(stage, cls_name, state)))
    return OpWorkflowModel(
        result_features=workflow.result_features,
        raw_features=workflow.raw_features,
        stages=fitted,
        parameters=dict(workflow.parameters),
    )
