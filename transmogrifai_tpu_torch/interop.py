"""Carry a workflow's fitted state across from the JAX package.

``load_reference_state`` turns the fitted state of a workflow trained by
``transmogrifai_tpu`` into this package's fitted ``OpWorkflowModel`` for
the same code-defined workflow, so the same fitted model can be scored on
either side.  The state arrives as plain data - for each stage of the
fitted DAG, its class name and its ``stage_state(stage)`` dict of numpy
arrays and Python values (``serialization/model_io.py`` in either
package) - so this package never imports the other: the caller extracts
the state on the JAX side.

A model selector's fitted stage is the JAX package's ``SelectedModel``:
its state holds the winner's ``model_params`` as every predictor's does,
and also needs the selection summary (the fitted stage's
``metadata["model_selector_summary"]``, which names the winning family
and its grid point) under the key ``"model_selector_summary"``; the
winner is rebuilt from the selector's own candidates.

``load_reference_artifact`` does the same from a model directory that the
JAX package's ``save_model`` wrote: this package's ``model_io`` verifies
the manifest and reads ``model.json`` and ``arrays.npz`` (json, hashlib
and numpy only), and the saved schema contract comes along.  This
package's own ``load_model`` cannot read such an artifact, because its
class paths name the JAX package's modules.
"""
from __future__ import annotations

from typing import Any, Mapping, Sequence

from .models.base import PredictorEstimator, PredictorModel
from .models.unsupervised import OpLDA, OpLDAModel, OpWord2Vec, OpWord2VecModel
from .ops.bucketizers import DecisionTreeNumericBucketizer, NumericBucketizerModel
from .ops.categorical import OneHotModel, OneHotVectorizer
from .ops.maps import MapVectorizer, MapVectorizerModel
from .ops.text import CountVectorizerModel, OpCountVectorizer
from .ops.numeric import (
    BinaryVectorizer,
    IntegralVectorizer,
    NumericVectorizerModel,
    RealNNVectorizer,
    RealVectorizer,
)
from .ops.scalers import (
    FillMissingWithMean,
    OpScalarStandardScaler,
    PercentileCalibrator,
    _FillMeanModel,
    _PercentileModel,
    _ScaleModel,
)
from .preparators.sanity_checker import SanityChecker, SanityCheckerModel
from .selector.model_selector import ModelSelector, SelectedModel
from .serialization import model_io
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
    FillMissingWithMean: (_FillMeanModel, ("fill",)),
    OpScalarStandardScaler: (_ScaleModel, ("mean", "std")),
    PercentileCalibrator: (_PercentileModel, ("splits", "buckets")),
    MapVectorizer: (
        MapVectorizerModel, ("plans", "track_nulls", "clean_text", "clean_keys"),
    ),
    OpCountVectorizer: (CountVectorizerModel, ("vocabulary", "min_tf", "binary")),
    OpLDA: (OpLDAModel, ("topics", "alpha")),
    OpWord2Vec: (OpWord2VecModel, ("vocab", "vectors")),
}


def _selected_for(stage: ModelSelector, state: Mapping[str, Any]):
    """The winner of a reference-fitted selection, rebuilt from ``stage``'s
    candidates: the first of the winning family, with the winning grid
    point's params, scoring the carried ``model_params``."""
    summary = state["model_selector_summary"]
    family = summary["best_model_type"]
    ests = [est for est, _ in stage.models if est.model_type == family]
    if not ests:
        raise ValueError(
            f"stage {stage.uid} has no {family} candidate to carry the "
            "reference's winner"
        )
    stage._to_device()
    model = SelectedModel(ests[0].with_params(**summary["best_params"]),
                          state["model_params"], stage)
    model.metadata = {"model_selector_summary": dict(summary)}
    return model


def _fitted_for(stage: Estimator, cls_name: str, state: Mapping[str, Any]):
    if isinstance(stage, ModelSelector):
        if cls_name != SelectedModel.__name__:
            raise ValueError(
                f"stage {stage.uid} ({type(stage).__name__}) pairs with a "
                f"fitted {cls_name}, expected {SelectedModel.__name__}"
            )
        return _selected_for(stage, state)
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
    model = cls(**{k: state[k] for k in fields})
    if hasattr(stage, "device") and hasattr(model, "device"):
        model.device = stage.device  # a fitted device stage runs where its estimator did
    return model


def load_reference_state(
    workflow: OpWorkflow, states: Sequence[tuple[str, Mapping[str, Any]]]
) -> OpWorkflowModel:
    """Fitted model of ``workflow`` from reference-fitted stage states.

    ``states`` holds one ``(class name, stage_state dict)`` pair for each
    stage of the reference's fitted DAG, in DAG order; stages pair with
    ``workflow``'s DAG positionally, as the JAX package's ``load_model``
    pairs them.  Carried over: vectorizer fills and vocabularies,
    bucketizer splits, ``indices_to_keep``, and every predictor's
    ``model_params`` as they are (the binary linear models' and linear
    regression's ``beta`` and ``intercept``; multiclass logistic
    regression's ``betas``, ``intercepts``, ``classes`` and ``family``,
    multinomial or OvR; the tree heaps, edges, classes and GBT margin
    terms; naive Bayes' ``theta``, ``prior``, ``classes`` and ``shift``;
    the GLM's ``beta``, ``intercept``, ``family`` and ``link_power``; the
    MLP's ``layers``, ``classes``, ``mu`` and ``sd``), ``OpLDAModel``'s
    ``topics`` and ``alpha``, ``OpWord2VecModel``'s ``vocab`` and
    ``vectors``, and a model selector's winner - binary, multiclass or
    regression.  Estimators in the result score on ``workflow.device``.
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
        device=workflow.device,
    )


def load_reference_artifact(path: str, workflow: OpWorkflow) -> OpWorkflowModel:
    """Fitted model of ``workflow`` from the model directory ``path`` that
    the JAX package's ``save_model`` wrote (``model.json``, ``arrays.npz``
    and ``manifest.json``, checksum-verified; ``.last-good`` recovery as
    in ``model_io.load_model``).  Each saved stage's class name and
    decoded state pair with ``workflow``'s DAG as in
    :func:`load_reference_state`; a selected model's summary comes from
    its saved metadata.  The saved schema contract, when there is one,
    becomes the model's.  Estimators score on ``workflow.device``."""
    path, doc, arrays = model_io.read_artifact(path)
    # the saved RawFeatureFilter blacklist cuts the same stages out of
    # ``workflow``'s DAG before the states pair with it
    model_io.apply_saved_blacklist(doc, workflow)
    states = []
    for saved in doc["stages"]:
        state = dict(model_io._decode(saved["state"], arrays))
        meta = model_io._decode(saved["metadata"], arrays)
        if "model_selector_summary" in meta:
            state.setdefault("model_selector_summary",
                             meta["model_selector_summary"])
        states.append((saved["class"].rpartition(".")[2], state))
    model = load_reference_state(workflow, states)
    model.blacklisted_features = list(workflow.blacklisted_features)
    model.parameters = dict(model_io._decode(doc["parameters"], arrays))
    model.train_time_s = doc.get("train_time_s", 0.0)
    model.schema_contract = model_io.read_schema_contract(path)
    return model
