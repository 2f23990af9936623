"""Workflow: DAG construction, training, scoring.

Counterpart of ``transmogrifai_tpu/workflow/workflow.py`` (reference:
core/.../OpWorkflow.scala:85-563, OpWorkflowCore.scala:136-319,
OpWorkflowModel.scala:253-420, core/.../utils/stages/
FitStagesUtil.scala:96-358).

Execution model: the DAG (layers of stages) is recovered from the requested
result features; each layer fits its estimators on the train split, then
transforms train+holdout with every stage of the layer.  Transforms are
columnar numpy; the heavy numeric stages (SanityChecker statistics, model
fits) run as torch computations on the workflow's ``device``, which
defaults to ``"cuda"`` and is handed to every estimator the workflow fits.
"""
from __future__ import annotations

import json
import time
from typing import Any, Mapping, Optional, Sequence

import numpy as np

from ..features.feature import Feature
from ..stages.base import Estimator, PipelineStage, Transformer
from ..types.columns import Column, column_from_list
from ..types.dataset import Dataset
from ..utils.device import resolve_device
from .dag import Layer, compute_dag, cut_dag_during, flatten, validate_dag


def _as_dataset(data: Any, raw_features: Sequence[Feature]) -> Dataset:
    """Accept Dataset / pandas DataFrame / mapping of python lists and
    materialize the raw feature columns (reader hand-off, reference:
    OpWorkflowCore.setInputDataset:136-160)."""
    if isinstance(data, Dataset):
        return data.select([f.name for f in raw_features if f.name in data])
    cols: dict[str, Column] = {}
    if hasattr(data, "columns") and hasattr(data, "__getitem__") and not isinstance(data, Mapping):
        # pandas DataFrame
        for f in raw_features:
            if f.name not in data.columns:
                raise KeyError(f"raw feature {f.name!r} missing from input data")
            series = data[f.name]
            if f.ftype.kind == "numeric" and series.dtype.kind in "fiub":
                # vectorized: values + isna mask, no per-value python loop
                vals = series.to_numpy(dtype=np.float64, na_value=np.nan)
                cols[f.name] = column_from_list(vals, f.ftype)
                continue
            vals = [
                None
                if (v is None or (isinstance(v, float) and np.isnan(v)) or v is np.nan)
                else v
                for v in series.tolist()
            ]
            cols[f.name] = column_from_list(vals, f.ftype)
        return Dataset(cols)
    if isinstance(data, Mapping):
        for f in raw_features:
            if f.name not in data:
                raise KeyError(f"raw feature {f.name!r} missing from input data")
            cols[f.name] = column_from_list(data[f.name], f.ftype)
        return Dataset(cols)
    raise TypeError(f"unsupported input data type: {type(data)}")


def fit_and_transform_dag(
    dag: Sequence[Layer],
    train: Dataset,
    holdout: Optional[Dataset] = None,
    device: Optional[str] = None,
    cv_during: Optional[dict[str, list[PipelineStage]]] = None,
) -> tuple[list[PipelineStage], Dataset, Optional[Dataset]]:
    """Fold layers fit->transform (reference: FitStagesUtil.
    fitAndTransformDAG:213-240, fitAndTransformLayer:254-293).  Every
    estimator with a ``device`` attribute is fitted on ``device`` when one
    is given.

    ``cv_during`` ({selector_uid: [during stages..., selector]}, from
    dag.cut_dag_during) enables workflow-level CV inline: when a selector
    is reached, its ``find_best_estimator`` runs against the CURRENT
    dataset, refitting the during stages per fold from scratch; the winner
    is then refit on the full data by the selector's own fit.  A selector
    (``has_test_eval``) evaluates its fitted model on the holdout."""
    fitted: list[PipelineStage] = []
    for layer in dag:
        layer_models: list[Transformer] = []
        for stage in layer:
            if isinstance(stage, Estimator):
                if device is not None and hasattr(stage, "device"):
                    stage.device = device
                if (
                    cv_during
                    and getattr(stage, "is_model_selector", False)
                    and len(cv_during.get(stage.uid, [])) > 1
                ):
                    stage.find_best_estimator(train, cv_during[stage.uid])
                model = stage.fit(train)
                if (getattr(stage, "has_test_eval", False)
                        and holdout is not None and len(holdout)):
                    model.evaluate_model(holdout)
                layer_models.append(model)
            elif isinstance(stage, Transformer):
                layer_models.append(stage)
            else:
                raise TypeError(f"stage {stage.uid} is neither Transformer nor Estimator")
        for model in layer_models:
            train = model.transform(train)
            if holdout is not None and len(holdout):
                holdout = model.transform(holdout)
        fitted.extend(layer_models)
    return fitted, train, holdout


def apply_transformations_dag(
    dag: Sequence[Layer], data: Dataset
) -> Dataset:
    """Scoring executor (reference: OpWorkflowCore.
    applyTransformationsDAG:295-319): all stages must be transformers."""
    for layer in dag:
        for stage in layer:
            if not isinstance(stage, Transformer):
                raise ValueError(
                    f"cannot score with unfitted estimator {stage.uid}; train first"
                )
            data = stage.transform(data)
    return data


def _not_ported(what: str, item: int) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to the torch package yet "
        f"(ROADMAP.md queue 1, item {item})"
    )


class OpWorkflow:
    """User entry point (reference: OpWorkflow.scala:85-563).

    ``device`` is where the device stages fit (``"cuda"`` by default);
    ``train()`` raises when it names CUDA and CUDA is not available."""

    def __init__(self, device: str = "cuda") -> None:
        self.device = str(device)
        self.result_features: tuple[Feature, ...] = ()
        self.raw_features: tuple[Feature, ...] = ()
        self._input_data: Any = None
        self.parameters: dict[str, Any] = {}
        self._workflow_cv = False
        self._warm_stages: dict[str, PipelineStage] = {}

    def set_result_features(self, *features: Feature) -> "OpWorkflow":
        self.result_features = tuple(features)
        raws: dict[str, Feature] = {}
        for f in features:
            for r in f.raw_features():
                raws[r.name] = r
        self.raw_features = tuple(sorted(raws.values(), key=lambda f: f.name))
        return self

    def set_input_dataset(self, data: Any) -> "OpWorkflow":
        self._input_data = data
        return self

    def set_reader(self, reader) -> "OpWorkflow":
        raise _not_ported("reading through a DataReader", 1)

    def set_parameters(self, **params: Any) -> "OpWorkflow":
        if params.get("schema_contract"):
            raise _not_ported("schema-contract capture", 1)
        if params.get("streaming_ingest"):
            raise _not_ported("streaming ingest", 12)
        self.parameters.update(params)
        return self

    def with_raw_feature_filter(self, rff) -> "OpWorkflow":
        raise _not_ported("RawFeatureFilter", 8)

    def with_workflow_cv(self) -> "OpWorkflow":
        """Leakage-free workflow-level cross-validation: label-aware
        estimators between the last upstream estimator and the model
        selector are refit inside each fold (reference:
        OpWorkflowCore.withWorkflowCV:108, FitStagesUtil.cutDAG:305-358)."""
        self._workflow_cv = True
        return self

    def generate_raw_data(self) -> Dataset:
        if self._input_data is None:
            raise ValueError("no input data: call set_input_dataset")
        return _as_dataset(self._input_data, self.raw_features)

    def with_model_stages(self, model: "OpWorkflowModel") -> "OpWorkflow":
        """Warm start: fitted stages of ``model`` replace their unfitted
        counterparts (matched by uid) when this workflow trains, so only
        new estimators fit (reference: OpWorkflow.withModelStages:457).
        The swap happens inside ``train()`` and ``compute_data_up_to``,
        because the layers are rebuilt from the features on every call."""
        self._warm_stages = {s.uid: s for s in model.stages}
        return self

    def _warm(self, dag: Sequence[Layer]) -> list[Layer]:
        """``dag`` with every stage that ``with_model_stages`` recorded
        swapped for its fitted counterpart, which adopts the current
        wiring (a fitted stage is a Transformer: it is not refit)."""
        if not self._warm_stages:
            return list(dag)

        def sub(s):
            w = self._warm_stages.get(s.uid)
            if w is None or w is s:
                return s
            w.input_features = s.input_features
            w._output = s.get_output()
            return w

        return [[sub(s) for s in layer] for layer in dag]

    def compute_data_up_to(self, feature: Feature,
                           path: Optional[str] = None) -> Dataset:
        """Fit and transform only the stages strictly upstream of
        ``feature`` on the workflow's device and return the dataset of
        every column generated before it (reference:
        OpWorkflowCore.computeDataUpTo:273-284).  Saving it as Avro
        (``path``) comes with the Avro reader (ROADMAP.md queue 1,
        item 12)."""
        if path is not None:
            raise _not_ported("compute_data_up_to's Avro output (path=)", 12)
        resolve_device(self.device)
        raw = self.generate_raw_data()
        upto = [
            [s for s in layer if s is not feature.origin_stage]
            for layer in compute_dag([feature])
        ]
        upto = self._warm([layer for layer in upto if layer])
        _, data, _ = fit_and_transform_dag(upto, raw, device=self.device)
        return data

    def train(self) -> "OpWorkflowModel":
        """(reference: OpWorkflow.train:332-357)"""
        resolve_device(self.device)
        t0 = time.perf_counter()
        raw = self.generate_raw_data()
        dag = compute_dag(self.result_features)
        validate_dag(dag)
        dag = self._warm(dag)

        # non-nullable response gate (reference: .toRealNN throws on empty
        # values at extraction): a missing label must fail loudly here, not
        # silently train as class 0.0 behind its validity mask
        for f in self.raw_features:
            if f.is_response and f.ftype.non_nullable and f.name in raw:
                mask = getattr(raw[f.name], "mask", None)
                if mask is not None:
                    n_bad = int((~np.asarray(mask)).sum())
                    if n_bad:
                        raise ValueError(
                            f"response feature {f.name!r} is "
                            f"{f.ftype.__name__} (non-nullable) but has "
                            f"{n_bad} missing values; drop or impute those "
                            "rows before training"
                        )

        # reserve a holdout for test-eval stages (reference: Splitter
        # reserveTestFraction, tuning/Splitter.scala:57): the larger of the
        # workflow's parameter and every model selector's splitter's
        holdout: Optional[Dataset] = None
        train_data = raw
        selectors = [s for s in flatten(dag)
                     if getattr(s, "is_model_selector", False)]
        frac = float(self.parameters.get("reserve_test_fraction", 0.0))
        for sel in selectors:
            sp = getattr(sel, "splitter", None)
            if sp is not None:
                frac = max(frac, getattr(sp, "reserve_test_fraction", 0.0))
        if frac > 0.0:
            seed = int(self.parameters.get("split_seed", 42))
            rng = np.random.RandomState(seed)
            n = len(raw)
            perm = rng.permutation(n)
            n_test = int(np.floor(n * frac))
            test_idx, train_idx = perm[:n_test], perm[n_test:]
            train_data, holdout = raw.take(np.sort(train_idx)), raw.take(np.sort(test_idx))

        cv_during = None
        if self._workflow_cv and selectors:
            # per-selector cut (reference: FitStagesUtil.cutDAG:305-358,
            # extended to parallel selectors); execution stays one pass
            cv_during = cut_dag_during(dag, selectors)
        fitted, train_out, holdout_out = fit_and_transform_dag(
            dag, train_data, holdout, device=self.device, cv_during=cv_during,
        )
        model = OpWorkflowModel(
            result_features=self.result_features,
            raw_features=self.raw_features,
            stages=fitted,
            parameters=dict(self.parameters),
            train_time_s=time.perf_counter() - t0,
        )
        model._train_data_cache = train_out
        model._holdout_data_cache = holdout_out
        return model


class OpWorkflowModel:
    """Fitted workflow (reference: OpWorkflowModel.scala)."""

    def __init__(
        self,
        result_features: Sequence[Feature],
        raw_features: Sequence[Feature],
        stages: Sequence[PipelineStage],
        parameters: Optional[dict] = None,
        train_time_s: float = 0.0,
    ) -> None:
        self.result_features = tuple(result_features)
        self.raw_features = tuple(raw_features)
        self.stages = list(stages)
        self.parameters = dict(parameters or {})
        self.train_time_s = train_time_s
        self._train_data_cache: Optional[Dataset] = None
        self._holdout_data_cache: Optional[Dataset] = None
        self._scoring_dag: Optional[list[Layer]] = None

    def _dag(self) -> list[Layer]:
        if self._scoring_dag is None:
            # rebuild layers from fitted stages, preserving layer order by
            # recomputing distances on the (now fitted) graph
            self._scoring_dag = compute_dag(self.result_features)
            # substitute fitted stages (same uid) into the layers
            by_uid = {s.uid: s for s in self.stages}
            self._scoring_dag = [
                [by_uid.get(s.uid, s) for s in layer] for layer in self._scoring_dag
            ]
        return self._scoring_dag

    def score(self, data: Any = None) -> Dataset:
        """(reference: OpWorkflowModel.score:253)"""
        if data is None:
            if self._train_data_cache is not None:
                return self._train_data_cache
            raise ValueError("no data to score: pass data=")
        raw = _as_dataset(data, self.raw_features)
        return apply_transformations_dag(self._dag(), raw)

    def _label_and_pred(self, label, prediction):
        prediction = prediction or self.result_features[0].name
        if label is None:
            # resolve the label from the prediction stage's own label
            # input: with a DERIVED label the raw response column is not
            # the numeric label the model trained on
            pred_f = next(
                (f for f in self.result_features if f.name == prediction),
                None,
            )
            st = pred_f.origin_stage if pred_f is not None else None
            ins = getattr(st, "input_features", ()) if st else ()
            if len(ins) >= 2 and ins[0].is_response:
                label = ins[0].name
        label = label or next(
            (f.name for f in self.raw_features if f.is_response), None
        )
        return label, prediction

    def evaluate(self, evaluator, data: Any = None, label: Optional[str] = None,
                 prediction: Optional[str] = None):
        return self.score_and_evaluate(evaluator, data, label, prediction)[1]

    def score_and_evaluate(self, evaluator, data: Any = None,
                           label: Optional[str] = None,
                           prediction: Optional[str] = None):
        """Score then evaluate in one pass over the same transformed data
        (reference: OpWorkflowModel.scoreAndEvaluate).  Returns (scored
        Dataset, metrics)."""
        scored = self.score(data)
        label, prediction = self._label_and_pred(label, prediction)
        metrics = evaluator.evaluate(
            scored, label_col=label, pred_col=prediction
        )
        return scored, metrics

    def evaluate_holdout(self, evaluator, label: Optional[str] = None,
                         prediction: Optional[str] = None):
        """Metrics on the reserved holdout (reference: HasTestEval holdout
        metrics surfaced in summaryPretty)."""
        if self._holdout_data_cache is None or not len(self._holdout_data_cache):
            raise ValueError("no holdout was reserved at train time")
        label, prediction = self._label_and_pred(label, prediction)
        return evaluator.evaluate(
            self._holdout_data_cache, label_col=label, pred_col=prediction
        )

    def summary_json(self) -> dict:
        return {
            "stages": [
                {
                    "uid": s.uid,
                    "operation": s.operation_name,
                    "metadata": s.metadata,
                }
                for s in self.stages
                if s.metadata
            ],
            "trainTimeSeconds": self.train_time_s,
        }

    def compute_data_up_to(self, feature: Feature, data: Any = None,
                           path: Optional[str] = None) -> Dataset:
        """All columns generated before ``feature``, by the fitted stages
        (reference: OpWorkflowModel's side of computeDataUpTo).  Saving it
        as Avro (``path``) comes with the Avro reader (ROADMAP.md queue 1,
        item 12)."""
        if path is not None:
            raise _not_ported("compute_data_up_to's Avro output (path=)", 12)
        if data is None:
            # the training cache holds fully-transformed columns, not raw
            raise ValueError("compute_data_up_to on a fitted model needs data=")
        out = _as_dataset(data, self.raw_features)
        keep = {
            s.uid
            for layer in compute_dag([feature])
            for s in layer
            if s is not feature.origin_stage
        }
        applied: set[str] = set()
        for layer in self._dag():
            for stage in layer:
                if stage.uid in keep:
                    if not isinstance(stage, Transformer):
                        raise ValueError(
                            f"unfitted estimator {stage.uid}; train first"
                        )
                    out = stage.transform(out)
                    applied.add(stage.uid)
        missing = keep - applied
        if missing:
            raise ValueError(
                "compute_data_up_to: the feature depends on stages not in "
                f"this trained model's DAG (uids {sorted(missing)}); train "
                "a workflow containing them first"
            )
        return out

    def summary(self) -> str:
        return json.dumps(self.summary_json(), indent=2, default=str)

    def summary_pretty(self) -> str:
        raise _not_ported("summary_pretty (ModelInsights)", 8)

    def score_function(self):
        raise _not_ported("local (engine-free) scoring", 7)

    def model_insights(self, feature: Optional[Feature] = None):
        raise _not_ported("ModelInsights", 8)

    def save(self, path: str) -> None:
        raise _not_ported("model save", 1)

    @staticmethod
    def load(path: str, workflow: "OpWorkflow") -> "OpWorkflowModel":
        raise _not_ported("model load", 1)
