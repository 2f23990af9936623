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

import contextlib
import json
import logging
import time
from typing import Any, Mapping, Optional, Sequence

import numpy as np

from ..features.feature import Feature
from ..obs import trace as _obs_trace
from ..stages.base import Estimator, PipelineStage, Transformer
from ..types.columns import Column, column_from_list
from ..types.dataset import Dataset
from ..utils.device import resolve_device
from .dag import Layer, compute_dag, cut_dag_during, flatten, validate_dag

log = logging.getLogger("transmogrifai_tpu_torch.workflow")


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
    metrics=None,
) -> tuple[list[PipelineStage], Dataset, Optional[Dataset]]:
    """Fold layers fit->transform (reference: FitStagesUtil.
    fitAndTransformDAG:213-240, fitAndTransformLayer:254-293).  Every
    estimator with a ``device`` attribute is fitted on ``device`` when one
    is given.  ``metrics`` (``utils.tracing.AppMetrics``) records each
    stage's workflow-CV, fit and transform walls, as the reference's
    OpSparkListener does.

    ``cv_during`` ({selector_uid: [during stages..., selector]}, from
    dag.cut_dag_during) enables workflow-level CV inline: when a selector
    is reached, its ``find_best_estimator`` runs against the CURRENT
    dataset, refitting the during stages per fold from scratch; the winner
    is then refit on the full data by the selector's own fit.  A selector
    (``has_test_eval``) evaluates its fitted model on the holdout."""
    def timed(stage, phase: str, n: int):
        if metrics is None:
            return contextlib.nullcontext()
        return metrics.timed(stage, phase, n)

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
                    with timed(stage, "workflow_cv", len(train)):
                        stage.find_best_estimator(train,
                                                  cv_during[stage.uid])
                with timed(stage, "fit", len(train)):
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
            with timed(model, "transform", len(train)):
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


class OpWorkflow:
    """User entry point (reference: OpWorkflow.scala:85-563).

    ``device`` is where the device stages fit (``"cuda"`` by default);
    ``train()`` raises when it names CUDA and CUDA is not available."""

    def __init__(self, device: str = "cuda") -> None:
        self.device = str(device)
        self.result_features: tuple[Feature, ...] = ()
        self.raw_features: tuple[Feature, ...] = ()
        self._input_data: Any = None
        self._reader = None
        self.parameters: dict[str, Any] = {}
        self._raw_feature_filter = None
        self._workflow_cv = False
        self._warm_stages: dict[str, PipelineStage] = {}
        self.blacklisted_features: list[Feature] = []
        self.blacklisted_map_keys: dict[str, list[str]] = {}
        self.rff_results: Optional[dict] = None
        #: uids of the estimators whose streamed partial fits armed in
        #: the last streaming ingest (``_ingest_streaming``)
        self.last_streamed_fits: list[str] = []

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
        """Read the raw features through ``reader`` (``generate_dataset``,
        e.g. ``readers.csv_reader.CSVReader``) when the workflow trains."""
        self._reader = reader
        return self

    def set_parameters(self, **params: Any) -> "OpWorkflow":
        """Workflow parameters; ``schema_contract=False`` opts out of the
        schema-contract capture at ``train()``; ``streaming_ingest``
        (default on, as in the reference) streams only from a reader with
        a chunk stream (``_streaming_eligible``)."""
        self.parameters.update(params)
        return self

    def with_raw_feature_filter(self, rff) -> "OpWorkflow":
        """Run ``rff`` (``filters.raw_feature_filter.RawFeatureFilter``)
        on the raw data before training (reference:
        OpWorkflow.withRawFeatureFilter:523-563)."""
        self._raw_feature_filter = rff
        return self

    def with_workflow_cv(self) -> "OpWorkflow":
        """Leakage-free workflow-level cross-validation: label-aware
        estimators between the last upstream estimator and the model
        selector are refit inside each fold (reference:
        OpWorkflowCore.withWorkflowCV:108, FitStagesUtil.cutDAG:305-358)."""
        self._workflow_cv = True
        return self

    def generate_raw_data(self) -> Dataset:
        """Reader hand-off and the optional RawFeatureFilter (reference:
        OpWorkflow.generateRawData:222-246): the filter's blacklist is
        kept on the workflow and cut out of the DAG."""
        if self._reader is not None:
            data = self._reader.generate_dataset(self.raw_features,
                                                 self.parameters)
        elif self._input_data is not None:
            data = _as_dataset(self._input_data, self.raw_features)
        else:
            raise ValueError(
                "no input data: call set_input_dataset or set_reader")
        if self._raw_feature_filter is not None:
            filtered = self._raw_feature_filter.filter_raw_data(
                data, self.raw_features, workflow=self
            )
            self.blacklisted_features = filtered.blacklisted_features
            self.blacklisted_map_keys = filtered.blacklisted_map_keys
            self.rff_results = filtered.results
            data = filtered.clean_data
            if self.blacklisted_features:
                self._apply_blacklist()
        return data

    def _apply_blacklist(self) -> None:
        """DAG surgery after the RawFeatureFilter (reference:
        OpWorkflow.setBlacklist:112-154): blacklisted raw features leave
        every stage's inputs; a stage left with no inputs, or with inputs
        it cannot take, is cut and its output joins the blacklist, in
        topological order, so downstream stages shed it too.  Cutting a
        response or a result feature is an error."""
        bl = {f.uid for f in self.blacklisted_features}
        bad_resp = [f for f in self.blacklisted_features if f.is_response]
        if bad_resp:
            raise ValueError(f"cannot blacklist response features: {bad_resp}")
        result_uids = {f.uid for f in self.result_features}
        dag = compute_dag(self.result_features)
        for stage in flatten(dag):
            kept = tuple(f for f in stage.input_features if f.uid not in bl)
            if len(kept) == len(stage.input_features):
                continue
            ok = bool(kept)
            if ok:
                try:
                    stage.check_input_types(kept)
                except TypeError:
                    ok = False  # a reduced arity the stage cannot take
            out = stage.get_output()
            if ok:
                stage.input_features = kept
            elif out.uid in result_uids:
                raise ValueError(
                    "RawFeatureFilter blacklisted features critical to "
                    f"result feature {out.name!r} (via stage {stage.uid})"
                )
            else:
                bl.add(out.uid)  # cascade: the stage's output dies too
        merged = {f.uid: f for f in self.blacklisted_features}
        for s in flatten(dag):
            out = s.get_output()
            if out.uid in bl:
                merged.setdefault(out.uid, out)
        self.blacklisted_features = list(merged.values())
        self.raw_features = tuple(
            f for f in self.raw_features if f.uid not in bl
        )

    def _streaming_eligible(self) -> bool:
        """Streaming ingest applies when the reader exposes the chunk
        stream seam (``stream_dataset``) and nothing downstream needs the
        whole dataset before the first chunk (RawFeatureFilter does).  Opt
        out with ``set_parameters(streaming_ingest=False)`` (reference:
        OpWorkflow._streaming_eligible): ``readers.pipeline.
        PipelinedCSVReader`` has it."""
        return (
            self._reader is not None
            and hasattr(self._reader, "stream_dataset")
            and self._raw_feature_filter is None
            and bool(self.parameters.get("streaming_ingest", True))
        )

    def _reserve_fraction(self, dag) -> float:
        """The holdout share: the larger of the workflow's
        ``reserve_test_fraction`` and every model selector's splitter's."""
        frac = float(self.parameters.get("reserve_test_fraction", 0.0))
        for sel in flatten(dag):
            if getattr(sel, "is_model_selector", False):
                sp = getattr(sel, "splitter", None)
                if sp is not None:
                    frac = max(frac,
                               getattr(sp, "reserve_test_fraction", 0.0))
        return frac

    def _ingest_streaming(self) -> Dataset:
        """Consume the reader's chunk stream: raw-feature materialization
        happens per chunk WHILE worker threads parse the remaining shards,
        and first-layer estimators with mergeable fit statistics
        (``Estimator.streaming_fittable``) accumulate their partial fits
        on each chunk as it lands (reference:
        OpWorkflow._ingest_streaming).

        Partial-fit accumulation is leakage-gated: it observes the FULL
        raw stream, so it arms only when no holdout will be reserved
        (reserve fraction 0); otherwise the stream still overlaps
        materialization but every estimator fits from the materialized
        train split.  Chunk statistics merge in (shard_id, chunk_id)
        source order whatever the arrival order, so a streamed fit is the
        same on every run.  ``last_streamed_fits`` names the estimators
        whose partial fits armed (the uids, in DAG order)."""
        dag = compute_dag(self.result_features)
        raw_names = {f.name for f in self.raw_features}
        eligible = []
        if self._reserve_fraction(dag) == 0.0:
            eligible = [
                s for s in flatten(dag)
                if isinstance(s, Estimator)
                and getattr(s, "streaming_fittable", False)
                and all(f.name in raw_names for f in s.input_features)
            ]
        parts: list[tuple] = []
        stats: dict[str, list] = {s.uid: [] for s in eligible}
        stream = self._reader.stream_dataset(
            self.raw_features, self.parameters
        )
        for pc, ds_chunk in stream:
            for st in eligible:
                cols = [ds_chunk[f.name] for f in st.input_features]
                stats[st.uid].append(
                    (pc.order_key, st.partial_fit_chunk(cols, ds_chunk))
                )
            parts.append((pc.order_key, ds_chunk))
        parts.sort(key=lambda kv: kv[0])
        if parts and any(len(p) for _, p in parts):
            raw = Dataset.concat([p for _, p in parts])
        else:
            # zero rows (header-only shards, or every row quarantined):
            # keep the batch path's shape - schema'd 0-row columns, not a
            # column-less Dataset that fails on the first raw feature
            raw = Dataset({
                f.name: column_from_list([], f.ftype)
                for f in self.raw_features
            })
        armed = []
        for st in eligible:
            per_chunk = sorted(stats[st.uid], key=lambda kv: kv[0])
            if per_chunk:
                st.accept_partial_fits([s for _, s in per_chunk])
                armed.append(st.uid)
        self.last_streamed_fits = armed
        return raw

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
        OpWorkflowCore.computeDataUpTo:273-284); with ``path``, also
        saved there as an Avro file (``readers.avro_reader.
        save_dataset_avro``)."""
        resolve_device(self.device)
        raw = self.generate_raw_data()
        upto = [
            [s for s in layer if s is not feature.origin_stage]
            for layer in compute_dag([feature])
        ]
        upto = self._warm([layer for layer in upto if layer])
        _, data, _ = fit_and_transform_dag(upto, raw, device=self.device)
        if path is not None:
            from ..readers.avro_reader import save_dataset_avro

            save_dataset_avro(data, path)
        return data

    def train(self) -> "OpWorkflowModel":
        """(reference: OpWorkflow.train:332-357).  The run is one
        ``workflow.train`` trace span (obs/), with the reader's ingest
        inside a ``workflow.ingest`` span.

        It first brings up the process group from the environment
        (``parallel.distributed.initialize``: a no-op for one process), so
        that under ``torchrun`` every rank joins before any stage touches
        a device and the stages' meshes span the ranks (the Spark
        executor bootstrap analog, SURVEY §5.8)."""
        from ..parallel.distributed import initialize

        initialize()
        resolve_device(self.device)
        with _obs_trace.span("workflow.train") as train_span:
            return self._train_traced(train_span)

    def _train_traced(self, train_span) -> "OpWorkflowModel":
        from ..utils.tracing import AppMetrics

        app_metrics = AppMetrics()
        t0 = time.perf_counter()
        raw = None
        if self._streaming_eligible():
            with _obs_trace.span("workflow.ingest", mode="streaming"):
                raw = self._ingest_streaming()
        if raw is None:
            with _obs_trace.span("workflow.ingest"):
                raw = self.generate_raw_data()
        train_span.set_attr("rows", len(raw))
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
        frac = self._reserve_fraction(dag)
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
            metrics=app_metrics,
        )
        # capture the schema contract from the raw data after the
        # RawFeatureFilter (its blacklist is out of raw_features): the serve tier
        # enforces this exact shape (names, dtypes, nullability,
        # per-feature distributions) against every batch.  Opt out with
        # set_parameters(schema_contract=False); a capture failure never
        # fails a completed train.
        contract = None
        if self.parameters.get("schema_contract", True):
            try:
                from ..schema.contract import SchemaContract

                contract = SchemaContract.capture(self.raw_features, raw)
            except Exception as e:  # noqa: BLE001 - capture is best-effort
                log.warning("schema contract capture failed (model will "
                            "serve uncontracted): %s", e)
        model = OpWorkflowModel(
            result_features=self.result_features,
            raw_features=self.raw_features,
            stages=fitted,
            parameters=dict(self.parameters),
            train_time_s=time.perf_counter() - t0,
            blacklisted_features=list(self.blacklisted_features),
            rff_results=self.rff_results,
            schema_contract=contract,
            device=self.device,
        )
        model._train_data_cache = train_out
        model._holdout_data_cache = holdout_out
        model.app_metrics = app_metrics
        return model


class OpWorkflowModel:
    """Fitted workflow (reference: OpWorkflowModel.scala).  ``device`` is
    where it scores: its workflow's device, ``"cuda"`` by default."""

    def __init__(
        self,
        result_features: Sequence[Feature],
        raw_features: Sequence[Feature],
        stages: Sequence[PipelineStage],
        parameters: Optional[dict] = None,
        train_time_s: float = 0.0,
        blacklisted_features: Sequence[Feature] = (),
        rff_results: Optional[dict] = None,
        schema_contract=None,
        device: str = "cuda",
    ) -> None:
        self.result_features = tuple(result_features)
        self.raw_features = tuple(raw_features)
        self.stages = list(stages)
        self.parameters = dict(parameters or {})
        self.train_time_s = train_time_s
        # the RawFeatureFilter's blacklist and results
        self.blacklisted_features = list(blacklisted_features)
        self.rff_results = rff_results
        #: the per-stage walls of the train() that fitted this model
        #: (utils/tracing.AppMetrics); None for a loaded model
        self.app_metrics = None
        # fit-time data shape (schema/contract.py), persisted in the
        # artifact as schema.json and enforced by the local scorer
        self.schema_contract = schema_contract
        self.device = str(device)
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
        out = {
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
        if self.app_metrics is not None:
            out["stageMetrics"] = self.app_metrics.to_json()
            from ..parallel.resilience import mesh_telemetry

            # degraded-mode training during this run (collective stalls,
            # straggler retries, shrink-to-survivors), scoped to this
            # model's training window
            events = mesh_telemetry().events_json(
                since_epoch=self.app_metrics.start_time)
            if events:
                out["meshResilience"] = dict(mesh_telemetry().snapshot(),
                                             events=events)
        return out

    def compute_data_up_to(self, feature: Feature, data: Any = None,
                           path: Optional[str] = None) -> Dataset:
        """All columns generated before ``feature``, by the fitted stages
        (reference: OpWorkflowModel's side of computeDataUpTo); with
        ``path``, also saved there as an Avro file."""
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
        if path is not None:
            from ..readers.avro_reader import save_dataset_avro

            save_dataset_avro(out, path)
        return out

    def summary(self) -> str:
        return json.dumps(self.summary_json(), indent=2, default=str)

    def summary_pretty(self) -> str:
        from ..insights.model_insights import ModelInsights

        return ModelInsights.from_model(self).pretty()

    def score_function(self, **kw):
        """Engine-free row scorer (reference: local/.../
        OpWorkflowModelLocal.scala:67): the compiled LocalScorer - callable
        dict -> dict, plus ``score_batch`` / ``score_stream`` for
        micro-batching.  On a CUDA model it scores through one torch
        program on the card; on a CPU model through the numpy-fused
        program.  ``kw`` goes to :class:`~..local.scorer.LocalScorer`."""
        from ..local.scorer import LocalScorer

        return LocalScorer(self, **kw)

    def model_insights(self, feature: Optional[Feature] = None):
        from ..insights.model_insights import ModelInsights

        return ModelInsights.from_model(self, feature)

    def save(self, path: str) -> None:
        """Crash-consistent save (serialization/model_io.py).  In a
        process group only rank 0 writes: every rank trained the same
        model, and their writes would race on one path."""
        from ..parallel.mesh import is_writer
        from ..serialization.model_io import save_model

        if not is_writer():
            return
        with _obs_trace.span("model.save", path=path):
            save_model(self, path)

    @staticmethod
    def load(path: str, workflow: "OpWorkflow") -> "OpWorkflowModel":
        """Restore a saved model into the same code-defined ``workflow``,
        scoring on ``workflow.device``."""
        from ..serialization.model_io import load_model

        with _obs_trace.span("model.load", path=path):
            return load_model(path, workflow)
