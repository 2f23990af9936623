"""Batch application runner.

Counterpart of OpWorkflowRunner / OpApp (reference: core/.../
OpWorkflowRunner.scala:296-365, OpApp.scala:49-209) and port of
``transmogrifai_tpu/workflow/runner.py``: run types

* train          - fit the workflow, save the model + summary
* score          - load model, score the reader's data, write scores
* features       - materialize raw features only
* evaluate       - load model, score + evaluate, write metrics
* streaming_score- micro-batch scoring loop over a batch iterator
                   (reference: StreamingScore over DStreams,
                   OpWorkflowRunner.scala:313-332)
* serve          - load model, compile the batch-first serving endpoint
                   (serving/), pump the reader's rows through the
                   micro-batching scheduler as requests, export the
                   latency/throughput telemetry JSON
* deploy         - registry-driven serving (registry/): publish the
                   model_location artifact into a versioned registry
                   when asked, hot-swap the stable version live through
                   a DeploymentController, optionally canary a second
                   version on a deterministic traffic split with
                   signal-driven automatic rollback, and export the
                   deployment summary (generations, lifecycle events,
                   rollback evidence) as JSON
* fleet          - scale-out serving (fleet/): bring up N replica worker
                   processes behind the least-loaded router, each on the
                   workflow's device, pump the reader's rows through
                   the fleet as concurrent batches, optionally rolling
                   hot-swap to a new registry version mid-traffic, and
                   export the fleet status + router counters
* continuous     - a bounded run of the drift-triggered refit controller
                   (continuous/): tail ``watch_dir`` for shards, score
                   each window's drift against the stable model's
                   training contract, refit + publish + promote when the
                   governor trips, exit after ``continuous_max_cycles``
                   cycles or ``continuous_idle_exit`` empty polls

plus a CLI (``python -m transmogrifai_tpu_torch.workflow.runner
--run-type ...``) standing in for OpApp.main's scopt parsing.

Models load and score on the workflow's device: ``OpWorkflow()`` is the
card (``"cuda"``), ``OpWorkflow(device="cpu")`` the host.  The train
run takes the pipelined sharded reader (``ingest_shards``) and the
successive-halving ``autotune`` knobs, the serve run the
``serving_autotune`` A/B knob probes, and every run ships the process's
observability plane into ``fleet_dir`` / ``TX_OBS_FLEET_DIR``.  The
fleet run attaches the autoscaler with ``fleet_autoscale``, and the
``bulk`` run type scores sharded files through an exactly-once
:class:`~..bulk.BulkScoringJob` on the model's device.
"""
from __future__ import annotations

import argparse
import json
import os
import time
from dataclasses import dataclass
from typing import Any, Callable, Iterable, Optional

from ..types.dataset import Dataset
from .params import OpParams
from .workflow import OpWorkflow, OpWorkflowModel

@dataclass
class OpWorkflowRunnerResult:
    run_type: str
    model: Optional[OpWorkflowModel] = None
    scores: Optional[Dataset] = None
    metrics: Optional[dict] = None
    summary: Optional[dict] = None
    wall_s: float = 0.0


def train_fused_summary(validators: list) -> Optional[dict]:
    """Run-level rollup of the per-selector fused-training trails:
    ``train_fused.backend`` + ``cache{hits,misses,stale}`` mirroring the
    serving telemetry shape (the torch programs have no executable cache,
    so the counters stay 0).  The backend tri-state folds the
    per-selector verdicts rather than re-deriving from families, and a
    family selected by TWO selectors keeps both entries under suffixed
    keys instead of last-one-wins."""
    trails = [v.last_train_fused for v in validators
              if v.last_train_fused is not None]
    if not trails:
        return None
    cache = {"hits": 0, "misses": 0, "stale": 0}
    families: dict = {}
    backends: set = set()
    for t in trails:
        backends.add(t.get("backend"))
        for key in cache:
            cache[key] += int(t.get("cache", {}).get(key, 0))
        for fam, entry in t.get("families", {}).items():
            key, i = fam, 2
            while key in families:
                key, i = f"{fam}#{i}", i + 1
            families[key] = entry
    return {
        "backend": (
            "fused" if backends == {"fused"}
            else "existing" if backends == {"existing"} else "mixed"
        ),
        "families": families,
        "cache": cache,
    }


class OpWorkflowRunner:
    def __init__(
        self,
        workflow: OpWorkflow,
        evaluator=None,
        train_reader=None,
        score_reader=None,
        workflow_factory=None,
    ) -> None:
        self.workflow = workflow
        self.evaluator = evaluator
        self.train_reader = train_reader
        self.score_reader = score_reader
        # zero-arg builder returning a FRESH workflow (or the main()
        # factory's tuple): model loads apply blacklist surgery to their
        # target, so loading TWO versions (deploy run: stable + canary)
        # needs a fresh build per load whenever their blacklists differ
        self.workflow_factory = workflow_factory
        # the run-scoped SLO engine (slo_path knob): built per run(),
        # consumed by _deploy's rollback policy
        self._slo_engine = None

    def _fresh_workflow(self) -> OpWorkflow:
        if self.workflow_factory is None:
            return self.workflow
        built = self.workflow_factory()
        return built[0] if isinstance(built, tuple) else built

    def run(self, run_type: str, params: Optional[OpParams] = None) -> OpWorkflowRunnerResult:
        params = params or OpParams()
        t0 = time.perf_counter()
        from ..obs import trace as _obs_trace
        from .dag import compute_dag

        run_type = run_type.lower().replace("-", "_")
        dag = compute_dag(self.workflow.result_features)
        params.apply_to_dag(dag)
        # declarative SLOs: custom_params {"slo_path": FILE} loads the
        # objective config and evaluates it over the live registry -
        # built BEFORE the run so the deploy run can wire it into the
        # RollbackPolicy as a hard rollback signal
        slo_engine = None
        sp = params.custom_params.get("slo_path")
        if sp:
            from ..obs.slo import SLOEngine, load_slo_config

            slo_engine = SLOEngine(load_slo_config(str(sp)))
        self._slo_engine = slo_engine
        try:
            # one root span per run: every subsystem span underneath
            # (ingest, stage fits, save, publish, swap, serve batches)
            # inherits this trace id
            with _obs_trace.span("run." + run_type, run_type=run_type):
                if run_type == "train":
                    result = self._train(params)
                elif run_type == "score":
                    result = self._score(params)
                elif run_type == "features":
                    result = self._features(params)
                elif run_type == "evaluate":
                    result = self._evaluate(params)
                elif run_type == "serve":
                    result = self._serve(params)
                elif run_type == "deploy":
                    result = self._deploy(params)
                elif run_type == "fleet":
                    result = self._fleet(params)
                elif run_type == "continuous":
                    result = self._continuous(params)
                elif run_type == "bulk":
                    result = self._bulk(params)
                else:
                    raise ValueError(f"unknown run type {run_type!r}")
        finally:
            self._slo_engine = None
        result.wall_s = time.perf_counter() - t0
        # the observability-plane export knob: custom_params
        # {"metrics_path": DIR} dumps metrics.json + metrics.prom
        # (Prometheus text) + spans.jsonl after any run type
        mp = params.custom_params.get("metrics_path")
        if slo_engine is not None:
            from ..obs import write_json_artifact

            slo_engine.observe()
            report = slo_engine.report()
            loc = str(mp) if mp else params.metrics_location
            if loc:
                os.makedirs(loc, exist_ok=True)
                write_json_artifact(
                    os.path.join(loc, "slo_report.json"), report)
            if isinstance(result.metrics, dict):
                result.metrics = dict(result.metrics, slo=report)
        if mp:
            from ..obs import export_obs

            export_obs(str(mp), extra={"run_type": run_type})
        # fleet shipping: {"fleet_dir": DIR} custom param or the
        # TX_OBS_FLEET_DIR env ships this process's whole plane into the
        # aggregation dir - the env seam is what makes supervised or
        # re-dispatched children ship without any code of their own
        fd = params.custom_params.get("fleet_dir") or os.environ.get(
            "TX_OBS_FLEET_DIR")
        if fd:
            from ..obs import fleet as _fleet

            try:
                _fleet.ship_now(str(fd))
            except OSError as e:
                # best-effort like every other shipper seam: a full or
                # read-only aggregation disk costs the fleet this
                # process's freshness, never the completed run's result
                import logging

                logging.getLogger("transmogrifai_tpu_torch.obs").warning(
                    "post-run fleet ship to %s failed: %s", fd, e)
        return result

    # ------------------------------------------------------------------
    def _reader(self, which: str):
        r = self.train_reader if which == "train" else self.score_reader
        return r or self.workflow._reader

    def _train(self, params: OpParams) -> OpWorkflowRunnerResult:
        if self.train_reader is not None:
            self.workflow.set_reader(self.train_reader)
        # pipelined-ingest knobs (readers/pipeline.py): custom_params
        # ingest_shards=[paths...] swaps in the sharded parallel reader
        # (ingest_workers / ingest_buffer_chunks / ingest_errors tune it)
        shards = params.custom_params.get("ingest_shards")
        if shards:
            from ..readers.pipeline import PipelinedCSVReader

            self.workflow.set_reader(PipelinedCSVReader(
                [str(p) for p in shards],
                workers=int(params.custom_params.get("ingest_workers", 4)),
                buffer_chunks=int(params.custom_params.get(
                    "ingest_buffer_chunks", 8)),
                errors=str(params.custom_params.get(
                    "ingest_errors", "coerce")),
            ))
        at_cfg = self._setup_autotune(params)
        tf_validators = self._setup_train_fused(params)
        model = self.workflow.train()
        summary = model.summary_json()
        if at_cfg is not None:
            summary["autotune"] = self._autotune_summary(at_cfg)
        tf_summary = train_fused_summary(tf_validators)
        if tf_summary is not None:
            summary["train_fused"] = tf_summary
        if params.model_location:
            model.save(params.model_location)
            with open(
                os.path.join(params.model_location, "summary.json"), "w"
            ) as f:
                json.dump(summary, f, indent=1, default=str)
        if at_cfg is not None and at_cfg.model_path:
            # the versioned cost-model artifact rides next to the model -
            # AFTER model.save (the artifact swap must not eat it), and
            # also when only autotune_model_path was given
            at_cfg.cost_model.save(at_cfg.model_path)
        return OpWorkflowRunnerResult(
            run_type="train", model=model, summary=summary
        )

    def _setup_autotune(self, params: OpParams):
        """The ``autotune`` custom param: build the cost model (loaded
        from the versioned artifact next to the model when one exists)
        and install successive-halving on every ModelSelector validator in
        the DAG.  Knobs: ``autotune_model_path`` (default
        <model_location>/autotune.json), ``autotune_rung_rows``,
        ``autotune_keep_fraction``, ``autotune_min_rows``."""
        cp = params.custom_params
        if not cp.get("autotune"):
            return None
        from ..autotune import COST_MODEL_FILENAME, AutotuneConfig, CostModel
        from .dag import compute_dag

        at_path = cp.get("autotune_model_path") or (
            os.path.join(params.model_location, COST_MODEL_FILENAME)
            if params.model_location else None
        )
        cfg = AutotuneConfig(
            cost_model=CostModel.load(at_path),
            rung_rows=int(cp.get("autotune_rung_rows", 250_000)),
            keep_fraction=float(cp.get("autotune_keep_fraction", 0.5)),
            min_rows=int(cp.get("autotune_min_rows", 20_000)),
            model_path=at_path,
        )
        for layer in compute_dag(self.workflow.result_features):
            for stage in layer:
                if getattr(stage, "is_model_selector", False):
                    stage.validator.autotune = cfg
        return cfg

    @staticmethod
    def _autotune_summary(at_cfg) -> dict:
        """Post-train autotune bookkeeping: fold this run's tagged fit
        spans into the cost model (the online-training loop) and report
        the model's state; the per-selection decision trail already rides
        each selector's stage metadata in the summary."""
        from ..obs import trace as _obs_trace

        cm = at_cfg.cost_model
        ingested = cm.ingest_spans(_obs_trace.tracer().spans())
        return {
            "cost_model": dict(
                cm.snapshot(),
                ingested_spans=ingested,
                path=at_cfg.model_path,
                load_error=cm.load_error,
            ),
        }

    def _setup_train_fused(self, params: OpParams) -> list:
        """Fused-training knob: the ``train_fused`` custom param (None =
        auto-by-scale, True/False force).  Returns the validators of the
        workflow's model selectors, for the post-train summary rollup."""
        from .dag import compute_dag

        train_fused = params.custom_params.get("train_fused")
        validators = []
        for layer in compute_dag(self.workflow.result_features):
            for stage in layer:
                if getattr(stage, "is_model_selector", False):
                    v = stage.validator
                    if train_fused is not None:
                        v.train_fused = bool(train_fused)
                    validators.append(v)
        return validators

    def _load_model(self, params: OpParams) -> OpWorkflowModel:
        if not params.model_location:
            raise ValueError("model_location required for score/evaluate")
        return OpWorkflowModel.load(params.model_location, self.workflow)

    def _scored_data(self, params: OpParams, model: OpWorkflowModel) -> Dataset:
        reader = self._reader("score")
        if reader is None:
            raise ValueError("no reader for scoring")
        raw = reader.generate_dataset(model.raw_features, params.reader_params)
        return model.score(raw)

    def _score(self, params: OpParams) -> OpWorkflowRunnerResult:
        model = self._load_model(params)
        scored = self._scored_data(params, model)
        if params.write_location:
            _write_scores(scored, model, params.write_location,
                          params.write_format)
        return OpWorkflowRunnerResult(run_type="score", model=model, scores=scored)

    def _features(self, params: OpParams) -> OpWorkflowRunnerResult:
        reader = self._reader("train")
        raw = reader.generate_dataset(self.workflow.raw_features, params.reader_params)
        if params.write_location:
            os.makedirs(params.write_location, exist_ok=True)
            with open(os.path.join(params.write_location, "features.json"), "w") as f:
                json.dump(raw.to_pylists(), f, default=str)
        return OpWorkflowRunnerResult(run_type="features", scores=raw)

    def _evaluate(self, params: OpParams) -> OpWorkflowRunnerResult:
        if self.evaluator is None:
            raise ValueError("evaluator required for evaluate run")
        model = self._load_model(params)
        scored = self._scored_data(params, model)
        label = next((f.name for f in model.raw_features if f.is_response), None)
        pred = model.result_features[0].name
        metrics = self.evaluator.evaluate(scored, label_col=label, pred_col=pred)
        mj = metrics.to_json()
        if params.metrics_location:
            os.makedirs(params.metrics_location, exist_ok=True)
            with open(os.path.join(params.metrics_location, "metrics.json"), "w") as f:
                json.dump(mj, f, indent=1, default=str)
        return OpWorkflowRunnerResult(run_type="evaluate", model=model,
                                      scores=scored, metrics=mj)

    def _serve(self, params: OpParams) -> OpWorkflowRunnerResult:
        """Request/response serving run: every reader row becomes one
        request through the micro-batching scheduler (serving/), then the
        built-in telemetry (p50/p95/p99, rows/s, batch fill, queue depth)
        exports to ``<metrics_location>/serving_metrics.json``.  Knobs
        ride OpParams.custom_params: serving_buckets, serving_max_wait_us,
        serving_max_queue, serving_deadline_ms, serving_window,
        serving_breaker_threshold, serving_breaker_cooldown_s,
        serving_guard_nonfinite, serving_drift_policy (raise|warn|shed,
        enforced against the artifact's schema contract), serving_fused
        (off-switch for the whole-pipeline fused program),
        serving_fused_backend (auto|torch|numpy: 'torch' routes batches
        through the device program, local/fused_torch.py; 'auto' takes it
        for a CUDA model)."""
        from ..serving import (
            MicroBatchScheduler,
            RowScoringError,
            compile_endpoint,
            records_from_dataset,
        )

        cp = params.custom_params
        model = self._load_model(params)
        reader = self._reader("score")
        if reader is not None:
            raw = reader.generate_dataset(
                model.raw_features, params.reader_params
            )
        else:
            # no reader: serve the workflow's attached input dataset
            raw = self.workflow.generate_raw_data()
        records = records_from_dataset(raw, model.raw_features)
        n = len(records)
        endpoint = compile_endpoint(
            model,
            batch_buckets=tuple(cp.get("serving_buckets", (1, 8, 32, 128))),
            breaker_threshold=int(cp.get("serving_breaker_threshold", 5)),
            breaker_cooldown_s=float(
                cp.get("serving_breaker_cooldown_s", 5.0)),
            guard_nonfinite=bool(cp.get("serving_guard_nonfinite", True)),
            drift_policy=str(cp.get("serving_drift_policy", "warn")),
            fused=bool(cp.get("serving_fused", True)),
            fused_backend=cp.get("serving_fused_backend"),
        )
        deadline = cp.get("serving_deadline_ms")
        tuner_decision = None
        with MicroBatchScheduler(
            endpoint,
            max_wait_us=int(cp.get("serving_max_wait_us", 2000)),
            max_queue=int(cp.get("serving_max_queue", 1024)),
            default_deadline_ms=None if deadline is None else float(deadline),
        ) as scheduler:
            if cp.get("serving_autotune"):
                tuner_decision = self._autotune_scheduler(
                    scheduler, records, cp)
            results = list(scheduler.score_stream(
                records, window=int(cp.get("serving_window", 256))
            ))
        extra = {
            "run_type": "serve",
            "rows_submitted": n,
            "model_location": params.model_location,
        }
        if tuner_decision is not None:
            extra["autotune"] = tuner_decision
        if params.metrics_location:
            os.makedirs(params.metrics_location, exist_ok=True)
            metrics = endpoint.telemetry.export(
                os.path.join(params.metrics_location, "serving_metrics.json"),
                extra=extra,
            )
        else:
            metrics = dict(endpoint.telemetry.snapshot(), **extra)
        if params.write_location:
            os.makedirs(params.write_location, exist_ok=True)
            rows = [
                {"error": r.error} if isinstance(r, RowScoringError) else r
                for r in results
            ]
            with open(
                os.path.join(params.write_location, "scores.json"), "w"
            ) as f:
                json.dump(rows, f, default=str)
        return OpWorkflowRunnerResult(
            run_type="serve", model=model, metrics=metrics
        )

    @staticmethod
    def _autotune_scheduler(scheduler, records: list, cp: dict):
        """The ``serving_autotune`` knob: short measured A/B probes of
        micro-batch knob candidates against the hand-set defaults on a
        record prefix, applying the winner to the LIVE scheduler via
        ``retune``.  Probe rows score through the real endpoint (their
        latencies land in telemetry like any other request); the decision
        trail returns into run metrics and the tuned values into
        ``ServingTelemetry.tuned_knobs``.  Knobs: ``autotune_probe_rows``,
        ``autotune_margin``, ``autotune_probe_repeats``."""
        from ..autotune import KnobTuner, microbatch_candidates

        baseline = scheduler.knobs()
        probe_n = max(1, min(len(records),
                             int(cp.get("autotune_probe_rows", 512))))
        probe_records = records[:probe_n]
        window = int(cp.get("serving_window", 256))
        tuner = KnobTuner(
            margin=float(cp.get("autotune_margin", 0.03)),
            repeats=int(cp.get("autotune_probe_repeats", 2)),
        )

        def measure(knobs: dict) -> float:
            scheduler.retune(knobs["max_batch_size"],
                             knobs["max_wait_us"], source="probe")
            t0 = time.perf_counter()
            res = list(scheduler.score_stream(probe_records, window=window))
            return len(res) / max(time.perf_counter() - t0, 1e-9)

        decision = tuner.ab_probe(
            "serving.microbatch", baseline,
            microbatch_candidates(baseline), measure,
        )
        scheduler.retune(
            decision.winner["max_batch_size"],
            decision.winner["max_wait_us"],
            source="autotune" if decision.tuned else "hand_set",
        )
        return decision.to_json()

    def _deploy(self, params: OpParams) -> OpWorkflowRunnerResult:
        """Registry-driven deployment run.  Knobs ride
        OpParams.custom_params: ``registry_root`` (required),
        ``registry_publish`` (publish the model_location artifact as a
        new version; default: only when the registry has no stable yet),
        ``deploy_version`` (default: the registry's stable),
        ``canary_version`` + ``canary_fraction`` + ``canary_shadow``,
        ``canary_check_every_batches``, ``rollback_*`` (RollbackPolicy
        fields, e.g. ``rollback_max_latency_ratio``), ``slo_path`` (SLO
        config whose firing burn-rate alerts become hard rollback
        signals and whose report lands in ``slo_report.json`` +
        ``deploy_metrics.json``), plus the serve knobs
        ``serving_buckets`` / ``serving_drift_policy`` /
        ``serving_fused_backend``.  The deployment summary (generations
        + telemetry + lifecycle events with rollback evidence) exports
        to ``<metrics_location>/deploy_metrics.json``.  A canary still
        live when the run ends is RELEASED in the registry (back to
        candidate, undecided) so the slot never points at a version no
        process is serving.  Each registry load gets a fresh workflow
        from ``workflow_factory`` when the runner has one (the stable
        first, then the canary) — required whenever the stable and
        canary versions carry different blacklists or heads."""
        from ..registry import (
            DeploymentController,
            ModelRegistry,
            RollbackPolicy,
        )
        from ..schema.quarantine import data_telemetry
        from ..serving import RowScoringError, records_from_dataset

        cp = params.custom_params
        root = cp.get("registry_root")
        if not root:
            raise ValueError(
                "deploy run requires custom_params['registry_root']"
            )
        registry = ModelRegistry(root)
        published = None
        if params.model_location and cp.get(
                "registry_publish", registry.stable is None):
            model = self._load_model(params)
            published = registry.publish(
                model, metrics=dict(cp.get("registry_metrics", {}))
            )
            if registry.stable is None:
                registry.promote(published.version, to="stable")
        stable_version = cp.get("deploy_version") or registry.stable
        if stable_version is None:
            raise ValueError(
                "deploy run: the registry has no stable version to "
                "deploy (publish one via model_location + "
                "registry_publish, or promote one first)"
            )
        policy_kw = {
            k[len("rollback_"):]: v
            for k, v in cp.items() if k.startswith("rollback_")
        }
        # an slo_path knob (built in run()) plugs the SLO engine into
        # the rollback policy: firing burn-rate alerts are hard
        # rollback signals next to breaker opens and NaN refusals
        slo_engine = getattr(self, "_slo_engine", None)
        policy = None
        if policy_kw or slo_engine is not None:
            policy = RollbackPolicy(**policy_kw)
            policy.slo_engine = slo_engine
        controller = DeploymentController(
            registry=registry,
            policy=policy,
            canary_fraction=float(cp.get("canary_fraction", 0.05)),
            shadow=bool(cp.get("canary_shadow", False)),
            check_every_batches=int(
                cp.get("canary_check_every_batches", 8)),
            batch_buckets=tuple(cp.get("serving_buckets", (1, 8, 32, 128))),
            drift_policy=str(cp.get("serving_drift_policy", "warn")),
            fused_backend=cp.get("serving_fused_backend"),
        )
        controller.deploy_version(stable_version, self._fresh_workflow())
        if cp.get("canary_version"):
            controller.start_canary_version(
                str(cp["canary_version"]), self._fresh_workflow()
            )
        stable_gen = controller.stable_generation
        # serve-side ingest attribution: rows read for this deploy count
        # against the model version they feed (the shared telemetry
        # model_version/generation pair)
        data_telemetry().set_model_version(stable_version,
                                           generation=stable_gen.generation)
        raw_features = stable_gen.endpoint.raw_features
        reader = self._reader("score")
        if reader is not None:
            raw = reader.generate_dataset(raw_features,
                                          params.reader_params)
        else:
            raw = self.workflow.generate_raw_data()
        records = records_from_dataset(raw, raw_features)
        step = max(int(cp.get("deploy_batch_rows", 128)), 1)
        results: list = []
        for lo in range(0, len(records), step):
            results.extend(controller.score_batch(records[lo:lo + step]))
        final_check = controller.check_canary()
        # an undecided canary must not keep the registry slot after this
        # serving process exits: a later run's canary would otherwise
        # serve untracked while operator rollback targeted the stale one
        canary_released = None
        if controller.canary_generation is not None:
            canary_released = registry.release_canary(
                reason="deploy run ended with the canary undecided"
            )
        extra = {
            "run_type": "deploy",
            "registry_root": registry.root,
            "rows_submitted": len(records),
            "rows_failed": sum(
                isinstance(r, RowScoringError) for r in results),
            "published_version":
                published.version if published else None,
            "deployed_version": stable_version,
            "canary_version": cp.get("canary_version"),
            "final_decision":
                final_check.to_json() if final_check else None,
            "canary_released": canary_released,
        }
        if params.metrics_location:
            os.makedirs(params.metrics_location, exist_ok=True)
            metrics = controller.export(
                os.path.join(params.metrics_location,
                             "deploy_metrics.json"),
                extra=extra,
            )
        else:
            metrics = dict(controller.summary_json(), **extra)
        if params.write_location:
            os.makedirs(params.write_location, exist_ok=True)
            rows = [
                {"error": r.error} if isinstance(r, RowScoringError) else r
                for r in results
            ]
            with open(
                os.path.join(params.write_location, "scores.json"), "w"
            ) as f:
                json.dump(rows, f, default=str)
        return OpWorkflowRunnerResult(run_type="deploy", metrics=metrics)

    def _fleet(self, params: OpParams) -> OpWorkflowRunnerResult:
        """Scale-out fleet serving run.  Knobs ride
        OpParams.custom_params: ``registry_root`` (required),
        ``fleet_workflow`` (required ``module:function`` factory the
        replica workers rebuild the workflow from - the same spec the
        runner CLI's ``--workflow`` takes), ``fleet_replicas``
        (default 2), ``fleet_dir`` (obs aggregation dir; default under
        the fleet work dir), ``fleet_work_dir``, ``registry_publish``
        (publish model_location as a new version; default: only when
        the registry has no stable), ``fleet_deploy_version`` (rolling
        hot-swap to this version mid-traffic), ``fleet_batch_rows``
        (rows per routed batch, default 512), ``fleet_concurrency``
        (client pump threads, default 4), ``fleet_tenant_quota``,
        ``fleet_max_in_flight``, plus the worker serve knobs
        ``serving_buckets`` / ``serving_drift_policy`` /
        ``serving_fused_backend`` (auto|torch|numpy).  Network knobs:
        ``fleet_transport`` ("unix" on-host fast path, default; "tcp"
        for the cross-host wire, loopback-drillable), ``fleet_quorum``
        + ``fleet_tenant_priority`` (brownout: below quorum healthy
        replicas, tenants under priority 1 shed loudly),
        ``fleet_response_timeout_s`` (per-request silence ceiling
        driving ejection), ``fleet_deadline_ms`` (per-batch deadline
        that rides the wire so replicas drop abandoned work), and the
        ReplicaHealth eject/readmit knobs ``fleet_eject_after`` /
        ``fleet_probe_interval_s`` / ``fleet_probe_timeout_s``.  The
        replicas score on the runner workflow's device (the card for
        ``OpWorkflow()``).
        ``fleet_autoscale`` attaches a :class:`~..fleet.FleetAutoscaler`
        for the run (``fleet_min_replicas`` / ``fleet_max_replicas``,
        ``fleet_autoscale_interval_s``, ``fleet_target_utilization``);
        the replicas it adds come up on the same device.
        Exports the one-document fleet status + router counters to
        ``<metrics_location>/fleet_metrics.json``."""
        import threading

        from ..fleet import FleetController
        from ..local.scorer import FUSED_BACKENDS
        from ..registry import ModelRegistry
        from ..serving import records_from_dataset

        cp = params.custom_params
        root = cp.get("registry_root")
        spec = cp.get("fleet_workflow")
        if not root or not spec:
            raise ValueError(
                "fleet run requires custom_params['registry_root'] and "
                "['fleet_workflow'] (module:function)"
            )
        backend = cp.get("serving_fused_backend")
        if backend and backend not in FUSED_BACKENDS:
            raise ValueError(
                f"serving_fused_backend must be one of {FUSED_BACKENDS}, "
                f"got {backend!r}")
        registry = ModelRegistry(root)
        published = None
        if params.model_location and cp.get(
                "registry_publish", registry.stable is None):
            model = self._load_model(params)
            published = registry.publish(model)
            if registry.stable is None:
                registry.promote(published.version, to="stable")
        worker_args = []
        if cp.get("serving_buckets"):
            worker_args += ["--buckets", ",".join(
                str(b) for b in cp["serving_buckets"])]
        if cp.get("serving_drift_policy"):
            worker_args += ["--drift-policy",
                            str(cp["serving_drift_policy"])]
        if backend:
            worker_args += ["--fused-backend", str(backend)]
        router_kw = {
            "max_in_flight_per_replica": int(
                cp.get("fleet_max_in_flight", 4)),
            "max_queue": int(cp.get("fleet_max_queue", 256)),
        }
        if cp.get("fleet_tenant_quota") is not None:
            router_kw["tenant_quota"] = float(cp["fleet_tenant_quota"])
        if cp.get("fleet_quorum") is not None:
            router_kw["quorum"] = int(cp["fleet_quorum"])
        if cp.get("fleet_tenant_priority") is not None:
            router_kw["tenant_priority"] = dict(
                cp["fleet_tenant_priority"])
        if cp.get("fleet_response_timeout_s") is not None:
            router_kw["response_timeout_s"] = float(
                cp["fleet_response_timeout_s"])
        reader = self._reader("score")
        if reader is not None:
            raw = reader.generate_dataset(self.workflow.raw_features,
                                          params.reader_params)
        else:
            raw = self.workflow.generate_raw_data()
        records = records_from_dataset(
            raw, [f for f in self.workflow.raw_features
                  if not f.is_response])
        step = max(int(cp.get("fleet_batch_rows", 512)), 1)
        batches = [records[lo:lo + step]
                   for lo in range(0, len(records), step)]
        health_kw = {}
        if cp.get("fleet_eject_after") is not None:
            health_kw["eject_after"] = int(cp["fleet_eject_after"])
        if cp.get("fleet_probe_interval_s") is not None:
            health_kw["probe_interval_s"] = float(
                cp["fleet_probe_interval_s"])
        if cp.get("fleet_probe_timeout_s") is not None:
            health_kw["probe_timeout_s"] = float(
                cp["fleet_probe_timeout_s"])
        controller = FleetController(
            root, str(spec),
            n_replicas=int(cp.get("fleet_replicas", 2)),
            work_dir=cp.get("fleet_work_dir"),
            fleet_dir=cp.get("fleet_dir") or os.environ.get(
                "TX_OBS_FLEET_DIR"),
            router_kw=router_kw,
            worker_args=worker_args,
            transport=str(cp.get("fleet_transport", "unix")),
            device=self.workflow.device,
            **health_kw,
        )
        deadline_ms = cp.get("fleet_deadline_ms")
        deadline_ms = None if deadline_ms is None else float(deadline_ms)
        rolling_report = None
        autoscaler = None
        with controller:
            if cp.get("fleet_autoscale"):
                from ..fleet import FleetAutoscaler

                autoscaler = FleetAutoscaler(
                    controller,
                    min_replicas=int(cp.get("fleet_min_replicas", 1)),
                    max_replicas=int(cp.get("fleet_max_replicas", 8)),
                    interval_s=float(
                        cp.get("fleet_autoscale_interval_s", 0.5)),
                    target_utilization=float(
                        cp.get("fleet_target_utilization", 0.7)),
                )
                autoscaler.start()

            n_threads = max(int(cp.get("fleet_concurrency", 4)), 1)
            lock = threading.Lock()
            idx = {"i": 0}
            counts = {"ok": 0, "failed": 0}
            errors: list[str] = []

            def pump() -> None:
                while True:
                    with lock:
                        i = idx["i"]
                        if i >= len(batches):
                            return
                        idx["i"] = i + 1
                    try:
                        res = controller.router.score_batch(
                            batches[i], timeout_s=120.0,
                            deadline_ms=deadline_ms)
                        with lock:
                            counts["ok"] += len(res)
                    except Exception as e:  # noqa: BLE001 - batch isolation
                        with lock:
                            counts["failed"] += len(batches[i])
                            errors.append(f"{type(e).__name__}: {e}")

            # half the traffic lands before the rolling deploy, half
            # after, when one is requested - the deploy runs mid-load
            threads = [threading.Thread(target=pump, daemon=True)
                       for _ in range(n_threads)]
            for t in threads:
                t.start()
            if cp.get("fleet_deploy_version"):
                rolling_report = controller.rolling_deploy(
                    str(cp["fleet_deploy_version"]))
            deadline = time.monotonic() + float(
                cp.get("fleet_pump_timeout_s", 3600.0))
            for t in threads:
                t.join(timeout=max(deadline - time.monotonic(), 0.05))
            still_running = [t for t in threads if t.is_alive()]
            if still_running:
                # counts harvested below would silently under-report;
                # say so loudly in the exported metrics instead
                errors.append(
                    f"{len(still_running)} pump thread(s) still "
                    f"running at fleet_pump_timeout_s - row counts "
                    f"are partial")
            rows_ok, rows_failed = counts["ok"], counts["failed"]
            if autoscaler is not None:
                autoscaler.stop()
            status = controller.status()
        metrics = {
            "run_type": "fleet",
            "registry_root": root,
            "replicas": int(cp.get("fleet_replicas", 2)),
            "rows_submitted": len(records),
            "rows_ok": rows_ok,
            "rows_failed": rows_failed,
            "errors": errors[:16],
            "published_version":
                published.version if published else None,
            "rolling_deploy": rolling_report,
            "status": status,
        }
        if params.metrics_location:
            from ..obs import write_json_artifact

            os.makedirs(params.metrics_location, exist_ok=True)
            write_json_artifact(
                os.path.join(params.metrics_location,
                             "fleet_metrics.json"), metrics)
        return OpWorkflowRunnerResult(run_type="fleet", metrics=metrics)

    def _bulk(self, params: OpParams) -> OpWorkflowRunnerResult:
        """The ``bulk`` run type: a checkpointed, exactly-once
        batch-inference job - sharded input files stream through the
        input pipeline straight into the fused scoring program on the
        model's device (torch-fused on the card, numpy-fused for a
        ``device="cpu"`` model), each shard's output committing through
        the atomic journal so a killed run resumes from the last
        committed shard with zero duplicated or lost rows.  Knobs
        (custom_params): ``bulk_inputs`` (list of shard paths; optional
        when ``bulk_job_dir`` already holds a journal to resume),
        ``bulk_job_dir`` (default <write_location>/bulk), ``bulk_fmt``,
        ``bulk_errors``, ``bulk_chunk_rows``, ``bulk_workers``,
        ``bulk_buffer_chunks``, ``bulk_fused_backend`` (numpy|torch)."""
        from ..bulk import BulkScoringJob
        from ..readers.pipeline import DEFAULT_CHUNK_ROWS, DEFAULT_WORKERS

        cp = params.custom_params
        job_dir = cp.get("bulk_job_dir") or (
            os.path.join(params.write_location, "bulk")
            if params.write_location else None)
        if not job_dir:
            raise ValueError("bulk run needs custom_params "
                             "{'bulk_job_dir': DIR} or write_location")
        backend = cp.get("bulk_fused_backend")
        if backend and backend not in ("numpy", "torch"):
            raise ValueError(
                f"bulk_fused_backend must be 'numpy' or 'torch', "
                f"got {backend!r}")
        inputs = cp.get("bulk_inputs")
        model = self._load_model(params)
        job = BulkScoringJob(
            model, str(job_dir),
            [str(p) for p in inputs] if inputs else None,
            fmt=cp.get("bulk_fmt"),
            errors=str(cp.get("bulk_errors", "quarantine")),
            chunk_rows=int(cp.get("bulk_chunk_rows", DEFAULT_CHUNK_ROWS)),
            workers=int(cp.get("bulk_workers", DEFAULT_WORKERS)),
            buffer_chunks=int(cp.get("bulk_buffer_chunks", 8)),
            fused_backend=backend,
        )
        metrics = dict(job.run(), run_type="bulk")
        if params.metrics_location:
            from ..obs import write_json_artifact

            os.makedirs(params.metrics_location, exist_ok=True)
            write_json_artifact(
                os.path.join(params.metrics_location,
                             "bulk_metrics.json"), metrics)
        return OpWorkflowRunnerResult(run_type="bulk", metrics=metrics)

    def _continuous(self, params: OpParams) -> OpWorkflowRunnerResult:
        """The ``continuous`` run type: a BOUNDED run of the
        drift-triggered refit controller - tail ``watch_dir`` for shards,
        score each window's drift against the stable model's training
        contract, refit + publish + promote when the governor trips, then
        exit after ``continuous_max_cycles`` cycles or
        ``continuous_idle_exit`` consecutive empty polls.  The batch
        entrypoint runs in DIRECT promote mode (publish -> stable pointer
        flip), bootstrapping a stable version from the factory workflow
        when the registry has none.  Knobs (custom_params): ``watch_dir``
        (required), ``registry_root`` (default <model_location>/registry),
        ``drift_threshold`` / ``drift_consecutive`` / ``drift_cooldown``,
        ``continuous_window_rows``, ``continuous_refit_rows``,
        ``continuous_max_cycles`` / ``continuous_idle_exit`` /
        ``continuous_poll_s``, ``continuous_status_dir`` and
        ``train_fused``, which the refits take."""
        from ..continuous import ContinuousTrainer
        from ..registry import ModelRegistry

        cp = params.custom_params
        watch = cp.get("watch_dir")
        if not watch:
            raise ValueError("continuous run needs custom_params "
                             "{'watch_dir': DIR} to tail")
        root = cp.get("registry_root") or (
            os.path.join(params.model_location, "registry")
            if params.model_location else None)
        if not root:
            raise ValueError("continuous run needs custom_params "
                             "{'registry_root': DIR} or model_location")
        status_dir = str(cp.get("continuous_status_dir")
                         or params.metrics_location or watch)
        trainer = ContinuousTrainer(
            str(watch), ModelRegistry(str(root)), self._fresh_workflow,
            status_dir=status_dir,
            drift_threshold=float(cp.get("drift_threshold", 0.1)),
            consecutive_windows=int(cp.get("drift_consecutive", 3)),
            cooldown_windows=int(cp.get("drift_cooldown", 2)),
            min_window_rows=int(cp.get("continuous_window_rows", 64)),
            refit_rows=int(cp.get("continuous_refit_rows", 4096)),
            train_fused=cp.get("train_fused"),
            bootstrap=True,
        )
        trainer.run(
            max_cycles=int(cp.get("continuous_max_cycles", 4)),
            idle_exit=int(cp.get("continuous_idle_exit", 2)),
            poll_interval_s=float(cp.get("continuous_poll_s", 0.2)),
        )
        metrics = dict(trainer.status(), run_type="continuous")
        if params.metrics_location:
            from ..obs import write_json_artifact

            os.makedirs(params.metrics_location, exist_ok=True)
            write_json_artifact(
                os.path.join(params.metrics_location,
                             "continuous_metrics.json"), metrics)
        return OpWorkflowRunnerResult(run_type="continuous",
                                      metrics=metrics)

    # ------------------------------------------------------------------
    def streaming_score(
        self,
        batches: Iterable[Any],
        params: Optional[OpParams] = None,
        on_batch: Optional[Callable[[Dataset], None]] = None,
    ):
        """Micro-batch scoring loop (reference: StreamingScore run type,
        OpWorkflowRunner.scala:313-332 scoring each DStream micro-batch with
        the row-level score function)."""
        params = params or OpParams()
        model = self._load_model(params)
        for batch in batches:
            scored = model.score(batch)
            if on_batch is not None:
                on_batch(scored)
            yield scored


def _write_scores(scored: Dataset, model: OpWorkflowModel, location: str,
                  write_format: str = "json") -> None:
    """Column-pruned score output (reference: OpWorkflowModel.saveScores:
    375-420 - keep result features + response; avro like the reference's
    saveAvro, or json)."""
    os.makedirs(location, exist_ok=True)
    keep = [f.name for f in model.result_features if f.name in scored]
    keep += [
        f.name for f in model.raw_features if f.is_response and f.name in scored
    ]
    if write_format not in ("json", "avro"):
        raise ValueError(
            f"write_format must be 'json' or 'avro', got {write_format!r}"
        )
    pruned = scored.select(keep)
    if write_format == "avro":
        from ..readers.avro_reader import (
            rows_from_dataset,
            schema_for_dataset,
            write_avro_records,
        )

        schema = schema_for_dataset(pruned, name="Score")
        write_avro_records(
            os.path.join(location, "scores.avro"),
            schema, rows_from_dataset(pruned, schema),
        )
        return
    out = pruned.to_pylists()
    with open(os.path.join(location, "scores.json"), "w") as f:
        json.dump(out, f, default=str)


def main(argv=None) -> int:
    """CLI entry (OpApp.main analog)."""
    p = argparse.ArgumentParser(
        description="transmogrifai_tpu_torch workflow runner")
    p.add_argument("--run-type", required=True,
                   choices=["train", "score", "features", "evaluate",
                            "serve", "deploy", "fleet", "continuous",
                            "bulk"])
    p.add_argument("--params", help="path to OpParams JSON")
    p.add_argument("--workflow", required=True,
                   help="module:function returning (workflow, evaluator, readers...)")
    args = p.parse_args(argv)
    import importlib

    mod_name, _, fn_name = args.workflow.partition(":")
    factory = getattr(importlib.import_module(mod_name), fn_name)
    built = factory()
    wf = built[0] if isinstance(built, tuple) else built
    evaluator = built[1] if isinstance(built, tuple) and len(built) > 1 else None
    runner = OpWorkflowRunner(wf, evaluator=evaluator,
                              workflow_factory=factory)
    params = OpParams.from_file(args.params) if args.params else OpParams()
    result = runner.run(args.run_type, params)
    print(json.dumps({"run_type": result.run_type, "wall_s": result.wall_s}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
