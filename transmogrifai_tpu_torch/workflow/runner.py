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

plus a CLI (``python -m transmogrifai_tpu_torch.workflow.runner
--run-type ...``) standing in for OpApp.main's scopt parsing.

Models load and score on the workflow's device: ``OpWorkflow()`` is the
card (``"cuda"``), ``OpWorkflow(device="cpu")`` the host.  The ``fleet``,
``continuous`` and ``bulk`` run types, the ``autotune`` and
``serving_autotune`` knobs, the pipelined reader (``ingest_shards``) and
the obs-fleet shipping (``fleet_dir`` / ``TX_OBS_FLEET_DIR``) raise
``NotImplementedError`` until their subsystems are ported (ROADMAP.md
queue 1, item 12).
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

#: the run types whose subsystems wait for ROADMAP.md queue 1, item 12
UNPORTED_RUN_TYPES = ("fleet", "continuous", "bulk")


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to the torch package yet "
        "(ROADMAP.md queue 1, item 12)"
    )


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
        if run_type in UNPORTED_RUN_TYPES:
            raise _not_ported(f"the {run_type!r} run type")
        # obs-fleet shipping: the custom param or the env seam
        fd = params.custom_params.get("fleet_dir") or os.environ.get(
            "TX_OBS_FLEET_DIR")
        if fd:
            raise _not_ported("obs-fleet shipping (fleet_dir / "
                              "TX_OBS_FLEET_DIR)")
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
        return result

    # ------------------------------------------------------------------
    def _reader(self, which: str):
        r = self.train_reader if which == "train" else self.score_reader
        return r or self.workflow._reader

    def _train(self, params: OpParams) -> OpWorkflowRunnerResult:
        if self.train_reader is not None:
            self.workflow.set_reader(self.train_reader)
        if params.custom_params.get("ingest_shards"):
            raise _not_ported("the pipelined sharded reader "
                              "(ingest_shards)")
        if params.custom_params.get("autotune"):
            raise _not_ported("successive-halving autotune (autotune)")
        tf_validators = self._setup_train_fused(params)
        model = self.workflow.train()
        summary = model.summary_json()
        tf_summary = train_fused_summary(tf_validators)
        if tf_summary is not None:
            summary["train_fused"] = tf_summary
        if params.model_location:
            model.save(params.model_location)
            with open(
                os.path.join(params.model_location, "summary.json"), "w"
            ) as f:
                json.dump(summary, f, indent=1, default=str)
        return OpWorkflowRunnerResult(
            run_type="train", model=model, summary=summary
        )

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
        if cp.get("serving_autotune"):
            raise _not_ported("the serving micro-batch autotune "
                              "(serving_autotune)")
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
        with MicroBatchScheduler(
            endpoint,
            max_wait_us=int(cp.get("serving_max_wait_us", 2000)),
            max_queue=int(cp.get("serving_max_queue", 1024)),
            default_deadline_ms=None if deadline is None else float(deadline),
        ) as scheduler:
            results = list(scheduler.score_stream(
                records, window=int(cp.get("serving_window", 256))
            ))
        extra = {
            "run_type": "serve",
            "rows_submitted": n,
            "model_location": params.model_location,
        }
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
                            "serve", "deploy", *UNPORTED_RUN_TYPES])
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
