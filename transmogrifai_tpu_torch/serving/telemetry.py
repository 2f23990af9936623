"""Serving-tier telemetry: latency/throughput/queue/batch-fill metrics.

Counterpart of the per-stage AppMetrics accumulation in utils/tracing.py
(reference: OpSparkListener / AppMetrics, utils/.../spark/
OpSparkListener.scala:56-161) specialized to the request/response tier:
per-request latency percentiles (p50/p95/p99), rows/s, admission-control
outcome counters (shed/timeout/fallback), queue-depth samples, and a
batch-fill histogram showing how well the micro-batching scheduler packs
its shape buckets.  Snapshots export as a JSON artifact.

Host copy of ``transmogrifai_tpu/serving/telemetry.py``.  The fused
status records the torch device program's per-bucket ``compile_ms`` and
``first_exec_ms`` (``local/fused_torch.py``); the executable-cache
counters stay at zero, since the port has no executable cache.
"""
from __future__ import annotations

import logging
import threading
import time
from typing import Optional

from ..obs.metrics import (
    metrics_registry,
    percentiles,
    write_json_artifact,
)

log = logging.getLogger("transmogrifai_tpu_torch.serving")

LOG_PREFIX = "op_serving_metrics"

#: bounded sample reservoirs - serving loops run unbounded, telemetry
#: memory must not (beyond the cap, samples decimate 2:1, keeping every
#: other sample so the distribution stays representative)
_MAX_SAMPLES = 65536


def _finite(v: float, ndigits: int):
    """Round, mapping the empty-sample NaN to None: bare NaN tokens are
    not valid JSON (RFC 8259) and would break strict consumers of the
    exported artifact."""
    return None if v != v else round(v, ndigits)


class ServingTelemetry:
    """Thread-safe accumulator shared by endpoint + scheduler."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.started_at = time.time()  # epoch stamp (correlation only)
        self._pc_start = time.perf_counter()  # durations NEVER use the
        # epoch clock (the tests/test_style.py timing gate)
        # unified metrics plane (obs/): this accumulator's snapshot is a
        # registered VIEW - same shape, scrapeable via the Prometheus
        # exposition next to mesh/data/stage metrics
        metrics_registry().register_view("serving", self)
        # model-version attribution (registry/): every snapshot names
        # the model version + deployment generation that produced it, so
        # exported JSON and summary_json() metrics are attributable after a
        # hot-swap (the Mesh/Data telemetry classes carry the same pair)
        self.model_version: Optional[str] = None
        self.generation: Optional[int] = None
        # multi-model attribution: which HOSTED MODEL this
        # accumulator serves when a replica multiplexes N models behind
        # one lane - None on single-model surfaces, a model_id label in
        # the Prometheus exposition otherwise
        self.model_id: Optional[str] = None
        self._lifecycle: list[dict] = []
        self._latencies_s: list[float] = []
        self._batch_sizes: list[int] = []
        self._batch_fills: list[float] = []
        self._queue_depths: list[int] = []
        self.rows_ok = 0
        self.rows_fallback = 0
        self.rows_failed = 0
        self.rows_batched = 0
        # whole-pipeline fused compilation status (local/fused.py): set
        # by the endpoint, exported so every serving artifact names
        # whether the hot path was the fused program or the interpreted
        # DAG walk, why, and what each shape bucket's compile cost
        self.fused_enabled: Optional[bool] = None
        self.fused_reason: Optional[str] = None
        self.fused_compile_ms: dict = {}
        self.batches_fused = 0
        self.rows_fused = 0
        # the torch fused backend (local/fused_torch.py): which backend
        # serves and the per-bucket compile/first-exec split; the
        # executable-cache counters keep the JAX package's shape and stay
        # at zero (the torch program has no executable cache)
        self.fused_backend: Optional[str] = None
        self.fused_bucket_timings: dict = {}
        self.shed_deadline = 0
        self.shed_queue_full = 0
        self.shed_quota = 0
        self.request_timeouts = 0
        self.batches = 0
        self.batch_wall_s = 0.0
        # circuit-breaker health (admission.CircuitBreaker transitions +
        # the rows it sheds + NaN/Inf rows the output guard caught)
        self.shed_breaker = 0
        self.rows_shed_breaker = 0
        self.breaker_opens = 0
        self.breaker_closes = 0
        self.breaker_probes = 0
        self.rows_nonfinite = 0
        # data-contract guards (schema/: contract validation + the
        # serve-vs-train distribution drift monitor)
        self.empty_batches = 0
        self.shed_schema = 0
        self.rows_shed_schema = 0
        self.schema_drift_batches = 0
        self.schema_violations_by_kind: dict = {}
        self.schema_drift_actions: dict = {}
        self._drift_last: dict = {}
        self._drift_max: dict = {}
        # autotune: which serving knobs the tuner owns for
        # this endpoint/scheduler and the values it chose - scraped as
        # tx_serving_tuned_knobs_* so tuned-vs-hand-set is visible in
        # the obs plane, not just in run artifacts
        self.tuned_knobs: dict = {}
        self.knob_source: str = "hand_set"

    # -- recording ----------------------------------------------------------
    def _sample(self, bucket: list, value) -> None:
        bucket.append(value)
        if len(bucket) > _MAX_SAMPLES:
            del bucket[::2]

    def record_request(self, latency_s: float, outcome: str = "ok") -> None:
        """Outcomes: ok | failed | shed_deadline | shed_queue_full |
        shed_quota | shed_breaker | shed_schema | timeout."""
        with self._lock:
            if outcome in ("ok", "failed"):
                self._sample(self._latencies_s, float(latency_s))
            if outcome == "ok":
                self.rows_ok += 1
            elif outcome == "failed":
                self.rows_failed += 1
            elif outcome == "shed_deadline":
                self.shed_deadline += 1
            elif outcome == "shed_queue_full":
                self.shed_queue_full += 1
            elif outcome == "shed_quota":
                self.shed_quota += 1
            elif outcome == "shed_breaker":
                self.shed_breaker += 1
            elif outcome == "shed_schema":
                self.shed_schema += 1
            elif outcome == "timeout":
                self.request_timeouts += 1

    def record_batch(self, n_rows: int, bucket_size: int,
                     wall_s: float, fused: bool = False) -> None:
        with self._lock:
            self.batches += 1
            self.batch_wall_s += float(wall_s)
            self.rows_batched += int(n_rows)
            if fused:
                self.batches_fused += 1
                self.rows_fused += int(n_rows)
            self._sample(self._batch_sizes, int(n_rows))
            self._sample(
                self._batch_fills, n_rows / bucket_size if bucket_size else 0.0
            )

    def set_fused_status(self, enabled: bool, reason: Optional[str],
                         compile_ms_by_bucket: Optional[dict] = None,
                         backend: Optional[str] = None,
                         bucket_timings: Optional[dict] = None) -> None:
        """Record whether this endpoint serves through the fused
        program, which backend ('torch' | 'numpy'), why not (when
        degraded), the per-shape-bucket compile/warm wall times (keyed
        by batch length, ms) and - on the torch backend - the per-bucket
        ``compile_ms / first_exec_ms`` split."""
        with self._lock:
            self.fused_enabled = bool(enabled)
            self.fused_reason = reason
            if backend is not None:
                self.fused_backend = backend
            if compile_ms_by_bucket:
                self.fused_compile_ms.update(
                    {int(k): round(float(v), 3)
                     for k, v in compile_ms_by_bucket.items()}
                )
            if bucket_timings:
                self.fused_bucket_timings.update({
                    int(k): {kk: round(float(vv), 3) for kk, vv in v.items()}
                    for k, v in bucket_timings.items()
                })

    def record_fallback_rows(self, n: int) -> None:
        """Rows that missed the compiled bucketed path and scored through
        the row fallback (request-level ok/failed accounting stays with
        the caller - this only tracks the degradation count)."""
        with self._lock:
            self.rows_fallback += int(n)

    def record_queue_depth(self, depth: int) -> None:
        with self._lock:
            self._sample(self._queue_depths, int(depth))

    def record_breaker_transition(self, event: str) -> None:
        """Circuit-breaker state changes: open | close | probe.  Opens
        log at WARNING - a breaker opening IS the degradation alarm."""
        with self._lock:
            if event == "open":
                self.breaker_opens += 1
            elif event == "close":
                self.breaker_closes += 1
            elif event == "probe":
                self.breaker_probes += 1
        if event == "open":
            log.warning("%s circuit breaker OPEN: batch path unhealthy, "
                        "shedding until a half-open probe succeeds",
                        LOG_PREFIX)
        elif event == "close":
            log.info("%s circuit breaker closed: batch path recovered",
                     LOG_PREFIX)

    def record_breaker_shed_rows(self, n: int) -> None:
        """Rows shed unscored because the breaker was open (request-level
        shed_breaker accounting stays with the scheduler, mirroring the
        rows_fallback split)."""
        with self._lock:
            self.rows_shed_breaker += int(n)

    def record_nonfinite_rows(self, n: int) -> None:
        """Rows whose scores failed the NaN/Inf output guard."""
        with self._lock:
            self.rows_nonfinite += int(n)

    def record_empty_batch(self) -> None:
        """A zero-row batch reached the endpoint (e.g. every row was
        quarantined upstream): a counted no-op, not an error."""
        with self._lock:
            self.empty_batches += 1

    def record_schema_violations(self, violations, action: str) -> None:
        """One batch violated the schema contract; ``action`` is the
        drift_policy applied (raise | warn | shed), counted per policy
        so the snapshot shows HOW violating batches were handled."""
        with self._lock:
            self.schema_drift_batches += 1
            self.schema_drift_actions[action] = (
                self.schema_drift_actions.get(action, 0) + 1
            )
            for v in violations:
                kind = v.get("kind", "unknown")
                self.schema_violations_by_kind[kind] = (
                    self.schema_violations_by_kind.get(kind, 0) + 1
                )

    def record_schema_shed_rows(self, n: int) -> None:
        """Rows refused unscored under drift_policy='shed' (request-
        level shed_schema accounting stays with the scheduler)."""
        with self._lock:
            self.rows_shed_schema += int(n)

    def set_model_version(self, version: Optional[str],
                          generation: Optional[int] = None) -> None:
        """Attribute everything this accumulator records to one model
        version / deployment generation (set by the registry's
        DeploymentController at deploy time)."""
        with self._lock:
            self.model_version = version
            self.generation = generation

    def set_model_id(self, model_id: Optional[str]) -> None:
        """Attribute this accumulator to one hosted model of a
        multi-model replica; surfaces as the ``model_id``
        label on every ``tx_serving_*`` sample this view exports."""
        with self._lock:
            self.model_id = None if model_id is None else str(model_id)

    #: lifecycle events kept per accumulator (bounded like samples)
    _MAX_LIFECYCLE = 256

    def record_lifecycle(self, event: dict) -> None:
        """A deployment lifecycle event (swap / canary start / rollback
        decision with evidence) attributed to this generation; surfaced
        in the snapshot so the serving JSON artifact carries the WHY
        behind any metric discontinuity."""
        with self._lock:
            self._lifecycle.append(dict(event))
            if len(self._lifecycle) > self._MAX_LIFECYCLE:
                del self._lifecycle[0]

    def set_tuned_knobs(self, knobs: dict,
                        source: str = "autotune") -> None:
        """Record the knob values the tuner (or a hand-set override)
        chose for this serving surface; numeric values surface as
        scrapeable series, the source ('hand_set' | 'autotune') says
        who owns them now."""
        with self._lock:
            self.tuned_knobs.update({
                str(k): (float(v) if isinstance(v, (int, float))
                         and not isinstance(v, bool) else str(v))
                for k, v in knobs.items()
            })
            self.knob_source = str(source)

    def record_drift_scores(self, scores: dict) -> None:
        """Latest per-feature JS divergence vs the training
        distributions; running max kept per feature."""
        with self._lock:
            for name, s in scores.items():
                self._drift_last[name] = float(s)
                if s > self._drift_max.get(name, 0.0):
                    self._drift_max[name] = float(s)

    # -- reporting ----------------------------------------------------------
    def snapshot(self) -> dict:
        with self._lock:
            lat_ms = [v * 1e3 for v in self._latencies_s]
            fills = list(self._batch_fills)
            sizes = list(self._batch_sizes)
            depths = list(self._queue_depths)
            wall = max(time.perf_counter() - self._pc_start, 1e-9)
            batch_wall = max(self.batch_wall_s, 1e-9)
            rows = self.rows_ok + self.rows_failed
            fill_hist = {"0-25%": 0, "25-50%": 0, "50-75%": 0, "75-100%": 0}
            for f in fills:
                if f <= 0.25:
                    fill_hist["0-25%"] += 1
                elif f <= 0.5:
                    fill_hist["25-50%"] += 1
                elif f <= 0.75:
                    fill_hist["50-75%"] += 1
                else:
                    fill_hist["75-100%"] += 1
            return {
                "wall_s": round(wall, 3),
                "model_version": self.model_version,
                "generation": self.generation,
                "model_id": self.model_id,
                "lifecycle": [dict(e) for e in self._lifecycle],
                "rows_scored": self.rows_ok,
                "rows_failed": self.rows_failed,
                "rows_fallback": self.rows_fallback,
                "shed_deadline": self.shed_deadline,
                "shed_queue_full": self.shed_queue_full,
                "shed_quota": self.shed_quota,
                "shed_breaker": self.shed_breaker,
                "request_timeouts": self.request_timeouts,
                "breaker": {
                    "opens": self.breaker_opens,
                    "closes": self.breaker_closes,
                    "probes": self.breaker_probes,
                    "rows_shed": self.rows_shed_breaker,
                    "rows_nonfinite": self.rows_nonfinite,
                },
                "data_contract": {
                    "empty_batches": self.empty_batches,
                    "shed_schema": self.shed_schema,
                    "rows_shed_schema": self.rows_shed_schema,
                    "schema_drift_batches": self.schema_drift_batches,
                    "violations_by_kind": dict(
                        self.schema_violations_by_kind),
                    "batches_by_action": dict(self.schema_drift_actions),
                    "drift_js": {
                        name: {
                            "last": round(self._drift_last[name], 6),
                            "max": round(
                                self._drift_max.get(name, 0.0), 6),
                        }
                        for name in sorted(self._drift_last)
                    },
                    "drift_js_max": round(
                        max(self._drift_max.values(), default=0.0), 6),
                },
                "rows_per_s": round(rows / wall, 1),
                "tuned_knobs": dict(self.tuned_knobs),
                "knob_source": self.knob_source,
                "rows_batched": self.rows_batched,
                "batch_rows_per_s": round(self.rows_batched / batch_wall, 1),
                "fused": {
                    "enabled": self.fused_enabled,
                    "backend": self.fused_backend,
                    "reason": self.fused_reason,
                    "compile_ms_by_bucket": {
                        str(k): v
                        for k, v in sorted(self.fused_compile_ms.items())
                    },
                    "bucket_timings": {
                        str(k): dict(v)
                        for k, v in sorted(
                            self.fused_bucket_timings.items())
                    },
                    "cache": {"hits": 0, "misses": 0, "stale": 0},
                    "batches_fused": self.batches_fused,
                    "rows_fused": self.rows_fused,
                },
                "latency_ms": {
                    k: _finite(v, 3)
                    for k, v in percentiles(lat_ms, (50.0, 95.0, 99.0)).items()
                },
                "batches": self.batches,
                "mean_batch_size": round(
                    sum(sizes) / len(sizes), 2) if sizes else 0.0,
                # observed batch-size spread: what the
                # autotune bucket proposer reads to shape bucket edges
                "batch_size_p50": _finite(
                    percentiles(sizes, (50.0,))["p50"], 1),
                "batch_size_p95": _finite(
                    percentiles(sizes, (95.0,))["p95"], 1),
                "batch_size_max": max(sizes) if sizes else 0,
                "batch_fill_histogram": fill_hist,
                "queue_depth": {
                    "max": max(depths) if depths else 0,
                    **{k: _finite(v, 1)
                       for k, v in percentiles(depths, (50.0, 99.0)).items()},
                },
            }

    def log_line(self) -> str:
        snap = self.snapshot()
        lat = snap["latency_ms"]
        kv = {
            "rows": snap["rows_scored"],
            "rows_per_s": snap["rows_per_s"],
            "p50_ms": lat["p50"],
            "p95_ms": lat["p95"],
            "p99_ms": lat["p99"],
            "shed": (snap["shed_deadline"] + snap["shed_queue_full"]
                     + snap["shed_quota"] + snap["shed_breaker"]),
            "fallback": snap["rows_fallback"],
            "breaker_opens": snap["breaker"]["opens"],
        }
        return LOG_PREFIX + " " + " ".join(f"{k}={v}" for k, v in kv.items())

    def export(self, path: str, extra: Optional[dict] = None) -> dict:
        """Write the snapshot (plus caller context, e.g. the model config
        served) as the JSON telemetry artifact; returns what was written."""
        snap = self.snapshot()
        if extra:
            snap.update(extra)
        write_json_artifact(path, snap)
        log.info(self.log_line())
        return snap
