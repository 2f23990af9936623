"""Compiled, batch-first scoring endpoint over a fitted OpWorkflowModel.

The serving analog of the reference's MLeap-compiled local model
(reference: local/.../OpWorkflowModelLocal.scala:30-120 compiles a fitted
pipeline once into a reusable score function) built batch-FIRST: the
single-row contract the reference exposes is the degenerate case here,
not the design center.

* the scoring DAG resolves ONCE at construction (the LocalScorer's
  precompiled plan: on a CUDA model the torch device program of
  ``local/fused_torch.py``, on a CPU model the numpy-fused program);
* requests score through fixed shape BUCKETS (pad to the next bucket, so
  repeated batch shapes reuse every shape-keyed cache: one-hot code
  memos, fitted-metadata memos and the device program's per-bucket
  first-call state);
* on the card every tree head of every batch launches kernel K2
  (``parallel/kernels.bin_matrix``) once, then walks the flat heaps in
  torch, never a per-row or per-tree loop;
* construction warm-up primes each bucket ahead of traffic (on a CUDA
  model: one device-program call per bucket on the card), so the first
  real request never pays cold-path latency;
* a batch that fails the compiled path degrades gracefully: rows re-score
  individually through the row fallback, bad rows surface as
  ``RowScoringError`` results instead of poisoning their batch peers;
* a circuit breaker (admission.CircuitBreaker) watches batch-path
  health: K consecutive compiled-path failures open it, after which
  requests shed FAST (``BreakerOpenError``) instead of silently running
  every row through the slow fallback loop, until a half-open probe
  batch proves the path healthy again;
* a NaN/Inf output guard refuses non-finite scores (a poisoned model
  or kernel must fail loudly, not serve garbage) - guarded rows count
  as batch-path failures toward the breaker.

Fault-injection points (faults/injection.py): ``serving.batch`` (raise
inside the compiled path), ``serving.nan_scores`` (poison outputs),
``serving.slow_batch`` (sleep) - the drills prove the breaker, the
guard, and the fallback end to end.

Device faults are not degraded: a :class:`~..parallel.kernels.
KernelError` (a kernel that does not build or launch) or a
``torch.AcceleratorError`` raised by the scorer escapes warm-up, the
batch path and the row fallback unchanged (``kernels.is_device_fault``),
where any other error serves cold, re-scores row by row or marks its
row.  Port of ``transmogrifai_tpu/serving/endpoint.py``.
"""
from __future__ import annotations

import logging
import math
import threading
import time
from dataclasses import dataclass
from typing import Any, Mapping, Optional, Sequence

from ..faults import injection as _faults
from ..local.scorer import LocalScorer
from ..obs import trace as _obs_trace
from ..parallel.kernels import is_device_fault
from ..schema.contract import (
    SchemaDriftError,
    apply_drift_policy,
    collect_violations,
)
from ..schema.drift import DriftMonitor
from .admission import CircuitBreaker
from .telemetry import ServingTelemetry

log = logging.getLogger("transmogrifai_tpu_torch.serving")

DEFAULT_BUCKETS = (1, 8, 32, 128)

DRIFT_POLICIES = ("raise", "warn", "shed")


@dataclass
class RowScoringError:
    """Per-row failure marker returned in a batch's result list (the
    scheduler converts it into the request's exception; direct batch
    callers can filter).  ``shed`` marks rows refused unscored, with
    ``shed_reason`` naming why: ``"breaker"`` (circuit open — scheduler
    accounting shed_breaker) or ``"schema"`` (contract violation under
    drift_policy='shed' — accounting shed_schema)."""

    error: str
    shed: bool = False
    shed_reason: str = "breaker"


class CompiledEndpoint:
    """Batch-first compiled scorer with shape buckets + row fallback."""

    def __init__(
        self,
        model,
        batch_buckets: Sequence[int] = DEFAULT_BUCKETS,
        warm: bool = True,
        warm_record: Optional[Mapping[str, Any]] = None,
        telemetry: Optional[ServingTelemetry] = None,
        breaker: Optional[CircuitBreaker] = None,
        breaker_threshold: int = 5,
        breaker_cooldown_s: float = 5.0,
        guard_nonfinite: bool = True,
        contract=None,
        drift_policy: str = "warn",
        drift_scores: bool = True,
        fused: bool = True,
        fused_backend: Optional[str] = None,
    ) -> None:
        if not batch_buckets or any(int(b) < 1 for b in batch_buckets):
            raise ValueError("batch_buckets must be positive sizes")
        if fused_backend == "xla":
            raise ValueError(
                "fused_backend 'xla' is the JAX package's compiled program; "
                "this package serves through 'torch' (local/fused_torch.py, "
                "the card) or 'numpy'"
            )
        if drift_policy not in DRIFT_POLICIES:
            raise ValueError(
                f"drift_policy must be one of {DRIFT_POLICIES}, got "
                f"{drift_policy!r}"
            )
        self.batch_buckets = tuple(sorted({int(b) for b in batch_buckets}))
        self.breaker = breaker if breaker is not None else CircuitBreaker(
            failure_threshold=breaker_threshold,
            cooldown_s=breaker_cooldown_s,
        )
        self.telemetry = telemetry if telemetry is not None else ServingTelemetry()
        self.guard_nonfinite = bool(guard_nonfinite)
        # schema/distribution drift guards: the contract the model
        # trained under (loaded from the artifact's schema.json) is
        # enforced per batch; the inner scorer's own validation is OFF -
        # the endpoint owns it, validating twice would be pure overhead
        self.contract = (
            contract if contract is not None
            else getattr(model, "schema_contract", None)
        )
        self.drift_policy = drift_policy
        self._warned_violations: set = set()
        self._drift_monitor: Optional[DriftMonitor] = None
        self._drift_pending: list = []
        self._drift_lock = threading.Lock()
        if (drift_scores and self.contract is not None
                and self.contract.distributions):
            self._drift_monitor = DriftMonitor(self.contract)
        self._scorer = LocalScorer(model, drift_policy=None, fused=fused,
                                   fused_backend=fused_backend)
        # the pad row: scored to fill a bucket, sliced off before return.
        # All-None raw features ride the same missing-value handling every
        # stage already implements; a caller-provided warm_record is used
        # instead when the pipeline requires non-null rows.
        self._pad_record: Mapping[str, Any] = dict(
            warm_record
            if warm_record is not None
            else {f.name: None for f in self._scorer.raw_features}
        )
        self.shape_misses = 0
        self.warmed_buckets: tuple[int, ...] = ()
        self.warm_error: Optional[str] = None
        self._push_knob_status()
        if warm:
            self.warm_up()
        self._push_fused_status()

    def _push_knob_status(self) -> None:
        """Record bucket-knob provenance into whatever
        telemetry accumulator is currently attached, so tuned-vs-
        hand-set stays visible across accumulator swaps."""
        bb = getattr(self, "batch_buckets", None)
        if not bb:  # telemetry attached before construction finished
            return
        self._telemetry.set_tuned_knobs(
            {
                "batch_bucket_top": bb[-1],
                "batch_bucket_count": len(bb),
                "batch_buckets": ",".join(str(b) for b in bb),
            },
            source="hand_set",
        )

    @property
    def telemetry(self) -> ServingTelemetry:
        return self._telemetry

    @telemetry.setter
    def telemetry(self, value: ServingTelemetry) -> None:
        # breaker transitions must land wherever request telemetry lands,
        # including after a caller swaps the accumulator
        self._telemetry = value
        self.breaker.telemetry = value
        self._push_fused_status()
        self._push_knob_status()

    # -- fused-path status --------------------------------------------------
    @property
    def fused(self) -> bool:
        """True when batches score through the whole-pipeline fused
        program (local/fused.py) rather than the interpreted DAG walk."""
        return self._scorer.fused is not None

    @property
    def fused_reason(self) -> Optional[str]:
        return self._scorer.fused_reason

    @property
    def fused_backend(self) -> Optional[str]:
        """'torch' | 'numpy' | None: which fused program serves batches
        (None = interpreted DAG walk)."""
        return self._scorer.fused_backend

    def _push_fused_status(self) -> None:
        """Mirror the scorer's fused status + per-bucket compile times
        (and, on the torch backend, the per-bucket compile/first-exec
        split) into whatever telemetry accumulator is currently attached
        (the choice and its cost must ride every serving artifact).  The
        torch program has no executable cache, so no cache events."""
        scorer = getattr(self, "_scorer", None)
        if scorer is None:  # telemetry attached before construction done
            return
        fp = scorer.fused
        self._fused_buckets_pushed = (
            len(fp.compile_ms) if fp is not None else 0
        )
        self._telemetry.set_fused_status(
            fp is not None,
            scorer.fused_reason,
            dict(fp.compile_ms) if fp is not None else None,
            backend=scorer.fused_backend,
            bucket_timings=(
                {k: dict(v) for k, v in fp.bucket_stats.items()}
                if fp is not None and getattr(fp, "bucket_stats", None)
                else None
            ),
        )

    # -- warm-up ------------------------------------------------------------
    def warm_up(self) -> tuple[int, ...]:
        """Score one pad-batch per bucket ahead of traffic: primes the
        one-hot/metadata memos and the device program's first call for
        EXACTLY the shapes the bucketed hot path will submit.  Best-effort:
        a pipeline that cannot score the pad record serves cold
        (warm_error records why); a device fault raises."""
        warmed = []
        try:
            for b in self.batch_buckets:
                self._scorer.score_batch([self._pad_record] * b)
                warmed.append(b)
        except Exception as e:  # noqa: BLE001 - warm-up must never kill serving
            if is_device_fault(e):
                raise
            self.warm_error = f"{type(e).__name__}: {e}"
            log.warning("endpoint warm-up failed (serving cold, exact "
                        "batch shapes): %s", self.warm_error)
        self.warmed_buckets = tuple(warmed)
        return self.warmed_buckets

    # -- scoring ------------------------------------------------------------
    def bucket_for(self, n: int) -> int:
        """Smallest bucket >= n (callers chunk at the largest bucket)."""
        for b in self.batch_buckets:
            if n <= b:
                return b
        return self.batch_buckets[-1]

    def score_batch(self, records: Sequence[Mapping[str, Any]]) -> list:
        """Score a batch through the bucketed compiled path; element i of
        the result aligns with records[i] (RowScoringError on failure).
        An empty batch (all rows quarantined upstream) is a counted
        no-op, never an exception - pinned to LocalScorer's behavior."""
        if not records:
            self.telemetry.record_empty_batch()
            return []
        shed = self._enforce_contract(records)
        if shed is not None:
            return shed
        out: list = []
        step = self.batch_buckets[-1]
        for lo in range(0, len(records), step):
            chunk = records[lo:lo + step]
            # one span per bucketed chunk (obs/): bucket + fused status
            # tagged so a slow batch in the trace names its shape and
            # whether it rode the fused program or the interpreted walk
            with _obs_trace.span(
                "serve.batch", n=len(chunk),
                bucket=self.bucket_for(len(chunk)), fused=self.fused,
                fused_reason=self.fused_reason,
            ):
                out.extend(self._score_bucketed(chunk))
        self._observe_drift(records)
        return out

    # -- schema/distribution drift guards -----------------------------------
    def _enforce_contract(
        self, records: Sequence[Mapping[str, Any]]
    ) -> Optional[list]:
        """Validate a batch against the training contract and apply
        ``drift_policy``.  Returns None to proceed with scoring, or the
        full shed-marker result list (policy='shed').

        Enforcement is BATCH-granular by design (missing-column
        detection is a property of the batch's key union, and one
        validation per batch keeps the hot path O(1)-ish): under
        raise/shed, conformant requests micro-batched together with a
        violating one share its outcome for that batch.  Deployments
        mixing untrusted clients behind one scheduler should prefer
        ``drift_policy="warn"`` (violations counted + logged, rows
        still served) or segregate clients per endpoint."""
        extra = ()
        if _faults.fires("serving.schema_drift") is not None:
            extra = ({
                "kind": "injected",
                "feature": "<injected>",
                "detail": "serving.schema_drift fault armed",
            },)
        # the validate + policy dispatch is the ONE shared implementation
        # in schema/contract.py (the local scorer runs the same code, so
        # the two serve surfaces cannot diverge); only the telemetry +
        # shed-marker mechanics are endpoint-specific
        violations = collect_violations(self.contract, records, extra)
        if not violations:
            return None
        self.telemetry.record_schema_violations(
            violations, self.drift_policy
        )
        shed = apply_drift_policy(violations, self.drift_policy,
                                  self._warned_violations, log,
                                  "endpoint serving anyway")
        if not shed:
            return None
        # shed: refuse the batch unscored, loudly and cheaply - the
        # endpoint stays healthy for conformant traffic
        self.telemetry.record_schema_shed_rows(len(records))
        err = SchemaDriftError(violations)
        return [
            RowScoringError(str(err), shed=True, shed_reason="schema")
            for _ in records
        ]

    #: drift observation amortization: scored records buffer until this
    #: many rows, then fold into the running distributions in ONE
    #: vectorized pass - per-histogram python overhead on the batch-of-1
    #: hot path would otherwise cost ~2/3 of single-row throughput
    DRIFT_OBSERVE_MIN_ROWS = 64

    def _observe_drift(
        self, records: Sequence[Mapping[str, Any]]
    ) -> None:
        """Buffer the batch toward the running serve-side distributions;
        per-feature JS divergence lands in telemetry once per observe
        window.  Monitoring must never take scoring down."""
        if self._drift_monitor is None:
            return
        with self._drift_lock:
            self._drift_pending.extend(records)
            if len(self._drift_pending) < self.DRIFT_OBSERVE_MIN_ROWS:
                return
            pending, self._drift_pending = self._drift_pending, []
        try:
            self._drift_monitor.observe(pending)
            self.telemetry.record_drift_scores(
                self._drift_monitor.scores()
            )
        except Exception:  # noqa: BLE001 - monitoring only
            log.warning("drift monitoring failed for a batch",
                        exc_info=True)

    def drift_scores(self) -> dict[str, float]:
        """Current per-feature JS divergence vs the training
        distributions (empty when the model has no contract).  Flushes
        the observation buffer so the scores reflect every row scored
        so far."""
        if self._drift_monitor is None:
            return {}
        with self._drift_lock:
            pending, self._drift_pending = self._drift_pending, []
        if pending:
            try:
                self._drift_monitor.observe(pending)
            except Exception:  # noqa: BLE001 - monitoring only
                log.warning("drift flush failed", exc_info=True)
        scores = self._drift_monitor.scores()
        if scores:
            self.telemetry.record_drift_scores(scores)
        return scores

    def _score_bucketed(self, records: Sequence[Mapping[str, Any]]) -> list:
        n = len(records)
        if n == 0:
            return []
        if not self.breaker.allow():
            # open breaker: shed FAST with an explicit marker instead of
            # burning the slow row loop on every request while the batch
            # path is known-bad (meltdown protection + a loud signal)
            self.telemetry.record_breaker_shed_rows(n)
            return [
                RowScoringError(
                    "serving batch path unhealthy (circuit breaker open); "
                    "request shed",
                    shed=True,
                )
                for _ in range(n)
            ]
        bucket = self.bucket_for(n)
        if self.warm_error is not None:
            # the pad record itself cannot score through this pipeline
            # (warm-up told us): padding every partial batch with it
            # would silently degrade ALL serving to the per-row fallback.
            # Score the exact batch instead - no shape bucketing, but the
            # batch path stays hot.
            padded = list(records)
        else:
            padded = list(records) + [self._pad_record] * (bucket - n)
        t0 = time.perf_counter()
        # inside the timed window: injected slowness must be VISIBLE to
        # batch telemetry, or the drill proves nothing
        _faults.inject_sleep("serving.slow_batch")
        poisoned = False
        try:
            _faults.inject("serving.batch")
            results = self._scorer.score_batch(padded)[:n]
            if _faults.fires("serving.nan_scores"):
                poisoned = True
                _faults.poison_nonfinite(results)
        except Exception as e:  # noqa: BLE001 - degrade to the row path
            if is_device_fault(e):
                raise
            # shape miss / malformed row: the compiled batch path assumes
            # bucket-shaped well-formed batches; anything else re-scores
            # row by row so one bad request cannot fail its batch peers.
            # Deliberately NOT record_batch: these rows never rode the
            # batch path, and counting them would make batch_rows_per_s /
            # batch-fill read nominal while serving is fully degraded -
            # rows_fallback is the truth signal
            self.shape_misses += 1
            results = self._score_rows_fallback(records)
            self.telemetry.record_fallback_rows(n)
            # breaker accounting distinguishes WHY the batch path failed:
            # rows that ALSO fail individually are data-borne (a poison
            # record opens no breaker - it is already surfaced to its
            # caller), while a batch that re-scores 100% clean row-by-row
            # indicts the batch path itself - exactly the persistent
            # degradation the breaker exists to make loud.  Decided
            # BEFORE the output guard runs: guard-refused NaN rows are
            # model/kernel-borne, not caller-data-borne, and must still
            # count toward the breaker.  In half-open the probe must
            # resolve either way, so any failure re-opens.
            data_borne = any(isinstance(r, RowScoringError) for r in results)
            # guard the fallback path too: a NaN row must not slip out
            # just because a batch peer tripped the fallback
            if self.guard_nonfinite:
                bad = self._nonfinite_rows(results)
                if bad:
                    self.telemetry.record_nonfinite_rows(len(bad))
                    for i in bad:
                        results[i] = RowScoringError(
                            "non-finite score (NaN/Inf) refused by the "
                            "serving output guard"
                        )
            if not data_borne or self.breaker.state == "half_open":
                self.breaker.record_failure()
            return results
        bad = self._guard_rows(results, n, poisoned)
        if bad:
            # non-finite scores: a poisoned model/kernel must fail loudly
            # per-row (the fallback would recompute the same NaN), and it
            # counts as a batch-path failure toward the breaker
            self.breaker.record_failure()
            self.telemetry.record_nonfinite_rows(len(bad))
            for i in bad:
                results[i] = RowScoringError(
                    "non-finite score (NaN/Inf) refused by the serving "
                    "output guard"
                )
            return results
        self.breaker.record_success()
        fp = self._scorer.fused
        self.telemetry.record_batch(n, bucket, time.perf_counter() - t0,
                                    fused=fp is not None)
        if fp is not None and len(fp.compile_ms) != getattr(
                self, "_fused_buckets_pushed", 0):
            # a new shape bucket compiled mid-traffic: surface its cost
            self._push_fused_status()
        return results

    def _guard_rows(self, results: Sequence[Any], n: int,
                    poisoned: bool) -> list[int]:
        """NaN/Inf guard dispatch: the fused program already computed a
        columnar non-finite mask over its result arrays, so the guard is
        a slice instead of a python walk over every result dict.  A
        fault-injected poisoning mutates the dicts AFTER scoring, so that
        (test-only) path - and the interpreted path - re-walk the dicts."""
        if not self.guard_nonfinite:
            return []
        fp = self._scorer.fused
        if fp is not None and not poisoned:
            return [i for i in fp.last_nonfinite_rows if i < n]
        return self._nonfinite_rows(results)

    @staticmethod
    def _nonfinite_rows(results: Sequence[Any]) -> list[int]:
        """Indices of rows whose score dicts contain any NaN/Inf float."""

        def bad(v: Any) -> bool:
            if isinstance(v, float):
                return not math.isfinite(v)
            if isinstance(v, dict):
                return any(bad(x) for x in v.values())
            if isinstance(v, (list, tuple)):
                return any(bad(x) for x in v)
            return False

        return [i for i, row in enumerate(results)
                if isinstance(row, dict) and bad(row)]

    def _score_rows_fallback(self, records: Sequence[Mapping[str, Any]]) -> list:
        out: list = []
        for r in records:
            try:
                out.append(self._scorer(r))
            except Exception as e:  # noqa: BLE001 - isolate the bad row
                if is_device_fault(e):
                    raise
                out.append(RowScoringError(f"{type(e).__name__}: {e}"))
        return out

    def __call__(self, record: Mapping[str, Any]) -> Any:
        return self.score_batch([record])[0]

    @property
    def result_features(self):
        return self._scorer.result_features

    @property
    def raw_features(self):
        return self._scorer.raw_features


def compile_endpoint(model, **kw) -> CompiledEndpoint:
    """Compile a fitted OpWorkflowModel into a warmed batch-first endpoint
    (the serving counterpart of local.score_function)."""
    return CompiledEndpoint(model, **kw)


def records_from_dataset(ds, features) -> list[dict[str, Any]]:
    """Dataset -> per-row request dicts restricted to ``features`` (the
    one conversion the runner's serve and deploy runs share)."""
    cols = ds.to_pylists()
    names = [f.name for f in features if f.name in cols]
    n = len(cols[names[0]]) if names else 0
    return [{k: cols[k][i] for k in names} for i in range(n)]
