"""Micro-batching scheduler: concurrent requests -> shape-bucketed batches.

The serving-side batching pattern (PAPERS.md: tf.data's pipelined batch
path decoupled from per-request dispatch, and TensorFlow Serving's
BatchingSession accumulating small requests into device-efficient
shapes): requests from any number of caller threads accumulate in the
admission queue; ONE batch loop forms batches under two knobs -

* ``max_batch_size``  - never score more rows per dispatch than this
                        (defaults to the endpoint's largest shape bucket);
* ``max_wait_us``     - a batch launches as soon as it is full OR the
                        oldest queued request has waited this long, so
                        tail latency is bounded at low traffic while
                        throughput batches up under load.

Batches score through the CompiledEndpoint's bucketed flat-heap path,
admission control (bounded queue, deadline shedding) lives in
admission.py, and every outcome lands in ServingTelemetry.

``start=False`` runs no worker thread: tests drive ``run_once`` for
deterministic batch-formation/shedding assertions.

Host copy of ``transmogrifai_tpu/serving/scheduler.py``; the batcher
thread scores on the endpoint's device.  A device fault (``kernels.
is_device_fault``: a kernel that does not build or launch, a CUDA error)
is not isolated per request: every request of the failed batch receives
that error itself, the batch loop stops, the queued requests receive it
too, and later submits raise it.
"""
from __future__ import annotations

import logging
import threading
import time
from collections import deque
from typing import Any, Iterable, Mapping, Optional

from ..parallel.kernels import is_device_fault
from .admission import (
    AdmissionController,
    BreakerOpenError,
    QueueFullError,
    RequestTimeoutError,
    TenantQuotaError,
    _Request,
)
from ..schema.contract import SchemaDriftError
from .endpoint import CompiledEndpoint, RowScoringError
from .telemetry import ServingTelemetry

log = logging.getLogger("transmogrifai_tpu_torch.serving")


class MicroBatchScheduler:
    """Batch loop + admission control over a CompiledEndpoint."""

    def __init__(
        self,
        endpoint: CompiledEndpoint,
        max_batch_size: Optional[int] = None,
        max_wait_us: int = 2000,
        max_queue: int = 1024,
        default_deadline_ms: Optional[float] = None,
        telemetry: Optional[ServingTelemetry] = None,
        clock=time.monotonic,
        start: bool = True,
        tenant_quota: Optional[float] = None,
    ) -> None:
        self.endpoint = endpoint
        self.max_batch_size = int(
            max_batch_size
            if max_batch_size is not None
            else endpoint.batch_buckets[-1]
        )
        if self.max_batch_size < 1:
            raise ValueError("max_batch_size must be >= 1")
        self.max_wait_s = max(int(max_wait_us), 0) / 1e6
        self.default_deadline_ms = default_deadline_ms
        self.telemetry = (
            telemetry if telemetry is not None else endpoint.telemetry
        )
        self.clock = clock
        self.admission = AdmissionController(max_queue=max_queue, clock=clock,
                                             tenant_quota=tenant_quota)
        self._closed = False
        #: the device fault that stopped the batch loop, if one did
        self.device_fault: Optional[BaseException] = None
        self._worker: Optional[threading.Thread] = None
        if start:
            self._worker = threading.Thread(
                target=self._worker_loop, name="tx-serving-batcher",
                daemon=True,
            )
            self._worker.start()

    # -- knob seam ----------------------------------------------------------
    def knobs(self) -> dict:
        """The scheduler's live micro-batch knobs (the tuner's A/B probe
        surface and the values the serving artifact reports)."""
        return {
            "max_batch_size": int(self.max_batch_size),
            "max_wait_us": int(round(self.max_wait_s * 1e6)),
        }

    def retune(self, max_batch_size: Optional[int] = None,
               max_wait_us: Optional[int] = None,
               source: str = "autotune") -> dict:
        """Apply tuner-chosen micro-batch knobs to the LIVE scheduler.
        Attribute writes are atomic and the batch loop reads them fresh
        each ``run_once``, so no lock or restart is needed; the new values
        land in telemetry as the tuned-knob record.  Returns the applied
        knob dict."""
        if max_batch_size is not None:
            if int(max_batch_size) < 1:
                raise ValueError("max_batch_size must be >= 1")
            self.max_batch_size = int(max_batch_size)
        if max_wait_us is not None:
            self.max_wait_s = max(int(max_wait_us), 0) / 1e6
        applied = self.knobs()
        self.telemetry.set_tuned_knobs(applied, source=source)
        return applied

    # -- request side -------------------------------------------------------
    def submit(self, record: Mapping[str, Any],
               deadline_ms: Optional[float] = None,
               tenant: Optional[str] = None,
               _count_shed: bool = True) -> _Request:
        """Enqueue one score request; returns a future-like handle
        (``.wait(timeout)``).  Raises QueueFullError when the bounded
        queue sheds at the front door (TenantQuotaError - counted as
        ``shed_quota`` - when ``tenant``'s own share is what tripped).
        ``_count_shed=False`` lets the backpressuring stream retry
        without inflating the shed counter for rows that are ultimately
        admitted."""
        if self.device_fault is not None:
            raise self.device_fault
        if self._closed:
            raise RuntimeError("scheduler is closed")
        if deadline_ms is None:
            deadline_ms = self.default_deadline_ms
        try:
            return self.admission.admit(
                record,
                None if deadline_ms is None else deadline_ms / 1e3,
                tenant=tenant,
            )
        except TenantQuotaError:
            # a quota trip is ALWAYS counted (even on the stream's
            # retry path): the whole-queue-full retry is expected to
            # eventually admit, but a tenant at its own cap retrying is
            # exactly the starvation signal the counter exists for
            self.telemetry.record_request(0.0, "shed_quota")
            raise
        except QueueFullError:
            if _count_shed:
                self.telemetry.record_request(0.0, "shed_queue_full")
            raise

    def score(self, record: Mapping[str, Any],
              timeout_s: Optional[float] = 30.0,
              deadline_ms: Optional[float] = None,
              tenant: Optional[str] = None) -> Any:
        """Synchronous request/response call through the batcher."""
        req = self.submit(record, deadline_ms=deadline_ms, tenant=tenant)
        try:
            return req.wait(timeout_s)
        except RequestTimeoutError:
            # claim abandonment atomically: the batch loop may still
            # score the row, but exactly ONE of {timeout, ok/failed}
            # lands in telemetry - if the worker resolved in the same
            # instant, the response IS here, so deliver it instead
            if not req.try_abandon():
                if req.error is not None:
                    raise req.error from None
                return req.result
            self.telemetry.record_request(
                self.clock() - req.enqueued_at, "timeout"
            )
            raise

    def score_stream(self, records: Iterable[Mapping[str, Any]],
                     window: int = 256,
                     timeout_s: float = 60.0) -> Iterable[Any]:
        """Pipeline an iterable through the batcher with bounded
        in-flight requests; yields results in submission order (failed
        or shed rows yield RowScoringError, the stream never dies on one
        row).  A full queue applies BACKPRESSURE - the stream waits for
        its own oldest request instead of erroring - so ``window`` may
        exceed the admission bound safely."""
        window = max(1, min(int(window), self.admission.max_queue))
        pending: deque = deque()

        def _resolve(req) -> Any:
            try:
                return req.wait(timeout_s)
            except Exception as e:  # noqa: BLE001 - per-row isolation
                if is_device_fault(e):
                    raise
                return RowScoringError(f"{type(e).__name__}: {e}")

        for r in records:
            while True:
                try:
                    pending.append(self.submit(r, _count_shed=False))
                    break
                except QueueFullError as e:
                    if pending:
                        # drain our oldest in-flight request; its batch
                        # completing frees queue space.  Not a shed: the
                        # row is retried and (normally) admitted
                        yield _resolve(pending.popleft())
                    else:
                        # the queue is full of OTHER callers' requests -
                        # shed this row for real, keep the stream alive
                        self.telemetry.record_request(
                            0.0, "shed_queue_full"
                        )
                        yield RowScoringError(f"{type(e).__name__}: {e}")
                        break
            if len(pending) >= window:
                yield _resolve(pending.popleft())
        while pending:
            yield _resolve(pending.popleft())

    # -- batch loop ---------------------------------------------------------
    def run_once(self, wait_timeout_s: float = 0.0) -> int:
        """Form and score ONE batch; returns rows scored (0 when idle).
        The worker loop calls this forever; tests call it directly for
        deterministic scheduling assertions."""
        if not self.admission.wait_nonempty(wait_timeout_s):
            return 0
        # linger for fill: launch as soon as full, else when the oldest
        # waiter has been queued max_wait_s
        if self.max_wait_s > 0:
            self.admission.wait_for_fill(self.max_batch_size, self.max_wait_s)
        self.telemetry.record_queue_depth(len(self.admission))
        live, shed = self.admission.take(self.max_batch_size)
        now = self.clock()
        for req in shed:
            # take() resolved these under the request state lock, so the
            # abandoned flag is final here: an abandoned request already
            # counted as 'timeout'
            if not req.abandoned:
                self.telemetry.record_request(now - req.enqueued_at,
                                              "shed_deadline")
        if not live:
            return 0
        try:
            results = self.endpoint.score_batch([r.record for r in live])
        except Exception as e:  # noqa: BLE001 - endpoint guards, belt+braces
            if is_device_fault(e):
                # the caller of every request in the batch receives the
                # device error itself, never a per-row marker
                done = self.clock()
                for req in live:
                    if req.resolve_delivered(error=e):
                        self.telemetry.record_request(
                            done - req.enqueued_at, "failed")
                raise
            results = [RowScoringError(f"{type(e).__name__}: {e}")] * len(live)
        done = self.clock()
        for req, res in zip(live, results):
            # resolve_delivered is atomic vs try_abandon: an abandoned
            # request (caller's wait timed out, counted 'timeout') must
            # not ALSO count as delivered 'ok'/'failed'
            if isinstance(res, RowScoringError):
                if res.shed:
                    # shed rows were refused unscored - a distinct
                    # outcome from a scoring failure, so the degradation
                    # is visible in telemetry, not blended into
                    # rows_failed; shed_reason picks the error class
                    # (breaker open vs schema-contract violation)
                    if getattr(res, "shed_reason", "breaker") == "schema":
                        err: Exception = SchemaDriftError(res.error)
                        outcome = "shed_schema"
                    else:
                        err = BreakerOpenError(res.error)
                        outcome = "shed_breaker"
                    if req.resolve_delivered(error=err):
                        self.telemetry.record_request(
                            done - req.enqueued_at, outcome)
                elif req.resolve_delivered(error=RuntimeError(res.error)):
                    self.telemetry.record_request(done - req.enqueued_at,
                                                  "failed")
            else:
                if req.resolve_delivered(result=res):
                    self.telemetry.record_request(done - req.enqueued_at,
                                                  "ok")
        return len(live)

    def _worker_loop(self) -> None:
        while not self._closed:
            try:
                self.run_once(wait_timeout_s=0.05)
            except Exception as e:  # noqa: BLE001 - the loop must survive
                if is_device_fault(e):
                    # the card failed: stop the loop, and every queued
                    # caller (and every later submit) receives the error
                    log.error("serving batch loop stopped by a device "
                              "fault: %s: %s", type(e).__name__, e)
                    self.device_fault = e
                    self._closed = True
                    self.admission.close()
                    for req in self.admission.drain():
                        req.resolve(error=e)
                    raise
                # individual-batch failures already resolve per-request;
                # anything reaching here is a scheduler bug - keep serving
                log.exception("serving batch loop error")

    def close(self, timeout_s: float = 5.0) -> None:
        """Stop the worker and fail any still-pending requests loudly.
        Admission closes FIRST (under the queue lock), so no request can
        slip in after the final drain and strand its caller."""
        self._closed = True
        self.admission.close()
        if self._worker is not None:
            self._worker.join(timeout_s)
        for req in self.admission.drain():
            req.resolve(error=RuntimeError("scheduler closed"))

    def __enter__(self) -> "MicroBatchScheduler":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
