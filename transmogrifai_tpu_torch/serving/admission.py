"""Admission control for the serving queue: bounded depth + deadlines.

The graceful-degradation half of the serving subsystem (reference frame:
the reference's serving story is MLeap local scoring behind the caller's
own RPC stack - local/.../OpWorkflowModelLocal.scala:30-120 - so
backpressure semantics live here, not in a Spark analog; the policy
follows TensorFlow Serving's batching-queue admission: bounded queue,
deadline-aware shedding at dequeue time).

* ``QueueFullError``      - raised at submit when the bounded queue is at
                            capacity (load shedding at the front door)
* ``DeadlineExceededError`` - delivered to a request whose deadline passed
                            while it sat in the queue (shed at dequeue,
                            never scored: scoring a dead request wastes
                            a batch slot someone live could use)
* ``AdmissionController`` - the bounded FIFO both ends share
* ``CircuitBreaker``      - batch-path health gate: K consecutive
                            compiled-path failures open it (requests
                            then shed fast with ``BreakerOpenError``
                            instead of silently degrading ALL traffic
                            to the slow row loop), a cooldown later a
                            single half-open probe rides the batch path
                            and its outcome closes or re-opens the
                            breaker

Host copy of ``transmogrifai_tpu/serving/admission.py``.
"""
from __future__ import annotations

import math
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Mapping, Optional


class QueueFullError(RuntimeError):
    """Serving queue at capacity - request rejected at submission."""


class TenantQuotaError(QueueFullError):
    """One tenant's share of the bounded queue is exhausted - ITS
    request is rejected while other tenants keep admitting (a single
    chatty tenant must not be able to convert the shared
    bounded queue into a private one and starve the rest of the
    fleet's traffic).  Subclasses QueueFullError so existing
    shed-at-the-front-door handling still catches it; callers that
    care about the distinction catch this first."""

    def __init__(self, tenant: str, held: int, limit: int) -> None:
        super().__init__(
            f"tenant {tenant!r} holds {held}/{limit} queue slots "
            f"(per-tenant quota)"
        )
        self.tenant = tenant
        self.held = held
        self.limit = limit


class DeadlineExceededError(TimeoutError):
    """Request deadline elapsed before a batch picked it up."""


class RequestTimeoutError(TimeoutError):
    """Caller-side wait timed out (the request may still complete)."""


class BreakerOpenError(RuntimeError):
    """The batch-path circuit breaker is open - request shed unscored."""


class CircuitBreaker:
    """Consecutive-failure circuit breaker for the compiled batch path.

    States: ``closed`` (healthy) -> ``open`` after ``failure_threshold``
    consecutive batch-path failures -> ``half_open`` once ``cooldown_s``
    elapses (exactly ONE probe batch is admitted) -> ``closed`` on probe
    success, back to ``open`` on probe failure.  Every transition lands
    in ``ServingTelemetry`` (when attached) so a degraded endpoint is an
    alarm, not a silent slow-down.  Thread-safe: the scheduler's batch
    loop and direct ``score_batch`` callers may race on it.
    """

    def __init__(self, failure_threshold: int = 5, cooldown_s: float = 5.0,
                 clock=time.monotonic, telemetry=None,
                 probe_timeout_s: Optional[float] = None) -> None:
        if failure_threshold < 1:
            raise ValueError("failure_threshold must be >= 1")
        if cooldown_s < 0:
            raise ValueError("cooldown_s must be >= 0")
        self.failure_threshold = int(failure_threshold)
        self.cooldown_s = float(cooldown_s)
        # a probe is presumed dead (owner crashed mid-score) only after
        # MUCH longer than the cooldown: a probe merely slower than
        # cooldown_s must keep its ownership, or slow-but-recovered
        # paths could never close the breaker (probe churn livelock)
        self.probe_timeout_s = (
            max(30.0, 10.0 * self.cooldown_s)
            if probe_timeout_s is None else float(probe_timeout_s)
        )
        self.clock = clock
        self.telemetry = telemetry
        self._lock = threading.Lock()
        self._state = "closed"
        self._consecutive_failures = 0
        self._opened_at: Optional[float] = None
        self._probe_in_flight = False
        self._probe_owner: Optional[int] = None  # thread ident of the probe
        self._probe_started_at: Optional[float] = None
        self.opens = 0
        self.closes = 0
        self.probes = 0

    @property
    def state(self) -> str:
        with self._lock:
            return self._state

    def _record(self, event: str) -> None:
        if self.telemetry is not None:
            self.telemetry.record_breaker_transition(event)

    def allow(self) -> bool:
        """True when a batch may ride the compiled path now.  In the
        open state this flips to half-open after the cooldown and admits
        one probe; further calls shed until the probe resolves.  The
        admitted caller's thread OWNS the probe: only its outcome can
        close or re-open (see record_success), and a probe whose owner
        never resolves (died mid-score) is re-granted after
        ``probe_timeout_s`` so the breaker cannot wedge half-open."""
        event = None
        with self._lock:
            if self._state == "closed":
                return True
            if self._state == "open":
                if (self._opened_at is not None
                        and self.clock() - self._opened_at >= self.cooldown_s):
                    event = self._grant_probe()
                else:
                    return False
            elif self._state == "half_open":
                stuck = (
                    self._probe_started_at is not None
                    and self.clock() - self._probe_started_at
                    >= self.probe_timeout_s
                )
                if self._probe_in_flight and not stuck:
                    return False
                event = self._grant_probe()
        self._record(event)
        return True

    def _grant_probe(self) -> str:
        """Lock held: move to half_open with the calling thread as the
        probe owner."""
        self._state = "half_open"
        self._probe_in_flight = True
        self._probe_owner = threading.get_ident()
        self._probe_started_at = self.clock()
        self.probes += 1
        return "probe"

    def _is_probe_owner(self) -> bool:
        """Lock held: is the calling thread the one the probe was
        granted to?  Anything else finishing during open/half_open is a
        batch admitted BEFORE the trip - stale evidence that must
        neither close nor re-open the breaker."""
        return (self._probe_in_flight
                and self._probe_owner == threading.get_ident())

    def record_success(self) -> None:
        event = None
        with self._lock:
            if self._state == "closed":
                self._consecutive_failures = 0
            elif self._state == "half_open" and self._is_probe_owner():
                self._state = "closed"
                self._consecutive_failures = 0
                self._probe_in_flight = False
                self._probe_owner = None
                self._probe_started_at = None
                self._opened_at = None
                self.closes += 1
                event = "close"
            # open, or half_open from a non-probe thread: stale success -
            # only the probe's outcome may close, otherwise mixed-latency
            # traffic makes the breaker flap instead of shedding fast
        if event:
            self._record(event)

    def record_failure(self) -> None:
        event = None
        with self._lock:
            if self._state == "half_open":
                if self._is_probe_owner():
                    self._consecutive_failures += 1
                    self._state = "open"
                    self._probe_in_flight = False
                    self._probe_owner = None
                    self._probe_started_at = None
                    self._opened_at = self.clock()
                    self.opens += 1
                    event = "open"
                # non-probe failure in half_open: stale, ignore
            elif self._state == "closed":
                self._consecutive_failures += 1
                if self._consecutive_failures >= self.failure_threshold:
                    self._state = "open"
                    self._opened_at = self.clock()
                    self.opens += 1
                    event = "open"
            else:  # open: count for observability, no transition
                self._consecutive_failures += 1
        if event:
            self._record(event)

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "state": self._state,
                "consecutive_failures": self._consecutive_failures,
                "opens": self.opens,
                "closes": self.closes,
                "probes": self.probes,
            }


@dataclass
class _Request:
    """One queued score request; the scheduler resolves it like a future."""

    record: Mapping[str, Any]
    enqueued_at: float
    deadline: Optional[float] = None  # absolute monotonic time, or None
    #: tenant attribution for per-tenant quota accounting (None = the
    #: anonymous shared pool); released back at take()/drain() time
    tenant: Optional[str] = None
    done: threading.Event = field(default_factory=threading.Event)
    result: Any = None
    error: Optional[BaseException] = None
    #: set when the caller stopped waiting (its wait timed out): the row
    #: still scores, but telemetry must not double-count it as delivered.
    #: Guarded by _state_lock so abandon vs resolve is a strict
    #: either/or - without it the batch loop could read abandoned=False
    #: and record 'ok' in the same instant the caller records 'timeout'.
    abandoned: bool = False
    _state_lock: threading.Lock = field(default_factory=threading.Lock)

    def resolve(self, result: Any = None,
                error: Optional[BaseException] = None) -> None:
        self.result = result
        self.error = error
        self.done.set()

    def try_abandon(self) -> bool:
        """Mark abandoned unless already resolved; True when this caller
        owns the abandonment (and so the 'timeout' telemetry record)."""
        with self._state_lock:
            if self.done.is_set():
                return False
            self.abandoned = True
            return True

    def resolve_delivered(self, result: Any = None,
                          error: Optional[BaseException] = None) -> bool:
        """Resolve; True when the request was NOT abandoned (the resolver
        owns the delivered/failed telemetry record)."""
        with self._state_lock:
            self.resolve(result=result, error=error)
            return not self.abandoned

    def wait(self, timeout: Optional[float] = None) -> Any:
        if not self.done.wait(timeout):
            raise RequestTimeoutError(
                f"request not completed within {timeout}s"
            )
        if self.error is not None:
            raise self.error
        return self.result


class AdmissionController:
    """Bounded FIFO with deadline-aware dequeue.

    ``admit`` is the producer side (request threads); ``take`` the consumer
    side (the scheduler's batch loop).  Expired requests are resolved with
    DeadlineExceededError at take() time and never reach the endpoint.

    ``tenant_quota`` bounds any single tenant's share of the
    queue: a tenant may hold at most ``ceil(tenant_quota * max_queue)``
    queued slots, beyond which ITS submissions raise
    :class:`TenantQuotaError` while other tenants keep admitting.
    Requests with no tenant share one anonymous pool under the same
    rule.  ``None`` (the default) disables quota accounting entirely -
    the single-tenant hot path pays nothing.
    """

    def __init__(self, max_queue: int = 1024,
                 clock=time.monotonic,
                 tenant_quota: Optional[float] = None) -> None:
        if max_queue < 1:
            raise ValueError("max_queue must be >= 1")
        if tenant_quota is not None and not (0.0 < tenant_quota <= 1.0):
            raise ValueError("tenant_quota must be in (0, 1]")
        self.max_queue = int(max_queue)
        self.tenant_quota = tenant_quota
        self.tenant_limit = (
            None if tenant_quota is None
            else max(1, math.ceil(tenant_quota * self.max_queue))
        )
        self.clock = clock
        self._lock = threading.Lock()
        self.not_empty = threading.Condition(self._lock)
        self._queue: deque[_Request] = deque()
        self._tenant_held: dict[Optional[str], int] = {}
        self._closed = False

    def __len__(self) -> int:
        with self._lock:
            return len(self._queue)

    def admit(self, record: Mapping[str, Any],
              deadline_s: Optional[float] = None,
              tenant: Optional[str] = None) -> _Request:
        """Enqueue or raise QueueFullError (TenantQuotaError when the
        per-tenant share is the bound that tripped).  ``deadline_s`` is
        relative to now; the request is shed (not scored) if still
        queued past it."""
        now = self.clock()
        req = _Request(
            record=record, enqueued_at=now,
            deadline=None if deadline_s is None else now + deadline_s,
            tenant=tenant,
        )
        with self.not_empty:
            if self._closed:
                # checked under the SAME lock close() drains with, so a
                # request can never slip in after the final drain and
                # strand its caller
                raise RuntimeError("scheduler closed")
            if len(self._queue) >= self.max_queue:
                raise QueueFullError(
                    f"serving queue full ({self.max_queue} pending)"
                )
            if self.tenant_limit is not None:
                held = self._tenant_held.get(tenant, 0)
                if held >= self.tenant_limit:
                    raise TenantQuotaError(
                        str(tenant), held, self.tenant_limit)
                self._tenant_held[tenant] = held + 1
            self._queue.append(req)
            self.not_empty.notify()
        return req

    def _release_tenant(self, req: _Request) -> None:
        """Lock held: give the request's queue slot back to its
        tenant's quota (dequeue time - quotas bound QUEUED work, the
        in-flight share belongs to the consumer's own bounds)."""
        if self.tenant_limit is None:
            return
        held = self._tenant_held.get(req.tenant, 0)
        if held <= 1:
            self._tenant_held.pop(req.tenant, None)
        else:
            self._tenant_held[req.tenant] = held - 1

    def take(self, max_n: int) -> tuple[list[_Request], list[_Request]]:
        """Dequeue up to ``max_n`` live requests -> (live, shed).  Shed
        requests are already resolved with DeadlineExceededError."""
        now = self.clock()
        live: list[_Request] = []
        shed: list[_Request] = []
        with self._lock:
            while self._queue and len(live) < max_n:
                req = self._queue.popleft()
                self._release_tenant(req)
                if req.deadline is not None and now > req.deadline:
                    shed.append(req)
                else:
                    live.append(req)
        for req in shed:
            req.resolve_delivered(error=DeadlineExceededError(
                f"deadline exceeded after "
                f"{(now - req.enqueued_at) * 1e3:.1f} ms in queue"
            ))
        return live, shed

    def wait_for_fill(self, n: int, timeout: Optional[float] = None) -> int:
        """Block until >= n requests are queued or ``timeout`` elapses;
        returns the queue depth seen (the scheduler's linger-for-fill)."""
        with self.not_empty:
            self.not_empty.wait_for(
                lambda: len(self._queue) >= n, timeout
            )
            return len(self._queue)

    def wait_nonempty(self, timeout: Optional[float] = None) -> bool:
        with self.not_empty:
            if self._queue:
                return True
            return bool(self.not_empty.wait_for(
                lambda: bool(self._queue), timeout
            ))

    def close(self) -> None:
        """Refuse all future admissions (shutdown path; see drain)."""
        with self._lock:
            self._closed = True

    def drain(self) -> list[_Request]:
        """Remove and return everything pending (shutdown path)."""
        with self._lock:
            out, self._queue = list(self._queue), deque()
            self._tenant_held.clear()
        return out

    def tenants_held(self) -> dict:
        """Per-tenant queued-slot counts (observability; the quota
        evidence)."""
        with self._lock:
            return dict(self._tenant_held)
