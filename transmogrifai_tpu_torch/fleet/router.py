"""Least-loaded front router over N replica serving workers.

The dispatch layer of the scale-out fleet (reference frame: the
TensorFlow system paper's many-workers-
behind-one-dispatch-layer scaling story, arXiv 1605.08695, with the
TpuGraphs learned-cost-signal idea, arXiv 2308.13490, supplying the
load estimate):

* **front door** - the :class:`AdmissionController` unchanged
  (bounded queue, deadline shed at dequeue) with
  per-tenant quotas layered on: one chatty tenant sheds with
  ``TenantQuotaError`` while the rest of the fleet's traffic admits.
* **least-loaded dispatch** - one dispatcher thread assigns each queued
  batch to the replica with the smallest *expected wait*:
  ``(in_flight_rows + batch_rows) * service_s_per_row``, where the
  per-replica service time blends a live EWMA over this router's own
  response walls with the replica's shipped obs shard
  (``batch_rows_per_s`` / p99 from its ServingTelemetry view, read via
  :meth:`FleetRouter.refresh_from_shards`) and - when the deployed
  artifact carries an ``autotune.json`` - the :class:`CostModel`
  (per-replica ``serve.batch/<instance>`` keys trained online from
  observed batch walls; its prediction replaces the cold-start default
  until live EWMAs exist).
* **at-least-once failover** - requests stay registered on their
  replica until the response arrives; a replica that dies (SIGKILL,
  channel EOF) or is ejected has every in-flight request re-dispatched
  to survivors from the SAME encoded payload (encode-once), so an
  accepted request is never lost - the fleet may score a row twice,
  the caller sees exactly one response (idempotent scoring).
* **health-gated membership** - each replica carries a
  :class:`ReplicaHealth` state machine with the breaker semantics
  lifted to the fleet tier: ``eject_after`` consecutive response
  timeouts/transport failures EJECT the replica (its in-flight work
  fails over, no new dispatches), a rate-bounded half-open PROBE (one
  control ping per ``probe_interval_s``, reconnecting the channel
  first when it died) readmits it on the first pong.  A partitioned
  TCP peer looks alive - the socket stays open while frames vanish -
  which is exactly why ejection is keyed on response timeouts, not on
  channel EOF.  Ejection/readmission are trace events
  (``fleet.ejection`` / ``fleet.readmission``) and the per-replica
  machine is its own ``fleet_health`` metrics view
  (``tx_fleet_health_*``).
* **deadline propagation** - a request's remaining budget rides the
  wire meta as an absolute wall-clock deadline (the gRPC convention;
  cross-host skew eats into slack, never adds budget), so a replica
  drops work the caller already abandoned - the tf.data
  bounded-staleness stance (arXiv 2101.12127) applied to serving.
* **quorum brownout** - when fewer than ``quorum`` replicas are
  healthy, new submissions from tenants below
  ``brownout_min_priority`` shed with :class:`BrownoutShedError` at
  the front door: planned degradation sheds the lowest-priority
  tenants first instead of queuing the whole fleet toward a stall.
* **backpressure, never hang** - per-replica in-flight is capped; when
  every replica is full the dispatcher waits in 50 ms quanta while the
  bounded admission queue sheds new submissions at the front door.
  Every blocking wait in this module is quantum-bounded
  (tests/test_torch_style.py holds fleet/ to the bounded-wait gate).
  No catch-all here degrades a device fault
  (``parallel.kernels.is_device_fault``): it is re-raised.

Fault points: ``fleet.router_stall`` (inject_sleep in the dispatch
loop) drills a wedged router without touching replica health; the
channel-seam points (``fleet.partition``, ``fleet.half_open``,
``channel.corrupt_frame``, ``fleet.reconnect_storm``) live in
channel.py and drill this module's detection/ejection/readmission
machinery end to end.
"""
from __future__ import annotations

import contextvars
import itertools
import logging
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Optional, Sequence

from ..faults import injection as _faults
from ..obs.metrics import metrics_registry
from ..obs.trace import tracer
from ..parallel.kernels import is_device_fault
from ..serving.admission import (
    AdmissionController,
    DeadlineExceededError,
    QueueFullError,
    RequestTimeoutError,
    TenantQuotaError,
    _Request,
)
from .multimodel import UnhostedModelError
from .channel import (
    HANDSHAKE_TIMEOUT_S,
    OP_CONTROL,
    OP_CONTROL_RESULT,
    OP_ERROR,
    OP_HELLO,
    OP_RESULT,
    OP_SCORE,
    QUANTUM_S,
    ChannelClosedError,
    ChannelProtocolError,
    ChannelTimeoutError,
    FleetChannel,
    connect,
    decode_results,
    parse_address,
)

log = logging.getLogger("transmogrifai_tpu_torch.fleet")

LOG_PREFIX = "op_fleet_metrics"


def _ctx_thread(target, name: str, *args) -> threading.Thread:
    """A daemon thread that runs ``target`` inside a COPY of the
    creating thread's contextvars - plain threads start with an empty
    context, which would root every ``fleet.ejection`` /
    ``fleet.readmission`` trace event in its own fresh trace id.
    Copying here keeps the whole fault envelope (detection in the
    receive loop, ejection in the health loop, readmission probes)
    under the one trace that created the router/handle."""
    ctx = contextvars.copy_context()
    return threading.Thread(target=lambda: ctx.run(target, *args),
                            name=name, daemon=True)

#: cold-start per-row service-time guess (10 us ~ a fused CPU replica at
#: 100k rows/s) used only until an observation or cost-model prediction
#: replaces it
_DEFAULT_SVC_S = 1e-5

#: EWMA smoothing for the per-replica observed service time
_SVC_ALPHA = 0.3

#: failover budget per request: a batch that has already killed (or
#: been orphaned by) this many replicas is POISON, not bad luck - it
#: fails loudly instead of cascading through every survivor and
#: burning the whole fleet's restart budget
MAX_FAILOVERS = 2

#: numeric encoding of ReplicaHealth.state for the gauge plane
HEALTH_CODES = {"healthy": 0, "probing": 1, "ejected": 2}


class FleetError(RuntimeError):
    """Fleet-level routing failure (no live replica to serve on)."""


class FleetWorkerError(RuntimeError):
    """A replica reported a scoring/control failure for one request."""


class FleetDecodeError(FleetWorkerError):
    """A replica's result payload failed to decode (counted as
    ``decode_errors`` in the fleet_router view and attributed to request
    id + replica instance, never an anonymous pickle traceback in the
    caller's lap)."""


class BrownoutShedError(QueueFullError):
    """Shed at the front door because the fleet is below quorum and the
    tenant is below the brownout priority floor (planned degradation:
    lowest-priority traffic goes first, the fleet never queues toward a
    stall)."""


class ModelQuotaError(QueueFullError):
    """Shed at the front door because one model's in-flight rows hit
    its configured quota (a chatty model's tenants shed while
    the other hosted models' traffic keeps admitting)."""


class ReplicaHealth:
    """Per-replica failure-detector state machine (circuit-breaker
    semantics at the fleet tier)::

        healthy --eject_after consecutive failures--> ejected
        ejected --rate-bounded probe sent-----------> probing
        probing --pong------------------------------> healthy
        probing --probe timeout/error---------------> ejected

    Channel death force-ejects regardless of the consecutive count
    (there is nothing to time out against a closed socket).  A
    response of ANY kind - including a worker error or a deadline
    drop - is evidence of transport life and resets the consecutive
    counter; only silence and channel failures count toward ejection.
    Mutations happen under the owning handle's lock.
    """

    __slots__ = (
        "eject_after", "state", "consecutive_failures", "last_rtt_ms",
        "last_error", "ejections", "readmissions", "probes_sent",
        "probes_failed", "ejected_at", "readmitted_at", "last_ok_at",
        "last_probe_at", "probe_rid", "probe_sent_at", "transitions",
    )

    def __init__(self, eject_after: int = 3) -> None:
        if eject_after < 1:
            raise ValueError("eject_after must be >= 1")
        self.eject_after = int(eject_after)
        self.state = "healthy"
        self.consecutive_failures = 0
        self.last_rtt_ms: Optional[float] = None
        self.last_error: Optional[str] = None
        self.ejections = 0
        self.readmissions = 0
        self.probes_sent = 0
        self.probes_failed = 0
        #: monotonic marks for latency accounting (latency reports read these)
        self.ejected_at: Optional[float] = None
        self.readmitted_at: Optional[float] = None
        self.last_ok_at: Optional[float] = None
        self.last_probe_at: Optional[float] = None
        self.probe_rid: Optional[int] = None
        self.probe_sent_at: Optional[float] = None
        #: bounded transition log [{"to", "reason", "t"}]
        self.transitions: list[dict] = []

    def _transition(self, state: str, reason: str) -> None:
        self.state = state
        self.transitions.append(
            {"to": state, "reason": reason, "t": time.time()})
        if len(self.transitions) > 64:
            del self.transitions[0]

    def record_success(self, rtt_ms: Optional[float],
                       now: float) -> None:
        self.last_ok_at = now
        if rtt_ms is not None:
            self.last_rtt_ms = rtt_ms
        if self.state == "healthy":
            self.consecutive_failures = 0
        # probing/ejected: only an explicit probe pong readmits - a
        # straggler response from before the partition is not health

    def record_failure(self, reason: str, now: float) -> bool:
        """Count one failure; True when it newly ejects the replica."""
        self.consecutive_failures += 1
        self.last_error = str(reason)
        if (self.state == "healthy"
                and self.consecutive_failures >= self.eject_after):
            self.force_eject(reason, now)
            return True
        return False

    def force_eject(self, reason: str, now: float) -> None:
        if self.state != "ejected":
            self._transition("ejected", str(reason))
            self.ejections += 1
            self.ejected_at = now
            self.probe_rid = None
        self.last_error = str(reason)

    def begin_probe(self, now: float) -> None:
        self.probes_sent += 1
        self.last_probe_at = now
        self.probe_sent_at = now
        self.probe_rid = None
        if self.state == "ejected":
            self._transition("probing", "probe sent")

    def probe_failed(self, reason: str, now: float) -> None:
        self.probes_failed += 1
        self.last_error = str(reason)
        self.probe_rid = None
        if self.state == "probing":
            self._transition("ejected", f"probe failed: {reason}")

    def readmit(self, now: float) -> bool:
        """Probe pong arrived; True when this newly readmits."""
        if self.state == "healthy":
            return False
        self._transition("healthy", "probe pong")
        self.readmissions += 1
        self.readmitted_at = now
        self.consecutive_failures = 0
        self.probe_rid = None
        self.last_ok_at = now
        return True

    def snapshot(self) -> dict:
        return {
            "state": self.state,
            "state_code": HEALTH_CODES.get(self.state, -1),
            "consecutive_failures": self.consecutive_failures,
            "ejections": self.ejections,
            "readmissions": self.readmissions,
            "probes_sent": self.probes_sent,
            "probes_failed": self.probes_failed,
            "last_rtt_ms": (None if self.last_rtt_ms is None
                            else round(self.last_rtt_ms, 3)),
            "last_error": self.last_error,
        }


@dataclass
class FleetBatch:
    """One queued unit of fleet work (rides ``_Request.record``): the
    encoded payload is retained until the response resolves so a
    failover re-sends the SAME bytes."""

    payload: bytes
    n_rows: int
    tenant: Optional[str] = None
    kind: str = "score"  # score | ctl | probe
    ctl: dict = field(default_factory=dict)
    retries: int = 0
    #: per-model dispatch: routed only to replicas hosting
    #: this model; None = the legacy single-model lane
    model_id: Optional[str] = None


class FleetResult:
    """A replica's response with the result payload still encoded -
    decoded lazily so counting/relaying responses never pays the
    object-graph cost.  A payload that fails to decode raises
    :class:`FleetDecodeError` naming the request id and replica, and
    counts on the owning router's ``decode_errors``."""

    __slots__ = ("meta", "payload", "_decoded", "_on_decode_error")

    def __init__(self, meta: dict, payload: bytes,
                 on_decode_error=None) -> None:
        self.meta = meta
        self.payload = payload
        self._decoded: Optional[list] = None
        self._on_decode_error = on_decode_error

    @property
    def n_rows(self) -> int:
        return int(self.meta.get("n_rows", 0))

    @property
    def version(self) -> Optional[str]:
        return self.meta.get("version")

    @property
    def generation(self) -> Optional[int]:
        return self.meta.get("generation")

    @property
    def instance(self) -> Optional[str]:
        return self.meta.get("instance")

    @property
    def request_id(self) -> Optional[int]:
        return self.meta.get("request_id")

    def _decode(self) -> list:
        try:
            return decode_results(self.payload) if self.payload else []
        except Exception as e:
            if is_device_fault(e):
                raise
            if self._on_decode_error is not None:
                self._on_decode_error()
            raise FleetDecodeError(
                f"undecodable result payload for request "
                f"{self.request_id} from replica {self.instance}: {e}"
            ) from e

    @property
    def results(self) -> list:
        if self._decoded is None:
            self._decoded = self._decode()
        return self._decoded

    @property
    def doc(self) -> Any:
        """Control-response document (status/deploy acknowledgements)."""
        docs = self._decode()
        return docs[0] if docs else None


class ReplicaHandle:
    """Router-side state for one replica worker."""

    def __init__(self, instance: str, channel: FleetChannel,
                 pid: Optional[int] = None,
                 address: Optional[str] = None,
                 eject_after: int = 3) -> None:
        self.instance = instance
        self.channel = channel
        self.pid = pid
        #: the address the channel was connected to (the readmission
        #: probe reconnects through it when the channel died)
        self.address = address
        self.transport = (parse_address(address)[0]
                          if address is not None else "unix")
        self.lock = threading.Lock()
        self.pending: dict[int, _Request] = {}
        self.in_flight_rows = 0
        self.alive = True
        self.drained = False
        self.rows_ok = 0
        self.requests_ok = 0
        self.last_version: Optional[str] = None
        self.last_generation: Optional[int] = None
        self.svc_s_ewma: Optional[float] = None
        self.health = ReplicaHealth(eject_after=eject_after)
        #: wire-integrity counters accumulated across channel
        #: replacements (a reconnect must not zero the drill ledger)
        self.wire = {"protocol_errors": 0, "frames_dropped": 0,
                     "partitions": 0, "half_opens": 0,
                     "corrupt_injected": 0}
        #: latest shard-observed stats (refresh_from_shards)
        self.obs: dict = {}
        #: model_ids this replica hosts, fed by the
        #: placement plan (set_hosting) and by the replica's own
        #: shipped ``fleet_replica`` view (refresh_from_shards);
        #: model-routed batches only dispatch to hosting replicas
        self.hosted_models: set[str] = set()
        self.receiver: Optional[threading.Thread] = None

    def hosts(self, model_id: str) -> bool:
        with self.lock:
            return model_id in self.hosted_models

    # -- load estimate ------------------------------------------------------
    def service_s_per_row(self, cost_model=None) -> float:
        """Best current per-row service-time estimate: live EWMA >
        cost-model prediction > shipped-shard throughput > default."""
        if self.svc_s_ewma is not None:
            return self.svc_s_ewma
        if cost_model is not None:
            try:
                from ..autotune import candidate_features

                pred_ms = cost_model.predict_wall_ms(
                    "serve.batch/" + self.instance,
                    candidate_features(512, 0),
                )
                if pred_ms is not None and pred_ms > 0:
                    return pred_ms / 1e3 / 512.0
            except Exception as e:  # noqa: BLE001 - estimate only
                if is_device_fault(e):
                    raise
                log.debug("cost-model estimate failed for %s: %s",
                          self.instance, e)
        rps = self.obs.get("batch_rows_per_s")
        if rps:
            return 1.0 / float(rps)
        return _DEFAULT_SVC_S

    def expected_wait_s(self, n_rows: int, cost_model=None) -> float:
        svc = self.service_s_per_row(cost_model)
        with self.lock:
            backlog = self.in_flight_rows
        return (backlog + n_rows) * svc

    def in_flight(self) -> int:
        with self.lock:
            return len(self.pending)

    def fold_wire_stats(self) -> None:
        """Accumulate the CURRENT channel's integrity counters into the
        handle-lifetime ledger (called right before the channel is
        replaced; callers hold ``self.lock``)."""
        for k, v in self.channel.stats().items():
            self.wire[k] = self.wire.get(k, 0) + v

    def wire_stats(self) -> dict:
        """Handle-lifetime wire counters: accumulated + live channel."""
        live = self.channel.stats()
        return {k: self.wire.get(k, 0) + live.get(k, 0)
                for k in set(self.wire) | set(live)}

    def snapshot(self) -> dict:
        with self.lock:
            return {
                "instance": self.instance,
                "pid": self.pid,
                "alive": self.alive,
                "drained": self.drained,
                "transport": self.transport,
                "in_flight": len(self.pending),
                "in_flight_rows": self.in_flight_rows,
                "rows_ok": self.rows_ok,
                "requests_ok": self.requests_ok,
                "version": self.last_version,
                "generation": self.last_generation,
                "service_us_per_row": (
                    round(self.svc_s_ewma * 1e6, 3)
                    if self.svc_s_ewma is not None else None),
                "health": self.health.snapshot(),
                "wire": self.wire_stats(),
                "obs": dict(self.obs),
                "hosted_models": sorted(self.hosted_models),
            }


class _FleetHealthView:
    """Adapter giving per-replica health its own metrics view
    (``fleet_health`` -> ``tx_fleet_health_*`` gauges) without
    re-snapshotting the whole router; owned by the router so the
    registry's weakref stays live exactly as long as the router."""

    def __init__(self, router: "FleetRouter") -> None:
        self._router = router

    def snapshot(self) -> dict:
        return self._router.health_snapshot()


class FleetRouter:
    """Least-loaded dispatch + at-least-once failover + health-gated
    membership over replica channels (module docstring).  In-process:
    the router lives in the controller/runner process, replicas are
    separate worker processes behind AF_UNIX (on-host) or TCP
    (cross-host) channels."""

    def __init__(
        self,
        max_queue: int = 256,
        max_in_flight_per_replica: int = 4,
        tenant_quota: Optional[float] = None,
        cost_model=None,
        clock=time.monotonic,
        send_timeout_s: float = 10.0,
        response_timeout_s: float = 30.0,
        eject_after: int = 3,
        probe_interval_s: float = 0.5,
        probe_timeout_s: float = 2.0,
        quorum: Optional[int] = None,
        tenant_priority: Optional[dict] = None,
        brownout_min_priority: int = 1,
        model_quotas: Optional[dict] = None,
        start: bool = True,
    ) -> None:
        if max_in_flight_per_replica < 1:
            raise ValueError("max_in_flight_per_replica must be >= 1")
        self.max_in_flight_per_replica = int(max_in_flight_per_replica)
        self.cost_model = cost_model
        self.clock = clock
        self.send_timeout_s = float(send_timeout_s)
        #: silence ceiling per in-flight score request: a replica that
        #: holds a request longer than this without ANY response is
        #: failing (partitioned peers keep the socket open - timeouts,
        #: not EOF, are the cross-host failure signal)
        self.response_timeout_s = float(response_timeout_s)
        self.eject_after = int(eject_after)
        self.probe_interval_s = float(probe_interval_s)
        self.probe_timeout_s = float(probe_timeout_s)
        self.quorum = None if quorum is None else int(quorum)
        self._tenant_priority = dict(tenant_priority or {})
        self.brownout_min_priority = int(brownout_min_priority)
        #: per-model in-flight row caps: {model_id: rows};
        #: a model at its cap sheds NEW submissions with
        #: ModelQuotaError while other models keep admitting
        self.model_quotas = {
            str(k): int(v) for k, v in (model_quotas or {}).items()}
        self.admission = AdmissionController(
            max_queue=max_queue, clock=clock, tenant_quota=tenant_quota)
        self._handles: dict[str, ReplicaHandle] = {}
        self._handles_lock = threading.Lock()
        self._retry: deque[_Request] = deque()
        self._retry_lock = threading.Lock()
        self._req_ids = itertools.count(1)
        self._stop = threading.Event()
        #: set by every response arrival: the dispatcher parked on
        #: "every replica full" wakes the moment capacity frees instead
        #: of burning the whole 50 ms quantum (the wait itself stays
        #: quantum-BOUNDED - the event only makes it prompt)
        self._capacity = threading.Event()
        # counters (the fleet_router metrics view)
        self._ctr_lock = threading.Lock()
        self.rows_ok = 0
        self.rows_failed = 0
        self.requests_ok = 0
        self.requests_failed = 0
        self.shed_queue_full = 0
        self.shed_quota = 0
        self.shed_deadline = 0
        self.shed_brownout = 0
        self.shed_model_quota = 0
        self.unhosted_model_errors = 0
        self.retries = 0
        self.replica_deaths = 0
        self.router_stalls = 0
        self.response_timeouts = 0
        self.protocol_errors = 0
        self.decode_errors = 0
        self.deadline_dropped_remote = 0
        self.ejections = 0
        self.readmissions = 0
        self.probes_sent = 0
        self.probes_failed = 0
        self._rows_by_generation: dict[str, int] = {}
        #: exact per-model row conservation ledger: every
        #: delivered scored row attributed to its model (None-keyed
        #: rows ride the legacy single-model lane)
        self._rows_by_model: dict[str, int] = {}
        metrics_registry().register_view("fleet_router", self)
        self._health_view = _FleetHealthView(self)
        metrics_registry().register_view("fleet_health",
                                         self._health_view)
        self._dispatcher: Optional[threading.Thread] = None
        self._health: Optional[threading.Thread] = None
        if start:
            self._dispatcher = _ctx_thread(
                self._dispatch_loop, "tx-fleet-dispatch")
            self._dispatcher.start()
            self._health = _ctx_thread(
                self._health_loop, "tx-fleet-health")
            self._health.start()

    # -- replica membership -------------------------------------------------
    def add_replica(self, instance: str, socket_path: str,
                    connect_timeout_s: float = 60.0,
                    pid: Optional[int] = None,
                    drained: bool = False) -> ReplicaHandle:
        """Connect a replica's channel (unix path or ``host:port``) and
        start its receiver thread.  Re-adding an instance name (a
        restarted worker) replaces the dead handle; its in-flight work
        was already failed over.  ``drained=True`` admits the handle
        with dispatch OFF - the scale-up path's probe gate: control
        traffic (ping) flows, score traffic waits for the explicit
        undrain after the health probe passes."""
        channel = connect(socket_path, timeout_s=connect_timeout_s)
        handle = ReplicaHandle(instance, channel, pid=pid,
                               address=socket_path,
                               eject_after=self.eject_after)
        handle.drained = bool(drained)
        handle.receiver = _ctx_thread(
            self._receive_loop, f"tx-fleet-recv-{instance}", handle)
        with self._handles_lock:
            old = self._handles.get(instance)
            self._handles[instance] = handle
        if old is not None and old.alive:
            self._on_replica_dead(old, "replaced by a new connection")
        handle.receiver.start()
        return handle

    def replicas(self) -> list[ReplicaHandle]:
        with self._handles_lock:
            return list(self._handles.values())

    def live_replicas(self) -> list[ReplicaHandle]:
        return [h for h in self.replicas() if h.alive]

    def healthy_replicas(self) -> list[ReplicaHandle]:
        return [h for h in self.replicas()
                if h.alive and h.health.state == "healthy"]

    def handle(self, instance: str) -> ReplicaHandle:
        with self._handles_lock:
            h = self._handles.get(instance)
        if h is None:
            raise FleetError(f"unknown replica {instance!r}")
        return h

    def remove_replica(self, instance: str,
                       reason: str = "scale_down",
                       timeout_s: float = 5.0) -> None:
        """Retire a replica from membership entirely (scale-down):
        stop dispatching to it, fail over anything still pending to
        survivors, close the channel, and FORGET the handle - unlike
        ejection, which keeps the handle around for probe-gated
        readmission.  Idempotent on unknown names (a victim that
        crashed mid-drain may already be gone)."""
        with self._handles_lock:
            handle = self._handles.pop(instance, None)
        if handle is None:
            return
        with handle.lock:
            handle.alive = False
            handle.drained = True
            orphans = list(handle.pending.values())
            handle.pending.clear()
            handle.in_flight_rows = 0
        handle.channel.close()
        self._capacity.set()  # wake a parked dispatcher to re-plan
        tracer().event("fleet.remove", instance=instance,
                       reason=str(reason))
        log.info("%s replica %s removed from membership (%s): %d "
                 "in-flight request(s) failing over", LOG_PREFIX,
                 instance, reason, len(orphans))
        self._requeue_orphans(handle, orphans, f"removed: {reason}")
        if handle.receiver is not None:
            handle.receiver.join(timeout_s)

    # -- submission ---------------------------------------------------------
    def _priority(self, tenant: Optional[str]) -> int:
        return int(self._tenant_priority.get(tenant, 0))

    def submit(self, records: Optional[Sequence] = None,
               payload: Optional[bytes] = None,
               n_rows: Optional[int] = None,
               tenant: Optional[str] = None,
               deadline_ms: Optional[float] = None,
               model_id: Optional[str] = None) -> _Request:
        """Queue one batch; returns the admission ``_Request`` handle
        (``.wait(timeout)`` -> :class:`FleetResult`).  Pass ``records``
        (encoded here, once) or an already-encoded ``payload`` +
        ``n_rows`` - the wire-form path for callers that hold the
        serialized batch already (a network front end, a load
        generator).  ``model_id`` selects one hosted model: the batch
        only dispatches to replicas hosting it, sheds loudly when nothing
        does, and counts toward that model's in-flight quota."""
        if payload is None:
            if records is None:
                raise ValueError("submit needs records or payload")
            from .channel import encode_records

            payload = encode_records(records)
            n_rows = len(records)
        if n_rows is None:
            raise ValueError("payload submission needs n_rows")
        if model_id is not None:
            model_id = str(model_id)
            if not any(h.alive and h.hosts(model_id)
                       for h in self.replicas()):
                with self._ctr_lock:
                    self.unhosted_model_errors += 1
                raise UnhostedModelError(
                    f"no replica hosts model {model_id!r} "
                    f"(hosting: {self.hosting_map()})")
            cap = self.model_quotas.get(model_id)
            if cap is not None:
                held = self._model_inflight_rows(model_id)
                if held + int(n_rows) > cap:
                    with self._ctr_lock:
                        self.shed_model_quota += 1
                    raise ModelQuotaError(
                        f"model {model_id!r} quota exceeded: "
                        f"{held} rows in flight + {n_rows} > {cap}")
        if self.quorum is not None:
            healthy = len(self.healthy_replicas())
            if (healthy < self.quorum
                    and self._priority(tenant)
                    < self.brownout_min_priority):
                with self._ctr_lock:
                    self.shed_brownout += 1
                raise BrownoutShedError(
                    f"fleet brownout: {healthy}/{self.quorum} replicas "
                    f"healthy; shedding tenant {tenant!r} (priority "
                    f"{self._priority(tenant)} < "
                    f"{self.brownout_min_priority})")
        batch = FleetBatch(payload=payload, n_rows=int(n_rows),
                           tenant=tenant, model_id=model_id)
        slept = _faults.inject_sleep("fleet.router_stall")
        if slept:
            with self._ctr_lock:
                self.router_stalls += 1
        try:
            req = self.admission.admit(
                batch,
                None if deadline_ms is None else deadline_ms / 1e3,
                tenant=tenant,
            )
        except TenantQuotaError:
            with self._ctr_lock:
                self.shed_quota += 1
            raise
        except QueueFullError:
            with self._ctr_lock:
                self.shed_queue_full += 1
            raise
        self._try_fast_dispatch()
        return req

    def score_batch(self, records: Sequence, timeout_s: float = 30.0,
                    tenant: Optional[str] = None,
                    deadline_ms: Optional[float] = None,
                    model_id: Optional[str] = None) -> list:
        """Synchronous scoring through the fleet; element i aligns with
        records[i] (the endpoint contract, preserved end to end)."""
        req = self.submit(records=records, tenant=tenant,
                          deadline_ms=deadline_ms, model_id=model_id)
        res: FleetResult = req.wait(timeout_s)
        return res.results

    # -- per-model hosting + quotas ------------------------------
    def set_hosting(self, assignments: dict) -> None:
        """Install a placement plan's ``{instance: [model_id, ...]}``
        map onto the handles (unknown instances ignored: the plan may
        lead membership during a scale-up)."""
        for h in self.replicas():
            models = assignments.get(h.instance)
            if models is None:
                continue
            with h.lock:
                h.hosted_models = {str(m) for m in models}

    def hosting_map(self) -> dict:
        """``{instance: sorted hosted model_ids}`` across live
        replicas."""
        out = {}
        for h in self.replicas():
            if not h.alive:
                continue
            with h.lock:
                out[h.instance] = sorted(h.hosted_models)
        return out

    def _model_inflight_rows(self, model_id: str) -> int:
        """Rows currently dispatched (pending on some replica) or in
        the retry lane for one model - the quantity the per-model quota
        caps."""
        total = 0
        for h in self.replicas():
            with h.lock:
                for req in h.pending.values():
                    if getattr(req.record, "model_id", None) == model_id:
                        total += req.record.n_rows
        with self._retry_lock:
            for req in self._retry:
                if getattr(req.record, "model_id", None) == model_id:
                    total += req.record.n_rows
        return total

    # -- dispatch -----------------------------------------------------------
    def _try_fast_dispatch(self) -> None:
        """Caller-thread fast path: when nothing waits ahead (no
        failover retries) and a replica has capacity, take the queue
        head and send it right here - two context switches cheaper per
        request than waking the dispatcher thread, which remains the
        slow path for the queued/backpressure case.  FIFO holds: only
        the queue HEAD is taken, and only when the retry deque is
        empty."""
        with self._retry_lock:
            if self._retry:
                return
        if self._pick(0) is None:
            return  # every replica full: the dispatcher's park owns it
        live, shed = self.admission.take(1)
        for r in shed:
            if not r.abandoned:
                with self._ctr_lock:
                    self.shed_deadline += 1
        if not live:
            return
        req = live[0]
        while not self._stop.is_set():
            handle = self._pick(req.record.n_rows,
                                getattr(req.record, "model_id", None))
            if handle is None:
                # capacity vanished between the probe and the take
                # (racing caller): hand the head back to the FRONT of
                # the retry lane - the dispatcher drains it within one
                # quantum, order preserved
                with self._retry_lock:
                    self._retry.appendleft(req)
                return
            done, _rid = self._send_to(handle, req)
            if done:
                return
        # the router closed while we held a taken request: it is in no
        # queue and no pending map, so close()'s drain cannot reach it
        # - fail it here or its caller blocks out its full wait timeout
        req.resolve(error=FleetError("router closed"))

    def _next_request(self) -> Optional[_Request]:
        """Failover retries first (they already waited once), then the
        admission queue; returns None after a bounded idle quantum."""
        with self._retry_lock:
            if self._retry:
                return self._retry.popleft()
        if not self.admission.wait_nonempty(QUANTUM_S):
            return None
        live, shed = self.admission.take(1)
        for req in shed:
            if not req.abandoned:
                with self._ctr_lock:
                    self.shed_deadline += 1
        return live[0] if live else None

    def _pick(self, n_rows: int,
              model_id: Optional[str] = None) -> Optional[ReplicaHandle]:
        candidates = [
            h for h in self.replicas()
            if h.alive and not h.drained
            and h.health.state == "healthy"
            and h.in_flight() < self.max_in_flight_per_replica
            and (model_id is None or h.hosts(model_id))
        ]
        if not candidates:
            return None
        return min(candidates,
                   key=lambda h: h.expected_wait_s(n_rows,
                                                   self.cost_model))

    def _dispatch_loop(self) -> None:
        while not self._stop.is_set():
            try:
                req = self._next_request()
                if req is None:
                    continue
                slept = _faults.inject_sleep("fleet.router_stall")
                if slept:
                    with self._ctr_lock:
                        self.router_stalls += 1
                self._dispatch_one(req)
            except Exception as e:  # noqa: BLE001 - the loop must survive
                if is_device_fault(e):
                    raise
                log.exception("fleet dispatch loop error")

    def _dispatch_one(self, req: _Request) -> None:
        """Assign one request to the least-loaded replica, waiting in
        bounded quanta while every replica is at its in-flight cap (or
        ejected pending readmission); a request whose deadline passes
        while waiting sheds, and a fleet with no live replica fails it
        loudly."""
        batch: FleetBatch = req.record  # type: ignore[assignment]
        while not self._stop.is_set():
            if req.deadline is not None and self.clock() > req.deadline:
                if req.resolve_delivered(error=DeadlineExceededError(
                        "deadline exceeded waiting for replica "
                        "capacity")):
                    with self._ctr_lock:
                        self.shed_deadline += 1
                return
            # clear BEFORE picking: a response landing between the pick
            # and the wait still wakes the next wait immediately
            self._capacity.clear()
            handle = self._pick(batch.n_rows, batch.model_id)
            if handle is not None:
                done, _rid = self._send_to(handle, req)
                if done:
                    return
                continue  # the picked replica died mid-send: repick
            if not self.live_replicas():
                req.resolve_delivered(error=FleetError(
                    "no live replica to serve on"))
                with self._ctr_lock:
                    self.requests_failed += 1
                return
            if (batch.model_id is not None
                    and not any(h.alive and h.hosts(batch.model_id)
                                for h in self.replicas())):
                # the hosting set changed after admission (scale-down,
                # unhost): parked work for a model nobody hosts must
                # fail loudly, not wait forever for capacity
                if req.resolve_delivered(error=UnhostedModelError(
                        f"no replica hosts model {batch.model_id!r} "
                        "anymore")):
                    with self._ctr_lock:
                        self.unhosted_model_errors += 1
                        self.requests_failed += 1
                        self.rows_failed += batch.n_rows
                return
            # all replicas full (or ejected, probing toward
            # readmission): park until a response frees capacity,
            # bounded at one quantum either way
            self._capacity.wait(QUANTUM_S)
        req.resolve_delivered(error=FleetError("router closed"))

    def _send_to(self, handle: ReplicaHandle, req: _Request,
                 op: int = OP_SCORE) -> tuple[bool, Optional[int]]:
        """-> (owned_elsewhere_or_sent, rid).  ``True`` means the
        caller must NOT touch ``req`` again: it was either sent (rid
        returned, response pending) or - on a send failure that raced
        the receiver's death handling - already harvested into the
        retry lane by ``_on_replica_dead`` (rid None).  ``False`` means
        the send failed and the caller still OWNS the request (exactly
        one of the two failure paths keeps it: whoever popped the rid)
        and may re-dispatch it inline."""
        batch: FleetBatch = req.record  # type: ignore[assignment]
        rid = next(self._req_ids)
        if op == OP_SCORE:
            meta = {"tenant": batch.tenant, "n_rows": batch.n_rows}
            if batch.model_id is not None:
                meta["model_id"] = batch.model_id
            if req.deadline is not None:
                # the caller's remaining budget rides the wire as an
                # absolute wall-clock deadline (cross-host clock skew
                # eats into slack, never adds budget) so the replica
                # can drop work the caller already abandoned - e.g. a
                # batch that sat in a partitioned socket's kernel
                # buffer until long after its caller gave up
                remaining_s = req.deadline - self.clock()
                meta["deadline_unix"] = time.time() + remaining_s
        else:
            meta = dict(batch.ctl)
        with handle.lock:
            if not handle.alive:
                return False, None
            if (op == OP_SCORE
                    and len(handle.pending)
                    >= self.max_in_flight_per_replica):
                # the cap is enforced HERE, under the lock: _pick's
                # unlocked probe can race concurrent fast-path
                # submitters, and the per-replica in-flight bound is a
                # promise, not a hint (control ops bypass it - a
                # drained replica must still take its deploy).  The
                # caller repicks; _pick's own locked read then sees the
                # replica full.
                return False, None
            handle.pending[rid] = req
            handle.in_flight_rows += batch.n_rows
        # stash for the service-time EWMA (send->response wall) and the
        # health scanner's silence ceiling
        req.record._sent_at = time.perf_counter()  # type: ignore
        if op == OP_SCORE:
            req.record._resp_deadline = (  # type: ignore
                time.monotonic() + self.response_timeout_s)
        try:
            handle.channel.send(op, rid, meta, batch.payload,
                                timeout_s=self.send_timeout_s,
                                stop=self._stop)
        except (ChannelClosedError, ChannelTimeoutError) as e:
            # ownership race with the receiver thread's death handling:
            # if IT noticed the dead channel first, _on_replica_dead
            # already popped our rid and queued the request into the
            # retry lane - retrying here too would DOUBLE-dispatch (two
            # survivors both scoring, the ledger counting one request
            # twice).  Whoever pops the rid owns the retry.
            with handle.lock:
                popped = handle.pending.pop(rid, None)
                if popped is not None:
                    handle.in_flight_rows -= batch.n_rows
            self._on_replica_dead(handle, f"send failed: {e}")
            return (popped is None), None
        return True, rid

    # -- responses ----------------------------------------------------------
    def _receive_loop(self, handle: ReplicaHandle) -> None:
        while not self._stop.is_set() and handle.alive:
            try:
                msg = handle.channel.recv(stop=self._stop)
            except ChannelProtocolError as e:
                with self._ctr_lock:
                    self.protocol_errors += 1
                self._on_replica_dead(handle, f"protocol error: {e}")
                return
            except ChannelClosedError as e:
                self._on_replica_dead(handle, str(e))
                return
            if msg is None:
                continue
            op, rid, meta, payload = msg
            if op == OP_HELLO:
                continue  # connection management, not data
            now_pc = time.perf_counter()
            with handle.lock:
                req = handle.pending.pop(rid, None)
                if req is not None:
                    handle.in_flight_rows -= req.record.n_rows
                    sent_at = getattr(req.record, "_sent_at", None)
                    handle.health.record_success(
                        None if sent_at is None
                        else (now_pc - sent_at) * 1e3,
                        time.monotonic())
            self._capacity.set()  # a parked dispatcher can send again
            if req is None:
                continue  # unknown id: already failed over elsewhere
            if req.record.kind == "probe":
                if op in (OP_CONTROL_RESULT, OP_RESULT):
                    self._readmit(handle)
                else:
                    with handle.lock:
                        handle.health.probe_failed(
                            str(meta.get("error", "probe error")),
                            time.monotonic())
                    with self._ctr_lock:
                        self.probes_failed += 1
                continue
            if op in (OP_RESULT, OP_CONTROL_RESULT):
                self._resolve_ok(handle, req, rid, meta, payload,
                                 scored=op == OP_RESULT)
            elif op == OP_ERROR:
                if meta.get("kind") == "deadline":
                    # the replica dropped work whose caller had already
                    # abandoned it: deadline shed, not a worker failure
                    with self._ctr_lock:
                        self.deadline_dropped_remote += 1
                    if req.resolve_delivered(error=DeadlineExceededError(
                            f"replica {handle.instance} dropped work "
                            "whose deadline had already passed")):
                        with self._ctr_lock:
                            self.shed_deadline += 1
                elif req.resolve_delivered(error=FleetWorkerError(
                        str(meta.get("error", "worker error")))):
                    with self._ctr_lock:
                        self.requests_failed += 1
                        self.rows_failed += req.record.n_rows

    def _resolve_ok(self, handle: ReplicaHandle, req: _Request,
                    rid: int, meta: dict, payload: bytes,
                    scored: bool) -> None:
        batch: FleetBatch = req.record  # type: ignore[assignment]
        meta = dict(meta, instance=handle.instance, request_id=rid)
        delivered = req.resolve_delivered(result=FleetResult(
            meta, payload, on_decode_error=self._count_decode_error))
        if not scored:
            return
        n = int(meta.get("n_rows", batch.n_rows))
        wall = time.perf_counter() - getattr(batch, "_sent_at",
                                             time.perf_counter())
        if n > 0 and wall > 0:
            per_row = wall / n
            handle.svc_s_ewma = (
                per_row if handle.svc_s_ewma is None
                else (1 - _SVC_ALPHA) * handle.svc_s_ewma
                + _SVC_ALPHA * per_row
            )
            if self.cost_model is not None:
                try:
                    from ..autotune import candidate_features

                    self.cost_model.observe(
                        "serve.batch/" + handle.instance,
                        candidate_features(n, 0), wall * 1e3)
                except Exception as e:  # noqa: BLE001 - estimate only
                    if is_device_fault(e):
                        raise
                    log.debug("cost-model observe failed: %s", e)
        handle.last_version = meta.get("version")
        handle.last_generation = meta.get("generation")
        with handle.lock:
            handle.rows_ok += n
            handle.requests_ok += 1
        gen_key = f"{meta.get('version')}/g{meta.get('generation')}"
        model_key = str(meta.get("model_id", batch.model_id) or "_default")
        with self._ctr_lock:
            if delivered:
                self.requests_ok += 1
                self.rows_ok += n
                self._rows_by_generation[gen_key] = (
                    self._rows_by_generation.get(gen_key, 0) + n)
                self._rows_by_model[model_key] = (
                    self._rows_by_model.get(model_key, 0) + n)

    def _count_decode_error(self) -> None:
        with self._ctr_lock:
            self.decode_errors += 1

    # -- failover + health --------------------------------------------------
    def _requeue_orphans(self, handle: ReplicaHandle,
                         orphans: Sequence[_Request],
                         reason: str) -> None:
        """Fail over a dead/ejected replica's in-flight requests to
        survivors via the retry lane (at-least-once, MAX_FAILOVERS
        budgeted); control ops fail loudly, probes are the health
        loop's own bookkeeping."""
        for req in orphans:
            if req.done.is_set():
                continue
            if req.record.kind == "probe":
                continue  # the health loop owns the probe lifecycle
            if req.record.kind == "ctl":
                # control ops are not idempotent-by-construction the way
                # scoring is: surface the failure to the operator path
                req.resolve_delivered(error=FleetError(
                    f"replica {handle.instance} died during a control "
                    f"operation ({reason})"))
                continue
            if req.record.retries >= MAX_FAILOVERS:
                # a poison batch must not cascade replica to replica
                if req.resolve_delivered(error=FleetError(
                        f"request failed over {req.record.retries} "
                        f"times (last replica {handle.instance}: "
                        f"{reason}); refusing further retries")):
                    with self._ctr_lock:
                        self.requests_failed += 1
                        self.rows_failed += req.record.n_rows
                continue
            req.record.retries += 1
            with self._ctr_lock:
                self.retries += 1
            with self._retry_lock:
                self._retry.append(req)

    def _on_replica_dead(self, handle: ReplicaHandle,
                         reason: str) -> None:
        now = time.monotonic()
        with handle.lock:
            if not handle.alive:
                return
            handle.alive = False
            handle.health.force_eject(f"channel dead: {reason}", now)
            orphans = list(handle.pending.values())
            handle.pending.clear()
            handle.in_flight_rows = 0
        handle.channel.close()
        self._capacity.set()  # wake a parked dispatcher to re-plan
        with self._ctr_lock:
            self.replica_deaths += 1
            self.ejections += 1
        tracer().event("fleet.ejection", instance=handle.instance,
                       reason=f"channel dead: {reason}")
        log.warning("%s replica %s dead (%s): failing over %d in-flight "
                    "request(s) to survivors", LOG_PREFIX,
                    handle.instance, reason, len(orphans))
        self._requeue_orphans(handle, orphans, reason)

    def _eject(self, handle: ReplicaHandle, reason: str,
               now: float) -> None:
        """Eject a replica whose CHANNEL still looks alive (the
        partitioned-peer case): stop dispatching to it, fail its
        in-flight work over, leave the socket open so a heal can
        readmit over the same connection."""
        with handle.lock:
            handle.health.force_eject(reason, now)
            orphans = list(handle.pending.values())
            handle.pending.clear()
            handle.in_flight_rows = 0
        self._capacity.set()
        with self._ctr_lock:
            self.ejections += 1
        tracer().event("fleet.ejection", instance=handle.instance,
                       reason=str(reason))
        log.warning("%s replica %s EJECTED (%s): failing over %d "
                    "in-flight request(s) to survivors", LOG_PREFIX,
                    handle.instance, reason, len(orphans))
        self._requeue_orphans(handle, orphans, f"ejected: {reason}")

    def _readmit(self, handle: ReplicaHandle) -> None:
        with handle.lock:
            readmitted = handle.health.readmit(time.monotonic())
        if not readmitted:
            return
        self._capacity.set()
        with self._ctr_lock:
            self.readmissions += 1
        tracer().event("fleet.readmission", instance=handle.instance)
        log.warning("%s replica %s READMITTED after probe pong",
                    LOG_PREFIX, handle.instance)

    def _health_loop(self) -> None:
        """Failure detector + readmission prober: scans in-flight
        requests against the silence ceiling, ejects on consecutive
        failures, and probes ejected replicas at a bounded rate."""
        while not self._stop.is_set():
            try:
                now = time.monotonic()
                for handle in self.replicas():
                    self._health_tick(handle, now)
            except Exception as e:  # noqa: BLE001 - the loop must survive
                if is_device_fault(e):
                    raise
                log.exception("fleet health loop error")
            self._stop.wait(QUANTUM_S)

    def _health_tick(self, handle: ReplicaHandle, now: float) -> None:
        st = handle.health
        if st.state == "healthy":
            if handle.alive:
                self._scan_response_timeouts(handle, now)
            return
        if st.state == "probing":
            if (st.probe_sent_at is not None
                    and now - st.probe_sent_at > self.probe_timeout_s):
                with handle.lock:
                    if st.probe_rid is not None:
                        handle.pending.pop(st.probe_rid, None)
                    st.probe_failed("probe unanswered", now)
                with self._ctr_lock:
                    self.probes_failed += 1
            return
        # ejected: rate-bounded readmission probing - at most one
        # probe (or reconnect attempt) per probe_interval_s, so a
        # flapping or storming peer sees a bounded connect rate
        if (st.last_probe_at is not None
                and now - st.last_probe_at < self.probe_interval_s):
            return
        st.last_probe_at = now
        if not handle.alive or handle.channel.closed:
            if not self._probe_reconnect(handle):
                with handle.lock:
                    st.probes_sent += 1
                    st.probes_failed += 1
                with self._ctr_lock:
                    self.probes_sent += 1
                    self.probes_failed += 1
                return
        self._send_probe(handle, now)

    def _scan_response_timeouts(self, handle: ReplicaHandle,
                                now: float) -> None:
        """Pop score requests a replica has sat on past the silence
        ceiling and fail them over; enough consecutive timeouts eject
        the replica (the partition detector: a partitioned TCP peer
        never EOFs, it just goes quiet)."""
        timed_out = []
        with handle.lock:
            for rid, req in list(handle.pending.items()):
                batch = req.record
                if getattr(batch, "kind", "score") != "score":
                    continue  # ctl ops own their timeout (control())
                rd = getattr(batch, "_resp_deadline", None)
                if rd is not None and now > rd:
                    handle.pending.pop(rid)
                    handle.in_flight_rows -= batch.n_rows
                    timed_out.append(req)
            newly_ejected = False
            for _req in timed_out:
                if handle.health.record_failure("response timeout",
                                                now):
                    newly_ejected = True
        if not timed_out:
            return
        self._capacity.set()
        with self._ctr_lock:
            self.response_timeouts += len(timed_out)
        log.warning("%s replica %s silent past %.1fs on %d request(s):"
                    " failing over", LOG_PREFIX, handle.instance,
                    self.response_timeout_s, len(timed_out))
        self._requeue_orphans(
            handle, timed_out,
            f"response timeout (> {self.response_timeout_s}s)")
        if newly_ejected:
            self._eject(handle, "consecutive response timeouts", now)

    def _probe_reconnect(self, handle: ReplicaHandle) -> bool:
        """Reconnect a dead channel for probing (bounded by the probe
        timeout; the worker's newest-connection-wins accept loop makes
        this safe to race against the controller's restart path)."""
        if handle.address is None:
            return False
        try:
            channel = connect(
                handle.address, timeout_s=self.probe_timeout_s,
                handshake_timeout_s=min(self.probe_timeout_s,
                                        HANDSHAKE_TIMEOUT_S))
        except (ChannelClosedError, ChannelTimeoutError,
                ChannelProtocolError, OSError) as e:
            with handle.lock:
                handle.health.last_error = f"reconnect failed: {e}"
            log.info("%s replica %s reconnect probe failed: %s",
                     LOG_PREFIX, handle.instance, e)
            return False
        with handle.lock:
            old = handle.channel
            handle.fold_wire_stats()
            handle.channel = channel
            handle.alive = True
            if channel.peer and channel.peer.get("pid"):
                handle.pid = channel.peer["pid"]
        old.close()
        handle.receiver = _ctx_thread(
            self._receive_loop, f"tx-fleet-recv-{handle.instance}",
            handle)
        handle.receiver.start()
        log.info("%s replica %s channel reconnected by readmission "
                 "probe", LOG_PREFIX, handle.instance)
        return True

    def _send_probe(self, handle: ReplicaHandle, now: float) -> None:
        """One half-open probe: a control ping whose pong (and nothing
        else) readmits the replica."""
        st = handle.health
        with handle.lock:
            st.begin_probe(now)
        with self._ctr_lock:
            self.probes_sent += 1
        batch = FleetBatch(payload=b"", n_rows=0, kind="probe",
                           ctl={"cmd": "ping"})
        req = _Request(record=batch, enqueued_at=self.clock())
        sent, rid = self._send_to(handle, req, op=OP_CONTROL)
        if not sent or rid is None:
            with handle.lock:
                st.probe_failed("probe send failed", now)
            with self._ctr_lock:
                self.probes_failed += 1
            return
        with handle.lock:
            if st.state == "probing":
                # the pong can beat us here (readmitted already): only
                # arm the timeout bookkeeping while the probe is live
                st.probe_rid = rid

    # -- control plane ------------------------------------------------------
    def control(self, instance: str, cmd: str,
                args: Optional[dict] = None,
                timeout_s: float = 120.0) -> Any:
        """One control round trip to a named replica (deploy / canary /
        status / ...); bypasses admission and the drain flag - draining
        a replica is exactly how a rolling deploy makes room to send it
        control traffic."""
        handle = self.handle(instance)
        if not handle.alive:
            raise FleetError(f"replica {instance!r} is not alive")
        batch = FleetBatch(payload=b"", n_rows=0, kind="ctl",
                           ctl=dict(args or {}, cmd=cmd))
        req = _Request(record=batch, enqueued_at=self.clock())
        sent, rid = self._send_to(handle, req, op=OP_CONTROL)
        if not sent or rid is None:
            raise FleetError(f"replica {instance!r} died mid-control")
        try:
            res: FleetResult = req.wait(timeout_s)
        except RequestTimeoutError:
            # reclaim the in-flight slot: a leaked pending entry would
            # hold one max_in_flight slot forever and keep
            # wait_drained() from ever seeing zero (a late reply finds
            # the rid gone and is dropped)
            with handle.lock:
                handle.pending.pop(rid, None)
            raise
        return res.doc

    def broadcast(self, cmd: str, args: Optional[dict] = None,
                  timeout_s: float = 120.0) -> dict:
        """The control op on every LIVE replica; per-instance results
        (exceptions captured as ``{"error": ...}`` so one dead replica
        cannot abort a fleet-wide rollback)."""
        out = {}
        for h in self.live_replicas():
            try:
                out[h.instance] = self.control(h.instance, cmd, args,
                                               timeout_s)
            except (FleetError, FleetWorkerError,
                    RequestTimeoutError) as e:
                out[h.instance] = {"error": f"{type(e).__name__}: {e}"}
        return out

    def set_drained(self, instance: str, drained: bool = True) -> None:
        self.handle(instance).drained = bool(drained)

    def wait_drained(self, instance: str, timeout_s: float = 30.0) -> bool:
        """True once the replica has zero in-flight requests (its
        drained flag stops NEW dispatches; in-flight batches finish on
        the old generation - the zero-drop half of a rolling deploy)."""
        handle = self.handle(instance)
        deadline = time.monotonic() + timeout_s
        while time.monotonic() <= deadline:
            if handle.in_flight() == 0:
                return True
            time.sleep(QUANTUM_S)
        return False

    # -- observed load refresh ----------------------------------------------
    def refresh_from_shards(self, metrics_docs: Sequence[dict]) -> int:
        """Fold the fleet aggregation dir's per-replica serving stats
        into the dispatch weights (the router reads observed throughput/p99
        from fleet shards).  ``metrics_docs``
        is ``FleetAggregator.merged_metrics_docs()``; returns how many
        handles were updated."""
        from ..obs.fleet import serving_views

        by_instance = {str(d.get("instance")): d for d in metrics_docs}
        updated = 0
        for h in self.replicas():
            doc = by_instance.get(h.instance)
            if doc is None:
                continue
            best: dict = {}
            for _key, snap in serving_views(doc):
                rps = snap.get("batch_rows_per_s") or 0
                if rps >= best.get("batch_rows_per_s", 0):
                    best = {
                        "batch_rows_per_s": rps,
                        "p99_ms": (snap.get("latency_ms") or {}).get(
                            "p99"),
                        "queue_depth_p99": (snap.get("queue_depth")
                                            or {}).get("p99"),
                        "rows_scored": snap.get("rows_scored"),
                    }
            if best:
                h.obs = best
                updated += 1
            # fold the replica's own hosted-model report (its
            # fleet_replica view rides the same shard): the replica is
            # the authority on what it actually hosts, so a placement
            # plan applied out-of-band still converges here
            for key, snap in (doc.get("views") or {}).items():
                if (key.partition("/")[0] == "fleet_replica"
                        and isinstance(snap, dict)
                        and snap.get("models")):
                    with h.lock:
                        h.hosted_models = {
                            str(r.get("model_id"))
                            for r in snap["models"]
                            if r.get("model_id")}
        return updated

    # -- reporting ----------------------------------------------------------
    def snapshot(self) -> dict:
        """The ``fleet_router`` metrics view: fleet-level counters plus
        per-replica dispatch state, scraped as ``tx_fleet_router_*``."""
        with self._ctr_lock:
            out = {
                "rows_ok": self.rows_ok,
                "rows_failed": self.rows_failed,
                "requests_ok": self.requests_ok,
                "requests_failed": self.requests_failed,
                "shed_queue_full": self.shed_queue_full,
                "shed_quota": self.shed_quota,
                "shed_deadline": self.shed_deadline,
                "shed_brownout": self.shed_brownout,
                "shed_model_quota": self.shed_model_quota,
                "unhosted_model_errors": self.unhosted_model_errors,
                "retries": self.retries,
                "replica_deaths": self.replica_deaths,
                "router_stalls": self.router_stalls,
                "response_timeouts": self.response_timeouts,
                "protocol_errors": self.protocol_errors,
                "decode_errors": self.decode_errors,
                "deadline_dropped_remote": self.deadline_dropped_remote,
                "ejections": self.ejections,
                "readmissions": self.readmissions,
                "probes_sent": self.probes_sent,
                "probes_failed": self.probes_failed,
                "rows_by_generation": dict(self._rows_by_generation),
                "rows_by_model": dict(self._rows_by_model),
            }
        out["queue_depth"] = len(self.admission)
        out["tenants_held"] = {
            str(k): v for k, v in self.admission.tenants_held().items()
        }
        out["healthy_replicas"] = len(self.healthy_replicas())
        out["quorum"] = self.quorum
        out["replicas"] = {
            h.instance: h.snapshot() for h in self.replicas()
        }
        return out

    def health_snapshot(self) -> dict:
        """The ``fleet_health`` metrics view (``tx_fleet_health_*``):
        the failure-detector plane alone - per-replica state machine +
        fleet-level ejection/readmission/probe counters - small enough
        to scrape every tick without the full router document."""
        with self._ctr_lock:
            out: dict = {
                "ejections": self.ejections,
                "readmissions": self.readmissions,
                "probes_sent": self.probes_sent,
                "probes_failed": self.probes_failed,
                "response_timeouts": self.response_timeouts,
                "protocol_errors": self.protocol_errors,
                "decode_errors": self.decode_errors,
                "deadline_dropped_remote": self.deadline_dropped_remote,
                "shed_brownout": self.shed_brownout,
            }
        reps = self.replicas()
        out["healthy_replicas"] = sum(
            1 for h in reps if h.alive and h.health.state == "healthy")
        out["quorum"] = self.quorum
        out["replicas"] = {
            h.instance: h.health.snapshot() for h in reps
        }
        return out

    def close(self, timeout_s: float = 10.0) -> None:
        """Stop dispatching, fail everything still pending loudly, and
        close every channel (all joins bounded)."""
        self._stop.set()
        self.admission.close()
        if self._dispatcher is not None:
            self._dispatcher.join(timeout_s)
        if self._health is not None:
            self._health.join(timeout_s)
        for req in self.admission.drain():
            req.resolve(error=FleetError("router closed"))
        with self._retry_lock:
            retry, self._retry = list(self._retry), deque()
        for req in retry:
            req.resolve(error=FleetError("router closed"))
        for h in self.replicas():
            with h.lock:
                pending = list(h.pending.values())
                h.pending.clear()
                h.alive = False
            for req in pending:
                req.resolve(error=FleetError("router closed"))
            h.channel.close()
            if h.receiver is not None:
                h.receiver.join(timeout_s)

    def __enter__(self) -> "FleetRouter":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
