"""Replica serving worker: one supervised endpoint process of the fleet.

Each replica is its own process owning one
:class:`~..registry.deployment.DeploymentController` over the shared
model registry:

* **the card, or the CPU when asked** - every workflow the replica
  loads into runs on ``--device`` (``cuda`` by default): the replica
  loads the registry-stable artifact, lowers it to the torch-fused
  program on that device and warms its buckets (``fused_backend`` rides
  the CLI).  Without CUDA and without ``--device cpu`` the worker
  raises at construction; it never scores on the CPU quietly.  Each
  replica is its own process, so each holds its own CUDA context;
* **device faults end the replica** - a :class:`~..parallel.kernels.
  KernelError` or ``torch.AcceleratorError`` while scoring or under a
  control verb is answered with an ``OP_ERROR`` of kind
  ``device_fault`` (no row) and then re-raised, so the process exits
  nonzero and the controller's supervision takes over; it is never
  turned into a per-request error while the replica keeps serving;
* **observability ships from birth** - the worker stamps its process
  instance (``--instance`` -> the Prometheus ``instance`` label and the
  obs shard filename) and runs a :class:`~..obs.fleet.ObsShipper`
  into the fleet aggregation dir, with per-replica ``fleet`` info
  (version/generation, rows scored, in-flight) merged into every shard
  - one scrape of the dir covers the whole fleet;
* **lifecycle over the control channel** - the router sends
  ``deploy`` / ``canary`` / ``promote_canary`` / ``rollback`` /
  ``status`` / ``stop`` control messages; a deploy is the
  zero-drop hot-swap (build+warm off-pointer, one pointer flip), run
  while the router has the replica DRAINED so in-flight batches
  finished on the old generation - the per-replica step of the
  fleet-wide rolling deploy;
* **bounded everything** - the serve loop runs on the channel's 50 ms
  quanta (style-gated), beats the supervision heartbeat file between
  messages, and a router that goes away (EOF) ends the worker cleanly.

Fault point ``fleet.replica_kill`` (``inject_kill``) dies mid-serve
exactly like a SIGKILL - the router's at-least-once failover and the
controller's restart-with-backoff are drilled against it.

Run as ``python -m transmogrifai_tpu_torch.fleet.worker --registry-root R
--workflow mod:fn --socket S --instance NAME [--device cuda|cpu] [...]``.
"""
from __future__ import annotations

import argparse
import importlib
import logging
import os
import threading
import time
from typing import Mapping, Optional

from ..faults import injection as _faults
from ..obs import set_process_instance
from ..obs.fleet import ObsShipper
from ..obs.metrics import metrics_registry
from ..parallel.kernels import is_device_fault
from ..registry import DeploymentController, ModelRegistry, RollbackPolicy
from ..utils.device import resolve_device
from ..workflow.supervisor import beat
from . import channel as _ch
from .multimodel import ModelTable, UnknownModelError, parse_models_arg
from .channel import (
    OP_CONTROL,
    OP_CONTROL_RESULT,
    OP_ERROR,
    OP_RESULT,
    OP_SCORE,
    ChannelClosedError,
    ChannelTimeoutError,
    FleetChannel,
    decode_records,
    encode_results,
)

log = logging.getLogger("transmogrifai_tpu_torch.fleet")

#: how long a freshly-started worker waits for its router to connect
#: before concluding it is orphaned (bounded in 50 ms accept quanta)
DEFAULT_ACCEPT_TIMEOUT_S = 300.0

#: heartbeat throttle: at most one beat per this interval
_BEAT_EVERY_S = 0.25

#: bound on any single response send: a router that stops DRAINING its
#: socket (frozen process, GIL stall) while staying connected must not
#: wedge the serve loop forever - the response is dropped (the router
#: retries or fails the request on its side) and the loop lives on
DEFAULT_SEND_TIMEOUT_S = 30.0


def load_workflow_factory(spec: str):
    """``module:function`` -> the zero-arg factory (the runner-CLI
    convention); the factory may return a workflow or a tuple whose
    first element is one."""
    mod_name, _, fn_name = spec.partition(":")
    if not mod_name or not fn_name:
        raise ValueError(
            f"workflow spec must be module:function, got {spec!r}")
    return getattr(importlib.import_module(mod_name), fn_name)


class ReplicaWorker:
    """One replica process: deployment controller + obs shipper behind
    a bounded fleet channel (module docstring)."""

    def __init__(
        self,
        registry_root: str,
        workflow_spec: str,
        socket_path: str,
        instance: str,
        version: Optional[str] = None,
        fleet_dir: Optional[str] = None,
        heartbeat_path: Optional[str] = None,
        fleet_status_path: Optional[str] = None,
        ship_interval_s: float = 0.5,
        accept_timeout_s: float = DEFAULT_ACCEPT_TIMEOUT_S,
        models: Optional[Mapping[str, str]] = None,
        model_cache_bytes: Optional[int] = None,
        max_resident_models: Optional[int] = None,
        evict_min_interval_s: Optional[float] = None,
        device: str = "cuda",
        **endpoint_kw,
    ) -> None:
        # raises here, before anything loads, when CUDA is asked for and
        # absent
        resolve_device(device)
        self.device = str(device)
        self.registry_root = registry_root
        self.workflow_spec = workflow_spec
        self.socket_path = socket_path
        self.instance = instance
        self.version = version
        self.fleet_dir = fleet_dir
        self.heartbeat_path = heartbeat_path
        self.fleet_status_path = fleet_status_path
        self.ship_interval_s = float(ship_interval_s)
        self.accept_timeout_s = float(accept_timeout_s)
        self._endpoint_kw = dict(endpoint_kw)
        self._factory = load_workflow_factory(workflow_spec)
        # live-retunable serving knobs: the
        # worker-side mirror of MicroBatchScheduler.retune - the
        # ``retune`` control verb applies them between batches.
        # max_batch_size caps the score-chunk size (smaller chunks pad
        # to smaller serving buckets); None = hand-set default (whole
        # batch, endpoint bucket chunking only)
        self.max_batch_size: Optional[int] = None
        self.max_wait_us: Optional[int] = None
        self.knob_source = "hand_set"
        self._stopping = False
        self._in_flight_rows = 0
        self.rows_scored = 0
        self.batches = 0
        #: batches refused because the caller's wire deadline had
        #: already passed on arrival (deadline propagation)
        self.deadline_dropped = 0
        #: wire-integrity counters folded across channel replacements
        self._wire: dict = {}
        self._chan: Optional[FleetChannel] = None
        self.started_at = time.monotonic()
        self.controller: Optional[DeploymentController] = None
        self.registry: Optional[ModelRegistry] = None
        self._shipper: Optional[ObsShipper] = None
        # multi-model hosting: N registry versions behind
        # this one serve lane, each with its own lifecycle, under a
        # weighted LRU over the resident models.  None until start()
        # (and stays None on a pure single-model replica with no
        # ``models`` map - zero new moving parts on the legacy path).
        self.initial_models = dict(models) if models else {}
        self.model_cache_bytes = model_cache_bytes
        self.max_resident_models = max_resident_models
        self.evict_min_interval_s = evict_min_interval_s
        self.models_table: Optional[ModelTable] = None

    def _fresh_workflow(self):
        """The factory's workflow, set to score on this replica's
        device before every registry load."""
        built = self._factory()
        wf = built[0] if isinstance(built, tuple) else built
        wf.device = self.device
        return wf

    # -- lifecycle ----------------------------------------------------------
    def start(self) -> "ReplicaWorker":
        set_process_instance(self.instance)
        self.registry = ModelRegistry(self.registry_root, create=False)
        self.controller = DeploymentController(
            registry=self.registry, policy=RollbackPolicy(),
            **self._endpoint_kw)
        if self.fleet_status_path:
            # satellite: the deploy summary's `fleet` view reads the
            # controller-published one-document fleet status instead of
            # re-reading N obs shards
            self.controller.fleet_status_source = self.fleet_status_path
        version = self.version or self.registry.stable
        if version is None:
            raise RuntimeError(
                f"registry at {self.registry_root} has no stable version "
                "to serve")
        self.controller.deploy_version(version, self._fresh_workflow())
        if self.initial_models:
            self._init_model_table()
        metrics_registry().register_view("fleet_replica", self)
        if self.fleet_dir:
            self._shipper = ObsShipper(
                self.fleet_dir, interval_s=self.ship_interval_s,
                instance=self.instance,
                extra_fn=lambda: {"fleet": self.replica_info()},
            ).start()
        return self

    def _init_model_table(self) -> None:
        """Bring the ModelTable up (lazily on the first model-scoped
        control verb, eagerly when ``models`` was configured) and host
        the initial map."""
        if self.models_table is None:
            table_kw: dict = {}
            if self.evict_min_interval_s is not None:
                table_kw["evict_min_interval_s"] = float(
                    self.evict_min_interval_s)
            self.models_table = ModelTable(
                self.registry, self._fresh_workflow,
                capacity_bytes=self.model_cache_bytes,
                max_resident=self.max_resident_models,
                policy=RollbackPolicy(), **table_kw,
                **self._endpoint_kw)
        for model_id, version in self.initial_models.items():
            if not self.models_table.has(model_id):
                self.models_table.host(model_id, version)

    def replica_info(self) -> dict:
        gen = self.controller.stable_generation if self.controller \
            else None
        can = self.controller.canary_generation if self.controller \
            else None
        table = self.models_table
        return {
            "instance": self.instance,
            "pid": os.getpid(),
            "device": self.device,
            "version": gen.version if gen else None,
            "generation": gen.generation if gen else None,
            "canary_version": can.version if can else None,
            "canary_generation": can.generation if can else None,
            "rows_scored": self.rows_scored,
            "batches": self.batches,
            "in_flight_rows": self._in_flight_rows,
            "deadline_dropped": self.deadline_dropped,
            "knobs": self.knobs(),
            "wire": self._wire_stats(),
            "uptime_s": round(time.monotonic() - self.started_at, 3),
            # multi-model hosting: per-model rows ride the
            # obs shard's `fleet` info, so `tx fleet status` and the
            # router's refresh_from_shards learn who hosts what without
            # a new wire verb
            "models": table.rows() if table is not None else [],
            "model_table": table.counters() if table is not None
            else None,
        }

    # -- live knobs ---------------------------------------------------------
    def knobs(self) -> dict:
        """Current live knobs + provenance (the
        ``MicroBatchScheduler.knobs()`` contract, worker-side)."""
        return {"max_batch_size": self.max_batch_size,
                "max_wait_us": self.max_wait_us,
                "source": self.knob_source}

    def retune(self, max_batch_size: Optional[int] = None,
               max_wait_us: Optional[int] = None,
               source: str = "autotune") -> dict:
        """Apply knob changes live, between batches (the
        ``MicroBatchScheduler.retune()`` contract: atomic attribute
        writes, returns what was applied).  ``max_batch_size <= 0``
        resets to the hand-set default (no chunk cap)."""
        applied: dict = {}
        if max_batch_size is not None:
            cap = int(max_batch_size)
            self.max_batch_size = cap if cap > 0 else None
            applied["max_batch_size"] = self.max_batch_size
        if max_wait_us is not None:
            # recorded for knob-contract parity; the single-threaded
            # serve loop has no micro-batch wait to apply it to
            self.max_wait_us = max(0, int(max_wait_us))
            applied["max_wait_us"] = self.max_wait_us
        if applied:
            self.knob_source = str(source)
        return applied

    def _wire_stats(self) -> dict:
        chan = self._chan
        live = chan.stats() if chan is not None else {}
        return {k: self._wire.get(k, 0) + live.get(k, 0)
                for k in set(self._wire) | set(live)}

    def snapshot(self) -> dict:
        """Metrics-view shape (kind ``fleet_replica``) so per-replica
        serving state rides the ordinary scrape."""
        return self.replica_info()

    def _beat(self, last: float) -> float:
        now = time.monotonic()
        if self.heartbeat_path and now - last >= _BEAT_EVERY_S:
            beat(self.heartbeat_path)
            return now
        return last

    def _send(self, chan: FleetChannel, op: int, rid: int, meta: dict,
              payload: bytes = b"") -> bool:
        """Every worker->router send is BOUNDED (the channel contract:
        a wedged peer must never block the serve loop forever).  A
        timed-out send drops the response - the router's failover/
        timeout machinery owns the request from there - and the worker
        keeps serving (and beating) instead of being stale-killed for
        the ROUTER's stall."""
        try:
            chan.send(op, rid, meta, payload,
                      timeout_s=DEFAULT_SEND_TIMEOUT_S)
            return True
        except ChannelTimeoutError as e:
            log.warning("replica %s: response %d dropped (router not "
                        "draining: %s)", self.instance, rid, e)
            return False

    # -- serving ------------------------------------------------------------
    def serve_forever(self) -> None:
        """Accept a router connection and serve it until EOF/protocol
        death or ``stop``, then accept again: after a network fault
        BOTH the router's readmission probe and the controller's
        restart path may reconnect, so losing one channel must not end
        the replica.  A worker nobody talks to within
        ``accept_timeout_s`` concludes it is orphaned and exits."""
        lsock = _ch.listen(self.socket_path)
        try:
            while not self._stopping:
                chan = self._accept_beating(lsock)
                if chan is None:
                    log.warning("no router connected to %s within "
                                "%.0fs; exiting", self.socket_path,
                                self.accept_timeout_s)
                    return
                self._chan = chan
                try:
                    self._serve_channel(chan, lsock)
                finally:
                    self._fold_wire(chan)
                    self._chan = None
                    chan.close()
        finally:
            try:
                lsock.close()
                os.unlink(self.socket_path)
            except OSError:
                pass  # socket file already gone (or TCP: never a file)
            if self._shipper is not None:
                self._shipper.stop()

    def _accept_beating(self,
                        lsock: "_ch.socket.socket"
                        ) -> Optional[FleetChannel]:
        """Bounded accept that keeps the supervision heartbeat alive:
        waiting for a router to (re)connect is a legitimate state, not
        staleness."""
        last_beat = 0.0
        deadline = time.monotonic() + self.accept_timeout_s
        while not self._stopping and time.monotonic() <= deadline:
            last_beat = self._beat(last_beat)
            chan = _ch.accept(lsock, timeout_s=_ch.QUANTUM_S)
            if chan is not None:
                return chan
        return None

    def _fold_wire(self, chan: FleetChannel) -> None:
        for k, v in chan.stats().items():
            self._wire[k] = self._wire.get(k, 0) + v

    def _serve_channel(self, chan: FleetChannel,
                       lsock: "_ch.socket.socket") -> None:
        """Single-threaded serve loop: decode -> score -> encode in
        order on the one scoring lane.  (A three-stage threaded
        pipeline was tried and measured SLOWER - the codec stages are
        GIL-bound, so splitting them onto threads only added switch
        overhead against the scoring thread's GIL hold.)

        On idle quanta the listener is polled: a NEWLY accepted
        connection replaces this channel (newest wins).  That resolves
        the probe-vs-restart reconnect race deterministically - the
        replica always serves whoever dialed last, and the older
        peer's next recv sees EOF and re-plans."""
        last_beat = 0.0
        while not self._stopping:
            last_beat = self._beat(last_beat)
            try:
                # idle_return: one 50 ms quantum with no traffic hands
                # control back so the loop can beat its heartbeat
                msg = chan.recv(idle_return=True)
            except ChannelClosedError:
                log.info("router disconnected; replica %s re-listening",
                         self.instance)
                return
            except _ch.ChannelProtocolError as e:
                log.warning("replica %s: protocol error on channel "
                            "(%s); dropping connection", self.instance,
                            e)
                return
            if msg is None:
                newer = _ch.accept(lsock, timeout_s=0.0)
                if newer is not None:
                    log.info("replica %s: newer connection accepted; "
                             "replacing current channel",
                             self.instance)
                    self._fold_wire(chan)
                    chan.close()
                    chan = newer
                    self._chan = newer
                continue
            op, rid, meta, payload = msg
            if op == _ch.OP_HELLO:
                self._send(chan, _ch.OP_HELLO, rid,
                           dict(chan.hello_reply_meta(),
                                instance=self.instance))
            elif op == OP_SCORE:
                self._handle_score(chan, rid, meta, payload)
            elif op == OP_CONTROL:
                self._handle_control(chan, rid, meta)

    def _handle_score(self, chan: FleetChannel, rid: int, meta: dict,
                      payload) -> None:
        # the slow-peer drill: scoring wall inflates exactly like a
        # replica thrashing under memory pressure - the router's
        # silence ceiling (response_timeout_s) is what must catch it
        _faults.inject_sleep("fleet.slow_peer")
        deadline_unix = meta.get("deadline_unix")
        if deadline_unix is not None and time.time() > float(deadline_unix):
            # the caller's deadline passed while this batch sat in a
            # queue (or a partitioned socket's kernel buffer): the
            # caller already gave up, so scoring it would be pure waste
            # - drop it and say so (kind="deadline" is shed accounting
            # on the router, not a worker failure)
            self.deadline_dropped += 1
            self._send(chan, OP_ERROR, rid,
                       {"error": "deadline already passed on arrival",
                        "kind": "deadline"})
            return
        try:
            records = decode_records(payload)
        except Exception as e:  # noqa: BLE001 - poison payload isolation
            if is_device_fault(e):
                self._answer_device_fault(chan, rid, e)
                raise
            self._send(chan, OP_ERROR, rid,
                       {"error": f"undecodable batch: "
                                 f"{type(e).__name__}: {e}"})
            return
        # the SIGKILL drill: dies here exactly like a preemption landing
        # mid-serve - the request is accepted but unanswered, and the
        # router must retry it on survivors
        _faults.inject_kill("fleet.replica_kill")
        # the bulk-job drill: a replica dying mid-shard while
        # a BulkScoringJob fans chunk batches across the fleet - the
        # router reassigns through ReplicaHealth, the job's journal
        # keeps the output shard exactly-once
        _faults.inject_kill("bulk.replica_die_midshard")
        self._in_flight_rows = len(records)
        # per-model dispatch: model_id rides the meta dict
        # (no wire-format change); absent -> the legacy single-model
        # lane, byte-for-byte today's path
        model_id = meta.get("model_id")
        try:
            results, info = self._score_records(records,
                                                model_id=model_id)
        except UnknownModelError as e:
            self._send(chan, OP_ERROR, rid,
                       {"error": str(e), "kind": "unknown_model",
                        "model_id": model_id})
            return
        except Exception as e:  # noqa: BLE001 - per-request isolation
            if is_device_fault(e):
                self._answer_device_fault(chan, rid, e)
                raise
            self._send(chan, OP_ERROR, rid,
                       {"error": f"{type(e).__name__}: {e}"})
            return
        finally:
            self._in_flight_rows = 0
        self.rows_scored += len(results)
        self.batches += 1
        out_meta = {
            "n_rows": len(results),
            "version": info.get("stable_version"),
            "generation": info.get("stable_generation"),
            "canary_rows": info.get("canary_rows", 0),
            "canary_version": info.get("canary_version"),
        }
        if model_id is not None:
            out_meta["model_id"] = info.get("model_id", model_id)
            if info.get("cold_hit"):
                out_meta["cold_hit"] = True
                out_meta["rehydrate_ms"] = info.get("rehydrate_ms")
        self._send(chan, OP_RESULT, rid, out_meta,
                   encode_results(results))

    def _answer_device_fault(self, chan: FleetChannel, rid: int,
                             e: Exception, **meta) -> None:
        """Tell the router, with a row-less ``device_fault`` error, that
        this request failed on the device; the caller re-raises, so the
        replica exits nonzero instead of serving on a card in an unknown
        state."""
        log.error("replica %s: device fault, exiting: %s: %s",
                  self.instance, type(e).__name__, e)
        self._send(chan, OP_ERROR, rid,
                   dict(meta, error=f"{type(e).__name__}: {e}",
                        kind="device_fault"))

    def _score_records(self, records: list,
                       model_id: Optional[str] = None) -> tuple:
        """Score one wire batch, honoring the live ``max_batch_size``
        chunk cap: smaller chunks pad to smaller serving buckets, which is
        exactly the knob the autoscaler's A/B retune probes.  Chunk
        canary_rows are summed; version/generation come from the last
        chunk (a deploy cannot land mid-batch - the replica is drained
        first).  With ``model_id`` the batch dispatches through the
        ModelTable instead of the default controller."""
        if model_id is not None:
            if self.models_table is None:
                raise UnknownModelError(
                    f"model {model_id!r}: this replica hosts no "
                    "multi-model table")
            score = lambda recs: self.models_table.score(  # noqa: E731
                model_id, recs)
        else:
            score = self.controller.score_batch_with_info
        cap = self.max_batch_size
        if not cap or len(records) <= cap:
            return score(records)
        results: list = []
        canary_rows = 0
        cold_hit = False
        rehydrate_ms = None
        info: dict = {}
        for i in range(0, len(records), cap):
            chunk, info = score(records[i:i + cap])
            results.extend(chunk)
            canary_rows += int(info.get("canary_rows", 0) or 0)
            if info.get("cold_hit"):
                cold_hit = True
                rehydrate_ms = info.get("rehydrate_ms")
        info = dict(info, canary_rows=canary_rows)
        if cold_hit:
            info["cold_hit"] = True
            info["rehydrate_ms"] = rehydrate_ms
        return results, info

    # -- control ------------------------------------------------------------
    def _handle_control(self, chan: FleetChannel, rid: int,
                        meta: dict) -> None:
        cmd = str(meta.get("cmd", ""))
        # a deploy/canary control blocks this lane for a whole model
        # load + endpoint build + warm (budgeted up to the router's
        # ctl timeout - minutes), so a side thread keeps the
        # supervision heartbeat alive: the controller's staleness rule
        # must not kill a replica for doing exactly what it was asked.
        # SCORING deliberately gets no such keeper - a wedged endpoint
        # stopping the beat is the liveness signal working.
        stop_beats = threading.Event()
        keeper = None
        if self.heartbeat_path:
            def _keep_beating() -> None:
                while not stop_beats.wait(0.25):
                    beat(self.heartbeat_path)
            keeper = threading.Thread(target=_keep_beating,
                                      name="tx-fleet-ctl-beats",
                                      daemon=True)
            keeper.start()
        try:
            doc = self._control(cmd, meta)
        except Exception as e:  # noqa: BLE001 - operator path isolation
            if is_device_fault(e):
                self._answer_device_fault(chan, rid, e, cmd=cmd)
                raise
            self._send(chan, OP_ERROR, rid,
                       {"error": f"{type(e).__name__}: {e}",
                        "cmd": cmd})
            return
        finally:
            stop_beats.set()
            if keeper is not None:
                keeper.join(timeout=2.0)
        self._send(chan, OP_CONTROL_RESULT, rid, {"cmd": cmd},
                   encode_results([doc]))

    def _control(self, cmd: str, meta: dict) -> dict:
        ctl = self.controller
        # a model-scoped verb (meta carries model_id) routes through
        # the ModelTable's per-model controller; without one it is the
        # legacy single-model lane, unchanged
        model_id = meta.get("model_id")
        if model_id is not None:
            return self._control_model(cmd, str(model_id), meta)
        if cmd == "ping":
            return {"ok": True, "instance": self.instance,
                    "pid": os.getpid()}
        if cmd == "status":
            return dict(self.replica_info(),
                        events=len(ctl.events()),
                        telemetry=self._stable_telemetry())
        if cmd == "models":
            table = self.models_table
            return {"ok": True,
                    "table": table.snapshot() if table else None}
        if cmd == "deploy":
            gen = ctl.deploy_version(str(meta["version"]),
                                     self._fresh_workflow())
            self._ship_soon()
            return {"ok": True, "version": gen.version,
                    "generation": gen.generation}
        if cmd == "canary":
            gen = ctl.start_canary_version(
                str(meta["version"]), self._fresh_workflow(),
                fraction=meta.get("fraction"),
                shadow=meta.get("shadow"),
            )
            self._ship_soon()
            return {"ok": True, "version": gen.version,
                    "generation": gen.generation}
        if cmd == "promote_canary":
            gen = ctl.promote_canary()
            self._ship_soon()
            return {"ok": True, "version": gen.version,
                    "generation": gen.generation}
        if cmd == "rollback":
            event = ctl.rollback_canary(
                reason=str(meta.get("reason", "fleet")))
            self._ship_soon()
            return {"ok": True, "rolled_back": event is not None,
                    "event": event}
        if cmd == "release_canary":
            event = ctl.release_canary(
                reason=str(meta.get("reason", "fleet")))
            self._ship_soon()
            return {"ok": True, "released": event is not None,
                    "event": event}
        if cmd == "check_canary":
            decision = ctl.check_canary()
            return {"ok": True,
                    "decision": decision.to_json() if decision else None}
        if cmd == "retune":
            applied = self.retune(
                max_batch_size=meta.get("max_batch_size"),
                max_wait_us=meta.get("max_wait_us"),
                source=str(meta.get("source", "autotune")))
            self._ship_soon()
            return {"ok": True, "applied": applied,
                    "knobs": self.knobs()}
        if cmd == "stop":
            self._stopping = True
            return {"ok": True, "stopping": True}
        raise ValueError(f"unknown fleet control command {cmd!r}")

    def _control_model(self, cmd: str, model_id: str,
                       meta: dict) -> dict:
        """Model-scoped control verbs: each hosted model's
        deploy/canary lifecycle is independent, so every single-model
        verb has a per-model twin selected by ``meta["model_id"]``."""
        if cmd in ("host", "deploy", "canary") \
                and self.models_table is None:
            # first model-scoped mutation on a legacy replica brings
            # the table up lazily
            self._init_model_table()
        table = self.models_table
        if table is None:
            raise UnknownModelError(
                f"model {model_id!r}: this replica hosts no "
                "multi-model table")
        if cmd in ("host", "deploy"):
            gen = table.host(model_id, str(meta["version"]))
            self._ship_soon()
            return {"ok": True, "model_id": model_id,
                    "version": gen.version,
                    "generation": gen.generation}
        if cmd == "unhost":
            table.unhost(model_id)
            self._ship_soon()
            return {"ok": True, "model_id": model_id,
                    "unhosted": True}
        if cmd == "canary":
            gen = table.start_canary(
                model_id, str(meta["version"]),
                fraction=meta.get("fraction"),
                shadow=meta.get("shadow"))
            self._ship_soon()
            return {"ok": True, "model_id": model_id,
                    "version": gen.version,
                    "generation": gen.generation}
        if cmd == "promote_canary":
            gen = table.promote_canary(model_id)
            self._ship_soon()
            return {"ok": True, "model_id": model_id,
                    "version": gen.version,
                    "generation": gen.generation}
        if cmd == "rollback":
            event = table.rollback_canary(
                model_id, reason=str(meta.get("reason", "fleet")))
            self._ship_soon()
            return {"ok": True, "model_id": model_id,
                    "rolled_back": event is not None, "event": event}
        if cmd == "release_canary":
            event = table.release_canary(
                model_id, reason=str(meta.get("reason", "fleet")))
            self._ship_soon()
            return {"ok": True, "model_id": model_id,
                    "released": event is not None, "event": event}
        if cmd == "check_canary":
            decision = table.check_canary(model_id)
            return {"ok": True, "model_id": model_id,
                    "decision": decision.to_json() if decision
                    else None}
        if cmd == "status":
            rows = [r for r in table.rows()
                    if r["model_id"] == model_id]
            if not rows:
                raise UnknownModelError(
                    f"model {model_id!r} is not hosted here")
            return dict(rows[0], ok=True)
        raise ValueError(
            f"unknown model-scoped fleet control command {cmd!r}")

    def _stable_telemetry(self) -> Optional[dict]:
        gen = self.controller.stable_generation
        if gen is None:
            return None
        snap = gen.endpoint.telemetry.snapshot()
        return {
            "rows_scored": snap["rows_scored"],
            "rows_failed": snap["rows_failed"],
            "latency_ms": snap["latency_ms"],
            "breaker": snap["breaker"],
        }

    def _ship_soon(self) -> None:
        """Ship the plane right after a lifecycle change so the
        aggregation dir reflects the new generation within one beat."""
        if self._shipper is not None:
            self._shipper._ship_once()


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        description="transmogrifai_tpu_torch fleet replica worker")
    p.add_argument("--registry-root", required=True)
    p.add_argument("--workflow", required=True,
                   help="module:function workflow factory")
    p.add_argument("--socket", required=True,
                   help="AF_UNIX socket path to serve on")
    p.add_argument("--instance", required=True,
                   help="replica instance name (obs shard + labels)")
    p.add_argument("--version", default=None,
                   help="registry version to serve (default: stable)")
    p.add_argument("--fleet-dir", default=None,
                   help="obs aggregation dir to ship shards into")
    p.add_argument("--heartbeat", default=None,
                   help="supervision heartbeat file to beat")
    p.add_argument("--fleet-status-path", default=None,
                   help="controller-published fleet_status.json (the "
                        "deploy summary's one-document fleet view)")
    p.add_argument("--ship-interval-s", type=float, default=0.5)
    p.add_argument("--accept-timeout-s", type=float,
                   default=DEFAULT_ACCEPT_TIMEOUT_S)
    p.add_argument("--buckets", default=None,
                   help="comma-separated serving shape buckets")
    p.add_argument("--drift-policy", default="warn",
                   choices=("raise", "warn", "shed"))
    p.add_argument("--fused-backend", default=None,
                   choices=("auto", "numpy", "torch"))
    p.add_argument("--device", default="cuda",
                   help="where every loaded workflow scores (cuda|cpu); "
                        "cuda raises without a card")
    p.add_argument("--canary-fraction", type=float, default=0.05)
    p.add_argument("--models", default=None,
                   help="host N models: model_id=version[,model_id="
                        "version...] (multi-model serving)")
    p.add_argument("--model-cache-bytes", type=int, default=None,
                   help="weighted-LRU byte budget over hosted models' "
                        "artifact bytes")
    p.add_argument("--max-resident-models", type=int, default=None,
                   help="cap on concurrently-resident hosted models")
    p.add_argument("--evict-min-interval-s", type=float, default=None,
                   help="minimum spacing between LRU evictions (thrash "
                        "rate bound)")
    args = p.parse_args(argv)
    endpoint_kw: dict = {
        "drift_policy": args.drift_policy,
        "canary_fraction": args.canary_fraction,
    }
    if args.buckets:
        endpoint_kw["batch_buckets"] = tuple(
            int(b) for b in args.buckets.split(","))
    if args.fused_backend:
        endpoint_kw["fused_backend"] = args.fused_backend
    worker = ReplicaWorker(
        registry_root=args.registry_root,
        workflow_spec=args.workflow,
        socket_path=args.socket,
        instance=args.instance,
        version=args.version,
        fleet_dir=args.fleet_dir,
        heartbeat_path=args.heartbeat,
        fleet_status_path=args.fleet_status_path,
        ship_interval_s=args.ship_interval_s,
        accept_timeout_s=args.accept_timeout_s,
        models=parse_models_arg(args.models) if args.models else None,
        model_cache_bytes=args.model_cache_bytes,
        max_resident_models=args.max_resident_models,
        evict_min_interval_s=args.evict_min_interval_s,
        device=args.device,
        **endpoint_kw,
    )
    worker.start()
    worker.serve_forever()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
