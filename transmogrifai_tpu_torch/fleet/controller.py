"""Fleet lifecycle: spawn/supervise N replicas, rolling hot-swap,
fleet-wide canary with aggregated rollback signals.

The control plane of the scale-out serving fleet, with the
registry as the source of truth for WHAT each replica serves:

* **supervised replicas** - N :mod:`~.worker` processes, each scoring
  on ``device`` (the card by default, every replica with its own CUDA
  context; ``device="cpu"`` for a CPU fleet), spawned with the
  trace-context env seam, each beating a heartbeat file; a dead or
  heartbeat-stale replica is killed (if needed) and re-dispatched with
  the exponential backoff, while the router fails its in-flight
  requests over to survivors (at-least-once, no lost accepted
  requests).
* **rolling hot-swap** - :meth:`FleetController.rolling_deploy` flips
  generations ONE replica at a time: drain (router stops dispatching,
  in-flight batches finish on the old generation), send the ``deploy``
  control (the worker's zero-drop pointer flip), undrain, next
  replica.  Traffic keeps flowing to the rest of the fleet the whole
  time - zero dropped, zero mixed-generation responses.
* **fleet-wide canary** - :meth:`start_canary` brings the candidate up
  on every replica at one deterministic hash fraction;
  :meth:`check_canary` merges the per-replica stable/canary telemetry
  from the obs aggregation dir (sum counters, max p99/drift - the
  fleet rollup convention) and evaluates the
  :class:`~..registry.rollback.RollbackPolicy` plus the fleet
  :class:`~..obs.slo.SLOEngine` over the merged docs: one firing
  fleet-level SLO rolls the canary back across ALL replicas.
* **one consistent status document** - the controller atomically
  publishes ``fleet_status.json`` (per-replica generation, heartbeat
  age, in-flight, restart budget) which ``tx fleet status``, the
  workers' deploy summaries, and operators read instead of N shard
  re-reads; ``tx fleet drain`` drops command files the controller
  applies.
"""
from __future__ import annotations

import json
import logging
import os
import socket
import subprocess
import sys
import tempfile
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Optional, Sequence

from ..obs.fleet import (
    FleetAggregator,
    ObsShipper,
    child_env,
    read_json_torn_safe,
)
from ..obs.slo import SLOEngine, default_objectives
from ..parallel.kernels import is_device_fault
from ..registry import ModelRegistry, RollbackDecision, RollbackPolicy
from ..utils.device import resolve_device
from ..workflow.supervisor import backoff_delay_s, staleness
from .channel import QUANTUM_S
from .multimodel import (
    PlacementPlan,
    PlacementPlanner,
    UnhostedModelError,
    artifact_cache_bytes,
    format_models_arg,
)
from .router import FleetError, FleetRouter, FleetWorkerError

log = logging.getLogger("transmogrifai_tpu_torch.fleet")

LOG_PREFIX = "op_fleet_metrics"

#: fleet status document filename (atomically replaced in control_dir)
STATUS_FILENAME = "fleet_status.json"

#: drain/undrain command files dropped by ``tx fleet drain``
COMMANDS_DIR = "commands"


def _free_port(host: str = "127.0.0.1") -> int:
    """An ephemeral port the OS just proved free on ``host`` (the
    standard bind-0 probe; the worker re-binds it with SO_REUSEADDR, so
    the close->rebind race is benign on loopback and the port stays
    STABLE across replica restarts - the router's readmission probe
    reconnects to the same address the fleet was built with)."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind((host, 0))
        return int(s.getsockname()[1])


def merge_serving_snapshots(snaps: Sequence[dict]) -> dict:
    """Merge per-replica ServingTelemetry snapshots into ONE
    RollbackPolicy-consumable snapshot: counters SUM (how much fleet
    traffic failed), p99/drift MAX (how bad is the worst replica) -
    the FleetAggregator rollup convention applied to the rollback
    signal set."""
    out: dict = {
        "rows_scored": 0, "rows_failed": 0,
        "breaker": {"opens": 0, "closes": 0, "probes": 0,
                    "rows_shed": 0, "rows_nonfinite": 0},
        "latency_ms": {"p50": None, "p95": None, "p99": None},
        "data_contract": {"drift_js_max": 0.0},
        "model_version": None, "generation": None,
        "replicas": 0,
    }
    for snap in snaps:
        if not isinstance(snap, dict):
            continue
        out["replicas"] += 1
        out["rows_scored"] += int(snap.get("rows_scored", 0) or 0)
        out["rows_failed"] += int(snap.get("rows_failed", 0) or 0)
        for k in out["breaker"]:
            out["breaker"][k] += int(
                (snap.get("breaker") or {}).get(k, 0) or 0)
        for p in ("p50", "p95", "p99"):
            v = (snap.get("latency_ms") or {}).get(p)
            if v is not None and (out["latency_ms"][p] is None
                                  or v > out["latency_ms"][p]):
                out["latency_ms"][p] = v
        drift = (snap.get("data_contract") or {}).get("drift_js_max")
        if drift is not None and drift > out["data_contract"][
                "drift_js_max"]:
            out["data_contract"]["drift_js_max"] = drift
        if out["model_version"] is None:
            out["model_version"] = snap.get("model_version")
            out["generation"] = snap.get("generation")
    return out


@dataclass
class _Replica:
    index: int
    instance: str
    socket_path: str
    heartbeat_path: str
    proc: Optional[subprocess.Popen] = None
    restarts: int = 0
    restart_at: Optional[float] = None  # monotonic; None = not scheduled
    gave_up: bool = False
    #: a reconnect thread is in flight (the connect can take as long as
    #: a replica warm-up; supervision of the REST of the fleet must not
    #: stall behind it)
    reconnecting: bool = False
    #: a scale-down drain is in flight: supervision must NOT restart
    #: this replica when its process exits - retirement owns it
    retiring: bool = False
    events: list = field(default_factory=list)


class FleetController:
    """Spawn, supervise, and lifecycle a replica fleet (module
    docstring)."""

    def __init__(
        self,
        registry_root: str,
        workflow_spec: str,
        n_replicas: int = 2,
        work_dir: Optional[str] = None,
        fleet_dir: Optional[str] = None,
        control_dir: Optional[str] = None,
        version: Optional[str] = None,
        policy: Optional[RollbackPolicy] = None,
        slo_objectives: Optional[list] = None,
        router_kw: Optional[dict] = None,
        worker_args: Optional[Sequence[str]] = None,
        worker_env: Optional[dict] = None,
        worker_env_overrides: Optional[dict] = None,
        transport: str = "unix",
        tcp_host: str = "127.0.0.1",
        ship_router_obs: bool = False,
        max_restarts: int = 2,
        stale_after_s: float = 60.0,
        connect_timeout_s: float = 180.0,
        ship_interval_s: float = 0.25,
        use_cost_model: bool = True,
        monitor_interval_s: float = 0.2,
        eject_after: Optional[int] = None,
        probe_interval_s: Optional[float] = None,
        probe_timeout_s: Optional[float] = None,
        models: Optional[dict] = None,
        placement: Optional[PlacementPlanner] = None,
        device: str = "cuda",
    ) -> None:
        if n_replicas < 1:
            raise ValueError("n_replicas must be >= 1")
        # a CUDA fleet on a host without CUDA fails here, not as N
        # workers dying at start-up
        resolve_device(device)
        #: where every replica scores (``--device`` of each worker)
        self.device = str(device)
        self.registry_root = registry_root
        self.workflow_spec = workflow_spec
        self.n_replicas = int(n_replicas)
        self.work_dir = work_dir or tempfile.mkdtemp(prefix="tx-fleet-")
        self.fleet_dir = fleet_dir or os.path.join(self.work_dir, "obs")
        self.control_dir = control_dir or os.path.join(self.work_dir,
                                                       "control")
        self.version = version
        self.worker_args = list(worker_args or ())
        self.worker_env = dict(worker_env or {})
        #: per-instance env on top of ``worker_env`` (e.g. arming
        #: TX_FAULTS on exactly one replica for a partition drill)
        self.worker_env_overrides = dict(worker_env_overrides or {})
        if transport not in ("unix", "tcp"):
            raise ValueError(
                f"transport must be 'unix' or 'tcp', got {transport!r}")
        #: "unix" keeps the on-host fast path; "tcp" binds each replica
        #: to ``tcp_host:<ephemeral>`` - the cross-host wire, drillable
        #: on loopback
        self.transport = transport
        self.tcp_host = tcp_host
        #: ship the ROUTER process's obs (the fleet_router/fleet_health
        #: views) as its own shard so one scrape of the aggregation dir
        #: includes ejection/readmission gauges; off by default - a
        #: controller embedded in a test/serving process would ship that
        #: process's unrelated views too
        self.ship_router_obs = bool(ship_router_obs)
        self._router_shipper: Optional[ObsShipper] = None
        self.max_restarts = int(max_restarts)
        self.stale_after_s = float(stale_after_s)
        self.connect_timeout_s = float(connect_timeout_s)
        self.ship_interval_s = float(ship_interval_s)
        self.use_cost_model = bool(use_cost_model)
        self.monitor_interval_s = max(0.05, float(monitor_interval_s))
        self.registry = ModelRegistry(registry_root, create=False)
        self.aggregator = FleetAggregator(self.fleet_dir)
        self.slo_engine = SLOEngine(
            slo_objectives if slo_objectives is not None
            else default_objectives(),
            doc_fn=self.aggregator.merged_metrics_docs,
            register=False,
        )
        self.policy = policy if policy is not None else RollbackPolicy()
        self.policy.slo_engine = self.slo_engine
        self._router_kw = dict(router_kw or {})
        # ReplicaHealth eject/readmit knobs surfaced here
        # instead of router_kw-only: explicit kwargs win
        # over router_kw defaults, None leaves the router's own
        for knob, val in (("eject_after", eject_after),
                          ("probe_interval_s", probe_interval_s),
                          ("probe_timeout_s", probe_timeout_s)):
            if val is not None:
                self._router_kw[knob] = val
        self.router: Optional[FleetRouter] = None
        self.canary_version: Optional[str] = None
        # multi-model serving: {model_id: version} hosted
        # across the fleet; the placement planner decides co-residency
        # and is re-run on membership changes
        self.models = {str(k): str(v)
                       for k, v in (models or {}).items()}
        self.placement_planner = placement
        if self.models and self.placement_planner is None:
            self.placement_planner = PlacementPlanner()
        self.placement: Optional[PlacementPlan] = None
        #: per-model in-flight fleet canaries: {model_id: version} -
        #: each hosted model's lifecycle is independent of the fleet's
        #: single-model canary slot above
        self.model_canaries: dict[str, str] = {}
        #: attached by :class:`~.autoscaler.FleetAutoscaler.start` -
        #: folds its decision snapshot into ``status()`` /
        #: ``fleet_status.json``
        self.autoscaler = None
        self._next_index = 0
        self._replicas: dict[str, _Replica] = {}
        self._events: list[dict] = []
        self._events_lock = threading.Lock()
        self._stop = threading.Event()
        self._monitor: Optional[threading.Thread] = None
        self.started = False

    # -- lifecycle ----------------------------------------------------------
    def _event(self, event: str, **kw: Any) -> None:
        entry = {"event": event, "t": time.time(), **kw}
        with self._events_lock:
            self._events.append(entry)
            if len(self._events) > 256:
                del self._events[0]

    def start(self) -> "FleetController":
        os.makedirs(self.work_dir, exist_ok=True)
        os.makedirs(self.fleet_dir, exist_ok=True)
        os.makedirs(os.path.join(self.control_dir, COMMANDS_DIR),
                    exist_ok=True)
        cost_model = self._load_cost_model() if self.use_cost_model \
            else None
        self.router = FleetRouter(cost_model=cost_model,
                                  **self._router_kw)
        if self.ship_router_obs:
            self._router_shipper = ObsShipper(
                self.fleet_dir, interval_s=self.ship_interval_s,
                instance="router").start()
        try:
            for _ in range(self.n_replicas):
                rep = self._new_replica()
                self._replicas[rep.instance] = rep
            # place BEFORE spawning so each worker's --models carries
            # exactly its assigned co-residency set
            self._replan_placement(reason="fleet_start")
            for rep in self._replicas.values():
                self._spawn(rep)
            # connect AFTER spawning: replicas warm concurrently
            for rep in self._replicas.values():
                self.router.add_replica(
                    rep.instance, rep.socket_path,
                    connect_timeout_s=self.connect_timeout_s,
                    pid=rep.proc.pid if rep.proc else None)
            if self.placement is not None:
                self.router.set_hosting(self.placement.assignments)
        except BaseException:
            # a partially-failed bring-up (bad workflow spec, worker
            # crash at startup) must not leak spawned processes, the
            # router's threads, or its registered metrics view onto the
            # caller - `with FleetController(...)` never reaches
            # __exit__ when start() raises
            self.stop(timeout_s=5.0)
            raise
        self._event("fleet_start", replicas=self.n_replicas,
                    registry=self.registry_root)
        self.started = True
        self._write_status()
        self._monitor = threading.Thread(
            target=self._monitor_loop, name="tx-fleet-monitor",
            daemon=True)
        self._monitor.start()
        log.info("%s fleet up: %d replicas over %s", LOG_PREFIX,
                 self.n_replicas, self.registry_root)
        return self

    def _load_cost_model(self):
        """The cost model rides the deployed artifact
        (``autotune.json`` next to the model); when present the router
        weights its dispatch with it."""
        try:
            version = self.version or self.registry.stable
            if version is None:
                return None
            path = os.path.join(self.registry.artifact_path(version),
                                "autotune.json")
            if not os.path.exists(path):
                return None
            from ..autotune import CostModel

            cm = CostModel.load(path)
            log.info("%s router dispatch weighted by cost model %s",
                     LOG_PREFIX, path)
            return cm
        except Exception as e:  # noqa: BLE001 - weighting is optional
            if is_device_fault(e):
                raise
            log.warning("cost model load failed (round-robin-ish "
                        "weights): %s", e)
            return None

    def _new_replica(self) -> _Replica:
        """Allocate the next replica slot (monotonic index: a retired
        ``replica-2`` is never reused for a later scale-up, so events,
        heartbeat files, and trace history stay unambiguous)."""
        i = self._next_index
        self._next_index += 1
        if self.transport == "tcp":
            address = f"{self.tcp_host}:{_free_port(self.tcp_host)}"
        else:
            address = os.path.join(self.work_dir, f"replica-{i}.sock")
        return _Replica(
            index=i,
            instance=f"replica-{i}",
            socket_path=address,
            heartbeat_path=os.path.join(self.work_dir,
                                        f"replica-{i}.hb"),
        )

    def _worker_cmd(self, rep: _Replica) -> list[str]:
        cmd = [
            sys.executable, "-m", "transmogrifai_tpu_torch.fleet.worker",
            "--registry-root", self.registry_root,
            "--workflow", self.workflow_spec,
            "--socket", rep.socket_path,
            "--instance", rep.instance,
            "--heartbeat", rep.heartbeat_path,
            "--fleet-dir", self.fleet_dir,
            "--fleet-status-path",
            os.path.join(self.control_dir, STATUS_FILENAME),
            "--ship-interval-s", str(self.ship_interval_s),
            "--device", self.device,
        ]
        if self.version:
            cmd += ["--version", self.version]
        assigned = self._models_for_instance(rep.instance)
        if assigned:
            cmd += ["--models", format_models_arg(assigned)]
        cmd += self.worker_args
        return cmd

    def _models_for_instance(self, instance: str) -> dict:
        """{model_id: version} this replica should host under the
        current placement plan (all configured models when no plan has
        been computed yet)."""
        if not self.models:
            return {}
        if self.placement is None:
            return dict(self.models)
        return {m: self.models[m]
                for m in self.placement.models_for(instance)
                if m in self.models}

    def _spawn(self, rep: _Replica) -> None:
        env = child_env(dict(
            os.environ, **self.worker_env,
            **self.worker_env_overrides.get(rep.instance, {})))
        # the package is not pip-installed: children import it from the
        # repo root, wherever the controller process found it
        repo_root = os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))))
        env["PYTHONPATH"] = repo_root + os.pathsep + env.get(
            "PYTHONPATH", "")
        stale_files = [rep.heartbeat_path]
        if self.transport != "tcp":
            stale_files.append(rep.socket_path)
        for stale in stale_files:
            # the DEAD incarnation's heartbeat file must go too: its
            # frozen mtime is by construction older than stale_after_s
            # by restart time, and judging the fresh warming process by
            # it would stale-kill every restart (staleness() returns
            # None until the new process actually beats)
            try:
                os.unlink(stale)
            except OSError:
                pass  # nothing stale to clear
        rep.proc = subprocess.Popen(self._worker_cmd(rep), env=env)
        rep.events.append({"event": "spawn", "pid": rep.proc.pid,
                           "t": time.time()})

    # -- supervision --------------------------------------------------------
    def _monitor_loop(self) -> None:
        last_status = 0.0
        last_refresh = 0.0
        while not self._stop.wait(self.monitor_interval_s):
            try:
                self._check_replicas()
                self._poll_commands()
                now = time.monotonic()
                shards = None
                if now - last_refresh >= 0.5:
                    last_refresh = now
                    # ONE shard read serves both the weight refresh and
                    # the status publish this tick - shards carry the
                    # whole span ring, and double-parsing them twice a
                    # second is pure waste
                    shards = self.aggregator.shards()
                    self.router.refresh_from_shards([
                        dict(d.get("metrics", {}),
                             instance=str(d.get("instance")))
                        for d in shards
                    ])
                if now - last_status >= 0.5:
                    last_status = now
                    self._write_status(shards=shards)
            except Exception as e:  # noqa: BLE001 - supervision must survive
                if is_device_fault(e):
                    raise
                log.exception("fleet monitor loop error")

    def _reconnect(self, rep: _Replica) -> None:
        """Connect a restarted worker's channel on a side thread: the
        connect blocks for the replica's whole warm-up (up to
        ``connect_timeout_s``), and the monitor loop must keep
        supervising the REST of the fleet - heartbeat kills, drain
        commands, status publishing - meanwhile."""
        try:
            self.router.add_replica(
                rep.instance, rep.socket_path,
                connect_timeout_s=self.connect_timeout_s,
                pid=rep.proc.pid if rep.proc else None)
            self._event("replica_restarted", instance=rep.instance,
                        attempt=rep.restarts)
        except Exception as e:  # noqa: BLE001 - keep supervising
            if is_device_fault(e):
                raise
            log.warning("restarted replica %s did not come up: %s",
                        rep.instance, e)
        finally:
            rep.reconnecting = False

    def _check_replicas(self) -> None:
        for rep in list(self._replicas.values()):
            if rep.gave_up or rep.proc is None or rep.reconnecting \
                    or rep.retiring:
                continue
            rc = rep.proc.poll()
            stale = staleness(rep.heartbeat_path)
            if rc is None and stale is not None \
                    and stale > self.stale_after_s:
                # alive but wedged: the supervision rule - kill it and
                # let the restart path take over (restart with backoff)
                log.warning("%s replica %s heartbeat stale %.0fs: "
                            "killing", LOG_PREFIX, rep.instance, stale)
                rep.proc.kill()
                try:
                    rep.proc.wait(timeout=30.0)
                except subprocess.TimeoutExpired:
                    continue  # D-state child: retry next tick
                rc = rep.proc.returncode
            if rc is None:
                continue
            # dead: the router's receiver notices the closed channel on
            # its own and fails in-flight work over; supervision owns
            # the restart budget
            handle = None
            try:
                handle = self.router.handle(rep.instance)
            except FleetError:
                pass
            if handle is not None and handle.alive:
                self.router._on_replica_dead(
                    handle, f"process exit {rc}")
            if rep.restart_at is None:
                if rep.restarts >= self.max_restarts:
                    rep.gave_up = True
                    self._event("replica_gave_up", instance=rep.instance,
                                exit_code=rc, restarts=rep.restarts)
                    log.error("%s replica %s exhausted its restart "
                              "budget (%d)", LOG_PREFIX, rep.instance,
                              rep.restarts)
                    continue
                import random

                delay = backoff_delay_s(rep.restarts, 0.2, 10.0, 0.1,
                                        random.Random(rep.index))
                rep.restart_at = time.monotonic() + delay
                self._event("replica_down", instance=rep.instance,
                            exit_code=rc, backoff_s=round(delay, 3))
            elif time.monotonic() >= rep.restart_at:
                rep.restart_at = None
                rep.restarts += 1
                self._spawn(rep)
                rep.reconnecting = True
                threading.Thread(
                    target=self._reconnect, args=(rep,),
                    name=f"tx-fleet-reconnect-{rep.instance}",
                    daemon=True).start()

    def _poll_commands(self) -> None:
        """Apply (and consume) ``tx fleet drain`` command files."""
        cdir = os.path.join(self.control_dir, COMMANDS_DIR)
        try:
            names = os.listdir(cdir)
        except OSError:
            return
        for name in names:
            if not name.endswith(".json"):
                continue
            path = os.path.join(cdir, name)
            doc = read_json_torn_safe(path)
            if doc is None:
                continue  # torn write in flight: retry next tick
            instance = str(doc.get("replica", name[:-len(".json")]))
            try:
                drained = bool(doc.get("drain", True))
                self.router.set_drained(instance, drained)
                self._event("drain" if drained else "undrain",
                            instance=instance, source="command_file")
            except FleetError as e:
                self._event("command_rejected", instance=instance,
                            error=str(e))
            try:
                os.unlink(path)
            except OSError as e:
                log.warning("could not consume command file %s: %s",
                            path, e)

    # -- elastic membership --------------------------------------
    def member_instances(self) -> list[str]:
        """Instance names the controller currently OWNS (spawned, not
        retiring) - the autoscaler's notion of fleet size.  A replica
        mid-backoff or gave-up still counts as a member; capacity
        accounting (not membership) handles its missing throughput."""
        return [r.instance for r in self._replicas.values()
                if not r.retiring]

    def gave_up_instances(self) -> list[str]:
        """Members whose restart budget is exhausted: dead weight the
        supervisor will never bring back.  The autoscaler replaces
        their CAPACITY (sized from demand) instead of blindly
        restarting 1:1."""
        return [r.instance for r in self._replicas.values()
                if r.gave_up and not r.retiring]

    def add_replica(self, probe_timeout_s: float = 30.0) -> str:
        """Grow the fleet by one replica with probe-gated admission:
        spawn at the next free index (loading and warming on the fleet's
        device like any bring-up), connect it DRAINED so no score
        traffic can reach it, health-probe it with a ``ping`` control
        round trip, and only then undrain.  A replica that fails to
        warm or answer the probe is reaped and never admitted - a bad
        scale-up is a no-op, not a degraded fleet."""
        rep = self._new_replica()
        self._replicas[rep.instance] = rep
        # re-plan placement BEFORE spawning so the new worker's
        # --models carries exactly its assigned co-residency set
        self._replan_placement(reason=f"scale_up:{rep.instance}")
        self._spawn(rep)
        try:
            self.router.add_replica(
                rep.instance, rep.socket_path,
                connect_timeout_s=self.connect_timeout_s,
                pid=rep.proc.pid if rep.proc else None,
                drained=True)
            self.router.control(rep.instance, "ping",
                                timeout_s=probe_timeout_s)
            self.router.set_drained(rep.instance, False)
            if self.placement is not None:
                # existing replicas may have lost/gained assignments
                # under the new plan: converge them
                self._reconcile_hosting()
        except BaseException:
            # failed bring-up must not leak the process or a dead
            # handle: reap both, leave the fleet exactly as it was
            self._replicas.pop(rep.instance, None)
            self.router.remove_replica(rep.instance,
                                       reason="admission failed")
            self._replan_placement(
                reason=f"admission_failed:{rep.instance}")
            if rep.proc is not None and rep.proc.poll() is None:
                rep.proc.kill()
                try:
                    rep.proc.wait(timeout=10.0)
                except subprocess.TimeoutExpired:
                    log.warning("unadmitted replica %s did not reap",
                                rep.instance)
            raise
        self.n_replicas = len(self.member_instances())
        self._event("replica_added", instance=rep.instance,
                    pid=rep.proc.pid if rep.proc else None,
                    members=self.n_replicas)
        self._write_status()
        log.info("%s replica %s admitted after health probe "
                 "(%d members)", LOG_PREFIX, rep.instance,
                 self.n_replicas)
        return rep.instance

    def remove_replica(self, instance: str,
                       drain_timeout_s: float = 30.0) -> dict:
        """Shrink the fleet by retiring ``instance``, shed-never-hang:
        mark it retiring (supervision stops restarting it), drain via
        the router (no new dispatches; in-flight batches finish), then
        retire the handle and terminate the process.  A victim that
        dies mid-drain - SIGKILL included - is already owned by the
        router's failover: anything it stranded re-dispatches to
        survivors, and removal proceeds."""
        rep = self._replicas.get(instance)
        if rep is None:
            raise FleetError(f"unknown replica {instance!r}")
        if rep.retiring:
            return {"instance": instance, "already_retiring": True}
        rep.retiring = True
        report: dict = {"instance": instance, "drained": False}
        t0 = time.perf_counter()
        try:
            self.router.set_drained(instance, True)
            report["drained"] = self.router.wait_drained(
                instance, drain_timeout_s)
        except FleetError:
            # already out of router membership (died mid-drain and a
            # racing removal reaped the handle): failover owned its
            # in-flight work, nothing left to drain
            report["drained"] = True
        self.router.remove_replica(instance, reason="scale_down")
        if rep.proc is not None and rep.proc.poll() is None:
            rep.proc.terminate()
            deadline = time.monotonic() + 10.0
            while rep.proc.poll() is None \
                    and time.monotonic() < deadline:
                time.sleep(QUANTUM_S)
            if rep.proc.poll() is None:
                rep.proc.kill()
                try:
                    rep.proc.wait(timeout=10.0)
                except subprocess.TimeoutExpired:
                    log.warning("retired replica %s did not reap",
                                instance)
        self._replicas.pop(instance, None)
        self.n_replicas = max(1, len(self.member_instances()))
        if self.models:
            # the victim's hosted models need their replication copies
            # back on survivors: re-plan and converge
            self._replan_placement(reason=f"scale_down:{instance}")
            self._reconcile_hosting()
        report["drain_s"] = round(time.perf_counter() - t0, 4)
        self._event("replica_retired", **report,
                    members=len(self.member_instances()))
        self._write_status()
        log.info("%s replica %s retired (drained=%s, %.2fs, %d "
                 "members left)", LOG_PREFIX, instance,
                 report["drained"], report["drain_s"],
                 len(self.member_instances()))
        return report

    # -- multi-model placement -----------------------------------
    def _replan_placement(self,
                          reason: str = "membership"
                          ) -> Optional[PlacementPlan]:
        """Re-run the placement planner over current membership and
        push the hosting map to the router.  Called at fleet start and
        on every membership change (scale-up/down re-balances
        co-residency)."""
        if not self.models or self.placement_planner is None:
            return None
        if (self.placement_planner.cost_model is None
                and self.router is not None
                and self.router.cost_model is not None):
            self.placement_planner.cost_model = self.router.cost_model
        instances = self.member_instances()
        if not instances:
            return None
        specs = [
            {"model_id": m, "version": v,
             "weight_bytes": artifact_cache_bytes(self.registry, v)}
            for m, v in sorted(self.models.items())
        ]
        self.placement = self.placement_planner.plan(specs, instances)
        if self.router is not None:
            self.router.set_hosting(self.placement.assignments)
        self._event("placement_replan", reason=reason,
                    rev=self.placement.rev,
                    assignments=self.placement.assignments)
        log.info("%s placement re-planned (%s): rev %d", LOG_PREFIX,
                 reason, self.placement.rev)
        return self.placement

    def _reconcile_hosting(self, ctl_timeout_s: float = 300.0) -> dict:
        """Converge every live replica's ModelTable onto the current
        placement plan: host what the plan assigns it but it lacks,
        unhost what the plan moved away.  Per-replica errors are
        captured (one slow/broken replica must not abort fleet-wide
        convergence); a pinned model (canary in flight) stays put."""
        if self.placement is None:
            return {}
        report: dict = {}
        for h in list(self.router.live_replicas()):
            want = set(self.placement.models_for(h.instance))
            steps: list = []
            try:
                doc = self.router.control(h.instance, "models",
                                          timeout_s=ctl_timeout_s)
                table = (doc or {}).get("table") or {}
                have = {str(r["model_id"])
                        for r in table.get("models", [])}
            except (FleetError, FleetWorkerError) as e:
                report[h.instance] = {"error": str(e)}
                continue
            for model_id in sorted(want - have):
                try:
                    self.router.control(
                        h.instance, "host",
                        {"model_id": model_id,
                         "version": self.models[model_id]},
                        timeout_s=ctl_timeout_s)
                    steps.append({"host": model_id})
                except (FleetError, FleetWorkerError) as e:
                    steps.append({"host": model_id, "error": str(e)})
            for model_id in sorted(have - want):
                try:
                    self.router.control(h.instance, "unhost",
                                        {"model_id": model_id},
                                        timeout_s=ctl_timeout_s)
                    steps.append({"unhost": model_id})
                except (FleetError, FleetWorkerError) as e:
                    steps.append({"unhost": model_id, "error": str(e)})
            report[h.instance] = {"steps": steps}
        self.router.set_hosting(self.placement.assignments)
        if any(r for r in report.values() if r.get("steps")):
            self._event("hosting_reconciled", report=report)
        return report

    def model_hosts(self, model_id: str) -> list[str]:
        """Live replica instances hosting ``model_id`` (the router's
        converged view, which follows the placement plan)."""
        return [inst for inst, models
                in self.router.hosting_map().items()
                if model_id in models]

    def _hosting_instances(self, model_id: str) -> list[str]:
        hosts = self.model_hosts(model_id)
        if not hosts:
            raise UnhostedModelError(
                f"no live replica hosts model {model_id!r} "
                f"(hosting: {self.router.hosting_map()})")
        return hosts

    def host_model(self, model_id: str, version: str,
                   ctl_timeout_s: float = 300.0) -> dict:
        """Add (or hot-swap) one hosted model fleet-wide: record it in
        the model map, re-plan placement, and converge the replicas."""
        self.models[str(model_id)] = str(version)
        self._replan_placement(reason=f"host:{model_id}")
        report = self._reconcile_hosting(ctl_timeout_s=ctl_timeout_s)
        self._write_status()
        return report

    def unhost_model(self, model_id: str,
                     ctl_timeout_s: float = 120.0) -> dict:
        """Retire one hosted model fleet-wide."""
        self.models.pop(str(model_id), None)
        self.model_canaries.pop(str(model_id), None)
        self._replan_placement(reason=f"unhost:{model_id}")
        report = self._reconcile_hosting(ctl_timeout_s=ctl_timeout_s)
        self._write_status()
        return report

    # -- per-model canary lifecycle ------------------------------
    def start_model_canary(self, model_id: str, version: str,
                           fraction: float = 0.05,
                           shadow: bool = False,
                           ctl_timeout_s: float = 300.0) -> dict:
        """Bring ``version`` up as ``model_id``'s canary on every
        replica hosting it — each hosted model's canary lifecycle is
        independent: two models can canary (and one promote while the
        other rolls back) concurrently."""
        model_id = str(model_id)
        out: dict = {}
        errors: dict = {}
        for inst in self._hosting_instances(model_id):
            try:
                out[inst] = self.router.control(
                    inst, "canary",
                    {"model_id": model_id, "version": version,
                     "fraction": fraction, "shadow": shadow},
                    timeout_s=ctl_timeout_s)
            except (FleetError, FleetWorkerError) as e:
                errors[inst] = str(e)
                out[inst] = {"error": str(e)}
        if errors and len(errors) == len(out):
            raise FleetError(
                f"canary {version} for model {model_id!r} failed on "
                f"every hosting replica: {errors}")
        self.model_canaries[model_id] = str(version)
        self._event("model_canary_start", model_id=model_id,
                    version=version, fraction=fraction, shadow=shadow,
                    replicas=sorted(set(out) - set(errors)),
                    errors=errors or None)
        return out

    def _model_ctl(self, model_id: str, cmd: str,
                   args: Optional[dict] = None,
                   ctl_timeout_s: float = 120.0) -> dict:
        out: dict = {}
        for inst in self._hosting_instances(model_id):
            try:
                out[inst] = self.router.control(
                    inst, cmd, dict(args or {}, model_id=model_id),
                    timeout_s=ctl_timeout_s)
            except (FleetError, FleetWorkerError) as e:
                out[inst] = {"error": str(e)}
        return out

    def promote_model_canary(self, model_id: str) -> dict:
        model_id = str(model_id)
        out = self._model_ctl(model_id, "promote_canary")
        version = self.model_canaries.pop(model_id, None)
        if version is not None:
            self.models[model_id] = version
        self._event("model_canary_promote", model_id=model_id,
                    version=version, replicas=sorted(out))
        self._write_status()
        return out

    def rollback_model_canary(self, model_id: str,
                              decision: Optional[RollbackDecision]
                              = None,
                              reason: str = "fleet-policy") -> dict:
        model_id = str(model_id)
        out = self._model_ctl(
            model_id, "rollback",
            {"reason": reason if decision is None else "policy"})
        version = self.model_canaries.pop(model_id, None)
        self._event(
            "model_canary_rollback", model_id=model_id,
            version=version,
            reason=reason if decision is None else "policy",
            reasons=[dict(r) for r in decision.reasons] if decision
            else [],
            replicas=sorted(out))
        self._write_status()
        log.warning("%s model %s canary %s ROLLED BACK across %d "
                    "replicas", LOG_PREFIX, model_id, version, len(out))
        return out

    def release_model_canary(self, model_id: str,
                             reason: str = "undecided") -> dict:
        model_id = str(model_id)
        out = self._model_ctl(model_id, "release_canary",
                              {"reason": reason})
        version = self.model_canaries.pop(model_id, None)
        self._event("model_canary_release", model_id=model_id,
                    version=version, reason=reason,
                    replicas=sorted(out))
        self._write_status()
        return out

    def check_model_canary(self, model_id: str
                           ) -> Optional[RollbackDecision]:
        """Evaluate the rollback policy against ``model_id``'s own
        merged stable/canary telemetry split; a breach rolls back ONLY
        this model's canary — the other hosted models' lifecycles are
        untouched."""
        model_id = str(model_id)
        if model_id not in self.model_canaries:
            return None
        stable_snaps, canary_snaps = self._arm_snapshots(
            model_id=model_id,
            canary_version=self.model_canaries[model_id])
        decision = self.policy.evaluate(
            merge_serving_snapshots(stable_snaps),
            merge_serving_snapshots(canary_snaps),
        )
        if decision.rollback:
            self.rollback_model_canary(model_id, decision=decision)
        return decision

    # -- rolling deploy -----------------------------------------------------
    def rolling_deploy(self, version: str,
                       drain_timeout_s: float = 60.0,
                       ctl_timeout_s: float = 300.0) -> list[dict]:
        """Flip the whole fleet to ``version``, one replica at a time
        (module docstring).  Returns the per-replica step report; a
        replica that cannot drain or deploy raises with the fleet left
        in a loudly-reported mixed state (the registry already names
        the intended stable - retry completes the roll)."""
        if self.registry.get(version).stage != "stable":
            self.registry.promote(version, to="stable")
        self.version = version
        report = []
        for h in list(self.router.live_replicas()):
            step = {"instance": h.instance, "version": version}
            self.router.set_drained(h.instance, True)
            try:
                if not self.router.wait_drained(h.instance,
                                                drain_timeout_s):
                    raise FleetError(
                        f"replica {h.instance} did not drain within "
                        f"{drain_timeout_s}s")
                t0 = time.perf_counter()
                doc = self.router.control(
                    h.instance, "deploy", {"version": version},
                    timeout_s=ctl_timeout_s)
                step["generation"] = doc.get("generation")
                step["swap_s"] = round(time.perf_counter() - t0, 4)
            finally:
                self.router.set_drained(h.instance, False)
            report.append(step)
            self._event("rolling_deploy_step", **step)
        self._event("rolling_deploy_done", version=version,
                    replicas=len(report))
        self._write_status()
        log.info("%s rolling deploy of %s complete across %d replicas",
                 LOG_PREFIX, version, len(report))
        return report

    # -- fleet canary -------------------------------------------------------
    def start_canary(self, version: str, fraction: float = 0.05,
                     shadow: bool = False,
                     ctl_timeout_s: float = 300.0) -> dict:
        """Bring ``version`` up as the canary on every live replica at
        one deterministic hash fraction (the same record routes to the
        same arm on every replica - the split, fleet-wide)."""
        out = self.router.broadcast(
            "canary",
            {"version": version, "fraction": fraction, "shadow": shadow},
            timeout_s=ctl_timeout_s)
        errors = {k: v for k, v in out.items()
                  if isinstance(v, dict) and v.get("error")}
        if len(errors) == len(out):
            raise FleetError(f"canary {version} failed on every "
                             f"replica: {errors}")
        self.canary_version = version
        self._event("fleet_canary_start", version=version,
                    fraction=fraction, shadow=shadow,
                    replicas=sorted(set(out) - set(errors)),
                    errors=errors or None)
        return out

    def _arm_snapshots(self, model_id: Optional[str] = None,
                       canary_version: Optional[str] = None
                       ) -> tuple[list[dict], list[dict]]:
        """Split every live shard's serving views into (stable pool,
        canary pool) by model version.  With ``model_id`` only that
        hosted model's views are pooled (each ServingTelemetry carries
        its model_id label) and the split compares against
        ``canary_version`` instead of the fleet-wide canary slot."""
        from ..obs.fleet import serving_views

        against = (canary_version if model_id is not None
                   else self.canary_version)
        stable_snaps: list[dict] = []
        canary_snaps: list[dict] = []
        for doc in self.aggregator.shards():
            if str(doc.get("instance")) == "router":
                # the router's own shard (ship_router_obs) carries this
                # process's views, not replica serving telemetry -
                # folding it in would pollute the canary verdict pools
                continue
            for _key, snap in serving_views(doc.get("metrics", {})):
                if model_id is not None \
                        and snap.get("model_id") != model_id:
                    continue
                if snap.get("model_version") == against:
                    canary_snaps.append(snap)
                else:
                    stable_snaps.append(snap)
        return stable_snaps, canary_snaps

    def canary_telemetry(self, model_id: Optional[str] = None) -> dict:
        """The merged (stable, canary) serving telemetry split — the
        PUBLIC read seam for automated canary verdicts (the
        continuous trainer polls this for canary row counts instead of
        reaching into the aggregator's internals).  Same merge
        :meth:`check_canary` evaluates the rollback policy against.
        With ``model_id`` the split covers that hosted model alone
        (its own canary slot)."""
        stable_snaps, canary_snaps = self._arm_snapshots(
            model_id=None if model_id is None else str(model_id),
            canary_version=(None if model_id is None
                            else self.model_canaries.get(str(model_id))))
        return {
            "stable": merge_serving_snapshots(stable_snaps),
            "canary": merge_serving_snapshots(canary_snaps),
        }

    def check_canary(self) -> Optional[RollbackDecision]:
        """Evaluate the rollback policy (and the fleet SLO engine)
        against the MERGED per-replica telemetry; a breach rolls the
        canary back across the whole fleet."""
        if self.canary_version is None:
            return None
        stable_snaps, canary_snaps = self._arm_snapshots()
        decision = self.policy.evaluate(
            merge_serving_snapshots(stable_snaps),
            merge_serving_snapshots(canary_snaps),
        )
        if decision.rollback:
            self.rollback_canary(decision=decision)
        return decision

    def rollback_canary(self,
                        decision: Optional[RollbackDecision] = None,
                        reason: str = "fleet-policy") -> dict:
        """Demote the canary on EVERY replica (each worker's rollback
        is its own pointer flip; the first one also records the
        registry rollback, the rest observe it already rolled back)."""
        out = self.router.broadcast(
            "rollback",
            {"reason": reason if decision is None else "policy"})
        version, self.canary_version = self.canary_version, None
        self._event(
            "fleet_rollback", version=version,
            reason=reason if decision is None else "policy",
            reasons=[dict(r) for r in decision.reasons] if decision
            else [],
            replicas=sorted(out),
        )
        self._write_status()
        log.warning("%s fleet canary %s ROLLED BACK across %d "
                    "replicas", LOG_PREFIX, version, len(out))
        return out

    def release_canary(self, reason: str = "undecided") -> dict:
        """Release the canary slot on EVERY replica without a verdict
        (each worker's release is a pointer flip back to 100% stable;
        the first one also records the registry ``release_canary``, the
        rest observe the slot already freed) — the fleet-wide
        counterpart of ``DeploymentController.release_canary`` for a
        canary whose evaluation window expired undecided."""
        out = self.router.broadcast("release_canary",
                                    {"reason": reason})
        version, self.canary_version = self.canary_version, None
        self._event("fleet_canary_release", version=version,
                    reason=reason, replicas=sorted(out))
        self._write_status()
        log.info("%s fleet canary %s released undecided across %d "
                 "replicas: %s", LOG_PREFIX, version, len(out), reason)
        return out

    def promote_canary(self) -> dict:
        out = self.router.broadcast("promote_canary")
        version, self.canary_version = self.canary_version, None
        self.version = version
        self._event("fleet_canary_promote", version=version,
                    replicas=sorted(out))
        self._write_status()
        return out

    # -- status -------------------------------------------------------------
    def status(self, shards=None) -> dict:
        """The one consistent fleet document (per-replica generation,
        heartbeat age, in-flight, restart budget + router + registry
        pointers) - what ``tx fleet status`` renders and
        ``fleet_status.json`` persists.  ``shards`` reuses an
        already-read shard list (the monitor's once-per-tick read)."""
        shard_fleet = {}
        if shards is None:
            shards = self.aggregator.shards()
        for doc in shards:
            info = doc.get("fleet")
            if isinstance(info, dict):
                shard_fleet[str(doc.get("instance"))] = info
        replicas = {}
        router_snap = self.router.snapshot() if self.router else {}
        for rep in self._replicas.values():
            hb = staleness(rep.heartbeat_path)
            handle_snap = (router_snap.get("replicas") or {}).get(
                rep.instance, {})
            health = handle_snap.get("health") or {}
            replicas[rep.instance] = {
                "pid": rep.proc.pid if rep.proc else None,
                "running": (rep.proc is not None
                            and rep.proc.poll() is None),
                "restarts": rep.restarts,
                "gave_up": rep.gave_up,
                "heartbeat_age_s": (None if hb is None
                                    else round(hb, 3)),
                "generation": handle_snap.get("generation"),
                "version": handle_snap.get("version"),
                "in_flight": handle_snap.get("in_flight"),
                "in_flight_rows": handle_snap.get("in_flight_rows"),
                "drained": handle_snap.get("drained"),
                "alive": handle_snap.get("alive"),
                "rows_ok": handle_snap.get("rows_ok"),
                "transport": handle_snap.get("transport"),
                "health": health.get("state"),
                "consecutive_failures": health.get(
                    "consecutive_failures"),
                "last_rtt_ms": health.get("last_rtt_ms"),
                "ejections": health.get("ejections"),
                "readmissions": health.get("readmissions"),
                "wire": handle_snap.get("wire"),
                "worker": shard_fleet.get(rep.instance),
            }
        with self._events_lock:
            events = [dict(e) for e in self._events]
        out = {
            "t": time.time(),
            "registry_root": self.registry_root,
            "stable_version": self.registry.stable,
            "canary_version": self.canary_version,
            "replicas": replicas,
            "router": {k: v for k, v in router_snap.items()
                       if k != "replicas"},
            "shards": dict(self.aggregator.last_report),
            "events": events,
        }
        if self.models:
            out["models"] = self._model_status_rows(shard_fleet)
            out["model_canaries"] = dict(self.model_canaries)
            if self.placement is not None:
                out["placement"] = self.placement.to_json()
        if self.autoscaler is not None:
            try:
                out["autoscaler"] = self.autoscaler.snapshot()
            except Exception as e:  # noqa: BLE001 - status must publish
                if is_device_fault(e):
                    raise
                out["autoscaler"] = {"error": str(e)}
        return out

    def _model_status_rows(self, shard_fleet: dict) -> dict:
        """Fold every replica's per-model table rows (shipped in its
        ``fleet`` shard info) into one fleet-wide per-model document:
        who hosts it, cache-resident vs evicted copies, per-model rows
        scored — the per-model rows ``tx fleet status`` renders."""
        rows_by_model = {}
        if self.router is not None:
            rows_by_model = self.router.snapshot().get(
                "rows_by_model", {})
        out: dict = {}
        for instance, info in sorted(shard_fleet.items()):
            for row in (info or {}).get("models") or []:
                model_id = str(row.get("model_id"))
                agg = out.setdefault(model_id, {
                    "version": row.get("version"),
                    "hosts": [],
                    "resident_on": [],
                    "evicted_on": [],
                    "rows_scored": 0,
                    "cold_hits": 0,
                    "rehydrations": 0,
                    "canary_version":
                        self.model_canaries.get(model_id),
                })
                agg["hosts"].append(instance)
                key = ("resident_on" if row.get("resident")
                       else "evicted_on")
                agg[key].append(instance)
                agg["rows_scored"] += int(row.get("rows_scored", 0)
                                          or 0)
                agg["cold_hits"] += int(row.get("cold_hits", 0) or 0)
                agg["rehydrations"] += int(row.get("rehydrations", 0)
                                           or 0)
        for model_id, agg in out.items():
            agg["rows_delivered"] = rows_by_model.get(model_id, 0)
        return out

    def _write_status(self, shards=None) -> None:
        """Atomically publish the status doc (tempfile + replace: a
        reader - worker deploy summaries, ``tx fleet status`` - sees a
        complete document or the previous one, never a torn one)."""
        path = os.path.join(self.control_dir, STATUS_FILENAME)
        try:
            doc = self.status(shards=shards)
            fd, tmp = tempfile.mkstemp(dir=self.control_dir,
                                       suffix=".tmp")
            with os.fdopen(fd, "w") as f:
                json.dump(doc, f, default=str)
            os.replace(tmp, path)
        except OSError as e:
            log.warning("fleet status publish failed: %s", e)

    # -- shutdown -----------------------------------------------------------
    def stop(self, timeout_s: float = 15.0) -> None:
        self._stop.set()
        if self._monitor is not None:
            self._monitor.join(timeout_s)
        if self._router_shipper is not None:
            self._router_shipper.stop()
            self._router_shipper = None
        if self.router is not None:
            try:
                self.router.broadcast("stop", timeout_s=5.0)
            except Exception as e:  # noqa: BLE001 - best-effort goodbye
                if is_device_fault(e):
                    raise
                log.debug("fleet stop broadcast failed: %s", e)
            self.router.close()
        for rep in self._replicas.values():
            if rep.proc is not None and rep.proc.poll() is None:
                rep.proc.terminate()
        deadline = time.monotonic() + timeout_s
        for rep in self._replicas.values():
            if rep.proc is None:
                continue
            while rep.proc.poll() is None \
                    and time.monotonic() < deadline:
                time.sleep(QUANTUM_S)
            if rep.proc.poll() is None:
                rep.proc.kill()
                try:
                    rep.proc.wait(timeout=10.0)
                except subprocess.TimeoutExpired:
                    log.warning("replica %s did not reap", rep.instance)
        self._write_status()

    def __enter__(self) -> "FleetController":
        return self.start() if not self.started else self

    def __exit__(self, *exc) -> None:
        self.stop()
