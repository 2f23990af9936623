"""Degraded-mode distributed training: collective watchdog, peer health,
and shrink-to-survivors mesh recovery.

Host copy of ``transmogrifai_tpu/parallel/resilience.py`` on
``torch.distributed``.  A single hung or dead peer wedges every collective
of a process group forever (SURVEY §5.3/§5.8: the reference leaned on
Spark task retry for this gap).  This module owns that gap for the mesh
tier, as ``workflow/supervisor.py`` owns it for whole training runs:

* :class:`PeerHealth` - one file-based heartbeat per rank (the
  supervisor's beat/staleness primitives), so a survivor can tell a
  *hung* peer (alive, beatless) from a *dead* one without a collective -
  the collective is exactly what cannot be trusted.
* :class:`CollectiveWatchdog` - runs a mesh collective under a deadline
  derived from observed step times (p99 x ``TX_MESH_DEADLINE_FACTOR``,
  clamped to [``TX_MESH_DEADLINE_FLOOR_S``, ``TX_MESH_DEADLINE_CEIL_S``]).
  On expiry it classifies the stall and walks the state machine::

      healthy --deadline expiry--> classify
        straggler (peers still beating) -> ONE retry, extended deadline
            retry ok  -> healthy
            retry stalls -> shrink
        dead peer (stale heartbeat / mesh.peer_die) -> shrink

  *shrink-to-survivors*: recompute the step on this rank alone from the
  host inputs it still holds (:func:`survivor_mesh`): the replicated
  host design matrix of the product path, so no dead peer's rows are
  needed to finish the step.  A stalled NCCL collective cannot be
  cancelled from Python, so the validator's shrink runs its fit on a
  fresh CUDA stream (:func:`survivor_stream`), never behind the wedged
  one.
* :class:`MeshTelemetry` - every detection, retry, shrink and bootstrap
  event, in the snapshot/JSON-export shape of the serving telemetry,
  surfaced in ``utils/tracing`` stage metrics and the model's
  ``summary_json()``; each detection, shrink and bootstrap timeout also
  ships the process's obs plane to ``TX_OBS_FLEET_DIR`` at once.

Fault points (``faults/injection.py``, armed via ``TX_FAULTS``):
``collective.delay`` (straggler: the step stalls ``delay`` seconds),
``mesh.peer_hang`` (a peer wedges: the step stalls on every armed call,
so the straggler retry stalls too and escalates), ``mesh.peer_die`` (a
peer dies mid-collective: classified dead at once), and
``mesh.init_no_coordinator`` (``distributed.initialize``: the coordinator
never answers).  ``tests/test_torch_mesh_resilience.py`` drills each.
"""
from __future__ import annotations

import logging
import os
import re
import contextlib
import threading
import time
from typing import Callable, Optional, Sequence

import torch
import torch.distributed as dist

from ..faults import injection as _faults
from ..obs import metrics as _obs_metrics
from ..obs import trace as _obs_trace
from ..utils import tracing as _tracing
from ..workflow.supervisor import beat as _beat, staleness as _staleness

log = logging.getLogger("transmogrifai_tpu_torch.mesh")

LOG_PREFIX = "op_mesh_resilience"

#: bounded event history (oldest dropped) - watchdogs run for the whole
#: training job, telemetry memory must not
_MAX_EVENTS = 256
_MAX_SAMPLES = 4096

_HEARTBEAT_RE = re.compile(r"^peer-(\d+)\.heartbeat$")


def _ship_degradation() -> None:
    """Push this process's obs plane to the fleet aggregation dir
    (``TX_OBS_FLEET_DIR``) the moment a degradation event lands:
    detections, shrinks, and bootstrap timeouts are exactly the signals
    a fleet aggregator must not learn about one heartbeat late (rollback
    signals aggregate across replicas).  Best-effort: a full disk must
    degrade the *report* of degradation, never the recovery itself."""
    agg_dir = os.environ.get("TX_OBS_FLEET_DIR")
    if not agg_dir:
        return
    try:
        from ..obs import fleet as _fleet

        _fleet.ship_now(agg_dir)
    except OSError as e:
        log.warning("%s fleet ship after degradation event failed: %s",
                    LOG_PREFIX, e)

_tls = threading.local()


class CollectiveStallError(RuntimeError):
    """A mesh collective stalled past its deadline (and its retry, when
    classified straggler) and the caller provided no survivor recompute
    path - the loud alternative to wedging forever."""


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, default))
    except ValueError:
        return default


class DeadlinePolicy:
    """Deadline for one collective step: p99 of observed step walls x
    ``factor``, clamped to [floor, ceiling].  With no observations yet
    (first step of a job includes compile) the ceiling applies - a
    watchdog must never kill a legitimate cold compile.  Knobs:
    ``TX_MESH_DEADLINE_FLOOR_S`` (default 30), ``TX_MESH_DEADLINE_CEIL_S``
    (default 600), ``TX_MESH_DEADLINE_FACTOR`` (default 4)."""

    def __init__(
        self,
        floor_s: Optional[float] = None,
        ceiling_s: Optional[float] = None,
        factor: Optional[float] = None,
    ) -> None:
        self.floor_s = (
            _env_float("TX_MESH_DEADLINE_FLOOR_S", 30.0)
            if floor_s is None else float(floor_s)
        )
        self.ceiling_s = (
            _env_float("TX_MESH_DEADLINE_CEIL_S", 600.0)
            if ceiling_s is None else float(ceiling_s)
        )
        self.factor = (
            _env_float("TX_MESH_DEADLINE_FACTOR", 4.0)
            if factor is None else float(factor)
        )
        self._samples: list[float] = []
        self._lock = threading.Lock()

    def observe(self, step_wall_s: float) -> None:
        with self._lock:
            self._samples.append(float(step_wall_s))
            if len(self._samples) > _MAX_SAMPLES:
                del self._samples[::2]

    def deadline_s(self) -> float:
        with self._lock:
            if not self._samples:
                return self.ceiling_s
            p99 = _tracing.percentiles(self._samples, (99.0,))["p99"]
        return min(self.ceiling_s, max(self.floor_s, p99 * self.factor))


class PeerHealth:
    """File-based per-mesh-process heartbeat in a shared directory
    (``<dir>/peer-<id>.heartbeat``), reusing the supervisor's beat /
    staleness primitives.  Liveness rides the filesystem on purpose: when
    a collective is the thing that stalled, the collective is the one
    channel peers must NOT need to prove they are alive.  Staleness is
    clamped at 0 by ``supervisor.staleness`` (clock skew / coarse-mtime
    filesystems), so a skewed clock cannot make a hung peer look alive
    forever.  ``stale_after_s`` defaults from ``TX_MESH_PEER_STALE_S``
    (60)."""

    def __init__(
        self,
        heartbeat_dir: str,
        process_id: int = 0,
        stale_after_s: Optional[float] = None,
    ) -> None:
        self.heartbeat_dir = heartbeat_dir
        self.process_id = int(process_id)
        self.stale_after_s = (
            _env_float("TX_MESH_PEER_STALE_S", 60.0)
            if stale_after_s is None else float(stale_after_s)
        )
        os.makedirs(heartbeat_dir, exist_ok=True)

    def path_for(self, process_id: int) -> str:
        return os.path.join(
            self.heartbeat_dir, f"peer-{int(process_id):05d}.heartbeat"
        )

    def beat(self) -> None:
        _beat(self.path_for(self.process_id))

    def peers(self) -> tuple[int, ...]:
        """Every process id that has ever beaten into the directory."""
        try:
            names = os.listdir(self.heartbeat_dir)
        except OSError:
            return ()
        out = []
        for n in names:
            m = _HEARTBEAT_RE.match(n)
            if m:
                out.append(int(m.group(1)))
        return tuple(sorted(out))

    def staleness_by_peer(self) -> dict[int, Optional[float]]:
        return {
            pid: _staleness(self.path_for(pid)) for pid in self.peers()
        }

    def dead_peers(self, stale_after_s: Optional[float] = None) -> list[int]:
        """Peers (other than this process) whose beat is stale - hung or
        dead; either way they will never finish the collective."""
        thr = self.stale_after_s if stale_after_s is None else stale_after_s
        out = []
        for pid, s in self.staleness_by_peer().items():
            if pid == self.process_id:
                continue
            if s is not None and s > thr:
                out.append(pid)
        return out

    def survivors(self, stale_after_s: Optional[float] = None) -> list[int]:
        dead = set(self.dead_peers(stale_after_s))
        return [p for p in self.peers() if p not in dead]


class MeshTelemetry:
    """Thread-safe accumulator for the mesh resilience tier - the
    training-side counterpart of ``serving.ServingTelemetry`` (same
    snapshot/JSON-artifact shape): ok-step walls, stall detections with
    classification + latency, straggler retries, shrink recomputes with
    overhead, bootstrap timeouts, and a bounded event log."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.started_at = time.time()  # epoch stamp (correlation only)
        self._pc_start = time.perf_counter()  # durations never use the
        # epoch clock (the tests/test_style.py timing gate)
        # unified metrics plane (obs/): snapshot registered as a view
        _obs_metrics.metrics_registry().register_view("mesh", self)
        # model-version attribution (registry/): the ServingTelemetry-
        # shared pair, so degraded-training events in bench JSON and
        # summary_json() name the model version they trained
        self.model_version: Optional[str] = None
        self.generation: Optional[int] = None
        self.collectives_ok = 0
        self.detections = 0
        self.straggler_retries = 0
        self.retries_ok = 0
        self.shrinks = 0
        self.shrink_failures = 0
        self.bootstrap_timeouts = 0
        self._step_s: list[float] = []
        self._detection_s: list[float] = []
        self._shrink_s: list[float] = []
        self._events: list[dict] = []
        # epoch stamp per event, parallel to _events and kept OUT of the
        # exported dicts: the since_epoch window filter must compare
        # epoch against epoch (a perf_counter-elapsed `t` vs an
        # epoch-difference cutoff diverges when NTP steps the wall
        # clock mid-process)
        self._event_epochs: list[float] = []

    # -- recording ----------------------------------------------------------
    def _sample(self, bucket: list, value: float) -> None:
        bucket.append(float(value))
        if len(bucket) > _MAX_SAMPLES:
            del bucket[::2]

    def _event(self, **kw) -> None:
        kw["t"] = round(time.perf_counter() - self._pc_start, 3)
        self._events.append(kw)
        self._event_epochs.append(time.time())
        if len(self._events) > _MAX_EVENTS:
            del self._events[0]
            del self._event_epochs[0]

    def record_step(self, label: str, wall_s: float) -> None:
        with self._lock:
            self.collectives_ok += 1
            self._sample(self._step_s, wall_s)

    def record_detection(
        self, label: str, deadline_s: float, classification: str,
        latency_s: float, dead_peers: Sequence,
    ) -> None:
        """A collective blew its deadline.  Detections log at WARNING -
        the detection IS the degradation alarm."""
        with self._lock:
            self.detections += 1
            self._sample(self._detection_s, latency_s)
            self._event(
                event="detect", label=label,
                deadline_s=round(deadline_s, 3),
                latency_s=round(latency_s, 3),
                classification=classification,
                dead_peers=list(dead_peers),
            )
        log.warning(
            "%s collective %r stalled past %.3fs deadline (classified "
            "%s; dead peers: %s)", LOG_PREFIX, label, deadline_s,
            classification, list(dead_peers),
        )
        _ship_degradation()

    def record_retry(self, label: str, ok: bool, deadline_s: float) -> None:
        with self._lock:
            self.straggler_retries += 1
            if ok:
                self.retries_ok += 1
            self._event(
                event="retry", label=label, ok=ok,
                deadline_s=round(deadline_s, 3),
            )

    def record_shrink(
        self, label: str, ok: bool, overhead_s: float,
        survivors: Optional[int],
    ) -> None:
        with self._lock:
            if ok:
                self.shrinks += 1
                self._sample(self._shrink_s, overhead_s)
            else:
                self.shrink_failures += 1
            self._event(
                event="shrink", label=label, ok=ok,
                overhead_s=round(overhead_s, 3), survivors=survivors,
            )
        if ok:
            log.warning(
                "%s collective %r recomputed on survivor mesh in %.3fs",
                LOG_PREFIX, label, overhead_s,
            )
        _ship_degradation()

    def set_model_version(self, version: Optional[str],
                          generation: Optional[int] = None) -> None:
        """Attribute subsequent mesh events to one model version /
        deployment generation (the ServingTelemetry contract)."""
        with self._lock:
            self.model_version = version
            self.generation = generation

    def record_bootstrap_timeout(self, address: str,
                                 timeout_s: float) -> None:
        with self._lock:
            self.bootstrap_timeouts += 1
            self._event(
                event="bootstrap_timeout", address=str(address),
                timeout_s=round(timeout_s, 3),
            )
        _ship_degradation()

    # -- reporting ----------------------------------------------------------
    def events_json(self, since_epoch: Optional[float] = None) -> list[dict]:
        """Events (each stamped ``t`` seconds after telemetry start),
        optionally only those at/after the absolute ``since_epoch`` -
        consumers scoping a report to one run (AppMetrics.to_json,
        summary_json) must not surface another run's degradation."""
        with self._lock:
            if since_epoch is None:
                return [dict(e) for e in self._events]
            cutoff = since_epoch - 1e-3  # caller-stamp ordering slack
            return [
                dict(e)
                for e, te in zip(self._events, self._event_epochs)
                if te >= cutoff
            ]

    def snapshot(self) -> dict:
        def _ms(vals):
            return {
                k: (None if v != v else round(v * 1e3, 3))
                for k, v in _tracing.percentiles(
                    vals, (50.0, 95.0, 99.0)
                ).items()
            }

        with self._lock:
            return {
                "wall_s": round(
                    max(time.perf_counter() - self._pc_start, 1e-9), 3),
                "model_version": self.model_version,
                "generation": self.generation,
                "collectives_ok": self.collectives_ok,
                "detections": self.detections,
                "straggler_retries": self.straggler_retries,
                "retries_ok": self.retries_ok,
                "shrinks": self.shrinks,
                "shrink_failures": self.shrink_failures,
                "bootstrap_timeouts": self.bootstrap_timeouts,
                "step_ms": _ms(self._step_s),
                "detection_ms": _ms(self._detection_s),
                "shrink_recompute_ms": _ms(self._shrink_s),
                "events": [dict(e) for e in self._events],
            }

    def log_line(self) -> str:
        snap = self.snapshot()
        kv = {
            "ok": snap["collectives_ok"],
            "detections": snap["detections"],
            "retries_ok": snap["retries_ok"],
            "shrinks": snap["shrinks"],
            "bootstrap_timeouts": snap["bootstrap_timeouts"],
            "p99_step_ms": snap["step_ms"]["p99"],
        }
        return LOG_PREFIX + " " + " ".join(f"{k}={v}" for k, v in kv.items())

    def export(self, path: str, extra: Optional[dict] = None) -> dict:
        snap = self.snapshot()
        if extra:
            snap.update(extra)
        _obs_metrics.write_json_artifact(path, snap)
        log.info(self.log_line())
        return snap


def _block_until_ready(value):
    """Wait for the work the step enqueued on this thread's CUDA stream,
    inside the watchdog's worker, so the deadline covers execution - not
    just enqueue."""
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.current_stream().synchronize()
    return value


def _caller_device() -> Optional[int]:
    """The caller's current CUDA device, for the watchdog's workers (the
    current device is per thread)."""
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        return torch.cuda.current_device()
    return None


class CollectiveWatchdog:
    """Run mesh collectives under a stall deadline with straggler retry
    and shrink-to-survivors escalation (module docstring has the state
    machine).  The step runs in a daemon worker thread; the watchdog
    joins it with a timeout - and the straggler retry and the survivor
    recompute run in bounded workers of their own - so no stage of
    recovery can wedge the caller, even when the thing being recovered
    from is the survivor route itself.  ``TX_MESH_RETRY_FACTOR``
    (default 2) stretches the deadline for the one straggler retry.

    Known caveat on real hardware: an abandoned attempt's worker may
    still be blocked INSIDE the collective while the retry or shrink
    dispatches - the retry re-issues the same collective (NCCL enforces
    cross-peer issue order, so a retry may need ``TX_MESH_RETRY_FACTOR``
    tuning on a floor deadline), and work on the wedged CUDA stream
    queues behind it, hence :func:`survivor_stream` for the shrink.  Both
    recovery stages are deadline-bounded, so the worst case is a loud
    :class:`CollectiveStallError`, never a hang.  A true NCCL stall is not
    drilled: the drills stall through the fault points, on gloo."""

    def __init__(
        self,
        telemetry: Optional[MeshTelemetry] = None,
        policy: Optional[DeadlinePolicy] = None,
        peer_health: Optional[PeerHealth] = None,
        retry_factor: Optional[float] = None,
    ) -> None:
        self.telemetry = telemetry if telemetry is not None else mesh_telemetry()
        self.policy = policy or DeadlinePolicy()
        self.peer_health = peer_health
        self.retry_factor = (
            _env_float("TX_MESH_RETRY_FACTOR", 2.0)
            if retry_factor is None else float(retry_factor)
        )

    # -- one attempt --------------------------------------------------------
    def _attempt(self, label: str, step_fn: Callable, deadline_s: float,
                 consult_faults: bool = True):
        out: dict = {}
        device = _caller_device()

        def _work() -> None:
            _tls.in_guard = True  # nested guards run their step inline
            try:
                if device is not None:
                    torch.cuda.set_device(device)
                if consult_faults:
                    # consult EVERY fault point up front, then stall: an
                    # abandoned worker that wakes after its deadline must
                    # not consume fires a later drill armed (consultation
                    # all happens inside this attempt's arming window)
                    delay = _faults.fires("collective.delay")
                    hang = _faults.fires("mesh.peer_hang")
                    die = _faults.fires("mesh.peer_die")
                    if die is not None:
                        # a dead peer never completes the collective: mark
                        # the death for classification, then stall like one
                        out["injected_dead"] = True
                        time.sleep(die.delay)
                        return
                    stall_s = (
                        delay.delay if delay is not None else 0.0
                    ) + (hang.delay if hang is not None else 0.0)
                    if stall_s:
                        time.sleep(stall_s)
                out["value"] = _block_until_ready(step_fn())
            except BaseException as e:  # noqa: BLE001 - re-raised by caller
                out["error"] = e
            finally:
                _tls.in_guard = False

        t = threading.Thread(
            target=_work, daemon=True, name=f"tx-collective-{label}"
        )
        t0 = time.perf_counter()
        t.start()
        t.join(deadline_s)
        wall = time.perf_counter() - t0
        if "error" in out:
            raise out["error"]
        if "value" in out:
            return True, out["value"], wall, out
        return False, None, wall, out  # stalled (thread hung or peer died)

    def _classify(self, info: dict) -> tuple[str, list]:
        if info.get("injected_dead"):
            return "dead_peer", ["injected"]
        if self.peer_health is not None:
            dead = self.peer_health.dead_peers()
            if dead:
                return "dead_peer", dead
        return "straggler", []

    def _survivor_count(self) -> Optional[int]:
        if self.peer_health is not None:
            return len(self.peer_health.survivors())
        return None

    # -- the guarded run ----------------------------------------------------
    def run(
        self,
        label: str,
        step_fn: Callable,
        shrink_fn: Optional[Callable] = None,
        deadline_s: Optional[float] = None,
    ):
        """Run ``step_fn`` (a mesh collective) under the deadline;
        ``shrink_fn`` is the survivor recompute - the same step from
        host-local inputs on a survivor/single-host mesh.  Returns the
        step's value; raises :class:`CollectiveStallError` when the step
        stalls and no shrink path exists.  ``deadline_s`` overrides the
        policy (drills/benches pin it for determinism)."""
        deadline = (
            self.policy.deadline_s() if deadline_s is None
            else float(deadline_s)
        )
        if self.peer_health is not None:
            self.peer_health.beat()
        # one trace span per guarded collective: a stalled step's
        # detection/retry/shrink story rides the SAME run trace as the
        # stage fit that issued it (ISSUE 7), outcome tagged on exit
        with _obs_trace.span(
            "mesh.collective", label=label,
            deadline_s=round(deadline, 3),
        ) as sp:
            ok, value, wall, info = self._attempt(label, step_fn, deadline)
            if ok:
                sp.set_attr("outcome", "ok")
                self.policy.observe(wall)
                self.telemetry.record_step(label, wall)
                if self.peer_health is not None:
                    self.peer_health.beat()  # liveness == progress
                return value
            classification, dead = self._classify(info)
            sp.set_attr("classification", classification)
            self.telemetry.record_detection(
                label, deadline, classification, wall, dead
            )
            if classification == "straggler":
                extended = deadline * self.retry_factor
                ok2, value2, wall2, info2 = self._attempt(
                    label, step_fn, extended
                )
                self.telemetry.record_retry(label, ok2, extended)
                if ok2:
                    sp.set_attr("outcome", "retry_ok")
                    self.policy.observe(wall2)
                    if self.peer_health is not None:
                        self.peer_health.beat()
                    return value2
                # the retry stalled too: a straggler that never finishes
                # is a dead peer for recovery purposes
                _, dead2 = self._classify(info2)
                dead = dead or dead2 or ["unresponsive"]
            if shrink_fn is None:
                sp.set_attr("outcome", "stalled")
                self.telemetry.record_shrink(label, False, 0.0, None)
                raise CollectiveStallError(
                    f"collective {label!r} stalled past its "
                    f"{deadline:.3f}s deadline (classified "
                    f"{classification}; dead peers: {dead}) and no "
                    "survivor recompute path was provided"
                )
            # the shrink runs in its own bounded worker too (the ceiling
            # - a fresh mesh means recompile - and no fault consultation:
            # the armed faults simulate the DEGRADED mesh, not the
            # survivor route).  'Never wedge the caller' must hold even
            # when the survivor recompute itself is broken.
            ok3, value, wall3, _info3 = self._attempt(
                label, shrink_fn, self.policy.ceiling_s,
                consult_faults=False
            )
            if not ok3:
                sp.set_attr("outcome", "shrink_stalled")
                self.telemetry.record_shrink(
                    label, False, wall3, self._survivor_count()
                )
                raise CollectiveStallError(
                    f"survivor recompute for collective {label!r} "
                    f"stalled past the {self.policy.ceiling_s:.1f}s "
                    "ceiling - the degraded mesh AND the survivor route "
                    "are both wedged"
                )
            sp.set_attr("outcome", "shrink_ok")
            self.telemetry.record_shrink(
                label, True, wall3, self._survivor_count()
            )
            return value


# -- module-level plumbing ---------------------------------------------------

_telemetry: Optional[MeshTelemetry] = None
_default_wd: Optional[CollectiveWatchdog] = None
# RLock: default_watchdog() calls mesh_telemetry() while holding it
_singleton_lock = threading.RLock()


def mesh_telemetry() -> MeshTelemetry:
    """Process-global telemetry (what tracing/summary_json surface)."""
    global _telemetry
    with _singleton_lock:
        if _telemetry is None:
            _telemetry = MeshTelemetry()
        return _telemetry


def reset_mesh_telemetry() -> None:
    """Fresh global telemetry + watchdog (test/bench teardown)."""
    global _telemetry, _default_wd
    with _singleton_lock:
        _telemetry = None
        _default_wd = None


def _mesh_faults_armed() -> bool:
    plan = _faults._plan
    return plan is not None and any(
        p.startswith(("mesh.", "collective.")) for p in plan.points()
    )


def watchdog_enabled() -> bool:
    """``TX_MESH_WATCHDOG`` wins (1/0); unset defaults to ON for a
    process group of more than one rank and whenever a
    ``mesh.*``/``collective.*`` fault point is armed (drills), OFF
    otherwise - single-process healthy paths pay zero threads."""
    v = os.environ.get("TX_MESH_WATCHDOG")
    if v is not None:
        return v.strip().lower() not in ("0", "false", "")
    if _mesh_faults_armed():
        return True
    return dist.is_available() and dist.is_initialized() \
        and dist.get_world_size() > 1


def default_watchdog() -> CollectiveWatchdog:
    """The process-global watchdog the guarded call sites share, with
    PeerHealth attached when ``TX_MESH_HEARTBEAT_DIR`` names the shared
    heartbeat directory (the launcher mounts one path on every host);
    the process id is the rank."""
    global _default_wd
    with _singleton_lock:
        if _default_wd is None:
            ph = None
            hb_dir = os.environ.get("TX_MESH_HEARTBEAT_DIR")
            if hb_dir:
                pid = dist.get_rank() if dist.is_initialized() else 0
                ph = PeerHealth(hb_dir, process_id=pid)
            _default_wd = CollectiveWatchdog(
                telemetry=mesh_telemetry(), peer_health=ph
            )
        return _default_wd


def guarded_collective(
    label: str,
    step_fn: Callable,
    shrink_fn: Optional[Callable] = None,
    watchdog: Optional[CollectiveWatchdog] = None,
    deadline_s: Optional[float] = None,
):
    """The one seam production call sites use: run ``step_fn`` under the
    (default) watchdog when enabled, else call it inline.  Re-entrant
    calls (a guarded fit inside a guarded validator step) run inline -
    one deadline per collective, not a tower of nested threads."""
    if getattr(_tls, "in_guard", False):
        return step_fn()
    wd = watchdog
    if wd is None:
        if not watchdog_enabled():
            return step_fn()
        wd = default_watchdog()
    return wd.run(label, step_fn, shrink_fn=shrink_fn, deadline_s=deadline_s)


def survivor_mesh(axis_names: Sequence[str] = ("data",)):
    """The shrink target: a mesh of every rank this process can still
    reach.  A world of one rank keeps its ``global_mesh`` (a single-rank
    group gives the uninterrupted answer); a survivor of a multi-process
    world gets a mesh of itself alone (``mesh.LocalMesh``, no process
    group: one cannot be formed while a peer holding the rendezvous store
    may be gone), and a WARNING says so.

    Multi-process semantics are PARTIAL by construction: a survivor
    recomputing over this mesh covers only its own rows.  Full-result
    recovery belongs to the seams that still hold the inputs needed to
    finish alone - the validator's guarded fit recomputes from the
    replicated host copies every rank holds - while reductions over
    ``host_local_to_global`` row blocks come back as this rank's partial
    statistic."""
    from . import mesh as _mesh
    from .distributed import global_mesh

    world = _mesh.world_size()
    if world == 1 and dist.is_available() and dist.is_initialized():
        return global_mesh(tuple(axis_names))
    if world > 1:
        log.warning(
            "%s survivor mesh spans only this rank (%d of %d): recomputed "
            "reductions cover this rank's rows, not the full dataset",
            LOG_PREFIX, dist.get_rank(), world,
        )
    return _mesh.LocalMesh(tuple(axis_names))


@contextlib.contextmanager
def survivor_stream(device):
    """Run a survivor recompute on a fresh CUDA stream of ``device`` (a
    stalled collective cannot be cancelled from Python, and work queued
    on its stream would wait behind it); a no-op for a CPU device."""
    dev = torch.device(device)
    if dev.type != "cuda":
        yield
        return
    stream = torch.cuda.Stream(device=dev)
    with torch.cuda.stream(stream):
        yield
    stream.synchronize()


def guarded_all_reduce_stats(
    fn,
    mesh,
    *arrays,
    axis: str = "data",
    label: str = "all_reduce_stats",
    watchdog: Optional[CollectiveWatchdog] = None,
    deadline_s: Optional[float] = None,
):
    """``distributed.all_reduce_stats`` under the watchdog, with the
    built-in shrink path: rerun the same reduction over the survivor
    mesh from the (host-local) ``arrays`` the caller still holds.

    A world of one rank: the shrink result equals the uninterrupted
    answer.  Multi-process: the survivor reduces only its own rows (the
    whole of a replicated input is not re-reduced: :func:`survivor_mesh`
    is this rank alone, holding one block), so the shrink returns this
    rank's partial statistic - callers that need the global answer after
    a peer's death must aggregate survivor partials out of band or
    re-bootstrap the group."""
    from . import distributed as dist

    def _step():
        return dist.all_reduce_stats(fn, mesh, *arrays, axis=axis)

    def _shrink():
        return dist.all_reduce_stats(
            fn, survivor_mesh((axis,)), *arrays, axis=axis
        )

    return guarded_collective(
        label, _step, shrink_fn=_shrink, watchdog=watchdog,
        deadline_s=deadline_s,
    )


# stage metrics / summary_json surfacing: tracing takes a callback
# instead of importing this module
_tracing.register_mesh_events_source(
    lambda since_epoch=None: mesh_telemetry().events_json(since_epoch)
)
