"""Elastic fleet autoscaling: the capacity control loop.

A control loop on :class:`~.controller.FleetController` that scales
the replica count against OFFERED load and survives every failure mode
of doing so.  Host code: its new replicas score on the fleet's device
(the card by default), and every catch-all of the loop passes a device
fault (``parallel.kernels.is_device_fault``) through - the loop's own
guard ends the loop on one instead of counting a step error.

* **evidence, not thresholds** - each window the loop reads three
  signals: the :class:`~..obs.slo.SLOEngine` multi-window burn
  rates (the scale-up trigger), per-replica observed throughput/p99
  from the obs-plane fleet shards (via the router's handle ``obs``
  fold), and the cost model's PREDICTED per-replica capacity.
  The cost model sizes a surge - ``ceil(demand / capacity)`` replicas,
  not "+1" - falling back to the observed-throughput waterfall when it
  cannot predict yet.
* **hysteresis so the fleet never flaps** - directions feed a
  :class:`ScaleGovernor` (the ``RefitGovernor`` discipline:
  consecutive-window streaks per direction + a shared cooldown).  A
  flap-storm input - up/down alternating every window - resets the
  streaks forever and never triggers.
* **probe-gated grow, shed-never-hang shrink** - scale-up spawns
  replicas that load and warm on the fleet's device and are
  admitted to routing only after a ``ping`` health probe (connected
  DRAINED until then); scale-down drains the victim via the router
  (stop dispatching, in-flight finishes) and the router's at-least-once
  failover owns anything a mid-drain SIGKILL strands.  Double-entry row
  conservation holds across every transition.
* **the envelope** - brownout (the router's quorum rule) remains the
  last line when scaling cannot keep up: at ``max_replicas`` the loop
  records the hold and defers to shedding.  A replica death is
  replacement CAPACITY accounting - the gave-up replica's missing
  throughput raises utilization and the next trigger sizes from
  demand - never a blind 1:1 restart.  And the loop's own death (fault
  point ``autoscaler.crash``, armed OUTSIDE the decision guard) kills
  only the control plane: replicas, router, and supervision keep
  serving, and a restarted autoscaler ADOPTS the live fleet with fresh
  streaks - it cannot justify a scale event except from new evidence.
* **live knob retune rides the loop** - when replica count holds but
  p99 burns, the loop A/B-probes micro-batch knobs on the live
  replicas (:meth:`~..autotune.KnobTuner.ab_probe` over the
  worker ``retune`` verb - the ``MicroBatchScheduler.retune()``
  contract).  The baseline wins ties and margins: tuned knobs never
  regress past the hand-set default.

Every decision is a bounded, trace-event-recorded
:class:`AutoscaleDecision` carrying its evidence (burn rates, observed
vs predicted capacity, streak state), surfaced as ``tx_autoscaler_*``
metrics, ``fleet_status.json`` columns, and ``tx fleet status``.
"""
from __future__ import annotations

import contextvars
import logging
import math
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Optional, Sequence

from ..faults import injection as _faults
from ..obs.metrics import metrics_registry
from ..obs.trace import tracer
from ..parallel.kernels import is_device_fault

log = logging.getLogger("transmogrifai_tpu_torch.fleet")

LOG_PREFIX = "op_fleet_metrics"

#: decision ring bound (the controller-events convention)
MAX_DECISIONS = 256

#: cold-start per-replica capacity guess (rows/s) used only until an
#: observation or cost-model prediction replaces it - matches the
#: router's ``_DEFAULT_SVC_S`` of 10 us/row
DEFAULT_CAPACITY_ROWS_S = 1e5


def _ctx_thread(target, name: str) -> threading.Thread:
    """A daemon thread running inside a COPY of the creating thread's
    contextvars, so every ``autoscaler.decision`` trace event stays
    under the one trace that started the loop (the router convention)."""
    ctx = contextvars.copy_context()
    return threading.Thread(target=lambda: ctx.run(target),
                            name=name, daemon=True)


class ScaleGovernor:
    """Hysteresis for capacity decisions - the ``RefitGovernor``
    discipline with a streak per DIRECTION: a scale fires only after
    ``consecutive`` agreeing windows, any disagreeing window resets
    both streaks, and a trigger opens a shared ``cooldown`` during
    which further triggers are suppressed.  Alternating up/down input
    (a flap storm) therefore never fires."""

    def __init__(self, up_consecutive: int = 2,
                 down_consecutive: int = 4,
                 cooldown: int = 4) -> None:
        self.up_consecutive = max(1, int(up_consecutive))
        self.down_consecutive = max(1, int(down_consecutive))
        self.cooldown = max(0, int(cooldown))
        self.up_streak = 0
        self.down_streak = 0
        self.cooldown_left = 0
        self.windows = 0
        self.triggers = 0
        self.suppressed = 0

    def observe_window(self, direction: str) -> str:
        """Feed one window's direction (``up`` / ``down`` / ``hold``);
        returns ``clear`` (hold: streaks reset), ``over`` (streak
        building), ``suppressed`` (streak complete but cooling down),
        or ``trigger`` (act now; streaks reset, cooldown opens)."""
        if direction not in ("up", "down", "hold"):
            raise ValueError(f"unknown direction {direction!r}")
        self.windows += 1
        cooling = self.cooldown_left > 0
        if cooling:
            self.cooldown_left -= 1
        if direction == "hold":
            self.up_streak = 0
            self.down_streak = 0
            return "clear"
        if direction == "up":
            self.up_streak += 1
            self.down_streak = 0
            streak, need = self.up_streak, self.up_consecutive
        else:
            self.down_streak += 1
            self.up_streak = 0
            streak, need = self.down_streak, self.down_consecutive
        if streak < need:
            return "over"
        if cooling:
            self.suppressed += 1
            return "suppressed"
        self.triggers += 1
        self.up_streak = 0
        self.down_streak = 0
        self.cooldown_left = self.cooldown
        return "trigger"

    def snapshot(self) -> dict:
        return {
            "up_streak": self.up_streak,
            "down_streak": self.down_streak,
            "up_consecutive": self.up_consecutive,
            "down_consecutive": self.down_consecutive,
            "cooldown": self.cooldown,
            "cooldown_left": self.cooldown_left,
            "windows": self.windows,
            "triggers": self.triggers,
            "suppressed": self.suppressed,
        }


@dataclass
class AutoscaleDecision:
    """One recorded control-loop decision WITH its evidence: what the
    loop saw (burn rates, observed vs predicted capacity, streaks),
    what it decided, and what actually happened."""

    action: str        # adopt | scale_up | scale_down | retune | hold
    outcome: str       # governor outcome or what happened (e.g. at_max)
    reason: str
    members_before: int
    members_after: int
    target: Optional[int]
    evidence: dict = field(default_factory=dict)
    t: float = field(default_factory=time.time)

    def to_json(self) -> dict:
        return {
            "action": self.action,
            "outcome": self.outcome,
            "reason": self.reason,
            "members_before": self.members_before,
            "members_after": self.members_after,
            "target": self.target,
            "evidence": dict(self.evidence),
            "t": self.t,
        }


class FleetAutoscaler:
    """The elastic capacity control loop over a live
    :class:`~.controller.FleetController` (module docstring).  Drives
    the fleet exclusively through PUBLIC controller/router seams
    (style-gated): ``add_replica`` / ``remove_replica`` /
    ``member_instances`` / ``slo_engine.observe`` / router snapshots.

    ``step()`` is the deterministic single-window decision function
    (unit-testable without a fleet); ``start()`` runs it on a bounded
    interval loop whose death - the ``autoscaler.crash`` fault point -
    never touches the data plane."""

    def __init__(
        self,
        controller,
        min_replicas: int = 1,
        max_replicas: int = 8,
        interval_s: float = 0.5,
        up_consecutive: int = 2,
        down_consecutive: int = 4,
        cooldown_windows: int = 4,
        target_utilization: float = 0.7,
        idle_utilization: float = 0.3,
        ref_batch_rows: int = 512,
        probe_timeout_s: float = 60.0,
        drain_timeout_s: float = 30.0,
        retune_enabled: bool = True,
        retune_margin: float = 0.03,
        retune_probe_repeats: int = 2,
        retune_cooldown_windows: int = 8,
        probe_records: Optional[Sequence] = None,
        measure_fn: Optional[Callable[[dict], float]] = None,
    ) -> None:
        if min_replicas < 1:
            raise ValueError("min_replicas must be >= 1")
        if max_replicas < min_replicas:
            raise ValueError("max_replicas must be >= min_replicas")
        self.controller = controller
        self.min_replicas = int(min_replicas)
        self.max_replicas = int(max_replicas)
        self.interval_s = max(0.05, float(interval_s))
        #: capacity is provisioned so steady demand lands at this
        #: utilization - the surge headroom knob
        self.target_utilization = min(max(float(target_utilization),
                                          0.05), 1.0)
        #: below this utilization (and only with the SLO plane quiet
        #: and the queue empty) the fleet is idle enough to shrink
        self.idle_utilization = min(max(float(idle_utilization), 0.0),
                                    self.target_utilization)
        self.ref_batch_rows = max(1, int(ref_batch_rows))
        self.probe_timeout_s = float(probe_timeout_s)
        self.drain_timeout_s = float(drain_timeout_s)
        self.retune_enabled = bool(retune_enabled)
        self.retune_margin = float(retune_margin)
        self.retune_probe_repeats = max(1, int(retune_probe_repeats))
        self.retune_cooldown_windows = max(0,
                                           int(retune_cooldown_windows))
        #: records scored through the router to measure a knob arm
        #: (the default measure seam); tests inject ``measure_fn``
        self.probe_records = (list(probe_records)
                              if probe_records is not None else None)
        self.measure_fn = measure_fn
        self.governor = ScaleGovernor(
            up_consecutive=up_consecutive,
            down_consecutive=down_consecutive,
            cooldown=cooldown_windows)
        self._lock = threading.Lock()
        self._decisions: list[AutoscaleDecision] = []
        self.decisions_total = 0
        self.steps = 0
        self.scale_ups = 0
        self.scale_downs = 0
        self.retunes = 0
        self.replicas_added = 0
        self.replicas_removed = 0
        self.errors = 0
        self.crashed = False
        self._retune_cooldown_left = 0
        self._prev_rows_ok: Optional[int] = None
        self._prev_t: Optional[float] = None
        self._served_ewma: Optional[float] = None
        self._last_capacity: dict = {}
        self._last_utilization: Optional[float] = None
        self._last_demand: Optional[float] = None
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.started = False

    # -- lifecycle ----------------------------------------------------------
    def start(self) -> "FleetAutoscaler":
        """Adopt the live fleet and start the loop.  Adoption is a
        recorded decision with only FRESH evidence: streaks start at
        zero, so a restarted autoscaler cannot justify a scale event
        from anything but new windows - the crash-recovery rule."""
        if self.started:
            return self
        self.controller.autoscaler = self
        metrics_registry().register_view("autoscaler", self)
        members = self.controller.member_instances()
        self._record(AutoscaleDecision(
            action="adopt", outcome="adopted",
            reason="adopted live fleet; any scale event requires "
                   "fresh consecutive-window evidence",
            members_before=len(members), members_after=len(members),
            target=None,
            evidence={"members": sorted(members),
                      "gave_up": sorted(
                          self.controller.gave_up_instances()),
                      "governor": self.governor.snapshot()},
        ))
        self._stop.clear()
        self._thread = _ctx_thread(self._loop, "tx-fleet-autoscaler")
        self._thread.start()
        self.started = True
        log.info("%s autoscaler up over %d member(s) "
                 "[%d..%d replicas, %.2fs windows]", LOG_PREFIX,
                 len(members), self.min_replicas, self.max_replicas,
                 self.interval_s)
        return self

    def stop(self, timeout_s: float = 10.0) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout_s)
        self.started = False

    def alive(self) -> bool:
        """True while the control loop thread runs; False after stop()
        OR after an ``autoscaler.crash`` killed the loop (the data
        plane keeps serving either way)."""
        return self._thread is not None and self._thread.is_alive()

    def _loop(self) -> None:
        while not self._stop.wait(self.interval_s):
            # the control-plane death drill: armed OUTSIDE the decision
            # guard, so the fault kills this loop (and only this loop)
            # - replicas, router, and supervision never notice
            try:
                _faults.inject("autoscaler.crash")
            except _faults.InjectedFault as e:
                self.crashed = True
                log.error("%s autoscaler control loop CRASHED (%s); "
                          "data plane unaffected", LOG_PREFIX, e)
                return
            try:
                self.step()
            except Exception as e:  # noqa: BLE001 - the loop must survive
                if is_device_fault(e):
                    # a device fault ends the loop (the control plane
                    # only): it is never retried as a step error
                    self.crashed = True
                    log.error("%s autoscaler control loop ended by a "
                              "device fault: %s", LOG_PREFIX, e)
                    return
                with self._lock:
                    self.errors += 1
                log.exception("autoscaler step error")

    def __enter__(self) -> "FleetAutoscaler":
        return self.start() if not self.started else self

    def __exit__(self, *exc) -> None:
        self.stop()

    # -- the decision function ----------------------------------------------
    def step(self) -> Optional[AutoscaleDecision]:
        """One evidence->direction->governor->action window.  Pure
        control flow over public seams; deterministic given the
        evidence - the unit-testable heart of the loop."""
        router = self.controller.router
        if router is None:
            return None
        evidence = self._gather_evidence(router)
        direction, reason = self._direction(evidence)
        outcome = self.governor.observe_window(direction)
        evidence["governor"] = self.governor.snapshot()
        with self._lock:
            self.steps += 1
            if self._retune_cooldown_left > 0:
                self._retune_cooldown_left -= 1
        if outcome == "trigger" and direction == "up":
            return self._scale_up(evidence, reason)
        if outcome == "trigger" and direction == "down":
            return self._scale_down(evidence, reason)
        if self._should_retune(direction, outcome, evidence):
            return self._ab_retune(evidence, reason)
        if outcome in ("over", "suppressed"):
            # streak state IS evidence: record the hold so the trace
            # shows the loop seeing the burn and waiting out hysteresis
            n = evidence["members_n"]
            return self._record(AutoscaleDecision(
                action="hold", outcome=outcome, reason=reason,
                members_before=n, members_after=n, target=None,
                evidence=evidence))
        return None

    # -- evidence -----------------------------------------------------------
    def _gather_evidence(self, router) -> dict:
        now = time.monotonic()
        snap = router.snapshot()
        slo = self.controller.slo_engine.observe()
        burn = {}
        for name, obj in (slo.get("objectives") or {}).items():
            burn[name] = {
                "state": obj.get("state"),
                "burn_long": obj.get("burn_long"),
                "burn_short": obj.get("burn_short"),
                "burn_threshold": obj.get("burn_threshold"),
            }
        firing = sorted(str(f.get("name"))
                        for f in (slo.get("firing") or []))
        members = self.controller.member_instances()
        gave_up = self.controller.gave_up_instances()
        healthy = int(snap.get("healthy_replicas") or 0)
        queue_depth = int(snap.get("queue_depth") or 0)
        rows_ok = int(snap.get("rows_ok") or 0)
        requests_ok = int(snap.get("requests_ok") or 0)
        in_flight_rows = sum(
            int(r.get("in_flight_rows") or 0)
            for r in (snap.get("replicas") or {}).values())
        served = 0.0
        if (self._prev_t is not None and now > self._prev_t
                and self._prev_rows_ok is not None):
            served = max(0.0, (rows_ok - self._prev_rows_ok)
                         / (now - self._prev_t))
        self._prev_rows_ok, self._prev_t = rows_ok, now
        self._served_ewma = (served if self._served_ewma is None
                             else 0.5 * self._served_ewma
                             + 0.5 * served)
        rows_per_req = (rows_ok / requests_ok if requests_ok
                        else float(self.ref_batch_rows))
        backlog_rows = in_flight_rows + queue_depth * rows_per_req
        # demand = what we are serving + clearing the backlog within
        # one full up-hysteresis window
        window_s = self.interval_s * self.governor.up_consecutive
        demand = self._served_ewma + backlog_rows / window_s
        capacity = self._replica_capacity(router)
        serving_n = healthy if healthy > 0 else max(
            1, len(members) - len(gave_up))
        # heterogeneous capacity: under a multi-model
        # placement plan replicas have DIFFERENT predicted capacities
        # (each hosts a different model mix), so fleet capacity is the
        # SUM of the per-replica mix, not one-capacity * N
        mix = self._capacity_mix(members, gave_up, capacity)
        fleet_capacity = sum(mix.values())
        if mix and len(mix) != serving_n:
            fleet_capacity *= serving_n / len(mix)
        if fleet_capacity <= 0:
            fleet_capacity = (capacity["per_replica_rows_s"]
                              * serving_n)
        utilization = demand / max(fleet_capacity, 1e-9)
        self._last_capacity = capacity
        self._last_utilization = utilization
        self._last_demand = demand
        return {
            "slo_firing": firing,
            "burn": burn,
            "members": sorted(members),
            "members_n": len(members),
            "gave_up": sorted(gave_up),
            "healthy_replicas": healthy,
            "serving_n": serving_n,
            "queue_depth": queue_depth,
            "in_flight_rows": in_flight_rows,
            "served_rows_s": round(self._served_ewma, 1),
            "demand_rows_s": round(demand, 1),
            "capacity": capacity,
            "capacity_mix": {k: round(v, 1)
                             for k, v in sorted(mix.items())},
            "fleet_capacity_rows_s": round(fleet_capacity, 1),
            "utilization": round(utilization, 4),
        }

    def _capacity_mix(self, members: Sequence[str],
                      gave_up: Sequence[str],
                      capacity: dict) -> dict:
        """Per-replica capacity map for the serving members.  With a
        multi-model placement plan each replica's predicted capacity
        under its hosted mix shapes the ratios, anchored to the
        observed/predicted absolute level (``capacity`` waterfall);
        without one every replica gets the homogeneous estimate -
        byte-for-byte the old sizing."""
        base = float(capacity["per_replica_rows_s"])
        serving = [m for m in members if m not in set(gave_up)]
        plan = getattr(self.controller, "placement", None)
        if plan is None or not getattr(plan, "capacity_rows_s", None):
            return {m: base for m in serving}
        mean = plan.mean_capacity() or base
        factor = base / mean if mean > 0 else 1.0
        return {m: plan.replica_capacity(m, mean) * factor
                for m in serving}

    def _replica_capacity(self, router) -> dict:
        """Per-replica capacity estimate with its provenance: the
        cost model's prediction when it can predict (the sizing
        input), else the live service-time EWMA, else shard-observed
        throughput, else the cold-start default.  Observed AND
        predicted both ride the evidence so every decision shows the
        observed-vs-predicted gap."""
        live = router.live_replicas()
        observed = [float(h.obs["batch_rows_per_s"]) for h in live
                    if h.obs.get("batch_rows_per_s")]
        p99s = [float(h.obs["p99_ms"]) for h in live
                if h.obs.get("p99_ms") is not None]
        ewma = [1.0 / h.svc_s_ewma for h in live
                if h.svc_s_ewma]
        predicted: list[float] = []
        cm = router.cost_model
        if cm is not None:
            from ..autotune import candidate_features

            for h in live:
                key = "serve.batch/" + h.instance
                try:
                    if not cm.can_predict(key):
                        continue
                    wall_ms = cm.predict_wall_ms(
                        key,
                        candidate_features(self.ref_batch_rows, 0))
                    if wall_ms is not None and wall_ms > 0:
                        predicted.append(
                            self.ref_batch_rows / (wall_ms / 1e3))
                except Exception as e:  # noqa: BLE001 - estimate only
                    if is_device_fault(e):
                        raise
                    log.debug("capacity prediction failed for %s: %s",
                              h.instance, e)
        for source, pool in (("cost_model", predicted),
                             ("observed_ewma", ewma),
                             ("observed_shards", observed)):
            if pool:
                per_replica = sum(pool) / len(pool)
                break
        else:
            source, per_replica = "default", DEFAULT_CAPACITY_ROWS_S
        return {
            "per_replica_rows_s": round(per_replica, 1),
            "source": source,
            "predicted_rows_s": (round(sum(predicted) / len(predicted),
                                       1) if predicted else None),
            "observed_peak_rows_s": (round(max(observed), 1)
                                     if observed else None),
            "observed_p99_ms": (round(max(p99s), 3) if p99s else None),
        }

    def _direction(self, evidence: dict) -> tuple[str, str]:
        util = evidence["utilization"]
        if evidence["slo_firing"] and (
                util > self.idle_utilization
                or evidence["queue_depth"] > 0):
            # a burn with NO offered load is stale evidence (p99 from a
            # past surge that no fresh traffic can clear): scaling up an
            # idle fleet fixes nothing, and treating it as a trigger
            # would deadlock scale-down forever
            return "up", ("slo_burn:"
                          + ",".join(evidence["slo_firing"]))
        if util >= 1.0:
            # demand exceeds effective capacity - includes the
            # replica-death case, where gave-up members' missing
            # throughput pushes utilization over the line
            # (replacement CAPACITY, not blind 1:1 restart)
            return "up", f"overload:utilization={util:.2f}"
        if (util <= self.idle_utilization
                and evidence["queue_depth"] == 0
                and evidence["serving_n"] > self.min_replicas):
            return "down", f"idle:utilization={util:.2f}"
        return "hold", f"steady:utilization={util:.2f}"

    # -- actions ------------------------------------------------------------
    def _sized_target(self, evidence: dict) -> int:
        """How many SERVING replicas the current demand needs at the
        target utilization - the cost-model sizing rule, never '+1'."""
        demand = evidence["demand_rows_s"]
        mix = evidence.get("capacity_mix") or {}
        if mix:
            # heterogeneous fleet: accumulate the per-replica capacity
            # mix (largest first - existing replicas keep serving)
            # until the demand fits at target utilization; replicas we
            # would ADD beyond the current mix are assumed mean-sized
            caps = sorted(mix.values(), reverse=True)
            mean = sum(caps) / len(caps)
            need = demand / max(self.target_utilization, 1e-9)
            total, n = 0.0, 0
            while total < need and n < self.max_replicas + len(caps):
                total += caps[n] if n < len(caps) else max(mean, 1e-9)
                n += 1
            return n
        capacity = evidence["capacity"]["per_replica_rows_s"]
        return int(math.ceil(
            demand / max(capacity * self.target_utilization, 1e-9)))

    def _scale_up(self, evidence: dict,
                  reason: str) -> AutoscaleDecision:
        members_before = evidence["members_n"]
        effective = max(1, members_before - len(evidence["gave_up"]))
        # a triggered surge always adds at least one replica even when
        # the demand estimate lags (SLO burn said capacity is short)
        target = max(self._sized_target(evidence), effective + 1)
        target = min(target, self.max_replicas)
        if effective >= self.max_replicas:
            return self._record(AutoscaleDecision(
                action="hold", outcome="at_max", reason=reason
                + f"; at max_replicas={self.max_replicas}, brownout "
                  "(quorum shed) is the last line",
                members_before=members_before,
                members_after=members_before,
                target=target, evidence=evidence))
        added: list[str] = []
        failures: list[str] = []
        for _ in range(target - effective):
            try:
                added.append(self.controller.add_replica(
                    probe_timeout_s=self.probe_timeout_s))
            except Exception as e:  # noqa: BLE001 - a failed
                # admission reaps its own replica; the loop records
                # the shortfall and retries on fresh evidence
                if is_device_fault(e):
                    raise
                failures.append(f"{type(e).__name__}: {e}")
                log.warning("%s scale-up admission failed: %s",
                            LOG_PREFIX, e)
                break
        with self._lock:
            self.scale_ups += 1
            self.replicas_added += len(added)
        members_after = len(self.controller.member_instances())
        log.info("%s autoscaler SCALE UP %d -> %d (%s): added %s",
                 LOG_PREFIX, members_before, members_after, reason,
                 added or "none")
        return self._record(AutoscaleDecision(
            action="scale_up", outcome="trigger", reason=reason,
            members_before=members_before, members_after=members_after,
            target=target,
            evidence=dict(evidence, added=added,
                          admission_failures=failures or None)))

    def _scale_down(self, evidence: dict,
                    reason: str) -> AutoscaleDecision:
        members_before = evidence["members_n"]
        target = max(self.min_replicas, self._sized_target(evidence))
        victims_n = evidence["serving_n"] - target
        if victims_n <= 0:
            return self._record(AutoscaleDecision(
                action="hold", outcome="at_target", reason=reason,
                members_before=members_before,
                members_after=members_before, target=target,
                evidence=evidence))
        # retire the youngest members first: the longest-lived
        # replicas keep their warm caches and observation history
        victims = sorted(
            self.controller.member_instances(), reverse=True,
            key=lambda name: (len(name), name))[:victims_n]
        retired: list[dict] = []
        for victim in victims:
            try:
                retired.append(self.controller.remove_replica(
                    victim, drain_timeout_s=self.drain_timeout_s))
            except Exception as e:  # noqa: BLE001 - a victim that
                # cannot retire (already dead, race with supervision)
                # is recorded; the next window re-plans from evidence
                if is_device_fault(e):
                    raise
                retired.append({"instance": victim, "error": str(e)})
                log.warning("%s scale-down of %s failed: %s",
                            LOG_PREFIX, victim, e)
        with self._lock:
            self.scale_downs += 1
            self.replicas_removed += sum(
                1 for r in retired if not r.get("error"))
        members_after = len(self.controller.member_instances())
        log.info("%s autoscaler SCALE DOWN %d -> %d (%s): retired %s",
                 LOG_PREFIX, members_before, members_after, reason,
                 [r.get("instance") for r in retired])
        return self._record(AutoscaleDecision(
            action="scale_down", outcome="trigger", reason=reason,
            members_before=members_before, members_after=members_after,
            target=target, evidence=dict(evidence, retired=retired)))

    # -- live knob retune (satellite) ---------------------------------------
    def _should_retune(self, direction: str, outcome: str,
                       evidence: dict) -> bool:
        """Retune rides the loop when replica count HOLDS but p99
        burns: latency pressure without a capacity trigger is a knob
        problem, not a fleet-size problem."""
        if not self.retune_enabled or direction != "up" \
                or outcome == "trigger":
            return False
        if self.measure_fn is None and self.probe_records is None:
            return False  # no probe seam wired: nothing to measure
        with self._lock:
            if self._retune_cooldown_left > 0:
                return False
        return any("latency" in name or "p99" in name
                   for name in evidence["slo_firing"])

    def _ab_retune(self, evidence: dict,
                   reason: str) -> AutoscaleDecision:
        from ..autotune import KnobTuner, microbatch_candidates

        router = self.controller.router
        baseline = {"max_batch_size": self.ref_batch_rows,
                    "max_wait_us": 0}
        tuner = KnobTuner(cost_model=router.cost_model,
                          margin=self.retune_margin,
                          repeats=self.retune_probe_repeats)
        decision = tuner.ab_probe(
            "serving.microbatch", baseline,
            microbatch_candidates(baseline,
                                  cost_model=router.cost_model),
            self._measure_knobs)
        # apply the winner fleet-wide; a baseline win RESTORES the
        # hand-set default - tuned knobs never regress past it
        source = "autotune" if decision.tuned else "hand_set"
        winner = (dict(decision.winner) if decision.tuned
                  else {"max_batch_size": 0, "max_wait_us": 0})
        applied = router.broadcast("retune",
                                   dict(winner, source=source))
        with self._lock:
            self.retunes += 1
            self._retune_cooldown_left = self.retune_cooldown_windows
        n = evidence["members_n"]
        log.info("%s autoscaler retune (%s): %s -> %s on %d "
                 "replica(s)", LOG_PREFIX, reason,
                 "tuned" if decision.tuned else "baseline held",
                 decision.winner, len(applied))
        return self._record(AutoscaleDecision(
            action="retune",
            outcome="tuned" if decision.tuned else "baseline_held",
            reason=reason, members_before=n, members_after=n,
            target=None,
            evidence=dict(evidence,
                          knob_decision=decision.to_json(),
                          applied_on=sorted(applied))))

    def _measure_knobs(self, knobs: dict) -> float:
        """Measure one knob arm: the injected ``measure_fn`` when the
        caller provided one (tests; custom measuring code), else apply the
        knobs live via the worker ``retune`` verb and score the probe
        records through the router, returning rows/s."""
        if self.measure_fn is not None:
            return float(self.measure_fn(knobs))
        router = self.controller.router
        router.broadcast("retune", dict(knobs, source="probe"))
        records = self.probe_records or []
        if not records:
            raise RuntimeError("no probe records to measure with")
        t0 = time.perf_counter()
        res = router.score_batch(records,
                                 timeout_s=self.probe_timeout_s)
        wall = max(time.perf_counter() - t0, 1e-9)
        return len(res.results()) / wall

    # -- recording + reporting ----------------------------------------------
    def _record(self,
                decision: AutoscaleDecision) -> AutoscaleDecision:
        with self._lock:
            self._decisions.append(decision)
            if len(self._decisions) > MAX_DECISIONS:
                del self._decisions[0]
            self.decisions_total += 1
        tracer().event("autoscaler.decision",
                       action=decision.action,
                       outcome=decision.outcome,
                       reason=decision.reason,
                       members_before=decision.members_before,
                       members_after=decision.members_after,
                       target=decision.target,
                       evidence=dict(decision.evidence))
        return decision

    def decisions(self) -> list[AutoscaleDecision]:
        with self._lock:
            return list(self._decisions)

    def snapshot(self) -> dict:
        """The ``autoscaler`` metrics view (``tx_autoscaler_*``) and
        the ``fleet_status.json`` / ``tx fleet status`` column set."""
        with self._lock:
            last = (self._decisions[-1].to_json()
                    if self._decisions else None)
            out: dict[str, Any] = {
                "alive": self.alive(),
                "crashed": self.crashed,
                "steps": self.steps,
                "decisions_total": self.decisions_total,
                "scale_ups": self.scale_ups,
                "scale_downs": self.scale_downs,
                "retunes": self.retunes,
                "replicas_added": self.replicas_added,
                "replicas_removed": self.replicas_removed,
                "errors": self.errors,
                "retune_cooldown_left": self._retune_cooldown_left,
            }
        out["min_replicas"] = self.min_replicas
        out["max_replicas"] = self.max_replicas
        out["members"] = len(self.controller.member_instances())
        out["governor"] = self.governor.snapshot()
        out["demand_rows_s"] = (round(self._last_demand, 1)
                                if self._last_demand is not None
                                else None)
        out["utilization"] = (round(self._last_utilization, 4)
                              if self._last_utilization is not None
                              else None)
        out["capacity"] = dict(self._last_capacity)
        out["last_decision"] = last
        return out
