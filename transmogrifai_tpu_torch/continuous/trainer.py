"""ContinuousTrainer: the data -> drift -> refit -> canary -> promote loop,
closed.

Host copy of ``transmogrifai_tpu/continuous/trainer.py``.  Every building
block exists elsewhere in the package; this
daemon joins them, driving each through its public seams:

* **tail** - a :class:`~..readers.pipeline.ShardDirectoryFollower`
  watches a shard directory and feeds each poll's new files through the
  interleave/prefetch pipeline (``pipelined_columns``), so a window's
  ingest is the same parallel read a batch run gets.
* **detect** - each window of rows is scored by the
  :class:`~..schema.drift.DriftMonitor` against the CURRENT stable
  model's training contract, ``reset()`` at every window boundary
  (windowed, not cumulative), and the per-window worst JS feeds the
  :class:`~.governor.RefitGovernor` hysteresis/cooldown machine.  A refit
  is a governor decision, never a human's.
* **refit** - a fresh workflow from the factory retrains on the bounded
  buffer of most-recent rows, on the workflow's device (the card by
  default: the SanityChecker's K1 and the tree families' K2 run there),
  with the fused-training knob installed on its validators.
* **publish + canary** - the new version goes through
  :class:`~..registry.store.ModelRegistry`; with a fleet attached the
  :class:`~..fleet.controller.FleetController` runs
  canary -> shadow-score -> auto-promote-or-rollback, the SLO engine
  wired into ``check_canary`` as the rollback signal, and a canary whose
  verdict window expires undecided is RELEASED (slot freed, no
  judgement) rather than rolled back.  Without a fleet the publish
  promotes directly by a pointer flip (the batch ``continuous`` run
  type).
* **observe** - every cycle runs under ONE ``continuous.cycle`` trace id
  (detect / refit / publish / canary / verdict child spans), a ``continuous``
  metrics view rides the obs scrape (``tx_continuous_*``), and
  ``continuous_status.json`` is published atomically (tempfile +
  replace).

The refit has no catch-all: an error in it, a device fault included,
ends the cycle before the publish, so the registry keeps its stable.

``train_cache_dir`` is accepted for the JAX package's signature and
left unused: the port keeps no compiled-program cache (the validator
does the same).

Fault points:

* ``continuous.refit_crash`` - hard kill in the window between refit
  completion and registry publish: the registry (and therefore the
  fleet) must keep the old stable, and the NEXT cycle (a fresh daemon
  re-polling the same shards) must recover end-to-end.
* ``drift.false_positive`` - forces a trigger on a healthy window: the
  refit is published and promoted on its merits (in fleet mode the
  healthy canary auto-promotes or cleanly releases the slot), so a
  spurious detection cannot wedge or degrade the loop.
"""
from __future__ import annotations

import json
import logging
import os
import tempfile
import time
from collections import deque
from typing import Any, Callable, Optional, Union

from ..faults import injection as _faults
from ..obs import trace as _obs_trace
from ..obs.metrics import metrics_registry, process_instance
from ..readers.pipeline import ShardDirectoryFollower, pipelined_columns
from ..registry.store import ModelRegistry
from ..schema.drift import DriftMonitor
from .governor import RefitGovernor

log = logging.getLogger("transmogrifai_tpu_torch.continuous")

#: the atomically-published status document, next to the watch dir (or
#: wherever ``status_dir`` points) — ``tx continuous status`` reads it
STATUS_FILENAME = "continuous_status.json"


class ContinuousError(RuntimeError):
    """The continuous loop cannot run as configured (no stable model to
    supersede and bootstrap disabled, factory broken, ...)."""


class ContinuousTrainer:
    """Drift-triggered refit controller over one watched shard dir.

    ``registry`` is a :class:`ModelRegistry` or its root path;
    ``workflow_factory`` is a zero-arg callable returning a FRESH
    workflow (or a tuple whose first element is one), or an importable
    ``module:function`` spec - the same contract fleet replica workers
    use, so the daemon, the workers and the seed trainer all rebuild the
    identical workflow.  ``fleet`` is an optional started
    :class:`~..fleet.controller.FleetController`; without one, promote
    is a direct registry pointer flip."""

    def __init__(
        self,
        watch_dir: str,
        registry: Union[ModelRegistry, str],
        workflow_factory: Union[Callable[[], Any], str],
        *,
        fleet=None,
        status_dir: Optional[str] = None,
        drift_threshold: float = 0.1,
        consecutive_windows: int = 3,
        cooldown_windows: int = 2,
        min_window_rows: int = 64,
        refit_rows: int = 4096,
        train_fused: Optional[bool] = None,
        pipeline_workers: int = 2,
        settle_s: float = 0.0,
        bootstrap: bool = False,
        train_cache_dir: Optional[str] = None,
        canary_fraction: float = 0.5,
        canary_min_rows: int = 48,
        canary_timeout_s: float = 90.0,
        canary_poll_s: float = 0.1,
    ) -> None:
        if isinstance(workflow_factory, str):
            from ..fleet.worker import load_workflow_factory

            workflow_factory = load_workflow_factory(workflow_factory)
        self.fleet = fleet
        self.workflow_factory = workflow_factory
        self.registry = (registry if isinstance(registry, ModelRegistry)
                         else ModelRegistry(str(registry)))
        self.watch_dir = str(watch_dir)
        self.follower = ShardDirectoryFollower(self.watch_dir,
                                               settle_s=settle_s)
        self.status_dir = str(status_dir) if status_dir else None
        self.drift_threshold = float(drift_threshold)
        self.min_window_rows = int(min_window_rows)
        self.refit_rows = int(refit_rows)
        self.train_fused = train_fused
        self.pipeline_workers = int(pipeline_workers)
        #: accepted and unused: the port keeps no compiled-program cache
        self.train_cache_dir = (str(train_cache_dir)
                                if train_cache_dir else None)
        self.canary_fraction = float(canary_fraction)
        self.canary_min_rows = int(canary_min_rows)
        self.canary_timeout_s = float(canary_timeout_s)
        self.canary_poll_s = max(float(canary_poll_s), 0.01)
        # bounded most-recent-rows refit buffer: a refit trains on the
        # freshest refit_rows rows the tail has seen, nothing older
        self._buffer: deque = deque(maxlen=self.refit_rows)
        self.governor = RefitGovernor(
            threshold=self.drift_threshold,
            consecutive=consecutive_windows,
            cooldown=cooldown_windows,
        )
        self.instance = process_instance()
        # counters (the `continuous` metrics view)
        self.cycles = 0
        self.refits = 0
        self.promotes = 0
        self.rollbacks = 0
        self.releases = 0
        self.forced_triggers = 0
        self.rows_ingested = 0
        self.last_max_js = 0.0
        self.refit_cache = {"hits": 0, "misses": 0, "stale": 0,
                            "memory": 0}
        self.last_refit: Optional[dict] = None
        self.last_cycle: Optional[dict] = None
        self.last_trace: Optional[str] = None
        # baseline: the CURRENT stable model's training contract
        self.version = self.registry.stable
        if self.version is None:
            if not bootstrap:
                raise ContinuousError(
                    f"registry {self.registry.root} has no stable "
                    "version to supersede (pass bootstrap=True to "
                    "train + publish one from the factory workflow)")
            with _obs_trace.span("continuous.bootstrap"):
                model = self._fresh_workflow().train()
                entry = self.registry.publish(model, stage="stable")
            self.version = entry.version
            self.model = model
        else:
            self.model = self.registry.load_stable(
                self._fresh_workflow())
        self._raw_features = tuple(self._fresh_workflow().raw_features)
        self.monitor = self._monitor_for(self.model)
        metrics_registry().register_view("continuous", self)
        self.publish_status()

    # -- plumbing -----------------------------------------------------------
    def _fresh_workflow(self):
        built = self.workflow_factory()
        return built[0] if isinstance(built, tuple) else built

    def _monitor_for(self, model) -> DriftMonitor:
        contract = getattr(model, "schema_contract", None)
        if contract is None:
            raise ContinuousError(
                "stable model carries no schema contract - drift "
                "detection needs the training distributions (train "
                "with parameters(schema_contract=True), the default)")
        if not contract.distributions:
            log.warning("stable model's contract has no captured "
                        "distributions: drift can never trigger")
        return DriftMonitor(contract,
                            warn_threshold=self.drift_threshold)

    def _adopt(self, model, version: str) -> None:
        """The promoted refit becomes the drift baseline: subsequent
        windows score against ITS training contract."""
        self.model = model
        self.version = version
        self.monitor = self._monitor_for(model)

    # -- ingest -------------------------------------------------------------
    def _ingest(self, specs) -> list:
        """One poll's shards → row records, through the sharded pipeline
        (interleaved parse + prefetch), in deterministic shard order."""
        schema = {f.name: f.ftype for f in self._raw_features}
        pipe = self.follower.pipeline(
            specs, schema, workers=self.pipeline_workers)
        if pipe is None:
            return []
        cols = {name: col.to_list()
                for name, col in pipelined_columns(pipe).items()}
        names = list(cols)
        n = len(cols[names[0]]) if names else 0
        return [{k: cols[k][i] for k in names} for i in range(n)]

    # -- refit --------------------------------------------------------------
    def _refit(self) -> tuple:
        """Retrain a fresh factory workflow on the buffered recent rows
        with the fused-training knob installed; returns (model,
        train_fused trail, rows trained on)."""
        from ..workflow.runner import train_fused_summary

        rows = list(self._buffer)
        wf = self._fresh_workflow()
        names = [f.name for f in self._raw_features]
        wf.set_input_dataset(
            {name: [r.get(name) for r in rows] for name in names})
        validators = self._install_train_fused(wf)
        model = wf.train()
        trail = train_fused_summary(validators)
        return model, trail, len(rows)

    def _install_train_fused(self, wf) -> list:
        from ..workflow.dag import compute_dag

        validators = []
        for layer in compute_dag(wf.result_features):
            for stage in layer:
                if getattr(stage, "is_model_selector", False):
                    v = stage.validator
                    if self.train_fused is not None:
                        v.train_fused = bool(self.train_fused)
                    validators.append(v)
        return validators

    def _fold_refit_trail(self, trail: Optional[dict]) -> None:
        self.last_refit = trail
        if not trail:
            return
        for key in ("hits", "misses", "stale"):
            self.refit_cache[key] += int(
                trail.get("cache", {}).get(key, 0))
        self.refit_cache["memory"] += sum(
            1 for fam in trail.get("families", {}).values()
            if fam.get("cache") == "memory")

    # -- one cycle ----------------------------------------------------------
    def run_cycle(self) -> dict:
        """Poll → window-score → (maybe) refit → publish → canary →
        verdict, the whole cycle under ONE trace id.  Returns the cycle
        document (also kept as ``last_cycle`` and folded into the
        status file)."""
        self.cycles += 1
        cycle: dict = {"cycle": self.cycles, "verdict": "idle",
                       "rows": 0, "shards": 0, "outcome": None}
        with _obs_trace.span("continuous.cycle",
                             cycle=self.cycles) as root:
            cycle["trace"] = root.trace_id
            self.last_trace = root.trace_id
            verdict, forced = self._detect(cycle)
            if verdict == "trigger":
                self.refits += 1
                with _obs_trace.span(
                        "continuous.refit",
                        trigger_js=cycle.get("max_js"),
                        forced=forced) as sp:
                    model, trail, train_rows = self._refit()
                    self._fold_refit_trail(trail)
                    cycle["refit"] = {"rows": train_rows,
                                      "train_fused": trail}
                    sp.set_attr("rows", train_rows)
                # THE crash window the refit_crash drill kills in: the
                # refit exists only in this process; the registry (and
                # therefore the fleet) must be unaffected by dying here
                _faults.inject_kill("continuous.refit_crash")
                with _obs_trace.span("continuous.publish") as sp:
                    entry = self.registry.publish(model, metrics={
                        "trigger": "continuous",
                        "max_js": cycle.get("max_js"),
                        "forced": forced,
                    })
                    sp.set_attr("version", entry.version)
                cycle["published"] = entry.version
                cycle["outcome"] = self._rollout(
                    entry.version, model, cycle)
        self.last_cycle = cycle
        self.publish_status()
        return cycle

    def _detect(self, cycle: dict) -> tuple:
        """The detect phase: ingest new shards, score the window
        against the stable contract, ask the governor."""
        with _obs_trace.span("continuous.detect") as sp:
            specs = self.follower.poll()
            records = self._ingest(specs) if specs else []
            n = len(records)
            cycle["rows"] = n
            cycle["shards"] = len(specs)
            self.rows_ingested += n
            if records:
                self._buffer.extend(records)
            forced = _faults.fires("drift.false_positive") is not None
            if forced:
                self.forced_triggers += 1
            max_js = 0.0
            if records:
                self.monitor.reset()
                self.monitor.observe(records)
                scores = self.monitor.scores()
                max_js = max(scores.values(), default=0.0)
                self.last_max_js = max_js
                cycle["scores"] = scores
            if not records and not forced:
                verdict = "idle"
            elif n < self.min_window_rows and not forced:
                # an under-filled window judges NOTHING: too few rows
                # to trust the score, too few to call the stream clear
                verdict = "thin"
            else:
                verdict = self.governor.observe_window(max_js,
                                                       forced=forced)
            cycle["verdict"] = verdict
            cycle["max_js"] = round(max_js, 6)
            cycle["forced"] = forced
            sp.set_attr("verdict", verdict)
            sp.set_attr("rows", n)
            sp.set_attr("max_js", round(max_js, 6))
        return verdict, forced

    def _rollout(self, version: str, model, cycle: dict) -> str:
        """Publish -> promote hand-off.  Fleet mode: canary at
        ``canary_fraction``, poll merged telemetry until the policy
        rolls back, ``canary_min_rows`` canary rows auto-promote, or
        the verdict window expires and the slot is released undecided.
        Direct mode: stable pointer flip.  A promoted refit becomes the
        drift baseline."""
        if self.fleet is None:
            with _obs_trace.span("continuous.verdict", version=version,
                                 mode="direct"):
                self.registry.promote(version, to="stable")
                self.promotes += 1
                self._adopt(model, version)
            return "promote"
        outcome: Optional[str] = None
        decision = None
        canary_rows = 0
        with _obs_trace.span("continuous.canary", version=version,
                             fraction=self.canary_fraction) as sp:
            self.fleet.start_canary(version,
                                    fraction=self.canary_fraction)
            deadline = time.monotonic() + self.canary_timeout_s
            while time.monotonic() < deadline:
                decision = self.fleet.check_canary()
                if decision is not None and decision.rollback:
                    outcome = "rollback"
                    break
                tel = self.fleet.canary_telemetry()
                canary_rows = int(
                    tel.get("canary", {}).get("rows_scored") or 0)
                if canary_rows >= self.canary_min_rows:
                    outcome = "promote"
                    break
                time.sleep(self.canary_poll_s)  # bounded poll quantum
            sp.set_attr("rows", canary_rows)
            sp.set_attr("outcome", outcome or "timeout")
        cycle["canary_rows"] = canary_rows
        with _obs_trace.span("continuous.verdict",
                             version=version) as sp:
            if outcome == "promote":
                self.fleet.promote_canary()
                self.promotes += 1
                self._adopt(model, version)
            elif outcome == "rollback":
                # check_canary already rolled the fleet back; the old
                # baseline stays the drift reference
                self.rollbacks += 1
                cycle["rollback_reasons"] = [
                    dict(r) for r in decision.reasons]
            else:
                outcome = "release"
                self.fleet.release_canary(
                    reason="continuous: canary verdict window "
                           "expired undecided")
                self.releases += 1
            sp.set_attr("outcome", outcome)
        return outcome

    # -- daemon loop --------------------------------------------------------
    def run(self, max_cycles: Optional[int] = None,
            idle_exit: Optional[int] = None,
            poll_interval_s: float = 0.5,
            deadline_s: Optional[float] = None) -> list:
        """Run cycles until ``max_cycles``, ``idle_exit`` consecutive
        empty polls, or ``deadline_s`` wall seconds — all optional; a
        true daemon passes none of them and runs forever.  Returns the
        cycle documents."""
        out = []
        idle = 0
        t0 = time.monotonic()
        while True:
            cycle = self.run_cycle()
            out.append(cycle)
            idle = idle + 1 if cycle["rows"] == 0 else 0
            if max_cycles is not None and len(out) >= max_cycles:
                break
            if idle_exit is not None and idle >= idle_exit:
                break
            if (deadline_s is not None
                    and time.monotonic() - t0 >= deadline_s):
                break
            time.sleep(max(float(poll_interval_s), 0.01))
        return out

    # -- observability ------------------------------------------------------
    def snapshot(self) -> dict:
        """The ``continuous`` metrics view (flat numeric leaves →
        ``tx_continuous_*`` gauges in the Prometheus scrape)."""
        return {
            "cycles": self.cycles,
            "windows": self.governor.windows,
            "refits": self.refits,
            "promotes": self.promotes,
            "rollbacks": self.rollbacks,
            "releases": self.releases,
            "suppressed_triggers": self.governor.suppressed,
            "forced_triggers": self.forced_triggers,
            "rows_ingested": self.rows_ingested,
            "shards_seen": self.follower.shards_seen,
            "buffer_rows": len(self._buffer),
            "last_max_js": self.last_max_js,
            "refit_cache_hits": self.refit_cache["hits"],
            "refit_cache_misses": self.refit_cache["misses"],
            "refit_cache_stale": self.refit_cache["stale"],
            "refit_cache_memory": self.refit_cache["memory"],
        }

    def status(self) -> dict:
        """The one consistent continuous-loop document (counters +
        governor state + last cycle) — what ``tx continuous status``
        renders and ``continuous_status.json`` persists."""
        return {
            "t": time.time(),
            "instance": self.instance,
            "watch_dir": self.watch_dir,
            "registry_root": self.registry.root,
            "mode": "fleet" if self.fleet is not None else "direct",
            "stable_version": self.version,
            "registry_stable": self.registry.stable,
            "counters": self.snapshot(),
            "governor": self.governor.snapshot(),
            "last_cycle": self.last_cycle,
            "last_trace": self.last_trace,
        }

    def publish_status(self) -> Optional[str]:
        """Atomically publish ``continuous_status.json`` (tempfile +
        replace: a reader sees a
        complete document or the previous one, never a torn one)."""
        if self.status_dir is None:
            return None
        path = os.path.join(self.status_dir, STATUS_FILENAME)
        try:
            os.makedirs(self.status_dir, exist_ok=True)
            fd, tmp = tempfile.mkstemp(dir=self.status_dir,
                                       suffix=".tmp")
            with os.fdopen(fd, "w") as f:
                json.dump(self.status(), f, indent=1, sort_keys=True,
                          default=str)
            os.replace(tmp, path)
        except OSError as e:
            log.warning("continuous status publish failed: %s", e)
            return None
        return path
