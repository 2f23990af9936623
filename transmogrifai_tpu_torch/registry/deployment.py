"""Zero-downtime deployment control over compiled serving endpoints.

The serve-plane half of the registry (reference frame: TF-Serving's
servable manager, which advances versions under live traffic without
dropping requests; the reference's local scoring has no lifecycle at
all): a :class:`DeploymentController` owns the live GENERATIONS — one
stable, optionally one canary — each a fully warmed
:class:`~..serving.endpoint.CompiledEndpoint` with its own
``ServingTelemetry`` and breaker, tagged with the registry version it
serves.

Guarantees:

* **Hot-swap never drops or double-scores.**  Scoring resolves the
  generation pointers ONCE per call under the routing lock and then
  scores on those objects; :meth:`deploy` builds and warms the new
  endpoint entirely OFF-pointer and publishes it with a single pointer
  flip under the same lock.  A batch that resolved the old generation
  finishes on it (the object stays alive as long as any call holds it);
  a batch that resolves after the flip scores on the new one; no batch
  can observe half a swap.  The ``registry.swap_crash`` fault point
  raises inside the swap window to drill that a failed deploy leaves
  the old generation serving untouched.
* **Canary routing is deterministic.**  A record routes to the canary
  iff ``murmur3(canonical-json(record), split_seed) % 10000`` falls
  under ``fraction * 10000`` — the same record always lands on the same
  arm across processes and retries (no flappy per-request coin flips),
  and the split needs no caller-provided request id.
* **Shadow scoring never touches responses.**  With ``shadow=True`` the
  full batch scores on stable (those are the returned results) and the
  candidate scores the same rows on the side; per-row output deltas
  accumulate in :meth:`shadow_stats`.
* **Rollback is automatic and evidenced.**  Every ``check_every_batches``
  scored batches the :class:`~.rollback.RollbackPolicy` compares the
  canary's live telemetry against stable's; a breach demotes the canary
  in one pointer flip, records the decision + evidence in both arms'
  telemetry lifecycle and :meth:`summary_json`, and (when a registry is
  attached) in the registry lineage.  Fault points ``canary.regression``
  (poisons live canary outputs through the same NaN-guard + breaker
  accounting the endpoint applies) and ``canary.latency`` (inflates the
  canary arm's latency inside its timed window) drill the loop end to
  end.

Port of ``transmogrifai_tpu/registry/deployment.py``.  A device fault
(``kernels.is_device_fault``: a kernel that does not build or launch, a
CUDA error) raised by the canary arm or the shadow escapes unchanged:
the canary's rows are not re-scored on stable after one.  A new
generation warms on the current CUDA stream, the one live traffic
scores on.  The fleet view reads a callable or, path-valued, a
published status document through ``obs.fleet.read_json_torn_safe``.
"""
from __future__ import annotations

import json
import logging
import math
import threading
import time
from dataclasses import dataclass
from typing import Any, Mapping, Optional, Sequence

from ..faults import injection as _faults
from ..obs import trace as _obs_trace
from ..parallel.kernels import is_device_fault
from ..serving.endpoint import (
    CompiledEndpoint,
    RowScoringError,
    compile_endpoint,
)
from ..serving.telemetry import ServingTelemetry
from ..utils.hashing import murmur3_32
from .rollback import RollbackDecision, RollbackPolicy
from .store import ModelRegistry, RegistryError

log = logging.getLogger("transmogrifai_tpu_torch.registry")

LOG_PREFIX = "op_registry_metrics"

#: lifecycle events kept on the controller (bounded like telemetry)
_MAX_EVENTS = 256

#: hash-split resolution: fractions quantize to 1/10000 (0.01% traffic)
_SPLIT_BUCKETS = 10000


@dataclass
class Generation:
    """One live deployed model generation."""

    generation: int
    version: str
    endpoint: CompiledEndpoint
    deployed_at: float

    def snapshot(self) -> dict:
        return {
            "generation": self.generation,
            "version": self.version,
            "deployed_at": self.deployed_at,
            "telemetry": self.endpoint.telemetry.snapshot(),
        }


def route_key(record: Mapping[str, Any]) -> str:
    """Canonical routing key for the deterministic canary split (the
    record's sorted-key JSON: stable across dict ordering and
    processes)."""
    return json.dumps(record, sort_keys=True, default=str)


class DeploymentController:
    """Stable/canary generation pointers + deterministic traffic split.

    ``endpoint_kw`` defaults apply to every generation this controller
    compiles (buckets, breaker knobs, drift policy); per-deploy
    overrides ride the ``deploy``/``start_canary`` calls.
    """

    def __init__(
        self,
        registry: Optional[ModelRegistry] = None,
        policy: Optional[RollbackPolicy] = None,
        canary_fraction: float = 0.05,
        shadow: bool = False,
        split_seed: int = 42,
        check_every_batches: int = 8,
        model_id: Optional[str] = None,
        track_registry: bool = True,
        **endpoint_kw: Any,
    ) -> None:
        if not (0.0 <= canary_fraction <= 1.0):
            raise ValueError("canary_fraction must be in [0, 1]")
        self.registry = registry
        #: multi-model serving: which hosted model this
        #: controller's lifecycle belongs to.  None = the single-model
        #: surface; set, it rides every generation's telemetry as the
        #: ``model_id`` label.
        self.model_id = None if model_id is None else str(model_id)
        #: whether lifecycle transitions mutate the registry's single
        #: stable/canary stage slots.  A model-multiplexed replica hosts
        #: N versions with INDEPENDENT lifecycles — N controllers racing
        #: one registry stage pointer would churn it, so the ModelTable
        #: runs with ``track_registry=False`` (loads still come from the
        #: registry; only stage promotion/rollback bookkeeping is off).
        self.track_registry = bool(track_registry)
        self.policy = policy if policy is not None else RollbackPolicy()
        self.canary_fraction = float(canary_fraction)
        self.shadow = bool(shadow)
        self.split_seed = int(split_seed)
        self.check_every_batches = max(1, int(check_every_batches))
        self._endpoint_kw = dict(endpoint_kw)
        # the routing lock guards ONLY the pointer reads/flips (never
        # held while scoring); the deploy lock serializes the slow
        # build-and-warm path so two deploys cannot interleave
        self._route_lock = threading.Lock()
        self._deploy_lock = threading.Lock()
        self._stable: Optional[Generation] = None
        self._canary: Optional[Generation] = None
        self._gen_counter = 0
        self._batches_since_check = 0
        self._events: list[dict] = []
        self._shadow_lock = threading.Lock()
        self._shadow_stats = {
            "rows": 0, "rows_differed": 0,
            "max_abs_delta": 0.0, "sum_abs_delta": 0.0,
        }
        #: fleet view source: a zero-arg callable returning the fleet
        #: status document, or a path to a published
        #: ``fleet_status.json`` read torn-safe -
        #: ``summary_json()`` then carries per-replica generation /
        #: heartbeat age / in-flight in ONE consistent document instead
        #: of every consumer re-reading N obs shards
        self.fleet_status_source: Optional[Any] = None

    # -- lifecycle ----------------------------------------------------------
    def _event(self, event: str, **kw: Any) -> dict:
        entry = {"event": event, "t": time.time(), **kw}
        with self._route_lock:
            self._events.append(entry)
            if len(self._events) > _MAX_EVENTS:
                del self._events[0]
        # every lifecycle event is also a zero-duration span on the
        # ambient run trace (obs/): a swap/canary/rollback lines up
        # causally with the serving batches around it
        _obs_trace.tracer().event("deploy." + event, **kw)
        return entry

    def _build_generation(self, model, version: str,
                          **endpoint_kw: Any) -> tuple[Generation, float]:
        """Compile + warm a new generation entirely off-pointer."""
        kw = dict(self._endpoint_kw, **endpoint_kw)
        telemetry = kw.pop("telemetry", None) or ServingTelemetry()
        gen_id = self._gen_counter + 1
        telemetry.set_model_version(version, generation=gen_id)
        if self.model_id is not None:
            telemetry.set_model_id(self.model_id)
        t0 = time.perf_counter()
        endpoint = compile_endpoint(model, telemetry=telemetry, **kw)
        warm_s = time.perf_counter() - t0
        return Generation(
            generation=gen_id, version=version, endpoint=endpoint,
            deployed_at=time.time(),
        ), warm_s

    def deploy(self, model, version: str = "unversioned",
               **endpoint_kw: Any) -> Generation:
        """Hot-swap ``model`` in as the new stable generation.  The old
        generation keeps serving until the single pointer flip; a fault
        raised in the swap window (``registry.swap_crash``) leaves it
        serving untouched."""
        with self._deploy_lock:
            gen, warm_s = self._build_generation(model, version,
                                                 **endpoint_kw)
            # swap-crash drill: the new endpoint is built but not yet
            # published — a failure here must not disturb the old
            # generation (callers keep scoring through it)
            _faults.inject("registry.swap_crash")
            t0 = time.perf_counter()
            with self._route_lock:
                self._gen_counter = gen.generation
                old = self._stable
                self._stable = gen
            flip_us = (time.perf_counter() - t0) * 1e6
        event = self._event(
            "swap", version=version, generation=gen.generation,
            from_version=old.version if old else None,
            warm_s=round(warm_s, 4), flip_us=round(flip_us, 1),
        )
        gen.endpoint.telemetry.record_lifecycle(event)
        log.info(
            "%s generation %d (version %s) live: warmed in %.3fs, "
            "pointer flip %.1fus", LOG_PREFIX, gen.generation, version,
            warm_s, flip_us,
        )
        return gen

    def deploy_version(self, version: str, workflow,
                       **endpoint_kw: Any) -> Generation:
        """Load ``version`` from the attached registry, promote it to
        the registry's stable slot, then hot-swap it in.  The promote
        runs FIRST so an ineligible version (e.g. retired — revert via
        ``registry.rollback`` instead) fails fast with the live pointer
        and the registry both untouched; if the swap itself then fails,
        the registry already names the intended stable (desired state)
        while the old generation keeps serving — loud and retryable,
        never silently divergent."""
        if self.registry is None:
            raise RegistryError("deploy_version needs an attached registry")
        model = self.registry.load(version, workflow)
        if (self.track_registry
                and self.registry.get(version).stage != "stable"):
            self.registry.promote(version, to="stable")
        return self.deploy(model, version=version, **endpoint_kw)

    def start_canary(self, model, version: str = "candidate",
                     fraction: Optional[float] = None,
                     shadow: Optional[bool] = None,
                     **endpoint_kw: Any) -> Generation:
        """Bring a candidate up as the canary generation (hash-routed
        ``fraction`` of traffic, or shadow-scored)."""
        if fraction is not None and not (0.0 <= fraction <= 1.0):
            raise ValueError("canary fraction must be in [0, 1]")
        with self._deploy_lock:
            # preconditions BEFORE the expensive endpoint build+warm: a
            # bad fraction or an occupied slot must not cost a compile
            # or burn a generation id
            with self._route_lock:
                if self._stable is None:
                    raise RegistryError(
                        "cannot start a canary with no stable generation"
                    )
                if self._canary is not None:
                    raise RegistryError(
                        f"canary slot already held by generation "
                        f"{self._canary.generation} "
                        f"({self._canary.version})"
                    )
            gen, warm_s = self._build_generation(model, version,
                                                 **endpoint_kw)
            with self._route_lock:
                self._gen_counter = gen.generation
                if fraction is not None:
                    self.canary_fraction = float(fraction)
                if shadow is not None:
                    self.shadow = bool(shadow)
                self._canary = gen
                self._batches_since_check = 0
        event = self._event(
            "canary_start", version=version, generation=gen.generation,
            fraction=self.canary_fraction, shadow=self.shadow,
            warm_s=round(warm_s, 4),
        )
        gen.endpoint.telemetry.record_lifecycle(event)
        if self.registry is not None and self.track_registry:
            try:
                if self.registry.get(version).stage != "canary":
                    self.registry.promote(version, to="canary")
            except RegistryError as e:
                log.warning("canary %s not tracked in the registry: %s",
                            version, e)
        return gen

    def start_canary_version(self, version: str, workflow,
                             **kw: Any) -> Generation:
        if self.registry is None:
            raise RegistryError(
                "start_canary_version needs an attached registry")
        model = self.registry.load(version, workflow)
        return self.start_canary(model, version=version, **kw)

    def promote_canary(self) -> Generation:
        """The canary graduates: one pointer flip makes it stable (the
        same zero-drop discipline as deploy)."""
        with self._deploy_lock:
            with self._route_lock:
                canary = self._canary
                if canary is None:
                    raise RegistryError("no canary to promote")
                old = self._stable
                self._stable = canary
                self._canary = None
        event = self._event(
            "canary_promote", version=canary.version,
            generation=canary.generation,
            from_version=old.version if old else None,
        )
        canary.endpoint.telemetry.record_lifecycle(event)
        if self.registry is not None and self.track_registry:
            try:
                self.registry.promote(canary.version, to="stable")
            except RegistryError as e:
                log.warning("promoted canary %s not tracked in the "
                            "registry: %s", canary.version, e)
        return canary

    def rollback_canary(self, decision: Optional[RollbackDecision] = None,
                        reason: str = "manual") -> Optional[dict]:
        """Demote the canary (one pointer flip back to 100% stable);
        the decision + evidence land in lifecycle telemetry and, when a
        registry is attached, its lineage."""
        with self._route_lock:
            canary = self._canary
            if canary is None:
                return None
            self._canary = None
            stable = self._stable
        event = self._event(
            "rollback", version=canary.version,
            generation=canary.generation,
            reason=reason if decision is None else "policy",
            reasons=[dict(r) for r in decision.reasons] if decision
            else [],
            evidence=decision.evidence if decision else {},
        )
        canary.endpoint.telemetry.record_lifecycle(event)
        if stable is not None:
            stable.endpoint.telemetry.record_lifecycle(event)
        log.warning(
            "%s canary generation %d (version %s) ROLLED BACK: %s",
            LOG_PREFIX, canary.generation, canary.version,
            "; ".join(
                f"{r['signal']}={r['value']} (limit {r['threshold']})"
                for r in event["reasons"]
            ) or reason,
        )
        if self.registry is not None and self.track_registry:
            try:
                self.registry.rollback(
                    version=canary.version,
                    reason=event["reason"],
                    evidence=decision.to_json() if decision else None,
                )
            except RegistryError as e:
                log.warning("rolled-back canary %s not tracked in the "
                            "registry: %s", canary.version, e)
        return event

    def release_canary(self, reason: str = "undecided") -> Optional[dict]:
        """Drop the canary arm WITHOUT a judgement: the pointer flips
        back to 100% stable like a rollback, but the registry records a
        ``release_canary`` (version back to candidate, slot freed,
        verdict undecided) instead of a rollback — the path for a
        canary whose evaluation window expired before either verdict
        (the continuous trainer's verdict timeout).  Returns
        None when there is no canary to release."""
        with self._route_lock:
            canary = self._canary
            if canary is None:
                return None
            self._canary = None
            stable = self._stable
        event = self._event(
            "canary_release", version=canary.version,
            generation=canary.generation, reason=reason,
        )
        canary.endpoint.telemetry.record_lifecycle(event)
        if stable is not None:
            stable.endpoint.telemetry.record_lifecycle(event)
        log.info(
            "%s canary generation %d (version %s) released undecided: "
            "%s", LOG_PREFIX, canary.generation, canary.version, reason,
        )
        if self.registry is not None and self.track_registry:
            try:
                self.registry.release_canary(reason=reason)
            except RegistryError as e:
                log.warning("released canary %s not tracked in the "
                            "registry: %s", canary.version, e)
        return event

    def unload(self) -> Optional[str]:
        """Drop the stable generation pointer — the eviction seam the
        multi-model weighted LRU (fleet/multimodel.py) pulls when a cold
        model's compiled executables must yield cache space.  Returns
        the version that was serving (what a later rehydrate must
        redeploy), or None when nothing was loaded.  Refuses while a
        canary is in flight: an active lifecycle pins the model.  A call
        that raced a scoring batch is safe — the batch resolved its
        generation pointer before the flip and finishes on the live
        object; only NEW calls see the unloaded state (RegistryError),
        which the ModelTable answers with a rehydrate."""
        with self._deploy_lock:
            with self._route_lock:
                if self._canary is not None:
                    raise RegistryError(
                        f"cannot unload: canary generation "
                        f"{self._canary.generation} "
                        f"({self._canary.version}) is in flight"
                    )
                stable = self._stable
                self._stable = None
        if stable is None:
            return None
        event = self._event(
            "unload", version=stable.version,
            generation=stable.generation,
        )
        stable.endpoint.telemetry.record_lifecycle(event)
        log.info(
            "%s generation %d (version %s) unloaded (executables "
            "released; rehydrate on next hit)", LOG_PREFIX,
            stable.generation, stable.version,
        )
        return stable.version

    @property
    def loaded(self) -> bool:
        """True while a stable generation is resident (serving)."""
        with self._route_lock:
            return self._stable is not None

    # -- routing + scoring --------------------------------------------------
    @property
    def stable_generation(self) -> Optional[Generation]:
        with self._route_lock:
            return self._stable

    @property
    def canary_generation(self) -> Optional[Generation]:
        with self._route_lock:
            return self._canary

    def routes_to_canary(self, record: Mapping[str, Any],
                         fraction: Optional[float] = None) -> bool:
        """The deterministic split decision for one record."""
        frac = self.canary_fraction if fraction is None else fraction
        h = murmur3_32(route_key(record).encode("utf-8"),
                       self.split_seed) % _SPLIT_BUCKETS
        return h < int(frac * _SPLIT_BUCKETS)

    def score_batch(self, records: Sequence[Mapping[str, Any]]) -> list:
        return self.score_batch_with_info(records)[0]

    def score_batch_with_info(
        self, records: Sequence[Mapping[str, Any]]
    ) -> tuple[list, dict]:
        """Score one batch through the live generations; element i of
        the results aligns with records[i] (the endpoint contract).
        ``info`` names the exact generations that scored this call —
        pointer reads happen ONCE, so a concurrent hot-swap can never
        split one batch across half-swapped state."""
        with self._route_lock:
            stable, canary = self._stable, self._canary
            fraction, shadow = self.canary_fraction, self.shadow
        if stable is None:
            raise RegistryError("no stable generation deployed")
        info: dict[str, Any] = {
            "stable_generation": stable.generation,
            "stable_version": stable.version,
            "canary_rows": 0,
        }
        if not records:
            return self._score_arm(stable, records), info
        if canary is None:
            results = self._score_arm(stable, records)
            return results, info
        info["canary_generation"] = canary.generation
        info["canary_version"] = canary.version
        if shadow:
            results = self._score_arm(stable, records)
            self._shadow_score(canary, records, results)
            info["shadow_rows"] = len(records)
            self._maybe_check()
            return results, info
        canary_idx = [
            i for i, r in enumerate(records)
            if self.routes_to_canary(r, fraction)
        ]
        canary_set = set(canary_idx)
        stable_idx = [i for i in range(len(records))
                      if i not in canary_set]
        results: list = [None] * len(records)
        if stable_idx:
            for i, res in zip(stable_idx, self._score_arm(
                    stable, [records[i] for i in stable_idx])):
                results[i] = res
        if canary_idx:
            canary_records = [records[i] for i in canary_idx]
            t_canary = time.perf_counter()
            try:
                canary_results = self._score_arm(canary, canary_records,
                                                 is_canary=True)
            except Exception as e:  # noqa: BLE001 - canary isolation
                if is_device_fault(e):
                    raise
                # a canary defect (e.g. a stricter contract raising
                # SchemaDriftError) must never fail the stable-routed
                # rows that already scored: serve the canary's share on
                # STABLE instead, and charge the failure to the canary's
                # telemetry so the rollback policy sees it
                log.warning(
                    "canary arm failed a batch (%s: %s); re-scoring its "
                    "%d rows on stable", type(e).__name__, e,
                    len(canary_idx),
                )
                wall = time.perf_counter() - t_canary
                for _ in canary_idx:
                    canary.endpoint.telemetry.record_request(wall, "failed")
                canary_results = self._score_arm(stable, canary_records)
            for i, res in zip(canary_idx, canary_results):
                results[i] = res
        info["canary_rows"] = len(canary_idx)
        self._maybe_check()
        return results, info

    def __call__(self, record: Mapping[str, Any]) -> Any:
        return self.score_batch([record])[0]

    def _score_arm(self, gen: Generation,
                   records: Sequence[Mapping[str, Any]],
                   is_canary: bool = False,
                   record_requests: bool = True) -> list:
        """Score one arm's share of a batch on its generation, with
        per-row request accounting into that generation's telemetry (at
        this surface the request latency IS the arm's batch wall — the
        controller is the serve boundary here, there is no queue)."""
        t0 = time.perf_counter()
        if is_canary:
            # inside the timed window: injected canary slowness must be
            # visible to the latency-ratio signal, or the drill proves
            # nothing
            _faults.inject_sleep("canary.latency")
        results = gen.endpoint.score_batch(records)
        if is_canary and _faults.fires("canary.regression") is not None:
            # corrupt the LIVE canary output path, then apply the exact
            # guard + breaker accounting the endpoint's own NaN guard
            # uses — the rollback policy must see real signals, not a
            # synthetic flag
            _faults.poison_nonfinite(results)
            bad = CompiledEndpoint._nonfinite_rows(results)
            if bad:
                gen.endpoint.telemetry.record_nonfinite_rows(len(bad))
                gen.endpoint.breaker.record_failure()
                for i in bad:
                    results[i] = RowScoringError(
                        "non-finite canary score (NaN/Inf) refused by "
                        "the serving output guard"
                    )
        wall = time.perf_counter() - t0
        if record_requests:
            for res in results:
                if isinstance(res, RowScoringError):
                    outcome = (
                        f"shed_{res.shed_reason}" if res.shed else "failed"
                    )
                else:
                    outcome = "ok"
                gen.endpoint.telemetry.record_request(wall, outcome)
        return results

    # -- shadow scoring -----------------------------------------------------
    @staticmethod
    def _row_delta(a: Any, b: Any) -> Optional[float]:
        """Max abs difference over the float leaves two score dicts
        share; None when either row is not a score dict."""
        if not isinstance(a, dict) or not isinstance(b, dict):
            return None
        worst = 0.0
        for k, va in a.items():
            vb = b.get(k)
            if isinstance(va, dict) and isinstance(vb, dict):
                d = DeploymentController._row_delta(va, vb)
                if d is not None:
                    worst = max(worst, d)
            elif isinstance(va, float) and isinstance(vb, float):
                if math.isfinite(va) and math.isfinite(vb):
                    worst = max(worst, abs(va - vb))
                else:
                    worst = max(worst, float("inf"))
        return worst

    def _shadow_score(self, canary: Generation,
                      records: Sequence[Mapping[str, Any]],
                      stable_results: list) -> None:
        """Run the candidate beside stable and record output deltas;
        responses are untouched and a shadow failure must never take
        the serve path down."""
        try:
            shadow_results = self._score_arm(canary, records,
                                             is_canary=True)
        except Exception as e:  # noqa: BLE001 - shadow only
            if is_device_fault(e):
                raise
            log.warning("shadow scoring failed for a batch: %s", e)
            return
        with self._shadow_lock:
            for sr, cr in zip(stable_results, shadow_results):
                d = self._row_delta(sr, cr)
                if d is None:
                    continue
                self._shadow_stats["rows"] += 1
                if d > 1e-9:
                    self._shadow_stats["rows_differed"] += 1
                if math.isfinite(d):
                    self._shadow_stats["max_abs_delta"] = max(
                        self._shadow_stats["max_abs_delta"], d)
                    self._shadow_stats["sum_abs_delta"] += d
                else:
                    self._shadow_stats["max_abs_delta"] = float("inf")

    def shadow_stats(self) -> dict:
        with self._shadow_lock:
            stats = dict(self._shadow_stats)
        total_delta = stats.pop("sum_abs_delta")
        n = stats.get("rows", 0)
        stats["mean_abs_delta"] = (
            round(total_delta / n, 9) if n else 0.0
        )
        if not math.isfinite(stats["max_abs_delta"]):
            stats["max_abs_delta"] = None  # NaN/Inf delta: not valid JSON
        return stats

    # -- the control loop ---------------------------------------------------
    def _maybe_check(self) -> None:
        with self._route_lock:
            if self._canary is None:
                return
            self._batches_since_check += 1
            if self._batches_since_check < self.check_every_batches:
                return
            self._batches_since_check = 0
        self.check_canary()

    def check_canary(self) -> Optional[RollbackDecision]:
        """Evaluate the rollback policy against live telemetry; a
        breach demotes the canary immediately."""
        with self._route_lock:
            stable, canary = self._stable, self._canary
        if stable is None or canary is None:
            return None
        decision = self.policy.evaluate(
            stable.endpoint.telemetry.snapshot(),
            canary.endpoint.telemetry.snapshot(),
        )
        if decision.rollback:
            self.rollback_canary(decision)
        return decision

    # -- reporting ----------------------------------------------------------
    def events(self) -> list[dict]:
        with self._route_lock:
            return [dict(e) for e in self._events]

    def summary_json(self) -> dict:
        """The deployment control surface's own summary (the registry
        sibling of OpWorkflowModel.summary_json): live generations with
        their telemetry, the lifecycle event log (swaps, canary starts,
        rollback decisions + evidence), and shadow deltas."""
        with self._route_lock:
            stable, canary = self._stable, self._canary
        out = {
            "stable": stable.snapshot() if stable else None,
            "canary": canary.snapshot() if canary else None,
            "canary_fraction": self.canary_fraction,
            "shadow": self.shadow,
            "events": self.events(),
            "shadow_stats": self.shadow_stats(),
        }
        # SLO-aware deployments (policy.slo_engine) carry the
        # burn-rate state in the deploy summary: a rollback decision's
        # "why" must be readable next to the lifecycle event it caused
        eng = getattr(self.policy, "slo_engine", None)
        if eng is not None:
            try:
                out["slo"] = eng.report()
            except Exception as e:  # noqa: BLE001 - summary only
                log.warning("deploy summary: SLO report failed: %s", e)
        src = self.fleet_status_source
        if src is not None:
            # the fleet view: per-replica generation, last heartbeat age,
            # in-flight - one consistent document, read torn-safe (the
            # publisher may be replacing it right now)
            try:
                if callable(src):
                    out["fleet"] = src()
                else:
                    from ..obs.fleet import read_json_torn_safe

                    out["fleet"] = read_json_torn_safe(str(src))
            except Exception as e:  # noqa: BLE001 - summary only
                log.warning("deploy summary: fleet view failed: %s", e)
        return out

    def export(self, path: str, extra: Optional[dict] = None) -> dict:
        snap = self.summary_json()
        if extra:
            snap.update(extra)
        with open(path, "w") as f:
            json.dump(snap, f, indent=1, sort_keys=True, default=str)
            f.write("\n")
        return snap
