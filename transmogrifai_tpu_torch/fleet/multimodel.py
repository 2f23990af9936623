"""Multi-model serving: the fleet as a model-multiplexed platform.

Reference frame: TensorFlow Serving's multi-tenant model server,
arXiv 1605.08695 — model identity as a routing dimension, loaded models
as a managed cache, placement as a resource decision.  Two pieces live
here, both pure composition over the registry and serving seams:

:class:`ModelTable` — one per replica worker.  Hosts N registry
versions behind the single serve lane, each with its OWN
:class:`~..registry.deployment.DeploymentController` (independent
stable/canary lifecycle, ``track_registry=False`` so N lifecycles never
race the registry's single stage slots) and its own ``ServingTelemetry``
carrying the ``model_id`` label.  Loaded models are a **weighted LRU
over the resident models**: when resident bytes (weighted by each
artifact's bytes on disk) exceed the cache budget — or resident count
exceeds ``max_resident`` — the least-recently-used cold model's
generations are dropped via ``DeploymentController.unload()`` (freeing
its endpoint, its lowered torch program and the device memory they
hold), and the next hit on it REHYDRATES by re-deploying from the
registry: load the artifact, lower it to the torch-fused program on the
workflow's device and warm its buckets.  Rehydrate walls and cold-hit
latencies are sampled so the p99 a cold model pays is measured, and
evictions are RATE-BOUNDED (``evict_min_interval_s``) so pathological
pressure — drilled by the ``fleet.model_evict_storm`` fault point —
degrades to denied-eviction counters, not cache thrash.

:class:`PlacementPlanner` — fleet-side.  Decides which models co-reside
on which replica, balancing predicted per-model throughput (the autotune
cost model when it can predict, observed rates when offered, a default
otherwise) against executable-cache pressure (first-fit-decreasing by
artifact bytes under each replica's cache budget).  The resulting
:class:`PlacementPlan` answers ``hosts(model_id)`` for the router's
per-model dispatch and ``replica_capacity(instance)`` for the
autoscaler's heterogeneous demand sizing, and is re-planned by the
fleet controller on membership changes (autoscaler add/remove).

Style contract (tests/test_torch_style.py): no unbounded waits (this module
takes no locks while scoring and owns no sockets/threads) and no
silent excepts.
"""
from __future__ import annotations

import logging
import os
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Mapping, Optional, Sequence

from ..faults import injection as _faults
from ..obs.metrics import percentiles
from ..registry.deployment import DeploymentController, Generation
from ..registry.store import ModelRegistry, RegistryError

log = logging.getLogger("transmogrifai_tpu_torch.fleet")

LOG_PREFIX = "op_multimodel_metrics"

#: bounded latency-sample reservoirs (telemetry discipline)
_MAX_SAMPLES = 4096

#: default minimum spacing between evictions: the thrash rate bound the
#: ``fleet.model_evict_storm`` drill proves (an eviction implies a
#: future rehydrate deserialize; unbounded eviction churn would turn
#: cache pressure into a retrace-rate serve path)
DEFAULT_EVICT_MIN_INTERVAL_S = 0.25

#: planner fallback when neither the cost model nor observation can
#: rate a model (the measured single-replica order of magnitude)
DEFAULT_MODEL_ROWS_PER_S = 1e5


class MultiModelError(RuntimeError):
    """Base for model-multiplexing failures."""


class UnknownModelError(MultiModelError):
    """The replica's ModelTable does not host this model_id."""


class UnhostedModelError(MultiModelError):
    """No replica in the fleet hosts this model_id (router-side)."""


def parse_models_arg(spec: str) -> Dict[str, str]:
    """``"a=v1,b=v2"`` -> ``{"a": "v1", "b": "v2"}`` — the shared
    ``--models`` CLI grammar (worker argv + controller worker_args must
    never drift).  Order-preserving; blanks rejected loudly."""
    out: Dict[str, str] = {}
    for part in str(spec).split(","):
        part = part.strip()
        if not part:
            continue
        model_id, sep, version = part.partition("=")
        if not sep or not model_id.strip() or not version.strip():
            raise ValueError(
                f"bad --models entry {part!r}: expected model_id=version")
        out[model_id.strip()] = version.strip()
    if not out:
        raise ValueError(f"--models spec {spec!r} names no models")
    return out


def format_models_arg(models: Mapping[str, str]) -> str:
    """Inverse of :func:`parse_models_arg`."""
    return ",".join(f"{m}={v}" for m, v in models.items())


def artifact_cache_bytes(registry: ModelRegistry, version: str) -> int:
    """Byte weight of one version's artifact: the whole artifact dir (the
    port saves no compiled-program cache beside the model, so the JAX
    package's cache-dir weight always falls back to this).  Missing
    files weigh 0 — the weight only shapes eviction order."""
    try:
        entry = registry.get(version)
    except RegistryError:
        return 0
    total = 0
    for dirpath, _dirnames, filenames in os.walk(
            os.path.join(registry.root, entry.path)):
        for fn in filenames:
            try:
                total += os.path.getsize(os.path.join(dirpath, fn))
            except OSError:
                continue  # racing a writer: weight is advisory
    return total


@dataclass
class HostedModel:
    """One hosted model's table row (controller + LRU bookkeeping)."""

    model_id: str
    version: str
    controller: DeploymentController
    weight_bytes: int = 0
    last_used: float = field(default_factory=time.monotonic)
    rows_scored: int = 0
    deploys: int = 0
    rehydrations: int = 0
    cold_hits: int = 0

    @property
    def resident(self) -> bool:
        return self.controller.loaded

    @property
    def pinned(self) -> bool:
        """An in-flight canary pins the model (unload would drop a live
        lifecycle mid-judgement)."""
        return self.controller.canary_generation is not None


class ModelTable:
    """N registry versions behind one replica serve lane, with a
    weighted LRU over the resident models.

    Thread contract: the table lock guards only the map + LRU
    bookkeeping; scoring resolves a controller under the lock and
    scores OUTSIDE it (the controller's own pointer discipline makes an
    eviction racing an in-flight batch safe — the batch finishes on the
    generation object it resolved; the next call rehydrates).
    """

    def __init__(
        self,
        registry: ModelRegistry,
        workflow_factory: Callable[[], Any],
        capacity_bytes: Optional[int] = None,
        max_resident: Optional[int] = None,
        evict_min_interval_s: float = DEFAULT_EVICT_MIN_INTERVAL_S,
        **controller_kw: Any,
    ) -> None:
        if max_resident is not None and int(max_resident) < 1:
            raise ValueError("max_resident must be >= 1")
        self.registry = registry
        self.workflow_factory = workflow_factory
        self.capacity_bytes = (
            None if capacity_bytes is None else int(capacity_bytes))
        self.max_resident = (
            None if max_resident is None else int(max_resident))
        self.evict_min_interval_s = float(evict_min_interval_s)
        self._controller_kw = dict(controller_kw)
        self._lock = threading.Lock()
        self._models: Dict[str, HostedModel] = {}
        self._last_evict_at = float("-inf")
        # -- table counters (obs + the eviction-storm drill) --
        self.evictions = 0
        self.evictions_denied = 0
        self.rehydrations = 0
        self.cold_hits = 0
        self.unknown_model_errors = 0
        self._rehydrate_ms: List[float] = []
        self._cold_hit_ms: List[float] = []

    # -- hosting ------------------------------------------------------------
    def _sample(self, bucket: List[float], value: float) -> None:
        bucket.append(float(value))
        if len(bucket) > _MAX_SAMPLES:
            del bucket[::2]

    def host(self, model_id: str, version: str,
             **endpoint_kw: Any) -> Generation:
        """Bring ``version`` up as hosted model ``model_id`` (or
        hot-swap an already-hosted model to a new version).  Builds and
        warms OFF the table lock, then publishes the row and applies
        cache pressure."""
        model_id = str(model_id)
        with self._lock:
            row = self._models.get(model_id)
        if row is None:
            controller = DeploymentController(
                registry=self.registry, model_id=model_id,
                track_registry=False, **self._controller_kw)
            row = HostedModel(model_id=model_id, version=version,
                              controller=controller)
        gen = row.controller.deploy_version(
            version, self.workflow_factory(), **endpoint_kw)
        row.version = version
        row.weight_bytes = artifact_cache_bytes(self.registry, version)
        row.deploys += 1
        row.last_used = time.monotonic()
        with self._lock:
            self._models[model_id] = row
        self._maybe_evict(protect=model_id)
        log.info("%s hosted model %s version %s (generation %d, "
                 "weight %d bytes)", LOG_PREFIX, model_id, version,
                 gen.generation, row.weight_bytes)
        return gen

    def unhost(self, model_id: str) -> None:
        """Drop a hosted model entirely (its row, not just residency).
        Refuses while its canary is in flight — finish or roll back the
        lifecycle first."""
        row = self._row(model_id)
        if row.pinned:
            raise MultiModelError(
                f"cannot unhost {model_id!r}: canary in flight")
        if row.resident:
            row.controller.unload()
        with self._lock:
            self._models.pop(model_id, None)

    def _row(self, model_id: str) -> HostedModel:
        with self._lock:
            row = self._models.get(str(model_id))
        if row is None:
            self.unknown_model_errors += 1
            raise UnknownModelError(
                f"model {model_id!r} is not hosted here "
                f"(hosting: {sorted(self._models)})")
        return row

    def has(self, model_id: str) -> bool:
        with self._lock:
            return str(model_id) in self._models

    def hosted_ids(self) -> List[str]:
        with self._lock:
            return sorted(self._models)

    def controller(self, model_id: str) -> DeploymentController:
        return self._row(model_id).controller

    # -- the weighted LRU ---------------------------------------------------
    def _resident_rows(self) -> List[HostedModel]:
        with self._lock:
            return [r for r in self._models.values() if r.resident]

    def _over_budget(self, resident: Sequence[HostedModel]) -> bool:
        if self.max_resident is not None and len(resident) > self.max_resident:
            return True
        if self.capacity_bytes is not None:
            if sum(r.weight_bytes for r in resident) > self.capacity_bytes:
                return True
        return False

    def _maybe_evict(self, protect: Optional[str] = None) -> int:
        """Evict least-recently-used resident models while over the
        cache budget (count or weighted bytes), never the ``protect``-ed
        (just-touched) model and never a pinned one.  The
        ``fleet.model_evict_storm`` fault point forces pressure — every
        armed fire demands an eviction — which is exactly what the rate
        bound must absorb: at most one eviction per
        ``evict_min_interval_s``; demands past the bound are counted
        (``evictions_denied``), not served."""
        evicted = 0
        while True:
            resident = self._resident_rows()
            forced = _faults.fires("fleet.model_evict_storm") is not None
            if not forced and not self._over_budget(resident):
                return evicted
            victims = sorted(
                (r for r in resident
                 if r.model_id != protect and not r.pinned),
                key=lambda r: r.last_used)
            if not victims:
                return evicted
            now = time.monotonic()
            if now - self._last_evict_at < self.evict_min_interval_s:
                self.evictions_denied += 1
                return evicted
            victim = victims[0]
            try:
                victim.controller.unload()
            except RegistryError as e:
                # raced a canary start: the pin won, pressure stands
                log.warning("%s eviction of %s refused: %s", LOG_PREFIX,
                            victim.model_id, e)
                self.evictions_denied += 1
                return evicted
            self._last_evict_at = now
            self.evictions += 1
            evicted += 1
            log.info("%s evicted model %s (%d bytes, idle %.3fs)",
                     LOG_PREFIX, victim.model_id, victim.weight_bytes,
                     now - victim.last_used)
            if forced and not self._over_budget(self._resident_rows()):
                return evicted

    def ensure_resident(self, model_id: str) -> tuple:
        """-> (row, rehydrate_ms | None): rehydrate an evicted model by
        re-deploying its remembered version — load, torch lowering
        and warm-up on the workflow's device — measured here so the
        cold-hit p99 bound is provable."""
        row = self._row(model_id)
        if row.resident:
            return row, None
        t0 = time.perf_counter()
        row.controller.deploy_version(
            row.version, self.workflow_factory())
        rehydrate_ms = (time.perf_counter() - t0) * 1e3
        row.rehydrations += 1
        self.rehydrations += 1
        self._sample(self._rehydrate_ms, rehydrate_ms)
        self._maybe_evict(protect=row.model_id)
        log.info("%s rehydrated model %s version %s in %.1fms",
                 LOG_PREFIX, row.model_id, row.version, rehydrate_ms)
        return row, rehydrate_ms

    # -- scoring ------------------------------------------------------------
    def score(self, model_id: str,
              records: Sequence[Mapping[str, Any]]) -> tuple:
        """Score one batch on one hosted model; -> ``(results, info)``
        with the controller's info extended by model attribution and
        the cold-hit cost when this batch paid a rehydrate."""
        t0 = time.perf_counter()
        row, rehydrate_ms = self.ensure_resident(model_id)
        results, info = row.controller.score_batch_with_info(records)
        row.last_used = time.monotonic()
        row.rows_scored += len(records)
        # every score is a cache decision: touch the LRU, then apply
        # pressure (this is the point the evict-storm drill forces)
        self._maybe_evict(protect=row.model_id)
        info = dict(info, model_id=row.model_id)
        if rehydrate_ms is not None:
            row.cold_hits += 1
            self.cold_hits += 1
            cold_ms = (time.perf_counter() - t0) * 1e3
            self._sample(self._cold_hit_ms, cold_ms)
            info["cold_hit"] = True
            info["rehydrate_ms"] = round(rehydrate_ms, 3)
        return results, info

    # -- per-model lifecycle passthroughs ------------------------------------
    def start_canary(self, model_id: str, version: str,
                     **kw: Any) -> Generation:
        row, _ = self.ensure_resident(model_id)
        gen = row.controller.start_canary_version(
            version, self.workflow_factory(), **kw)
        row.last_used = time.monotonic()
        return gen

    def promote_canary(self, model_id: str) -> Generation:
        row = self._row(model_id)
        gen = row.controller.promote_canary()
        row.version = gen.version
        row.weight_bytes = artifact_cache_bytes(self.registry, gen.version)
        return gen

    def rollback_canary(self, model_id: str, reason: str = "manual"):
        return self._row(model_id).controller.rollback_canary(
            reason=reason)

    def release_canary(self, model_id: str, reason: str = "undecided"):
        return self._row(model_id).controller.release_canary(
            reason=reason)

    def check_canary(self, model_id: str):
        return self._row(model_id).controller.check_canary()

    # -- reporting ----------------------------------------------------------
    def rows(self) -> List[dict]:
        """Per-model status rows for ``fleet_status.json`` / the obs
        shard: hosted version, residency, LRU weight/recency, rows."""
        with self._lock:
            rows = list(self._models.values())
        now = time.monotonic()
        out = []
        for r in sorted(rows, key=lambda r: r.model_id):
            stable = r.controller.stable_generation
            canary = r.controller.canary_generation
            out.append({
                "model_id": r.model_id,
                "version": r.version,
                "resident": r.resident,
                "canary_version": canary.version if canary else None,
                "generation": stable.generation if stable else None,
                "weight_bytes": r.weight_bytes,
                "idle_s": round(now - r.last_used, 3),
                "rows_scored": r.rows_scored,
                "deploys": r.deploys,
                "rehydrations": r.rehydrations,
                "cold_hits": r.cold_hits,
            })
        return out

    def counters(self) -> dict:
        """The table-level counters alone (no per-model rows): the
        compact shape that rides ``replica_info`` next to ``models``."""
        snap = self.snapshot()
        snap.pop("models", None)
        return snap

    def snapshot(self) -> dict:
        rows = self.rows()
        return {
            "hosted": len(rows),
            "resident": sum(1 for r in rows if r["resident"]),
            "resident_bytes": sum(
                r["weight_bytes"] for r in rows if r["resident"]),
            "capacity_bytes": self.capacity_bytes,
            "max_resident": self.max_resident,
            "evictions": self.evictions,
            "evictions_denied": self.evictions_denied,
            "rehydrations": self.rehydrations,
            "cold_hits": self.cold_hits,
            "unknown_model_errors": self.unknown_model_errors,
            "rehydrate_ms": {
                k: round(v, 3) if v == v else None
                for k, v in percentiles(
                    self._rehydrate_ms, (50.0, 99.0)).items()
            },
            "cold_hit_ms": {
                k: round(v, 3) if v == v else None
                for k, v in percentiles(
                    self._cold_hit_ms, (50.0, 99.0)).items()
            },
            "models": rows,
        }


# ---------------------------------------------------------------------------
# placement
# ---------------------------------------------------------------------------
@dataclass
class PlacementPlan:
    """Which models live where, plus each replica's predicted capacity
    under its hosted mix (the autoscaler's heterogeneous sizing input).
    """

    assignments: Dict[str, List[str]]       # instance -> [model_id]
    capacity_rows_s: Dict[str, float]       # instance -> predicted rows/s
    model_rows_s: Dict[str, float]          # model_id -> full-rate rows/s
    pressure_bytes: Dict[str, int] = field(default_factory=dict)
    rev: int = 0

    def hosts(self, model_id: str) -> List[str]:
        return [inst for inst, models in self.assignments.items()
                if model_id in models]

    def models_for(self, instance: str) -> List[str]:
        return list(self.assignments.get(instance, []))

    def replica_capacity(self, instance: str,
                         default: Optional[float] = None) -> Optional[float]:
        return self.capacity_rows_s.get(instance, default)

    def mean_capacity(self) -> Optional[float]:
        vals = list(self.capacity_rows_s.values())
        return sum(vals) / len(vals) if vals else None

    def to_json(self) -> dict:
        return {
            "rev": self.rev,
            "assignments": {k: list(v)
                            for k, v in sorted(self.assignments.items())},
            "capacity_rows_s": {k: round(v, 1) for k, v in
                                sorted(self.capacity_rows_s.items())},
            "model_rows_s": {k: round(v, 1) for k, v in
                             sorted(self.model_rows_s.items())},
            "pressure_bytes": dict(sorted(self.pressure_bytes.items())),
        }


class PlacementPlanner:
    """Cost-model-driven co-residency: first-fit-decreasing by artifact
    bytes under each replica's executable-cache budget, load-balanced by
    predicted per-model throughput, ``replication``-way redundant when
    the fleet is wide enough (a model must survive one replica death
    without an unhosted window)."""

    def __init__(self, cost_model=None,
                 cache_budget_bytes: Optional[int] = None,
                 replication: int = 2,
                 predict_rows: int = 512,
                 default_rows_per_s: float = DEFAULT_MODEL_ROWS_PER_S
                 ) -> None:
        if int(replication) < 1:
            raise ValueError("replication must be >= 1")
        self.cost_model = cost_model
        self.cache_budget_bytes = (
            None if cache_budget_bytes is None else int(cache_budget_bytes))
        self.replication = int(replication)
        self.predict_rows = int(predict_rows)
        self.default_rows_per_s = float(default_rows_per_s)
        self._rev = 0

    def _model_rate(self, spec: Mapping[str, Any]) -> float:
        """Predicted full-rate rows/s for one model: the spec's own
        observation wins, then the cost model's per-model serve
        key, then the default."""
        observed = spec.get("rows_per_s")
        if observed:
            return float(observed)
        if self.cost_model is not None:
            from ..autotune.cost_model import predict_serve_rows_per_s

            predicted = predict_serve_rows_per_s(
                self.cost_model, str(spec["model_id"]),
                n_rows=self.predict_rows,
                n_features=int(spec.get("n_features", 0) or 0))
            if predicted:
                return float(predicted)
        return self.default_rows_per_s

    def plan(self, models: Sequence[Mapping[str, Any]],
             instances: Sequence[str]) -> PlacementPlan:
        """``models``: dicts with ``model_id`` (+ optional ``version``,
        ``weight_bytes``, ``rows_per_s``, ``n_features``);
        ``instances``: the live fleet membership.  Deterministic for a
        fixed input (re-planning on membership change must not shuffle
        placements gratuitously: ties break on sorted order)."""
        instances = [str(i) for i in instances]
        if not instances:
            raise ValueError("cannot place models on an empty fleet")
        rates = {str(m["model_id"]): self._model_rate(m) for m in models}
        weights = {str(m["model_id"]): int(m.get("weight_bytes", 0) or 0)
                   for m in models}
        # heaviest artifacts place first (first-fit-decreasing), rate
        # as the tiebreak so hot models spread before cold ones
        order = sorted(rates, key=lambda m: (-weights[m], -rates[m], m))
        assignments: Dict[str, List[str]] = {i: [] for i in instances}
        load: Dict[str, float] = {i: 0.0 for i in instances}
        bytes_used: Dict[str, int] = {i: 0 for i in instances}
        n_copies = min(self.replication, len(instances))
        for model_id in order:
            share = 1.0 / max(rates[model_id], 1e-9) / n_copies
            placed = 0
            # replicas with cache headroom first, least-loaded within
            # them; a fleet with no headroom anywhere still places
            # (over-budget residency is the ModelTable's LRU's problem,
            # an unhosted model would be an outage)
            for inst in sorted(
                    instances,
                    key=lambda i: (
                        self.cache_budget_bytes is not None
                        and bytes_used[i] + weights[model_id]
                        > self.cache_budget_bytes,
                        load[i], i)):
                if placed >= n_copies:
                    break
                assignments[inst].append(model_id)
                load[inst] += share
                bytes_used[inst] += weights[model_id]
                placed += 1
        # replica capacity under its mix: equal time-sharing across the
        # k hosted models is the harmonic blend k / sum(1/r_i) — one
        # slow model drags the replica's achievable aggregate, which is
        # exactly what ceil(demand/one-capacity) sizing gets wrong
        capacity: Dict[str, float] = {}
        for inst in instances:
            hosted = assignments[inst]
            if not hosted:
                capacity[inst] = self.default_rows_per_s
                continue
            inv = sum(1.0 / max(rates[m], 1e-9) for m in hosted)
            capacity[inst] = len(hosted) / inv
        self._rev += 1
        plan = PlacementPlan(
            assignments={i: sorted(a) for i, a in assignments.items()},
            capacity_rows_s=capacity,
            model_rows_s=dict(rates),
            pressure_bytes=dict(bytes_used),
            rev=self._rev,
        )
        log.info("%s placement rev %d: %s", LOG_PREFIX, plan.rev,
                 {i: len(a) for i, a in plan.assignments.items()})
        return plan
