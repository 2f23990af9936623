"""Learned cost model over observability-plane observations.

Host copy of ``transmogrifai_tpu/autotune/cost_model.py``.  TpuGraphs (arXiv 2308.13490) shows that a CHEAP learned predictor over
program/config features is accurate enough to drive configuration
search; this module is that predictor for the workloads this system
already measures.  Every observation is a ``(key, features, wall_ms)``
triple where ``key`` names a workload family (``fit:OpLogisticRegression``,
``serve.batch``, ``pipeline.ingest``) and ``features`` is a flat numeric
dict (log row/feature counts, hyperparameter values, knob settings).
Per key the model keeps a bounded FIFO of observations and fits a tiny
closed-form ridge regression on ``log1p(wall_ms)`` - small enough to
retrain on every predict after new data, robust to the 3-orders-of-
magnitude spread between a rung fit and a full 2M-row sweep.

Observations come ONLY from public obs-plane APIs: span records from
``Tracer.spans()`` / an exported ``spans.jsonl`` (``ingest_spans``),
profiler snapshots (``ingest_profiler``), and direct ``observe`` calls
from probe harnesses.  The style gate (tests/test_torch_style.py) pins that
nothing in this package reaches into telemetry internals.

The model persists as a versioned JSON artifact (``autotune.json``)
written next to the model artifact by the runner's ``autotune`` knob;
``load`` is tolerant - a missing or torn file degrades to a cold model
(the selector then records ``cost_model_cold`` and runs exhaustively).
"""
from __future__ import annotations

import hashlib
import json
import math
import os
import threading
from typing import Iterable, Optional

import numpy as np

from ..obs.metrics import metrics_registry, write_json_artifact

__all__ = [
    "COST_MODEL_VERSION",
    "CostModel",
    "candidate_features",
    "params_hash",
    "serve_model_key",
    "predict_serve_rows_per_s",
]

#: artifact format version: bump when the feature layout changes so a
#: stale artifact retrains instead of predicting garbage
COST_MODEL_VERSION = 1

#: the flat feature vocabulary (order defines the regression columns);
#: unknown feature keys in an observation are ignored, missing ones are
#: zero - one fixed layout means saved weights stay meaningful
FEATURE_KEYS = (
    "log_rows",
    "log_features",
    "class_balance",
    # NOTE deliberately no "folds": observations are per-candidate-fold
    # amortized walls, so fold count is not a cost feature - and a
    # training-constant feature is collinear with the intercept, letting
    # ridge assign it arbitrary weight that extrapolates garbage
    "reg_param",
    "elastic_net_param",
    "max_depth",
    "num_trees",
    "min_info_gain",
    "min_instances_per_node",
    "max_batch_size",
    "max_wait_us",
    "workers",
    "buffer_chunks",
    "bucket",
)


def params_hash(params: dict) -> str:
    """Stable 12-hex identity of a hyperparameter map (span tag +
    report key; sha256 of the sorted JSON, never python ``hash``)."""
    blob = json.dumps(params, sort_keys=True, default=str)
    return hashlib.sha256(blob.encode()).hexdigest()[:12]


def candidate_features(
    n_rows: int,
    n_features: int,
    params: Optional[dict] = None,
    class_balance: float = 0.5,
    **extra: float,
) -> dict:
    """Feature dict for one (data shape, hyperparams/knobs) point.
    Row/feature counts enter log-transformed (fit cost is closer to
    linear in log space across the rung-to-full-sweep scale gap);
    numeric hyperparameters and knob settings pass through by name."""
    f = {
        "log_rows": math.log1p(max(float(n_rows), 0.0)),
        "log_features": math.log1p(max(float(n_features), 0.0)),
        "class_balance": float(class_balance),
    }
    for src in (params or {}), extra:
        for k, v in src.items():
            if k in FEATURE_KEYS and isinstance(v, (int, float)) \
                    and not isinstance(v, bool):
                f[k] = float(v)
    return f


class _KeyModel:
    """Bounded observation store + lazily refit ridge weights for one
    workload key."""

    __slots__ = ("xs", "ys", "weights", "dirty")

    def __init__(self) -> None:
        self.xs: list[list[float]] = []
        self.ys: list[float] = []
        self.weights: Optional[np.ndarray] = None
        self.dirty = True


class CostModel:
    """Featurized wall-time regressor trained online from obs-plane
    observations; thread-safe (the selector, the knob tuner, and the
    runner's post-run span ingest may all touch one instance)."""

    def __init__(self, ridge: float = 1e-2, max_obs_per_key: int = 512,
                 min_obs: int = 4) -> None:
        self.ridge = float(ridge)
        self.max_obs_per_key = int(max_obs_per_key)
        self.min_obs = max(int(min_obs), 2)
        self._lock = threading.Lock()
        self._keys: dict[str, _KeyModel] = {}
        #: span ids already ingested (bounded) so re-ingesting the same
        #: tracer ring after each run never double-counts observations
        self._seen_spans: dict = {}
        self.loaded_from: Optional[str] = None
        self.load_error: Optional[str] = None
        metrics_registry().counter(
            "autotune.observations",
            help="cost-model observations ingested",
        )

    # -- featurization ------------------------------------------------------
    @staticmethod
    def _vector(features: dict) -> list[float]:
        return [1.0] + [float(features.get(k, 0.0)) for k in FEATURE_KEYS]

    # -- observation --------------------------------------------------------
    def observe(self, key: str, features: dict, wall_ms: float) -> None:
        """Record one measured (features -> wall_ms) point under
        ``key``; non-finite or negative walls are dropped."""
        w = float(wall_ms)
        if not (w == w and w >= 0.0):
            return
        x = self._vector(features)
        with self._lock:
            km = self._keys.get(key)
            if km is None:
                km = self._keys[key] = _KeyModel()
            km.xs.append(x)
            km.ys.append(math.log1p(w))
            if len(km.xs) > self.max_obs_per_key:
                km.xs.pop(0)
                km.ys.pop(0)
            km.dirty = True
        metrics_registry().counter("autotune.observations").inc()

    def n_observations(self, key: Optional[str] = None) -> int:
        with self._lock:
            if key is not None:
                km = self._keys.get(key)
                return len(km.ys) if km is not None else 0
            return sum(len(km.ys) for km in self._keys.values())

    def can_predict(self, key: str) -> bool:
        return self.n_observations(key) >= self.min_obs

    # -- prediction ---------------------------------------------------------
    def predict_wall_ms(self, key: str,
                        features: dict) -> Optional[float]:
        """Predicted wall-ms for one point, or None while the key is
        cold (fewer than ``min_obs`` observations) - callers treat None
        as "no model", never as "free"."""
        with self._lock:
            km = self._keys.get(key)
            if km is None or len(km.ys) < self.min_obs:
                return None
            if km.dirty or km.weights is None:
                km.weights = self._fit(km)
                km.dirty = False
            w = km.weights
        x = np.asarray(self._vector(features))
        pred = float(x @ w)
        # clamp the log-space prediction before expm1: a wild
        # extrapolation must saturate, not overflow to inf
        return float(math.expm1(min(max(pred, 0.0), 50.0)))

    def _fit(self, km: _KeyModel) -> np.ndarray:
        X = np.asarray(km.xs, dtype=np.float64)
        y = np.asarray(km.ys, dtype=np.float64)
        d = X.shape[1]
        A = X.T @ X + self.ridge * np.eye(d)
        # the intercept column is never regularized away from the mean
        A[0, 0] -= self.ridge * 0.5
        return np.linalg.solve(A, X.T @ y)

    # -- obs-plane ingestion ------------------------------------------------
    def ingest_spans(self, records: Iterable[dict]) -> int:
        """Train from tracer span records (``Tracer.spans()`` or a
        ``spans.jsonl`` export read back): the per-candidate fit spans
        the validator tags (``cv.fit``/``cv.fit_folds``/``cv.fit_batch``)
        and tagged serving batches.  Batched dispatches amortize their
        wall across the candidates they carried.  Re-ingesting the same
        ring is safe: span ids dedupe.  Returns observations added."""
        added = 0
        for r in records:
            if not isinstance(r, dict):
                continue
            name = r.get("name")
            attrs = r.get("attrs") or {}
            wall = r.get("wall_ms")
            sid = r.get("span")
            # NOTE no "autotune.rung_fit" here: the validator observes
            # every rung fit DIRECTLY at fit time (selector/validator),
            # so re-ingesting the rung spans would double-count the
            # same fits under the same key with inconsistent walls
            if name not in ("cv.fit", "cv.fit_folds", "cv.fit_batch",
                            "serve.batch"):
                continue
            if not isinstance(wall, (int, float)) or sid is None:
                continue
            with self._lock:
                if sid in self._seen_spans:
                    continue
                self._seen_spans[sid] = True
                if len(self._seen_spans) > 65536:
                    self._seen_spans.pop(next(iter(self._seen_spans)))
            if name == "serve.batch":
                feats = candidate_features(
                    int(attrs.get("rows", 0) or 0), 0,
                    bucket=float(attrs.get("bucket", 0) or 0),
                )
                self.observe("serve.batch", feats, float(wall))
                added += 1
                continue
            family = attrs.get("family")
            if not family:
                continue
            feats = candidate_features(
                int(attrs.get("n_rows", 0) or 0),
                int(attrs.get("n_features", 0) or 0),
                {k: v for k, v in attrs.items()
                 if isinstance(v, (int, float))},
            )
            per = float(wall)
            if name == "cv.fit_folds":
                per /= max(int(attrs.get("folds", 1) or 1), 1)
            elif name == "cv.fit_batch":
                per /= max(int(attrs.get("candidates", 1) or 1), 1)
            self.observe(f"fit:{family}", feats, per)
            added += 1
        return added

    def ingest_profiler(self, snapshot: dict) -> int:
        """Train coarse per-span-name walls from a
        ``SpanProfiler.snapshot()``/``observations()`` export: no
        per-candidate features survive aggregation, so these become
        shape-free observations under ``span:<name>`` keys (useful for
        knob-free workloads like ``serve.batch`` EWMAs)."""
        added = 0
        spans = snapshot.get("spans", snapshot)
        if not isinstance(spans, dict):
            return 0
        for name, st in spans.items():
            if not isinstance(st, dict):
                continue
            ewma = st.get("ewma_ms")
            if isinstance(ewma, (int, float)):
                self.observe(f"span:{name}", {}, float(ewma))
                added += 1
        return added

    # -- persistence --------------------------------------------------------
    def to_json(self) -> dict:
        with self._lock:
            keys = {
                k: {"x": [list(x) for x in km.xs], "y": list(km.ys)}
                for k, km in self._keys.items()
            }
        return {
            "version": COST_MODEL_VERSION,
            "feature_keys": list(FEATURE_KEYS),
            "ridge": self.ridge,
            "min_obs": self.min_obs,
            "max_obs_per_key": self.max_obs_per_key,
            "keys": keys,
        }

    @classmethod
    def from_json(cls, doc: dict) -> "CostModel":
        cm = cls(
            ridge=float(doc.get("ridge", 1e-2)),
            max_obs_per_key=int(doc.get("max_obs_per_key", 512)),
            min_obs=int(doc.get("min_obs", 4)),
        )
        cm.restore(doc)
        return cm

    def restore(self, doc: dict) -> None:
        """Adopt a saved document's observations (versioned: a foreign
        or stale layout leaves the model cold with ``load_error`` set
        rather than mis-predicting from misaligned columns)."""
        if doc.get("version") != COST_MODEL_VERSION or \
                list(doc.get("feature_keys", [])) != list(FEATURE_KEYS):
            self.load_error = "version_mismatch"
            return
        with self._lock:
            for key, kd in (doc.get("keys") or {}).items():
                xs, ys = kd.get("x") or [], kd.get("y") or []
                km = _KeyModel()
                for x, y in zip(xs, ys):
                    if isinstance(x, list) \
                            and len(x) == len(FEATURE_KEYS) + 1:
                        km.xs.append([float(v) for v in x])
                        km.ys.append(float(y))
                if km.ys:
                    self._keys[str(key)] = km

    def save(self, path: str) -> None:
        """Persist as the versioned JSON artifact (atomic replace: a
        crash mid-save leaves the previous model, never a torn one)."""
        tmp = path + ".tmp"
        write_json_artifact(tmp, self.to_json())
        os.replace(tmp, path)

    @classmethod
    def load(cls, path: Optional[str]) -> "CostModel":
        """Tolerant load: missing/unreadable/torn artifacts yield a COLD
        model with ``load_error`` set - the selector then records the
        cold-start reason and runs the exhaustive path."""
        cm: Optional[CostModel] = None
        err: Optional[str] = None
        if path and os.path.exists(path):
            try:
                with open(path) as f:
                    cm = cls.from_json(json.load(f))
            except (OSError, ValueError) as e:
                err = f"{type(e).__name__}: {e}"
        if cm is None:
            cm = cls()
            cm.load_error = err
        cm.loaded_from = path if path else None
        return cm

    # -- metrics-registry view ----------------------------------------------
    def snapshot(self) -> dict:
        with self._lock:
            per_key = {k: len(km.ys) for k, km in self._keys.items()}
        return {
            "version": COST_MODEL_VERSION,
            "keys": len(per_key),
            "observations": sum(per_key.values()),
            "observations_by_key": per_key,
            "min_obs": self.min_obs,
        }


def key_for_fit(family: str) -> str:
    """The workload key candidate-fit observations file under."""
    return f"fit:{family}"


def serve_model_key(model_id: str) -> str:
    """The workload key one hosted model's serve-batch walls file
    under (multi-model placement: per-model cost curves so
    a slow GBT and a fast LR sharing one fleet get rated apart —
    the ``serve.batch`` key stays the model-blind aggregate)."""
    return f"serve.model/{model_id}"


def predict_serve_rows_per_s(cost_model: "CostModel", model_id: str,
                             n_rows: int = 512,
                             n_features: int = 0) -> Optional[float]:
    """Predicted serving throughput (rows/s) for one hosted model at a
    nominal batch shape, from its per-model serve key; None while the
    key is cold (fewer than ``min_obs`` observations) — callers fall
    back to observation or a default, never to "free"."""
    wall_ms = cost_model.predict_wall_ms(
        serve_model_key(model_id),
        candidate_features(n_rows, n_features, bucket=float(n_rows)),
    )
    if wall_ms is None or wall_ms <= 0.0:
        return None
    return float(n_rows) / (wall_ms / 1e3)
