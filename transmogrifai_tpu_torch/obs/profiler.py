"""Always-on low-overhead span profiler: EWMA + histogram per span
name, with a tail sampler that keeps FULL span trees only for slow
outliers.

Host copy of ``transmogrifai_tpu/obs/profiler.py``.  Offline device
profilers are heavyweight; this profiler is the opposite end of the
tradeoff - cheap enough to leave enabled in a hot path, detailed
enough that when a
batch lands past the p99 it retains the batch's WHOLE span tree as an
exemplar, so the slow request links directly to its stage-level
breakdown instead of to an aggregate.

Per span name it keeps: count, EWMA of wall-ms (recency-weighted
"current speed"), a fixed-bucket histogram (bounded memory, quantiles
interpolated from buckets - the same :class:`~transmogrifai_tpu_torch.
obs.metrics.Histogram` the metrics plane exposes), and min/max.  The tail
sampler arms only after ``min_samples`` observations (cold-start
compiles must not hoard the exemplar slots) and refreshes its p99
threshold every ``threshold_refresh`` observations so the quantile walk
stays OFF the per-span path.

Stdlib only, like the rest of obs/.
"""
from __future__ import annotations

import threading
from collections import deque
from typing import Optional

from .metrics import DEFAULT_BUCKETS_MS, Histogram, percentiles  # noqa: F401

__all__ = ["SpanProfiler"]


class _NameStats:
    __slots__ = ("count", "ewma_ms", "max_ms", "hist",
                 "threshold_ms", "roots_seen")

    def __init__(self) -> None:
        self.count = 0
        self.ewma_ms: Optional[float] = None
        self.max_ms = 0.0
        self.hist = Histogram("span_wall_ms", buckets=DEFAULT_BUCKETS_MS)
        self.threshold_ms: Optional[float] = None
        self.roots_seen = 0


class SpanProfiler:
    """Per-span-name accumulation + p99 exemplar retention.

    ``observe`` is the tracer's completion hook: ``tree`` is the full
    nested span tree when the finished span was a trace ROOT (only
    roots are exemplar candidates - a child's slowness is visible
    inside its root's tree), else None.
    """

    def __init__(self, ewma_alpha: float = 0.05,
                 exemplar_capacity: int = 16,
                 min_samples: int = 64,
                 tail_quantile: float = 99.0,
                 threshold_refresh: int = 64) -> None:
        self.ewma_alpha = float(ewma_alpha)
        self.min_samples = int(min_samples)
        self.tail_quantile = float(tail_quantile)
        self.threshold_refresh = max(1, int(threshold_refresh))
        self._lock = threading.Lock()
        self._stats: dict[str, _NameStats] = {}
        self._exemplars: deque = deque(maxlen=int(exemplar_capacity))
        self.exemplars_retained = 0
        self.exemplars_evicted = 0
        self.roots_considered = 0

    # -- hot path ------------------------------------------------------------
    def observe(self, name: str, wall_ms: float,
                tree: Optional[dict] = None) -> None:
        with self._lock:
            st = self._stats.get(name)
            if st is None:
                st = self._stats[name] = _NameStats()
            st.count += 1
            st.ewma_ms = wall_ms if st.ewma_ms is None else (
                self.ewma_alpha * wall_ms
                + (1.0 - self.ewma_alpha) * st.ewma_ms
            )
            if wall_ms > st.max_ms:
                st.max_ms = wall_ms
            retain = False
            if tree is not None:
                st.roots_seen += 1
                self.roots_considered += 1
                if st.count >= self.min_samples:
                    if (st.threshold_ms is None
                            or st.count % self.threshold_refresh == 0):
                        # amortized: the bucket walk runs once per
                        # refresh window, never per span.  The UPPER-
                        # edge quantile: a span must clear its p99
                        # bucket outright to count as an outlier
                        st.threshold_ms = st.hist.quantile_upper(
                            self.tail_quantile
                        )
                    t = st.threshold_ms
                    retain = t == t and wall_ms > t  # NaN-safe
            if retain:
                if len(self._exemplars) == self._exemplars.maxlen:
                    self.exemplars_evicted += 1
                self._exemplars.append({
                    "name": name,
                    "trace": tree.get("trace"),
                    "wall_ms": wall_ms,
                    "threshold_ms": round(st.threshold_ms, 6),
                    "tree": tree,
                })
                self.exemplars_retained += 1
        # outside the profiler lock: the histogram has its own
        st.hist.observe(wall_ms)

    # -- reporting -----------------------------------------------------------
    def exemplars(self) -> list[dict]:
        with self._lock:
            return [dict(e) for e in self._exemplars]

    def observations(self) -> list[dict]:
        """Per-span-name observation rows: the profiler's
        accumulated timings as flat records a cost model can train
        from (``CostModel.ingest_profiler``) without reaching into any
        internal state - name, count, EWMA, histogram quantiles, max.
        One row per name, sorted by name for determinism."""
        snap = self.snapshot()
        return [
            dict(st, name=name) for name, st in snap["spans"].items()
        ]

    def snapshot(self) -> dict:
        with self._lock:
            names = dict(self._stats)
            tail = {
                "roots_considered": self.roots_considered,
                "exemplars_retained": self.exemplars_retained,
                "exemplars_evicted": self.exemplars_evicted,
                "exemplars_held": len(self._exemplars),
                "min_samples": self.min_samples,
                "tail_quantile": self.tail_quantile,
            }
        spans = {}
        for name, st in sorted(names.items()):
            h = st.hist
            spans[name] = {
                "count": st.count,
                "ewma_ms": None if st.ewma_ms is None
                else round(st.ewma_ms, 6),
                "max_ms": round(st.max_ms, 6),
                "p50_ms": _finite(h.quantile(50.0)),
                "p95_ms": _finite(h.quantile(95.0)),
                "p99_ms": _finite(h.quantile(99.0)),
                "tail_threshold_ms": None if st.threshold_ms is None
                or st.threshold_ms != st.threshold_ms
                else round(st.threshold_ms, 6),
            }
        return {"spans": spans, "tail": tail}


def _finite(v: float):
    return None if v != v else round(v, 6)
