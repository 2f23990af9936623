"""Unified metrics plane: one registry, one percentile implementation,
one exposition pipeline (JSON + Prometheus text).

Host copy of ``transmogrifai_tpu/obs/metrics.py``.

* :func:`percentiles` - THE quantile implementation every telemetry
  class routes through.
* :class:`Counter` / :class:`Gauge` / :class:`Histogram` - native
  series.  Histograms use FIXED bucket boundaries so merging and
  exposition never resample.
* :class:`MetricsRegistry` - get-or-create series registry plus
  weakref-registered *snapshot views*: telemetry classes (the serving
  endpoint's ``ServingTelemetry``, the reader's ``DataTelemetry``, the
  SLO engine) register their live ``snapshot()`` callables and keep
  their own shapes; exposition flattens every finite numeric leaf into
  a series, so one scrape reports the whole process.
* :func:`prometheus_text_from_json` - renders the registry's JSON
  document as Prometheus text exposition (``# HELP``/``# TYPE`` +
  samples); the registry's own ``prometheus_text()`` and a saved JSON
  artifact share this one renderer.
* :func:`process_instance` - the ``instance`` label: ``<pid>-<nonce>``,
  or ``TX_OBS_INSTANCE`` / :func:`set_process_instance`.

Stdlib only: the metrics plane does not depend on the stack it
measures.
"""
from __future__ import annotations

import bisect
import json
import logging
import os
import re
import threading
import weakref
from typing import Any, Callable, Iterator, Optional

log = logging.getLogger("transmogrifai_tpu_torch.obs")

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "metrics_registry",
    "percentiles",
    "process_instance",
    "prometheus_text_from_json",
    "reset_metrics_registry",
    "set_process_instance",
    "write_json_artifact",
]


# ---------------------------------------------------------------------------
# process identity (the exposition `instance` label)
# ---------------------------------------------------------------------------
#: pid + an 8-hex start nonce: stable for the life of the process,
#: distinct across processes even when the kernel recycles pids (the
#: trace-prefix reasoning in trace.py, applied to metric identity)
_instance_lock = threading.Lock()
_instance: Optional[str] = None

#: instance identities are interpolated into Prometheus label VALUES
#: and shard FILENAMES: a quote/backslash/newline would corrupt every
#: consumer's scrape, and a path separator would write outside the
#: aggregation dir - sanitize at the trust boundary, not per use
_INSTANCE_BAD = re.compile(r"[^A-Za-z0-9._:-]")


def _sanitize_instance(name: str) -> str:
    return _INSTANCE_BAD.sub("_", str(name))[:128] or "unnamed"


def process_instance() -> str:
    """This process's stable exposition identity:
    ``<pid>-<start-nonce>`` by default, overridable by
    :func:`set_process_instance` or the ``TX_OBS_INSTANCE`` env var
    (fleet replicas get operator-readable names that way); always
    label- and filename-safe."""
    global _instance
    with _instance_lock:
        if _instance is None:
            named = os.environ.get("TX_OBS_INSTANCE", "").strip()
            _instance = (
                _sanitize_instance(named) if named
                else f"{os.getpid()}-{os.urandom(4).hex()}"
            )
        return _instance


def set_process_instance(name: Optional[str]) -> None:
    """Override (or with ``None`` re-derive) the exposition identity -
    a serving replica names itself ``replica-3`` instead of a pid."""
    global _instance
    with _instance_lock:
        _instance = _sanitize_instance(name) if name else None


def percentiles(
    values, qs: tuple = (50.0, 95.0, 99.0)
) -> dict[str, float]:
    """Empirical percentiles keyed 'p50'/'p95'/'p99' (linear interpolation
    between order statistics).  THE shared quantile helper behind every
    telemetry snapshot in the system (serving, mesh, data, stage) -
    the JAX package's copy computes the same numbers."""
    out: dict[str, float] = {}
    vals = sorted(float(v) for v in values)
    for q in qs:
        key = f"p{q:g}"
        if not vals:
            out[key] = float("nan")
            continue
        pos = (len(vals) - 1) * (q / 100.0)
        lo = int(pos)
        hi = min(lo + 1, len(vals) - 1)
        out[key] = vals[lo] + (vals[hi] - vals[lo]) * (pos - lo)
    return out


def write_json_artifact(path: str, doc: dict) -> None:
    """THE telemetry-artifact writer (indent=1, sorted keys, trailing
    newline): the four telemetry ``export()`` methods each had their own
    copy of this open/dump/newline block - one implementation means one
    artifact format."""
    with open(path, "w") as f:
        json.dump(doc, f, indent=1, sort_keys=True, default=str)
        f.write("\n")


# ---------------------------------------------------------------------------
# native series
# ---------------------------------------------------------------------------
class Counter:
    """Monotonic counter (thread-safe)."""

    __slots__ = ("name", "help", "_lock", "_value")

    def __init__(self, name: str, help: str = "") -> None:
        self.name = name
        self.help = help
        self._lock = threading.Lock()
        self._value = 0.0

    def inc(self, n: float = 1.0) -> None:
        with self._lock:
            self._value += n

    @property
    def value(self) -> float:
        with self._lock:
            return self._value


class Gauge:
    """Point-in-time value (thread-safe); ``fn`` makes it a pull gauge
    evaluated at snapshot time."""

    __slots__ = ("name", "help", "_lock", "_value", "_fn")

    def __init__(self, name: str, help: str = "",
                 fn: Optional[Callable[[], float]] = None) -> None:
        self.name = name
        self.help = help
        self._lock = threading.Lock()
        self._value = 0.0
        self._fn = fn

    def set(self, v: float) -> None:
        with self._lock:
            self._value = float(v)

    def add(self, n: float = 1.0) -> None:
        with self._lock:
            self._value += n

    @property
    def value(self) -> float:
        if self._fn is not None:
            try:
                return float(self._fn())
            except Exception as e:  # noqa: BLE001 - a broken pull gauge
                # must not take the whole scrape down, but it must be
                # VISIBLE (the events_dropped discipline)
                log.warning("pull gauge %s failed: %s", self.name, e)
                return float("nan")
        with self._lock:
            return self._value


#: default histogram boundaries: log-spaced milliseconds from 10us to
#: 100s (wide enough for span walls from a fused batch to a full train)
DEFAULT_BUCKETS_MS = (
    0.01, 0.03, 0.1, 0.3, 1.0, 3.0, 10.0, 30.0, 100.0, 300.0,
    1_000.0, 3_000.0, 10_000.0, 30_000.0, 100_000.0,
)


class Histogram:
    """Fixed-bucket histogram (thread-safe): count, sum, per-bucket
    counts, and interpolated quantiles FROM the buckets - no unbounded
    sample reservoir, so it is safe to leave on a serving hot path
    forever.  Bucket boundaries are upper-inclusive edges; values past
    the last edge land in the +Inf overflow bucket."""

    __slots__ = ("name", "help", "buckets", "_lock", "_counts",
                 "_count", "_sum", "_min", "_max")

    def __init__(self, name: str, help: str = "",
                 buckets: tuple = DEFAULT_BUCKETS_MS) -> None:
        self.name = name
        self.help = help
        self.buckets = tuple(sorted(float(b) for b in buckets))
        if not self.buckets:
            raise ValueError("histogram needs at least one bucket edge")
        self._lock = threading.Lock()
        self._counts = [0] * (len(self.buckets) + 1)  # +Inf overflow
        self._count = 0
        self._sum = 0.0
        self._min = float("inf")
        self._max = float("-inf")

    def observe(self, v: float) -> None:
        v = float(v)
        i = bisect.bisect_left(self.buckets, v)
        with self._lock:
            self._counts[i] += 1
            self._count += 1
            self._sum += v
            if v < self._min:
                self._min = v
            if v > self._max:
                self._max = v

    @property
    def count(self) -> int:
        with self._lock:
            return self._count

    @property
    def sum(self) -> float:
        with self._lock:
            return self._sum

    def quantile(self, q: float) -> float:
        """Interpolated quantile from the bucket counts (NaN when
        empty).  Within a bucket the mass is assumed uniform; the
        overflow bucket reports the observed max (the only bound we
        have past the last edge)."""
        with self._lock:
            total = self._count
            counts = list(self._counts)
            vmin, vmax = self._min, self._max
        if not total:
            return float("nan")
        target = (q / 100.0) * total
        seen = 0.0
        for i, c in enumerate(counts):
            if seen + c >= target and c:
                lo = self.buckets[i - 1] if i else min(vmin, self.buckets[0])
                hi = self.buckets[i] if i < len(self.buckets) else vmax
                frac = (target - seen) / c
                return lo + (hi - lo) * frac
            seen += c
        return vmax

    def quantile_upper(self, q: float) -> float:
        """CONSERVATIVE quantile: the upper edge of the bucket holding
        the q-th observation (observed max for the overflow bucket).
        The tail sampler's threshold - interpolation would under-read a
        distribution massed at a bucket's upper edge (every constant
        1.0ms span would look 'past the p99' of [0.3, 1.0]) and hoard
        exemplars of perfectly normal spans."""
        with self._lock:
            total = self._count
            counts = list(self._counts)
            vmax = self._max
        if not total:
            return float("nan")
        target = (q / 100.0) * total
        seen = 0.0
        for i, c in enumerate(counts):
            seen += c
            if seen >= target and c:
                return (
                    self.buckets[i] if i < len(self.buckets) else vmax
                )
        return vmax

    def to_json(self) -> dict:
        with self._lock:
            counts = list(self._counts)
            count, total = self._count, self._sum
            vmax = self._max
        out = {
            "count": count,
            "sum": round(total, 6),
            "max": None if count == 0 else round(vmax, 6),
            "buckets": {
                f"{edge:g}": c for edge, c in zip(self.buckets, counts)
            },
        }
        out["buckets"]["+Inf"] = counts[-1]
        return out


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------
_NAME_BAD = re.compile(r"[^a-zA-Z0-9_:]")


def sanitize_metric_name(name: str) -> str:
    """Prometheus-legal metric name ([a-zA-Z_:][a-zA-Z0-9_:]*), prefixed
    ``tx_`` so every series from this system namespaces together."""
    n = _NAME_BAD.sub("_", str(name))
    if not n.startswith("tx_"):
        n = "tx_" + n
    return n


def _numeric_leaves(doc: Any, path: tuple = ()) -> Iterator[tuple]:
    """Yield (path, value) for every finite int/float leaf reachable
    through nested dicts.  Bools, strings, lists, and None/NaN leaves
    are not series (lists hold event detail, not scrapeable scalars)."""
    if isinstance(doc, dict):
        for k, v in doc.items():
            yield from _numeric_leaves(v, path + (str(k),))
        return
    if isinstance(doc, bool) or not isinstance(doc, (int, float)):
        return
    if doc != doc or doc in (float("inf"), float("-inf")):
        return
    yield path, doc


class MetricsRegistry:
    """One process-wide registry for native series + snapshot views.

    *Native series* (``counter``/``gauge``/``histogram``) are
    get-or-create by name.  *Views* are weakly-referenced telemetry
    objects whose ``snapshot()`` is flattened at scrape time - the
    legacy accumulators keep owning their state and their snapshot
    shapes; the registry only READS them, so registration can never
    change behavior or pin an endpoint's telemetry alive."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._series: dict[str, Any] = {}
        self._views: list[tuple[str, int, Any]] = []  # (kind, idx, weakref)
        self._view_counts: dict[str, int] = {}

    # -- native series ------------------------------------------------------
    def _get_or_create(self, name: str, cls, **kw) -> Any:
        with self._lock:
            s = self._series.get(name)
            if s is None:
                s = cls(name, **kw)
                self._series[name] = s
            elif not isinstance(s, cls):
                raise TypeError(
                    f"metric {name!r} already registered as "
                    f"{type(s).__name__}, not {cls.__name__}"
                )
            return s

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get_or_create(name, Counter, help=help)

    def gauge(self, name: str, help: str = "",
              fn: Optional[Callable[[], float]] = None) -> Gauge:
        return self._get_or_create(name, Gauge, help=help, fn=fn)

    def histogram(self, name: str, help: str = "",
                  buckets: tuple = DEFAULT_BUCKETS_MS) -> Histogram:
        return self._get_or_create(name, Histogram, help=help,
                                   buckets=buckets)

    # -- snapshot views -----------------------------------------------------
    def register_view(self, kind: str, obj: Any) -> int:
        """Register a telemetry object exposing ``snapshot() -> dict``
        under ``kind`` (serving/mesh/data/stage).  Weakly referenced:
        a garbage-collected endpoint's telemetry silently leaves the
        scrape.  Returns the instance index used as the ``instance``
        label (per kind, starting at 0)."""
        with self._lock:
            idx = self._view_counts.get(kind, 0)
            self._view_counts[kind] = idx + 1
            self._views.append((kind, idx, weakref.ref(obj)))
            return idx

    def _live_views(self) -> list[tuple[str, int, Any]]:
        with self._lock:
            views = list(self._views)
        out = []
        dead = False
        for kind, idx, ref in views:
            obj = ref()
            if obj is None:
                dead = True
                continue
            out.append((kind, idx, obj))
        if dead:
            with self._lock:
                self._views = [
                    v for v in self._views if v[2]() is not None
                ]
        return out

    # -- exposition ---------------------------------------------------------
    def to_json(self) -> dict:
        """The whole plane as one JSON document: native series keyed by
        name, views keyed ``<kind>/<instance>`` with their UNCHANGED
        snapshot shapes; ``prometheus_text`` flattens it."""
        with self._lock:
            series = dict(self._series)
        out: dict = {"series": {}, "views": {}}
        for name, s in sorted(series.items()):
            if isinstance(s, Histogram):
                out["series"][name] = {"type": "histogram",
                                       "help": s.help, **s.to_json()}
            elif isinstance(s, Counter):
                out["series"][name] = {"type": "counter", "help": s.help,
                                       "value": s.value}
            else:
                out["series"][name] = {"type": "gauge", "help": s.help,
                                       "value": s.value}
        for kind, idx, obj in self._live_views():
            try:
                snap = obj.snapshot()
            except Exception as e:  # noqa: BLE001 - one broken view must
                # not take down the scrape, but it must be visible
                log.warning("metrics view %s/%d snapshot failed: %s",
                            kind, idx, e)
                self.counter(
                    "obs.view_errors",
                    help="snapshot() failures during exposition",
                ).inc()
                continue
            out["views"][f"{kind}/{idx}"] = snap
        return out

    def prometheus_text(self) -> str:
        return prometheus_text_from_json(self.to_json())


def _fmt_value(v: float) -> str:
    f = float(v)
    return repr(int(f)) if f == int(f) and abs(f) < 1e15 else repr(f)


def prometheus_text_from_json(doc: dict,
                              instance: Optional[str] = None) -> str:
    """Render a :meth:`MetricsRegistry.to_json` document as Prometheus
    text exposition.  ONE renderer for live scrapes and saved JSON
    artifacts, so the two can never drift.  Every sample carries an ``instance`` label
    naming the PROCESS it came from: ``instance`` argument wins,
    then the document's own ``instance`` stamp (saved artifacts render
    as the process that wrote them, not the process reading them), then
    this process's :func:`process_instance`.  View snapshots flatten
    every finite numeric leaf into a gauge named ``tx_<kind>_<path...>``
    with the per-kind index as a ``view`` label; native histograms emit
    the canonical ``_bucket``/``_sum``/``_count`` triplet."""
    inst = instance if instance is not None else doc.get("instance")
    # re-sanitized here too: a hand-edited/foreign document's stamp (or
    # a caller-supplied replica name) must not inject label syntax
    inst = _sanitize_instance(inst) if inst is not None \
        else process_instance()
    ilabel = f'instance="{inst}"'
    lines: list[str] = []
    for name, s in sorted(doc.get("series", {}).items()):
        pname = sanitize_metric_name(name)
        stype = s.get("type", "gauge")
        if s.get("help"):
            lines.append(f"# HELP {pname} {s['help']}")
        if stype == "histogram":
            lines.append(f"# TYPE {pname} histogram")
            acc = 0
            buckets = s.get("buckets", {})
            # sort edges NUMERICALLY: a saved metrics.json artifact has
            # its keys lexicographically reordered by sort_keys=True
            # ("10" < "3"), and cumulative _bucket values rendered in
            # that order would be non-monotonic garbage
            for edge in sorted((e for e in buckets if e != "+Inf"),
                               key=float):
                acc += int(buckets[edge])
                lines.append(
                    f'{pname}_bucket{{{ilabel},le="{edge}"}} {acc}')
            acc += int(buckets.get("+Inf", 0))
            lines.append(f'{pname}_bucket{{{ilabel},le="+Inf"}} {acc}')
            lines.append(
                f"{pname}_sum{{{ilabel}}} {_fmt_value(s.get('sum', 0.0))}")
            lines.append(f"{pname}_count{{{ilabel}}} {int(s.get('count', 0))}")
            continue
        lines.append(f"# TYPE {pname} {stype}")
        lines.append(f"{pname}{{{ilabel}}} {_fmt_value(s.get('value', 0.0))}")
    for key, snap in sorted(doc.get("views", {}).items()):
        kind, _, idx = key.partition("/")
        labels = f'{ilabel},view="{idx}"'
        # multi-model serving: a view that names the hosted
        # model it serves gets a model_id label on every sample, so one
        # scrape separates tx_serving_*{model_id="a"} from model "b"
        # on the same replica (sanitized like instance - a foreign
        # document must not inject label syntax)
        model_id = snap.get("model_id") if isinstance(snap, dict) else None
        if isinstance(model_id, str) and model_id:
            labels += f',model_id="{_sanitize_instance(model_id)}"'
        for path, value in sorted(_numeric_leaves(snap)):
            pname = sanitize_metric_name(kind + "_" + "_".join(path))
            lines.append(
                f'{pname}{{{labels}}} {_fmt_value(value)}')
    return "\n".join(lines) + "\n"


# ---------------------------------------------------------------------------
# module-level plumbing (the mesh_telemetry()/data_telemetry() pattern)
# ---------------------------------------------------------------------------
_registry: Optional[MetricsRegistry] = None
_registry_lock = threading.Lock()


def metrics_registry() -> MetricsRegistry:
    """The process-wide registry every telemetry class registers into
    and the ``metrics_path`` runner knob exports from."""
    global _registry
    with _registry_lock:
        if _registry is None:
            _registry = MetricsRegistry()
        return _registry


def reset_metrics_registry() -> MetricsRegistry:
    """Fresh registry (test/bench isolation).  Telemetry objects created
    BEFORE the reset stay registered only in the old registry - tests
    that scrape must create their accumulators after resetting."""
    global _registry
    with _registry_lock:
        _registry = MetricsRegistry()
        return _registry
