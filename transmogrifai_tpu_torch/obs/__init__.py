"""transmogrifai_tpu_torch.obs: the observability plane's host half.

Host copies of the JAX package's ``obs/trace.py``, ``obs/metrics.py``
and ``obs/profiler.py``:

* :mod:`~transmogrifai_tpu_torch.obs.trace` - run-scoped trace spans
  (contextvar-propagated, ``perf_counter_ns``-timed, bounded ring
  buffer, JSONL export): the workflow's ``workflow.train`` and
  ``workflow.ingest`` spans and the reader's ``ingest.read`` span.
* :mod:`~transmogrifai_tpu_torch.obs.metrics` - one metrics registry
  (counters, gauges, fixed-bucket histograms, the shared percentile
  implementation) into which telemetry classes register their
  snapshots as views; exported as JSON.
* :mod:`~transmogrifai_tpu_torch.obs.profiler` - per-span EWMA +
  histogram with a p99 tail sampler.

The cross-process shipping (``obs/fleet.py``), the SLO engine
(``obs/slo.py``), cross-process trace contexts and the Prometheus
exporter come with the host-side operations subsystems (ROADMAP.md
queue 1, item 12).  The package is stdlib-only.
"""
from __future__ import annotations

from .metrics import (
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    metrics_registry,
    percentiles,
    reset_metrics_registry,
    write_json_artifact,
)
from .profiler import SpanProfiler
from .trace import (
    Span,
    Tracer,
    build_trees,
    reset_tracer,
    set_enabled,
    span,
    tracer,
)

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "Span",
    "SpanProfiler",
    "Tracer",
    "build_trees",
    "metrics_registry",
    "percentiles",
    "reset_metrics_registry",
    "reset_tracer",
    "set_enabled",
    "span",
    "tracer",
    "write_json_artifact",
]
