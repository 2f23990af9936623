"""transmogrifai_tpu_torch.obs: the observability plane's host half.

Host copies of the JAX package's ``obs/trace.py``, ``obs/metrics.py``,
``obs/profiler.py``, ``obs/fleet.py`` and ``obs/slo.py``, and its
``export_obs``:

* :mod:`~transmogrifai_tpu_torch.obs.trace` - run-scoped trace spans
  (contextvar-propagated, ``perf_counter_ns``-timed, bounded ring
  buffer, JSONL export): one trace id follows a run through ingest,
  fit, save, publish, swap and the serving batches.
* :mod:`~transmogrifai_tpu_torch.obs.metrics` - one metrics registry
  (counters, gauges, fixed-bucket histograms, the shared percentile
  implementation) into which telemetry classes register their
  snapshots as views; exported as JSON and Prometheus text.
* :mod:`~transmogrifai_tpu_torch.obs.profiler` - per-span EWMA +
  histogram with a p99 tail sampler.
* :mod:`~transmogrifai_tpu_torch.obs.fleet` - cross-process
  trace-context propagation (``TX_OBS_TRACE_CONTEXT``, :func:`child_env`),
  per-process metric/span shipping into an aggregation dir, and the
  :class:`FleetAggregator` merging live shards into one scrape and one
  trace forest.
* :mod:`~transmogrifai_tpu_torch.obs.slo` - declarative SLOs with
  multi-window burn-rate alerting, read by the runner's ``slo_path``
  knob and ``RollbackPolicy.slo_engine``.

The package is stdlib-only.
"""
from __future__ import annotations

import os
from typing import Optional

from .fleet import (
    FleetAggregator,
    ObsShipper,
    child_env,
    read_json_torn_safe,
    read_jsonl_tolerant,
    ship_now,
)
from .metrics import (
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    metrics_registry,
    percentiles,
    process_instance,
    prometheus_text_from_json,
    reset_metrics_registry,
    sanitize_metric_name,
    set_process_instance,
    write_json_artifact,
)
from .profiler import SpanProfiler
from .slo import (
    SLOEngine,
    SLObjective,
    default_objectives,
    load_slo_config,
    resolve_metric,
)
from .trace import (
    TRACE_CONTEXT_ENV,
    Span,
    Tracer,
    build_trees,
    current_context,
    parse_context,
    reset_tracer,
    set_enabled,
    span,
    tracer,
)

__all__ = [
    "Counter",
    "FleetAggregator",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "ObsShipper",
    "SLOEngine",
    "SLObjective",
    "Span",
    "SpanProfiler",
    "TRACE_CONTEXT_ENV",
    "Tracer",
    "build_trees",
    "child_env",
    "current_context",
    "default_objectives",
    "export_obs",
    "load_slo_config",
    "metrics_registry",
    "parse_context",
    "percentiles",
    "process_instance",
    "prometheus_text_from_json",
    "read_json_torn_safe",
    "read_jsonl_tolerant",
    "reset_metrics_registry",
    "reset_tracer",
    "resolve_metric",
    "sanitize_metric_name",
    "set_enabled",
    "set_process_instance",
    "ship_now",
    "span",
    "tracer",
    "write_json_artifact",
]


def export_obs(path: str, extra: Optional[dict] = None) -> dict:
    """Export the whole observability plane into directory ``path``:
    ``metrics.json`` (the registry document - native series + every
    registered telemetry view), ``metrics.prom`` (the same document as
    Prometheus text exposition), and ``spans.jsonl`` (the tracer's
    retained spans).  The runner's ``metrics_path`` knob and callers
    who want a one-call dump share this.  Returns the JSON document."""
    os.makedirs(path, exist_ok=True)
    reg = metrics_registry()
    # stamped with the writing process's identity: the saved artifact
    # renders under the instance that produced it, not whoever reads it
    doc = dict(reg.to_json(), instance=process_instance())
    if extra:
        doc = dict(doc, **extra)
    write_json_artifact(os.path.join(path, "metrics.json"), doc)
    with open(os.path.join(path, "metrics.prom"), "w") as f:
        f.write(prometheus_text_from_json(doc))
    tracer().export_jsonl(os.path.join(path, "spans.jsonl"))
    return doc
