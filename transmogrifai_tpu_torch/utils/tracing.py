"""Per-stage execution metrics.

Counterpart of ``transmogrifai_tpu/utils/tracing.py`` (reference:
utils/.../spark/OpSparkListener.scala:56-161, AppMetrics / StageMetrics):
per-stage wall clock and row counts recorded while the workflow fits and
transforms, as structured log lines, kept for the end of the run
(``OpWorkflowModel.summary_json()["stageMetrics"]``).  ``AppMetrics.timed``
also opens a ``stage.<phase>`` trace span (``obs/trace.py``), and each
``AppMetrics`` registers itself as a metrics-registry view (``obs/
metrics.py``).  ``profile_to`` wraps a block in a ``torch.profiler``
trace written as a Chrome trace file.

Mesh-resilience events (collective stalls, straggler retries,
shrink-to-survivors recomputes, bootstrap timeouts) ride the stage
metrics as ``mesh_resilience_events``, scoped to the run's window:
``parallel/resilience.py`` registers its telemetry's event feed here
(:func:`register_mesh_events_source`), so this module imports nothing of
the distributed tier.
"""
from __future__ import annotations

import contextlib
import logging
import time
from dataclasses import dataclass, field
from typing import Iterator, Optional

from ..obs import metrics as _obs_metrics
from ..obs import trace as _obs_trace

log = logging.getLogger("transmogrifai_tpu_torch.metrics")

LOG_PREFIX = "op_stage_metrics"

#: the one quantile implementation lives in obs/metrics.py
percentiles = _obs_metrics.percentiles

# -- mesh resilience surfacing ----------------------------------------------
_mesh_events_source = None


def register_mesh_events_source(fn) -> None:
    """``fn(since_epoch=None) -> list[dict]`` of mesh resilience events;
    ``since_epoch`` scopes the feed to one run's window."""
    global _mesh_events_source
    _mesh_events_source = fn


def mesh_events_dropped() -> int:
    """How many times the mesh event feed failed to deliver (the
    ``obs.events_dropped`` self-metric): a broken feed must be visible in
    snapshots, not a hole in the degradation report."""
    return int(
        _obs_metrics.metrics_registry().counter("obs.events_dropped").value
    )


def mesh_events(since_epoch=None) -> list:
    if _mesh_events_source is None:
        return []
    try:
        return list(_mesh_events_source(since_epoch))
    except Exception as e:  # telemetry must never break metrics reporting
        _obs_metrics.metrics_registry().counter(
            "obs.events_dropped",
            help="telemetry event-feed failures (a broken feed, not an "
                 "empty one)",
        ).inc()
        log.warning("mesh event source failed (drop counted in "
                    "obs.events_dropped): %s", e)
        return []


@dataclass
class StageMetrics:
    stage_uid: str
    operation: str
    phase: str  # 'fit' | 'transform' | 'workflow_cv'
    wall_s: float
    n_rows: int
    extra: dict = field(default_factory=dict)

    def log_line(self) -> str:
        kv = {
            "uid": self.stage_uid,
            "op": self.operation,
            "phase": self.phase,
            "wall_s": f"{self.wall_s:.4f}",
            "rows": self.n_rows,
            **self.extra,
        }
        return LOG_PREFIX + " " + " ".join(f"{k}={v}" for k, v in kv.items())

    def to_json(self) -> dict:
        return {
            "stage_uid": self.stage_uid,
            "operation": self.operation,
            "phase": self.phase,
            "wall_s": self.wall_s,
            "n_rows": self.n_rows,
            **self.extra,
        }


@dataclass
class AppMetrics:
    """Whole-run accumulation (reference: AppMetrics, OpSparkListener.scala:
    133-161).  ``start_time`` is a wall-clock epoch; durations are timed on
    ``time.perf_counter``."""

    stages: list[StageMetrics] = field(default_factory=list)
    start_time: float = field(default_factory=time.time)
    _pc_start: float = field(default_factory=time.perf_counter, repr=False)

    def __post_init__(self) -> None:
        # a metrics-registry view: every finite numeric leaf of to_json()
        # becomes a series (weakly held)
        _obs_metrics.metrics_registry().register_view("stage", self)

    def record(self, m: StageMetrics) -> None:
        self.stages.append(m)
        log.info(m.log_line())

    @contextlib.contextmanager
    def timed(self, stage, phase: str, n_rows: int) -> Iterator[None]:
        t0 = time.perf_counter()
        with _obs_trace.span(
            "stage." + phase, uid=stage.uid,
            op=stage.operation_name, rows=int(n_rows),
        ):
            try:
                yield
            finally:
                self.record(
                    StageMetrics(
                        stage_uid=stage.uid,
                        operation=stage.operation_name,
                        phase=phase,
                        wall_s=time.perf_counter() - t0,
                        n_rows=n_rows,
                    )
                )

    @property
    def total_wall_s(self) -> float:
        return time.perf_counter() - self._pc_start

    def by_operation(self) -> dict[str, float]:
        out: dict[str, float] = {}
        for m in self.stages:
            out[m.operation] = out.get(m.operation, 0.0) + m.wall_s
        return dict(sorted(out.items(), key=lambda kv: -kv[1]))

    def to_json(self) -> dict:
        out = {
            "total_wall_s": self.total_wall_s,
            "stages": [m.to_json() for m in self.stages],
            "by_operation": self.by_operation(),
        }
        # degraded-mode events belong next to the stage walls they
        # inflated, scoped to this run's window
        ev = mesh_events(since_epoch=self.start_time)
        if ev:
            out["mesh_resilience_events"] = ev
        dropped = mesh_events_dropped()
        if dropped:
            out["obs_events_dropped"] = dropped
        return out

    def snapshot(self) -> dict:
        """The metrics-registry view contract."""
        return self.to_json()


@contextlib.contextmanager
def profile_to(path: Optional[str]) -> Iterator[None]:
    """Wrap a block in a ``torch.profiler`` trace of the CPU and, where
    there is one, the CUDA device, exported as a Chrome trace to ``path``
    when it is set."""
    if not path:
        yield
        return
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        yield
    prof.export_chrome_trace(path)
