"""Batched, compiled model serving with admission control + telemetry.

The production-serving tier the reference delegates to MLeap local
scoring (reference: local/.../OpWorkflowModelLocal.scala) rebuilt
batch-first for this engine: a micro-batching scheduler packs concurrent
requests into fixed shape buckets so every predict rides one fused
program per batch (the torch device program on a CUDA model, with kernel
K2 in every tree head; the numpy-fused program on a CPU model), admission control sheds load gracefully,
a circuit breaker turns persistent batch-path failure into fast loud
shedding (with a NaN/Inf output guard) instead of a silent slow-path
meltdown, schema/distribution drift guards validate every batch against
the contract the model trained under (schema/: ``SchemaDriftError``,
``drift_policy="raise"|"warn"|"shed"``, per-feature JS drift scores),
and built-in telemetry reports p50/p95/p99 latency, batch fill, queue
depth, rows/s, breaker transitions, and drift as a JSON artifact.

    endpoint = compile_endpoint(model)           # warmed, bucketed
    with MicroBatchScheduler(endpoint) as srv:
        result = srv.score(record, timeout_s=1.0)
    endpoint.telemetry.export("serving_metrics.json")

Port of ``transmogrifai_tpu/serving/``: a device fault (a kernel that
does not build or launch, a CUDA error) is never degraded away.
"""
from ..schema.contract import SchemaDriftError
from .admission import (
    AdmissionController,
    BreakerOpenError,
    CircuitBreaker,
    DeadlineExceededError,
    QueueFullError,
    RequestTimeoutError,
    TenantQuotaError,
)
from .endpoint import (
    CompiledEndpoint,
    RowScoringError,
    compile_endpoint,
    records_from_dataset,
)
from .scheduler import MicroBatchScheduler
from .telemetry import ServingTelemetry

__all__ = [
    "AdmissionController",
    "BreakerOpenError",
    "CircuitBreaker",
    "CompiledEndpoint",
    "DeadlineExceededError",
    "MicroBatchScheduler",
    "QueueFullError",
    "RequestTimeoutError",
    "RowScoringError",
    "SchemaDriftError",
    "ServingTelemetry",
    "TenantQuotaError",
    "compile_endpoint",
    "records_from_dataset",
]
