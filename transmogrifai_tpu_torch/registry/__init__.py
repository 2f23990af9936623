"""Versioned model registry: publish → canary → stable → rollback.

The lifecycle layer that composes the robustness machinery of the last
four rounds into a closed control loop (reference frame: TF-Serving's
versioned servable store + health-gated version advance, PAPERS.md —
the reference itself treats a fitted model as a terminal artifact):

* :class:`ModelRegistry` — a versioned, content-addressed store layered
  on the crash-consistent ``serialization/model_io.py`` artifacts; each
  version records its manifest SHA-256, schema-contract hash, eval
  metrics, parent version, and stage lineage in a checksummed
  ``registry.json`` updated by atomic rename (``.last-good`` recovery,
  drilled by the ``registry.publish_crash`` fault point).
* :class:`DeploymentController` — zero-downtime hot-swap of the live
  compiled endpoint generation (in-flight batches finish on the old
  generation; the swap never drops or double-scores a request),
  deterministic hash-based canary traffic splits, and optional shadow
  scoring that records candidate-vs-stable output deltas without
  touching responses.
* :class:`RollbackPolicy` — automatic canary demotion when live signals
  (breaker trips, NaN-guard hits, JS drift, p99 latency ratio) breach
  SLO relative to stable, with the decision + evidence recorded in
  telemetry, ``summary_json()``, and the registry lineage.

Runner: the ``deploy`` run type.  Port of
``transmogrifai_tpu/registry/``: on a CUDA model every generation warms
and scores on the card (the torch device program, kernel K2 in every
tree head), and a device fault is never degraded away.  The operator
CLI is ``python -m transmogrifai_tpu_torch.cli registry ...``.
"""
from .deployment import DeploymentController, Generation, route_key
from .rollback import RollbackDecision, RollbackPolicy
from .store import (
    ModelRegistry,
    RegistryError,
    RegistryIntegrityError,
    RegistryVersion,
)

__all__ = [
    "DeploymentController",
    "Generation",
    "ModelRegistry",
    "RegistryError",
    "RegistryIntegrityError",
    "RegistryVersion",
    "RollbackDecision",
    "RollbackPolicy",
    "route_key",
]
