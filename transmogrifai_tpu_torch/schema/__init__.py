"""Data-plane robustness: schema contracts, quarantine, drift guards.

Host copy of ``transmogrifai_tpu/schema/``.  Three pieces:

* :class:`SchemaContract` - raw-feature names, dtypes, nullability and
  per-feature :class:`~..filters.feature_distribution.FeatureDistribution`
  summaries captured at fit time, persisted inside the crash-consistent
  model artifact (serialization/model_io.py ``schema.json``, checksummed
  by the manifest), and enforced against serve-time batches by the local
  scorer's ``drift_policy``.
* Quarantine-mode ingestion - readers accept ``errors="quarantine"``:
  malformed / type-flipped / truncated rows land in a bounded
  :class:`QuarantineBuffer` (row index, payload excerpt, reason) with
  exact counts in :class:`DataTelemetry` instead of aborting the ingest
  (``errors="strict"``) or silently coercing (``errors="coerce"``, the
  default).
* :class:`DriftMonitor` - serve-side running FeatureDistributions merged
  batch by batch, scored against the training contract by JS divergence.
"""
from .contract import (
    FeatureSpec,
    SchemaContract,
    SchemaDriftError,
    apply_drift_policy,
    collect_violations,
)
from .drift import DriftMonitor
from .quarantine import (
    ERROR_MODES,
    DataTelemetry,
    MalformedRowError,
    QuarantineBuffer,
    QuarantinedRow,
    check_errors_mode,
    data_telemetry,
    reset_data_telemetry,
)

__all__ = [
    "ERROR_MODES",
    "DataTelemetry",
    "DriftMonitor",
    "FeatureSpec",
    "MalformedRowError",
    "QuarantineBuffer",
    "QuarantinedRow",
    "SchemaContract",
    "SchemaDriftError",
    "apply_drift_policy",
    "check_errors_mode",
    "collect_violations",
    "data_telemetry",
    "reset_data_telemetry",
]
