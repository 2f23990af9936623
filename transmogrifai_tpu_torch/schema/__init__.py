"""Data-plane robustness: poison-row quarantine for the readers.

Host copy of the quarantine part of ``transmogrifai_tpu/schema/``:
readers accept ``errors="quarantine"``, and malformed / type-flipped /
truncated rows land in a bounded :class:`QuarantineBuffer` (row index,
payload excerpt, reason) with exact counts in :class:`DataTelemetry`
instead of aborting the ingest (``errors="strict"``) or silently
coercing (``errors="coerce"``, the default).  The schema contract and
the drift monitor (``contract.py``, ``drift.py``) come with the rest of
the host core (ROADMAP.md queue 1, item 1).
"""
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
    "MalformedRowError",
    "QuarantineBuffer",
    "QuarantinedRow",
    "check_errors_mode",
    "data_telemetry",
    "reset_data_telemetry",
]
