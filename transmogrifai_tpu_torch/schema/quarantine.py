"""Poison-row quarantine + data-plane telemetry.

Host copy of ``transmogrifai_tpu/schema/quarantine.py``.  A
production input pipeline owns an error POLICY — one malformed row in a
million must not abort the ingest, and it must not silently coerce into
a plausible value either.  Every reader takes ``errors=``:

* ``"coerce"``     — legacy behavior (unparseable numeric cells become
                     missing values); the default, bit-identical to the
                     pre-quarantine readers.
* ``"strict"``     — the first malformed row raises
                     :class:`MalformedRowError` naming the row index,
                     column, and reason.
* ``"quarantine"`` — malformed rows are dropped from the output and
                     recorded (row index, payload excerpt, reason) in a
                     bounded :class:`QuarantineBuffer`; exact counts land
                     in :class:`DataTelemetry`.

``DataTelemetry`` gives the ingest tier a snapshot/export contract, and
the module-level
:func:`data_telemetry` accumulator lets readers record without plumbing
when the caller does not pass one.
"""
from __future__ import annotations

import logging
import threading
import time
from dataclasses import dataclass
from typing import Optional

from ..obs.metrics import metrics_registry, write_json_artifact

log = logging.getLogger("transmogrifai_tpu_torch.schema")

LOG_PREFIX = "op_data_metrics"

ERROR_MODES = ("coerce", "strict", "quarantine")

#: default QuarantineBuffer capacity: counts stay exact past it, only
#: the per-row detail stops accumulating (ingest memory must be bounded
#: no matter how poisoned the file is)
DEFAULT_MAX_ROWS = 1024

_EXCERPT_LEN = 80


def check_errors_mode(errors: str) -> str:
    """Validate a reader ``errors=`` mode (misconfigured policies must
    be loud at construction, not at the first bad row)."""
    if errors not in ERROR_MODES:
        raise ValueError(
            f"errors must be one of {ERROR_MODES}, got {errors!r}"
        )
    return errors


class MalformedRowError(ValueError):
    """Strict-mode ingest error naming the offending row.

    ``row_index`` is 0-based over the file's data rows (header
    excluded), matching the QuarantinedRow indices quarantine mode
    records for the same file.
    """

    def __init__(self, source: str, row_index: int, reason: str,
                 column: Optional[str] = None,
                 excerpt: Optional[str] = None) -> None:
        self.source = source
        self.row_index = row_index
        self.reason = reason
        self.column = column
        self.excerpt = excerpt
        at = f" column {column!r}" if column else ""
        ex = f" (cell: {excerpt!r})" if excerpt else ""
        super().__init__(
            f"{source}: malformed row {row_index}{at}: {reason}{ex}; "
            "use errors='quarantine' to isolate bad rows instead"
        )


def coerce_numeric(value) -> Optional[float]:
    """THE junk-vs-number decision every reader shares: the value a
    coerce-mode read would silently null is exactly what checked modes
    call a type flip, so strict/quarantine/coerce can never disagree
    about which cells are junk.  Bytes decode as UTF-8 first (the
    native CSV scanner hands raw cell bytes); None = does not parse."""
    if isinstance(value, (bytes, bytearray)):
        try:
            value = value.decode("utf-8")
        except UnicodeDecodeError:
            return None
    try:
        return float(value)
    except (TypeError, ValueError):
        return None


def excerpt_of(raw) -> str:
    """Bounded, printable excerpt of a bad cell/row payload."""
    if isinstance(raw, bytes):
        raw = raw.decode("utf-8", errors="replace")
    s = str(raw)
    return s if len(s) <= _EXCERPT_LEN else s[: _EXCERPT_LEN - 1] + "…"


@dataclass
class QuarantinedRow:
    """One isolated row: where it was, why, and what it looked like."""

    row_index: int
    reason: str
    column: Optional[str] = None
    excerpt: str = ""

    def to_json(self) -> dict:
        return {
            "row_index": self.row_index,
            "reason": self.reason,
            "column": self.column,
            "excerpt": self.excerpt,
        }


class QuarantineBuffer:
    """Bounded, thread-safe poison-row sink.

    ``total``/``by_reason`` counts stay EXACT past ``max_rows``; only
    per-row detail stops accumulating (``truncated`` reports how many
    details were dropped).  Thread-safe because DeviceCSVIngest's parse
    worker records from a background thread.
    """

    def __init__(self, max_rows: int = DEFAULT_MAX_ROWS,
                 source: str = "") -> None:
        if max_rows < 1:
            raise ValueError("max_rows must be >= 1")
        self.max_rows = int(max_rows)
        self.source = source
        self.rows: list[QuarantinedRow] = []
        self.total = 0
        self.by_reason: dict[str, int] = {}
        self._lock = threading.Lock()

    def add(self, row_index: int, reason: str,
            column: Optional[str] = None, excerpt: str = "") -> None:
        with self._lock:
            self.total += 1
            self.by_reason[reason] = self.by_reason.get(reason, 0) + 1
            if len(self.rows) < self.max_rows:
                self.rows.append(
                    QuarantinedRow(row_index, reason, column, excerpt)
                )

    @property
    def truncated(self) -> int:
        """Quarantined rows whose detail was dropped at the cap."""
        with self._lock:
            return self.total - len(self.rows)

    def __len__(self) -> int:
        return self.total

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "source": self.source,
                "total": self.total,
                "by_reason": dict(self.by_reason),
                "detail_capacity": self.max_rows,
                "detail_dropped": self.total - len(self.rows),
                "rows": [r.to_json() for r in self.rows],
            }


class DataTelemetry:
    """Ingest-tier accumulator (the ServingTelemetry sibling): exact
    read/kept/quarantined row counts per source plus reason totals,
    snapshot()-able any time and export()-able as a JSON artifact."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.started_at = time.time()  # epoch stamp (correlation only)
        self._pc_start = time.perf_counter()  # durations never use the
        # epoch clock
        # unified metrics plane (obs/): snapshot registered as a view
        metrics_registry().register_view("data", self)
        # model-version attribution: data-plane metrics name the model
        # version they fed
        self.model_version: Optional[str] = None
        self.generation: Optional[int] = None
        self.rows_read = 0
        self.rows_kept = 0
        self.rows_quarantined = 0
        self.strict_errors = 0
        self.reads = 0
        self.quarantined_by_reason: dict[str, int] = {}
        self.per_source: dict[str, dict] = {}

    # -- recording ----------------------------------------------------------
    def record_read(self, source: str, rows_read: int, rows_kept: int,
                    quarantine: Optional[QuarantineBuffer] = None) -> None:
        """One completed ingest: exact totals; ``quarantine`` folds the
        buffer's reason counts in."""
        with self._lock:
            self.reads += 1
            self.rows_read += int(rows_read)
            self.rows_kept += int(rows_kept)
            n_quar = int(rows_read) - int(rows_kept)
            self.rows_quarantined += n_quar
            if quarantine is not None:
                for reason, n in quarantine.by_reason.items():
                    self.quarantined_by_reason[reason] = (
                        self.quarantined_by_reason.get(reason, 0) + n
                    )
            src = self.per_source.setdefault(
                source, {"reads": 0, "rows_read": 0, "rows_kept": 0,
                         "rows_quarantined": 0},
            )
            src["reads"] += 1
            src["rows_read"] += int(rows_read)
            src["rows_kept"] += int(rows_kept)
            src["rows_quarantined"] += n_quar
        if n_quar:
            log.warning(
                "%s source=%s quarantined=%d of %d rows", LOG_PREFIX,
                source, n_quar, rows_read,
            )

    def record_strict_error(self, source: str) -> None:
        with self._lock:
            self.strict_errors += 1

    def set_model_version(self, version: Optional[str],
                          generation: Optional[int] = None) -> None:
        """Attribute subsequent ingest metrics to one model version /
        deployment generation (the ServingTelemetry contract)."""
        with self._lock:
            self.model_version = version
            self.generation = generation

    # -- reporting ----------------------------------------------------------
    def snapshot(self) -> dict:
        with self._lock:
            wall = max(time.perf_counter() - self._pc_start, 1e-9)
            return {
                "wall_s": round(wall, 3),
                "model_version": self.model_version,
                "generation": self.generation,
                "reads": self.reads,
                "rows_read": self.rows_read,
                "rows_kept": self.rows_kept,
                "rows_quarantined": self.rows_quarantined,
                "strict_errors": self.strict_errors,
                "quarantined_by_reason": dict(self.quarantined_by_reason),
                "per_source": {k: dict(v)
                               for k, v in self.per_source.items()},
            }

    def log_line(self) -> str:
        snap = self.snapshot()
        kv = {
            "reads": snap["reads"],
            "rows_read": snap["rows_read"],
            "rows_quarantined": snap["rows_quarantined"],
            "strict_errors": snap["strict_errors"],
        }
        return LOG_PREFIX + " " + " ".join(f"{k}={v}" for k, v in kv.items())

    def export(self, path: str, extra: Optional[dict] = None) -> dict:
        snap = self.snapshot()
        if extra:
            snap.update(extra)
        write_json_artifact(path, snap)
        log.info(self.log_line())
        return snap


_telemetry = DataTelemetry()


def data_telemetry() -> DataTelemetry:
    """Process-wide default accumulator readers record into when the
    caller passes none (the mesh_telemetry() pattern)."""
    return _telemetry


def reset_data_telemetry() -> DataTelemetry:
    """Fresh accumulator (test/bench isolation)."""
    global _telemetry
    _telemetry = DataTelemetry()
    return _telemetry
