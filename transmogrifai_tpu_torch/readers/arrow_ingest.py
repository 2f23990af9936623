"""Arrow/Parquet → device ingestion.

SURVEY §7 names chunked Arrow ingest with double buffering a hard part of
the rebuild; the CSV half lives in fast_csv.DeviceCSVIngest, this is the
Parquet/Arrow half (reference contract: ParquetProductReader → Spark
partitions → executor memory).

Counterpart of ``transmogrifai_tpu/readers/arrow_ingest.py``.  Row groups
stream through ``pyarrow.parquet.ParquetFile.iter_batches`` in a
background thread; each batch converts to a float32 block + validity mask
at Arrow speed (no per-value python) and ships via the shared
double-buffered pump (``fast_csv.double_buffered_to_device``: pinned
copies on a side stream), so the decode of batch i+1 overlaps the copy of
batch i to the card.  ``pyarrow`` is imported only when a file is read.

Error policy (``errors=``, schema/quarantine.py): ``"coerce"`` is the
legacy vectorized path (a string-typed column either casts or raises
raw); ``"strict"`` raises MalformedRowError naming the global row
index/column of the first junk cell; ``"quarantine"`` drops junk rows
from the device block and records them in a bounded QuarantineBuffer.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from ..faults import injection as _faults
from ..obs import trace as _obs_trace
from ..schema.quarantine import (
    MalformedRowError,
    QuarantineBuffer,
    check_errors_mode,
    coerce_numeric,
    data_telemetry,
    excerpt_of,
)
from ..utils.device import resolve_device
from .fast_csv import double_buffered_to_device


def batch_to_numeric_block(batch, columns: Sequence[str]):
    """One Arrow record batch -> ([rows, d] float32 values, [rows, d] bool
    mask).  Nulls (and NaNs) are masked and zeroed - the NumericColumn
    contract."""
    cols_v, cols_m = [], []
    for name in columns:
        arr = batch.column(name)
        np_vals = arr.to_numpy(zero_copy_only=False)
        vals = np.asarray(np_vals, dtype=np.float32)
        # nulls surface as NaN after the float cast; Arrow's own null
        # bitmap covers types whose to_numpy uses sentinels
        mask = ~np.isnan(vals)
        if arr.null_count:
            mask &= ~np.asarray(arr.is_null())
        cols_v.append(np.where(mask, vals, np.float32(0.0)))
        cols_m.append(mask)
    return np.stack(cols_v, axis=1), np.stack(cols_m, axis=1)


def checked_batch_to_numeric_block(
    batch,
    columns: Sequence[str],
    errors: str,
    quarantine: QuarantineBuffer,
    row_offset: int,
    source: str,
    telemetry=None,
):
    """The validated sibling of :func:`batch_to_numeric_block`: columns
    that refuse the vectorized float cast (string-typed numerics) parse
    per-value; a non-null cell that fails the parse is a type flip —
    strict raises naming the global row index, quarantine drops the row.
    Returns (values, mask, n_bad)."""
    cols_v, cols_m = [], []
    bad: dict[int, tuple[str, str]] = {}
    for name in columns:
        arr = batch.column(name)
        np_vals = arr.to_numpy(zero_copy_only=False)
        try:
            vals = np.asarray(np_vals, dtype=np.float32)
        except (TypeError, ValueError):
            raw = arr.to_pylist()
            vals = np.empty(len(raw), dtype=np.float32)
            for i, v in enumerate(raw):
                p = None if v is None else coerce_numeric(v)
                if p is None:
                    vals[i] = np.nan
                    if v is not None and i not in bad:
                        bad[i] = (name, excerpt_of(v))
                else:
                    vals[i] = p
        mask = ~np.isnan(vals)
        if arr.null_count:
            mask &= ~np.asarray(arr.is_null())
        cols_v.append(np.where(mask, vals, np.float32(0.0)))
        cols_m.append(mask)
    values = np.stack(cols_v, axis=1)
    masks = np.stack(cols_m, axis=1)
    n = values.shape[0]
    if _faults.fires("reader.type_flip") is not None and n:
        bad.setdefault(0, (columns[0], "<injected>"))
    if _faults.fires("reader.malformed_row") is not None and n:
        bad.setdefault(0, ("", "<injected>"))
    if not bad:
        return values, masks, 0
    if errors == "strict":
        i0 = min(bad)
        col, cell = bad[i0]
        (telemetry or data_telemetry()).record_strict_error(source)
        raise MalformedRowError(
            source, row_offset + i0, "type_flip", col or None, cell
        )
    for i in sorted(bad):
        col, cell = bad[i]
        quarantine.add(row_offset + i, "type_flip", col or None, cell)
    keep = np.ones(n, dtype=bool)
    keep[list(bad)] = False
    return values[keep], masks[keep], len(bad)


class DeviceParquetIngest:
    """Parquet file -> device-resident [n, d] float32 design matrix with
    double-buffered transfer (the Arrow sibling of DeviceCSVIngest).
    ``device`` defaults to the card and raises without CUDA."""

    def __init__(self, path: str, columns: Sequence[str],
                 batch_rows: int = 1 << 20,
                 errors: str = "coerce",
                 quarantine: Optional[QuarantineBuffer] = None,
                 telemetry=None,
                 device: str = "cuda") -> None:
        self.device = resolve_device(device)
        self.path = path
        self.columns = list(columns)
        self.batch_rows = batch_rows
        self.errors = check_errors_mode(errors)
        if self.errors != "coerce" and quarantine is None:
            quarantine = QuarantineBuffer(source=path)
        self.quarantine = quarantine
        self.telemetry = telemetry

    def _producer(self, q) -> None:
        checked = self.errors != "coerce"
        rows_seen = rows_kept = 0
        try:
            import pyarrow.parquet as pq

            pf = pq.ParquetFile(self.path)
            for batch in pf.iter_batches(batch_size=self.batch_rows,
                                         columns=self.columns):
                if batch.num_rows == 0:
                    continue
                if checked:
                    vals, mask, n_bad = checked_batch_to_numeric_block(
                        batch, self.columns, self.errors, self.quarantine,
                        rows_seen, self.path, telemetry=self.telemetry,
                    )
                    rows_seen += batch.num_rows
                    rows_kept += batch.num_rows - n_bad
                    if vals.shape[0]:
                        q.put((vals, mask))
                else:
                    q.put(batch_to_numeric_block(batch, self.columns))
            if checked:
                (self.telemetry or data_telemetry()).record_read(
                    self.path, rows_seen, rows_kept, self.quarantine
                )
            q.put(None)
        except BaseException as e:
            q.put(e)

    def to_device(self):
        """Returns (X [n, d] float32, valid_mask [n, d] bool, rows) on
        the ingest's device."""
        with _obs_trace.span(
            "ingest.device", source=self.path, format="parquet",
        ):
            return double_buffered_to_device(
                self._producer, len(self.columns), self.device
            )
