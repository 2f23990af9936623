"""CSV readers.

Counterpart of the reference CSV reader stack (reference: readers/.../
DataReaders.scala:44-198 factory, CSVAutoReaders auto-infer, utils/.../io/
csv/): parse a CSV into a columnar Dataset keyed by the requested raw
features.  Schema-ful (explicit {column: FeatureType}) or auto-inferring.

Error policy (``errors=``, schema/quarantine.py): ``"coerce"`` keeps the
legacy behavior (junk numeric cells become missing values), ``"strict"``
raises :class:`~..schema.quarantine.MalformedRowError` naming the row
index/column, ``"quarantine"`` drops malformed / type-flipped /
truncated rows into a bounded QuarantineBuffer with exact counts in
DataTelemetry.  Strict/quarantine validation needs per-row structure
(ragged-row detection), so those modes always run the python path — the
native scanner stays the coerce-mode fast path (fast_csv.py carries its
own ``errors=`` support for direct columnar callers).
"""
from __future__ import annotations

import csv
from typing import Mapping, Optional, Sequence, Type

import numpy as np

from ..faults import injection as _faults
from ..features.feature import Feature
from ..features.feature_builder import infer_feature_type
from ..obs import trace as _obs_trace
from ..schema.quarantine import (
    MalformedRowError,
    QuarantineBuffer,
    check_errors_mode,
    coerce_numeric,
    data_telemetry,
    excerpt_of,
)
from ..types.columns import column_from_list
from ..types.dataset import Dataset
from ..types.feature_types import FeatureType, OPNumeric


def _parse_cell(raw: str, ftype: Type[FeatureType]):
    if raw is None or raw == "":
        return None
    if issubclass(ftype, OPNumeric):
        try:
            return float(raw)
        except ValueError:
            return None
    return raw


def _cell_is_numeric(raw: str) -> bool:
    """True when a non-empty CSV cell parses as the coerce path would
    parse it (shared rule: schema.quarantine.coerce_numeric - float(),
    which also accepts 'nan'/'inf' and unicode digits)."""
    return coerce_numeric(raw) is not None


INJECTED_JUNK = "\x00<injected-junk>"


class CSVReader:
    """Simple batch CSV reader (reference: DataReaders.Simple.csvCase)."""

    def __init__(
        self,
        path: str,
        schema: Optional[Mapping[str, Type[FeatureType]]] = None,
        headers: Optional[Sequence[str]] = None,
        has_header: bool = True,
        key_col: Optional[str] = None,
        errors: str = "coerce",
        quarantine: Optional[QuarantineBuffer] = None,
        telemetry=None,
        use_native: bool = True,
    ) -> None:
        self.path = path
        self.schema = dict(schema) if schema else None
        self.headers = list(headers) if headers else None
        self.has_header = has_header
        self.key_col = key_col
        self.errors = check_errors_mode(errors)
        self.quarantine = quarantine
        self.telemetry = telemetry
        # use_native=False pins the python path even for numeric/text
        # schemas: apples-to-apples timing (bench) and path-parity tests
        self.use_native = bool(use_native)
        #: the route the last ``generate_dataset`` took: "native" (the
        #: C++ scanner), "python" or "checked" (strict / quarantine)
        self.route: Optional[str] = None

    def read_raw(self) -> dict[str, list]:
        # utf-8-sig: an Excel-style BOM must not leak into the first
        # column name (no-op for BOM-less files)
        with open(self.path, newline="", encoding="utf-8-sig") as f:
            rows = list(csv.reader(f))
        if not rows:
            return {}
        if self.has_header and self.headers is None:
            header, rows = rows[0], rows[1:]
        elif self.headers is not None:
            header = self.headers
            if self.has_header:
                rows = rows[1:]
        else:
            header = [f"c{i}" for i in range(len(rows[0]))]
        cols: dict[str, list] = {h: [] for h in header}
        for r in rows:
            for h, v in zip(header, r):
                cols[h].append(v if v != "" else None)
            for h in header[len(r):]:
                cols[h].append(None)
        return cols

    def generate_dataset(
        self, raw_features: Sequence[Feature], params: Optional[dict] = None
    ) -> Dataset:
        """Reader hand-off (reference: DataReader.generateDataFrame:173-199).
        Numeric/text schemas stream through the chunked C++ scanner
        (readers/fast_csv.py) - no per-value python work for numeric
        columns; anything else (or no native lib) takes the python path.
        Strict/quarantine error modes run the checked python path (row
        structure is required for ragged-row detection).  Each read is
        one ``ingest.read`` trace span on the ambient run trace
        (obs/), whose ``route`` attribute (and ``self.route``) names the
        route the read took."""
        with _obs_trace.span(
            "ingest.read", source=self.path, format="csv",
            errors=self.errors,
        ) as sp:
            ds = self._generate_dataset(raw_features, params)
            sp.set_attr("rows", len(ds))
            sp.set_attr("route", self.route)
            return ds

    def _generate_dataset(
        self, raw_features: Sequence[Feature], params: Optional[dict] = None
    ) -> Dataset:
        if self.errors != "coerce":
            self.route = "checked"
            return self._generate_checked(raw_features)
        if self.use_native and all(
            f.ftype.kind in ("numeric", "text") for f in raw_features
        ):
            try:
                from .fast_csv import read_csv_columnar

                cols = read_csv_columnar(
                    self.path,
                    schema={f.name: f.ftype for f in raw_features},
                    headers=self.headers,
                    has_header=self.has_header,
                )
                self.route = "native"
                return Dataset(cols)
            except RuntimeError as e:
                # native kernels unavailable: python fallback below
                import logging

                logging.getLogger("transmogrifai_tpu_torch.readers").debug(
                    "fast CSV path unavailable (%s); python fallback", e
                )
        self.route = "python"
        raw = self.read_raw()
        out = {}
        for feat in raw_features:
            if feat.name not in raw:
                raise KeyError(f"column {feat.name!r} not in CSV {self.path}")
            parsed = [_parse_cell(v, feat.ftype) for v in raw[feat.name]]
            out[feat.name] = column_from_list(parsed, feat.ftype)
        return Dataset(out)

    # -- checked ingestion (errors = strict | quarantine) -------------------
    def _read_rows(self) -> tuple[list[str], list[list[str]]]:
        """(header, raw rows) WITHOUT the read_raw padding - checked
        modes need each row's true field count."""
        with open(self.path, newline="", encoding="utf-8-sig") as f:
            rows = list(csv.reader(f))
        if not rows:
            return (self.headers or []), []
        if self.has_header and self.headers is None:
            return rows[0], rows[1:]
        if self.headers is not None:
            return list(self.headers), rows[1:] if self.has_header else rows
        return [f"c{i}" for i in range(len(rows[0]))], rows

    def _generate_checked(
        self, raw_features: Sequence[Feature]
    ) -> Dataset:
        """Row-validated ingest: malformed rows (field-count mismatch)
        and type-flipped numeric cells either raise (strict) or land in
        the quarantine buffer (quarantine).  Fault points
        ``reader.malformed_row`` / ``reader.type_flip`` corrupt live
        rows so drills exercise the REAL detection path."""
        header, rows = self._read_rows()
        missing = [f.name for f in raw_features if f.name not in header]
        if missing:
            raise KeyError(f"columns {missing} not in CSV {self.path}")
        col_idx = {f.name: header.index(f.name) for f in raw_features}
        numeric = [
            (f.name, col_idx[f.name]) for f in raw_features
            if issubclass(f.ftype, OPNumeric)
        ]
        buf = self.quarantine
        if buf is None:
            buf = self.quarantine = QuarantineBuffer(source=self.path)
        ncols = len(header)
        parsed: dict[str, list] = {f.name: [] for f in raw_features}
        kept = 0
        for i, r in enumerate(rows):
            if _faults.fires("reader.malformed_row") is not None:
                r = r[: max(len(r) - 1, 0)]  # chop a field: truncated row
            if numeric and _faults.fires("reader.type_flip") is not None:
                r = list(r)
                if numeric[0][1] < len(r):
                    r[numeric[0][1]] = INJECTED_JUNK
            bad_reason = bad_col = bad_cell = None
            if len(r) != ncols:
                bad_reason = (
                    "truncated_row" if len(r) < ncols else "extra_fields"
                )
                bad_cell = ",".join(r)
            else:
                for name, c in numeric:
                    cell = r[c]
                    if cell and not _cell_is_numeric(cell):
                        bad_reason, bad_col, bad_cell = (
                            "type_flip", name, cell
                        )
                        break
            if bad_reason is not None:
                if self.errors == "strict":
                    (self.telemetry or data_telemetry()).record_strict_error(
                        self.path
                    )
                    raise MalformedRowError(
                        self.path, i, bad_reason, bad_col,
                        excerpt_of(bad_cell),
                    )
                buf.add(i, bad_reason, bad_col, excerpt_of(bad_cell))
                continue
            kept += 1
            for f in raw_features:
                v = r[col_idx[f.name]]
                parsed[f.name].append(_parse_cell(v, f.ftype))
        (self.telemetry or data_telemetry()).record_read(
            self.path, len(rows), kept, buf
        )
        return Dataset({
            f.name: column_from_list(parsed[f.name], f.ftype)
            for f in raw_features
        })

    def infer_schema(
        self, raw: Optional[dict[str, list]] = None
    ) -> dict[str, Type[FeatureType]]:
        """``raw`` lets callers that already read the file (cli.generate)
        skip a second full parse."""
        if raw is None:
            raw = self.read_raw()
        schema = {}
        for name, vals in raw.items():
            typed = []
            for v in vals[:1000]:
                if v is None:
                    typed.append(None)
                    continue
                try:
                    fv = float(v)
                    typed.append(int(fv) if fv.is_integer() else fv)
                except ValueError:
                    typed.append(v)
            schema[name] = infer_feature_type(typed)
        return schema
