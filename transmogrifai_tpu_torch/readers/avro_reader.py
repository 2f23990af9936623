"""Avro Object Container File reader (pure python, no external deps).

Counterpart of the reference's Avro ingestion (reference: readers/.../
AvroReaders (DataReaders.scala:44-110), utils/.../io/avro/AvroInOut.scala):
decodes the standard OCF layout - header magic ``Obj\\x01``, file metadata
(embedded JSON schema, codec null/deflate), sync-marker-delimited blocks of
zigzag-varint-encoded records - into python dicts / a columnar Dataset.
Supports null, boolean, int, long, float, double, bytes, string, enum,
fixed, array, map, union, and nested record schemas.

Error policy (``errors=``, schema/quarantine.py): ``"coerce"`` keeps
legacy behavior (type-mismatched values silently become missing,
truncation raises raw EOFError), ``"strict"`` raises MalformedRowError
naming the record index, ``"quarantine"`` isolates type-flipped records
and a truncated/corrupt trailing block into a bounded QuarantineBuffer
instead of aborting the whole ingest.
"""
from __future__ import annotations

import json
import logging
import struct
import zlib
from typing import Any, Optional, Sequence

from ..faults import injection as _faults
from ..features.feature import Feature
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

log = logging.getLogger("transmogrifai_tpu_torch.readers")

MAGIC = b"Obj\x01"


class _Decoder:
    def __init__(self, buf: bytes) -> None:
        self.buf = buf
        self.pos = 0

    def read(self, n: int) -> bytes:
        out = self.buf[self.pos : self.pos + n]
        if len(out) != n:
            raise EOFError("truncated avro data")
        self.pos += n
        return out

    def at_end(self) -> bool:
        return self.pos >= len(self.buf)

    def read_long(self) -> int:
        shift = 0
        acc = 0
        while True:
            b = self.buf[self.pos]
            self.pos += 1
            acc |= (b & 0x7F) << shift
            if not (b & 0x80):
                break
            shift += 7
        return (acc >> 1) ^ -(acc & 1)  # zigzag

    read_int = read_long

    def read_bytes(self) -> bytes:
        return self.read(self.read_long())

    def read_string(self) -> str:
        return self.read_bytes().decode("utf-8")

    def read_float(self) -> float:
        return struct.unpack("<f", self.read(4))[0]

    def read_double(self) -> float:
        return struct.unpack("<d", self.read(8))[0]

    def read_boolean(self) -> bool:
        return self.read(1) != b"\x00"


def _decode_value(dec: _Decoder, schema: Any) -> Any:
    if isinstance(schema, list):  # union
        idx = dec.read_long()
        return _decode_value(dec, schema[idx])
    if isinstance(schema, dict):
        t = schema["type"]
        if t == "record":
            return {
                f["name"]: _decode_value(dec, f["type"])
                for f in schema["fields"]
            }
        if t == "enum":
            return schema["symbols"][dec.read_long()]
        if t == "fixed":
            return dec.read(schema["size"])
        if t == "array":
            out = []
            while True:
                n = dec.read_long()
                if n == 0:
                    break
                if n < 0:
                    dec.read_long()  # block size, ignored
                    n = -n
                for _ in range(n):
                    out.append(_decode_value(dec, schema["items"]))
            return out
        if t == "map":
            out = {}
            while True:
                n = dec.read_long()
                if n == 0:
                    break
                if n < 0:
                    dec.read_long()
                    n = -n
                for _ in range(n):
                    # key MUST be read before the value: python evaluates
                    # the RHS of `out[k()] = v()` first, which silently
                    # decoded value-then-key and scrambled every non-empty
                    # map (caught by the writer round-trip test)
                    key = dec.read_string()
                    out[key] = _decode_value(dec, schema["values"])
            return out
        return _decode_value(dec, t)  # {"type": "string"} style
    # primitive
    if schema == "null":
        return None
    if schema == "boolean":
        return dec.read_boolean()
    if schema in ("int", "long"):
        return dec.read_long()
    if schema == "float":
        return dec.read_float()
    if schema == "double":
        return dec.read_double()
    if schema == "bytes":
        return dec.read_bytes()
    if schema == "string":
        return dec.read_string()
    raise ValueError(f"unsupported avro type: {schema!r}")


class _ByteWindow:
    """Bounded read-ahead over a binary file.

    Exposes FILE-ABSOLUTE offsets so the decoder and the damage-resync
    scan can reason in the same coordinates the materializing reader
    used, while only ever buffering from the current block head forward.
    """

    def __init__(self, f, read_bytes: int = 1 << 20) -> None:
        self._f = f
        self._read_bytes = read_bytes
        self.buf = bytearray()
        self.base = 0  # file offset of buf[0]
        self.eof = False

    def _fill(self) -> bool:
        if self.eof:
            return False
        b = self._f.read(self._read_bytes)
        if not b:
            self.eof = True
            return False
        self.buf += b
        return True

    def ensure(self, end: int) -> bool:
        """Buffer through file offset ``end`` (exclusive); False at EOF."""
        while self.base + len(self.buf) < end:
            if not self._fill():
                return False
        return True

    def drop_to(self, pos: int) -> None:
        cut = pos - self.base
        if cut > 0:
            del self.buf[:cut]
            self.base = pos

    def find(self, needle: bytes, start: int) -> int:
        """File-absolute ``find`` from ``start``, discarding scanned
        bytes as it goes (a len(needle)-1 overlap survives each read so
        a marker straddling two reads still matches); -1 when absent —
        at which point the window has reached EOF, so ``base + len(buf)``
        is the total file size."""
        self.drop_to(start)
        while True:
            i = self.buf.find(needle)
            if i >= 0:
                return self.base + i
            keep = len(needle) - 1
            if len(self.buf) > keep:
                cut = len(self.buf) - keep
                del self.buf[:cut]
                self.base += cut
            if not self._fill():
                return -1


class _WindowDecoder(_Decoder):
    """The _Decoder API over a _ByteWindow; ``pos`` is file-absolute.
    The inherited compound reads (read_bytes/string/float/double/
    boolean) all route through the three primitives overridden here."""

    def __init__(self, win: _ByteWindow, pos: int = 0) -> None:
        self.win = win
        self.pos = pos

    def read(self, n: int) -> bytes:
        if not self.win.ensure(self.pos + n):
            raise EOFError("truncated avro data")
        s = self.pos - self.win.base
        out = bytes(self.win.buf[s : s + n])
        self.pos += n
        return out

    def at_end(self) -> bool:
        return not self.win.ensure(self.pos + 1)

    def read_long(self) -> int:
        shift = 0
        acc = 0
        while True:
            if not self.win.ensure(self.pos + 1):
                raise EOFError("truncated avro data")
            b = self.win.buf[self.pos - self.win.base]
            self.pos += 1
            acc |= (b & 0x7F) << shift
            if not (b & 0x80):
                break
            shift += 7
        return (acc >> 1) ^ -(acc & 1)  # zigzag

    read_int = read_long


class AvroBlockStream:
    """Incremental OCF block decoder — ONE implementation serving both
    the materializing batch reader (:func:`read_avro_records`) and the
    input pipeline's chunked avro ingest.

    The header (magic, metadata map, schema, codec, sync marker) parses
    eagerly in ``__init__``; :meth:`blocks` then yields each block's
    decoded record list while holding only the current block (plus a
    bounded read-ahead window) in memory, so an avro shard streams
    exactly like a CSV shard instead of materializing the whole file.

    Error policy matches the old whole-file reader byte for byte:
    ``"coerce"`` raises raw, ``"strict"`` raises MalformedRowError
    naming the clean-record index, ``"quarantine"`` rolls the suspect
    block back, records the damage (same excerpt strings), and resyncs
    forward past the next sync marker — scanned incrementally, never
    by loading the tail.  ``records_decoded`` counts cleanly decoded
    records and ``damaged`` counts quarantined block-level events so
    callers can reconcile rows_seen without owning the buffer.
    """

    def __init__(self, path: str, errors: str = "coerce",
                 quarantine: Optional[QuarantineBuffer] = None,
                 read_bytes: int = 1 << 20) -> None:
        check_errors_mode(errors)
        self.path = path
        self.errors = errors
        self.quarantine = quarantine
        self.records_decoded = 0
        self.damaged = 0
        self._f = open(path, "rb")
        try:
            self._win = _ByteWindow(self._f, read_bytes)
            dec = _WindowDecoder(self._win)
            if dec.read(4) != MAGIC:
                raise ValueError(
                    f"{path} is not an avro object container file")
            meta: dict[str, bytes] = {}
            while True:
                n = dec.read_long()
                if n == 0:
                    break
                if n < 0:
                    dec.read_long()
                    n = -n
                for _ in range(n):
                    key = dec.read_string()
                    meta[key] = dec.read_bytes()
            self._sync = dec.read(16)
            self.schema = json.loads(meta["avro.schema"].decode("utf-8"))
            self.codec = meta.get("avro.codec", b"null").decode("utf-8")
            if self.codec not in ("null", "deflate"):
                # configuration error, NOT block damage: checked once up
                # front so quarantine mode can never misread a whole
                # valid file in an unsupported codec as wall-to-wall
                # corrupt blocks
                raise ValueError(f"unsupported avro codec {self.codec!r}")
            self._dec = dec
        except BaseException:
            self._f.close()
            raise

    def close(self) -> None:
        self._f.close()

    def blocks(self):
        """Yield each block's decoded records (a list per block)."""
        dec, win, sync = self._dec, self._win, self._sync
        while True:
            block_start = dec.pos
            # nothing before the current block head is ever needed again
            # (the resync scan searches FORWARD from it), so release it:
            # this is what bounds memory to one block + read-ahead
            win.drop_to(block_start)
            if dec.at_end():
                return
            out: list = []
            try:
                count = dec.read_long()
                size = dec.read_long()
                block = dec.read(size)
                if self.codec == "deflate":
                    block = zlib.decompress(block, -15)
                bdec = _Decoder(block)
                for _ in range(count):
                    out.append(_decode_value(bdec, self.schema))
                if dec.read(16) != sync:
                    raise ValueError("bad sync marker (corrupt avro file)")
            except (EOFError, IndexError, ValueError, KeyError, zlib.error,
                    struct.error, UnicodeDecodeError) as e:
                if self.errors == "coerce":
                    raise
                truncated = isinstance(
                    e, (EOFError, IndexError, struct.error))
                reason = "truncated_block" if truncated else "corrupt_block"
                if self.errors == "strict":
                    data_telemetry().record_strict_error(self.path)
                    # the old whole-file reader's index counted the
                    # damaged block's partially decoded records too
                    # (nothing rolled back before a strict raise) -
                    # keep that contract exactly
                    raise MalformedRowError(
                        self.path, self.records_decoded + len(out),
                        reason, None, excerpt_of(str(e)),
                    ) from e
                # quarantine: the whole damaged block is suspect - its
                # records never left this frame, so dropping the block
                # is just not yielding it.  Search for the next sync
                # marker from the block HEAD, not the failure point:
                # when damage hits early payload (or just the trailing
                # marker) this finds THIS block's own boundary, so the
                # next healthy block is never skipped.  A false match
                # inside payload just fails the next decode and resyncs
                # again - strictly forward progress either way.
                self.damaged += 1
                nxt = win.find(sync, block_start)
                if nxt < 0:
                    total = win.base + len(win.buf)  # find() hit EOF
                    if self.quarantine is not None:
                        self.quarantine.add(
                            self.records_decoded, reason, None,
                            excerpt_of(f"{e}; no later sync marker - "
                                       f"{total - block_start} trailing "
                                       "bytes undecodable"),
                        )
                    log.warning(
                        "avro %s: %s at record %d; no sync marker after "
                        "byte %d - keeping the %d-record clean prefix",
                        self.path, reason, self.records_decoded,
                        block_start, self.records_decoded,
                    )
                    return
                if self.quarantine is not None:
                    self.quarantine.add(
                        self.records_decoded, reason, None,
                        excerpt_of(f"{e}; block dropped, resynced past "
                                   f"{nxt + 16 - block_start} bytes"),
                    )
                log.warning(
                    "avro %s: %s at record %d; dropping the damaged "
                    "block (%d bytes) and resyncing",
                    self.path, reason, self.records_decoded,
                    nxt + 16 - block_start,
                )
                dec.pos = nxt + 16  # just past the marker: next block
                continue
            self.records_decoded += len(out)
            yield out


def read_avro_records(
    path: str,
    errors: str = "coerce",
    quarantine: Optional[QuarantineBuffer] = None,
) -> tuple[dict, list[dict]]:
    """Read all records + the parsed schema from an OCF file (a
    materializing wrapper over :class:`AvroBlockStream`).

    A truncated or corrupt trailing block: raw EOFError/ValueError under
    ``"coerce"`` (legacy), :class:`MalformedRowError` naming the record
    index under ``"strict"``, or — under ``"quarantine"`` — the cleanly
    decoded prefix is returned and the damage recorded in the buffer.
    """
    stream = AvroBlockStream(path, errors=errors, quarantine=quarantine)
    try:
        records: list[dict] = []
        for block in stream.blocks():
            records.extend(block)
        return stream.schema, records
    finally:
        stream.close()


class AvroReader:
    """Batch reader over an avro file (reference: DataReaders.Simple.avro)."""

    def __init__(self, path: str, key_field: Optional[str] = None,
                 errors: str = "coerce",
                 quarantine: Optional[QuarantineBuffer] = None,
                 telemetry=None) -> None:
        self.path = path
        self.key_field = key_field
        self.errors = check_errors_mode(errors)
        self.quarantine = quarantine
        self.telemetry = telemetry
        self._schema: Optional[dict] = None
        self._records: Optional[list[dict]] = None
        self._checked_cache: dict[tuple, list] = {}

    def _buffer(self) -> QuarantineBuffer:
        if self.quarantine is None:
            self.quarantine = QuarantineBuffer(source=self.path)
        return self.quarantine

    @property
    def records(self) -> list[dict]:
        if self._records is None:
            self._schema, self._records = read_avro_records(
                self.path, errors=self.errors,
                quarantine=(
                    self._buffer() if self.errors == "quarantine" else None
                ),
            )
        return self._records

    def generate_dataset(
        self, raw_features: Sequence[Feature], params: Optional[dict] = None
    ) -> Dataset:
        with _obs_trace.span(
            "ingest.read", source=self.path, format="avro",
            errors=self.errors,
        ) as sp:
            ds = self._generate_dataset(raw_features)
            sp.set_attr("rows", len(ds))
            return ds

    def _generate_dataset(
        self, raw_features: Sequence[Feature]
    ) -> Dataset:
        recs = self.records
        if self.errors != "coerce":
            # memoized PER FEATURE SET: a repeat call with the same
            # features (train + compute_data_up_to on one reader) must
            # not re-validate and double every quarantine/telemetry
            # count, while a different feature list (new numeric
            # columns = new type-flip surface) validates afresh
            key = tuple(
                (f.name, f.ftype.kind) for f in raw_features
            )
            if key not in self._checked_cache:
                self._checked_cache[key] = self._checked_records(
                    recs, raw_features
                )
            recs = self._checked_cache[key]
        cols = {}
        for f in raw_features:
            vals = [_coerce(r.get(f.name), f) for r in recs]
            cols[f.name] = column_from_list(vals, f.ftype)
        return Dataset(cols)

    def _checked_records(
        self, recs: list, raw_features: Sequence[Feature]
    ) -> list:
        """Per-record validation: a non-null value in a numeric feature
        that fails the coerce path's float() is a type flip (the coerce
        mode would silently null it); a non-record entry is malformed.
        Strict raises at the first offense naming the record index;
        quarantine drops the record and keeps exact counts."""
        buf = self._buffer()
        # entries already in the buffer are file-level damage from
        # read_avro_records (a truncated/corrupt tail block): count each
        # as a read-and-quarantined row so rows_read - rows_kept always
        # agrees with the buffer's by_reason totals
        file_level = buf.total
        numeric = [f.name for f in raw_features
                   if f.ftype.kind == "numeric"]
        kept = []
        for i, r in enumerate(recs):
            reason = col = cell = None
            if _faults.fires("reader.malformed_row") is not None:
                reason, cell = "malformed_record", "<injected>"
            elif (_faults.fires("reader.type_flip") is not None
                    and numeric):
                reason, col, cell = "type_flip", numeric[0], "<injected>"
            elif not isinstance(r, dict):
                reason, cell = "malformed_record", excerpt_of(r)
            else:
                for name in numeric:
                    v = r.get(name)
                    if v is None or isinstance(v, (bool, int, float)):
                        continue
                    if coerce_numeric(v) is None:
                        reason, col, cell = (
                            "type_flip", name, excerpt_of(v)
                        )
                        break
            if reason is not None:
                if self.errors == "strict":
                    (self.telemetry or data_telemetry()
                     ).record_strict_error(self.path)
                    raise MalformedRowError(
                        self.path, i, reason, col, cell
                    )
                buf.add(i, reason, col, cell)
                continue
            kept.append(r)
        (self.telemetry or data_telemetry()).record_read(
            self.path, len(recs) + file_level, len(kept), buf
        )
        return kept


def _coerce(v: Any, f: Feature) -> Any:
    if v is None:
        return None
    if f.ftype.kind == "numeric":
        if isinstance(v, bool):
            return float(v)
        if isinstance(v, (int, float)):
            return float(v)
        return coerce_numeric(v)
    if f.ftype.kind == "text":
        return str(v)
    return v


class ParquetReader:
    """Batch reader over parquet (reference: ParquetProductReader) - via
    pyarrow when available."""

    def __init__(self, path: str, errors: str = "coerce",
                 quarantine: Optional[QuarantineBuffer] = None,
                 telemetry=None) -> None:
        self.path = path
        self.errors = check_errors_mode(errors)
        self.quarantine = quarantine
        self.telemetry = telemetry

    def _checked_take(self, table, raw_features: Sequence[Feature]):
        """Row-validated parquet ingest: parquet's own types make most
        flips impossible, but a string-typed column serving a numeric
        feature can still carry junk the coerce path would silently
        null.  Drops (quarantine) or names (strict) those rows."""
        import pyarrow.types as pat

        buf = self.quarantine
        if buf is None:
            buf = self.quarantine = QuarantineBuffer(source=self.path)
        n = table.num_rows
        bad: dict[int, tuple[str, Optional[str], str]] = {}
        for f in raw_features:
            if f.ftype.kind != "numeric":
                continue
            col = table.column(f.name)
            if (pat.is_integer(col.type) or pat.is_floating(col.type)
                    or pat.is_boolean(col.type) or pat.is_decimal(col.type)):
                continue
            for i, v in enumerate(col.to_pylist()):
                if v is None or isinstance(v, (bool, int, float)):
                    continue
                if coerce_numeric(v) is None and i not in bad:
                    bad[i] = ("type_flip", f.name, excerpt_of(v))
        if _faults.fires("reader.type_flip") is not None and n:
            bad.setdefault(0, ("type_flip", raw_features[0].name,
                               "<injected>"))
        if _faults.fires("reader.malformed_row") is not None and n:
            bad.setdefault(0, ("malformed_record", None, "<injected>"))
        if bad and self.errors == "strict":
            i0 = min(bad)
            reason, col_name, cell = bad[i0]
            (self.telemetry or data_telemetry()).record_strict_error(
                self.path
            )
            raise MalformedRowError(self.path, i0, reason, col_name, cell)
        for i in sorted(bad):
            reason, col_name, cell = bad[i]
            buf.add(i, reason, col_name, cell)
        (self.telemetry or data_telemetry()).record_read(
            self.path, n, n - len(bad), buf
        )
        if not bad:
            return table
        keep = [i for i in range(n) if i not in bad]
        return table.take(keep)

    def generate_dataset(
        self, raw_features: Sequence[Feature], params: Optional[dict] = None
    ) -> Dataset:
        with _obs_trace.span(
            "ingest.read", source=self.path, format="parquet",
            errors=self.errors,
        ) as sp:
            ds = self._generate_dataset(raw_features)
            sp.set_attr("rows", len(ds))
            return ds

    def _generate_dataset(
        self, raw_features: Sequence[Feature]
    ) -> Dataset:
        import numpy as np
        import pyarrow.parquet as pq
        import pyarrow.types as pat

        table = pq.read_table(
            self.path, columns=[f.name for f in raw_features]
        )
        if self.errors != "coerce":
            table = self._checked_take(table, raw_features)
        cols = {}
        for f in raw_features:
            col = table.column(f.name)
            arrow_numeric = (
                pat.is_integer(col.type) or pat.is_floating(col.type)
                or pat.is_boolean(col.type) or pat.is_decimal(col.type)
            )
            if f.ftype.kind == "numeric" and arrow_numeric:
                # vectorized Arrow decode (string-typed numerics hit the
                # fallback): nulls surface as NaN after the float cast,
                # and column_from_list's ndarray branch owns the
                # NaN->masked NumericColumn contract
                cols[f.name] = column_from_list(
                    np.asarray(col.to_numpy(zero_copy_only=False),
                               np.float64),
                    f.ftype,
                )
                continue
            vals = [_coerce(v, f) for v in col.to_pylist()]
            cols[f.name] = column_from_list(vals, f.ftype)
        return Dataset(cols)


# ---------------------------------------------------------------------------
# Avro OCF WRITER (inverse of the reader above; reference counterparts:
# utils/.../io/avro/AvroInOut.scala saveAvro and utils/.../io/csv/
# CSVToAvro.scala).  Encodes the same subset the decoder reads: null,
# boolean, int, long, float, double, bytes, string, enum, fixed, array,
# map, union, nested record; codec null or deflate.
# ---------------------------------------------------------------------------
class _Encoder:
    def __init__(self) -> None:
        self.parts: list[bytes] = []

    def write(self, b: bytes) -> None:
        self.parts.append(b)

    def write_long(self, v: int) -> None:
        v = (v << 1) ^ (v >> 63)  # zigzag (python ints: arithmetic shift)
        out = bytearray()
        while True:
            b = v & 0x7F
            v >>= 7
            if v:
                out.append(b | 0x80)
            else:
                out.append(b)
                break
        self.parts.append(bytes(out))

    write_int = write_long

    def write_bytes(self, b: bytes) -> None:
        self.write_long(len(b))
        self.write(b)

    def write_string(self, s: str) -> None:
        self.write_bytes(s.encode("utf-8"))

    def write_float(self, v: float) -> None:
        self.write(struct.pack("<f", v))

    def write_double(self, v: float) -> None:
        self.write(struct.pack("<d", v))

    def write_boolean(self, v: bool) -> None:
        self.write(b"\x01" if v else b"\x00")

    def getvalue(self) -> bytes:
        return b"".join(self.parts)


def _union_branch(schema_list: list, value: Any) -> int:
    """Pick the union branch for a value.  ['null', T] optionals take the
    single non-null branch; wider unions match the VALUE's python type
    against the branch kinds (the reader supports arbitrary unions, so the
    writer must not silently coerce - e.g. ['null','string','long'] with 5
    picks 'long', not 'string'; advisor r3 finding)."""
    names = [s if isinstance(s, str) else s.get("type") for s in schema_list]
    if value is None:
        if "null" in names:
            return names.index("null")
        raise ValueError("None for a union without a null branch")
    non_null = [(i, nm) for i, nm in enumerate(names) if nm != "null"]
    if not non_null:
        raise ValueError("union has only a null branch")
    if len(non_null) == 1:
        return non_null[0][0]
    if isinstance(value, bool):
        prefs = ("boolean",)
    elif isinstance(value, int):
        prefs = ("long", "int", "double", "float")
    elif isinstance(value, float):
        prefs = ("double", "float")
    elif isinstance(value, str):
        prefs = ("string", "enum")
    elif isinstance(value, (bytes, bytearray)):
        prefs = ("bytes", "fixed")
    elif isinstance(value, dict):
        prefs = ("record", "map")
    elif isinstance(value, (list, tuple)):
        prefs = ("array",)
    else:
        prefs = ()
    for p in prefs:
        for i, nm in non_null:
            if nm == p:
                return i
    raise ValueError(
        f"no union branch matches {type(value).__name__} value: {names}"
    )


def _encode_value(enc: _Encoder, schema: Any, value: Any) -> None:
    if isinstance(schema, list):  # union
        idx = _union_branch(schema, value)
        enc.write_long(idx)
        _encode_value(enc, schema[idx], value)
        return
    if isinstance(schema, dict):
        t = schema["type"]
        if t == "record":
            for f in schema["fields"]:
                _encode_value(enc, f["type"], (value or {}).get(f["name"]))
            return
        if t == "enum":
            enc.write_long(schema["symbols"].index(value))
            return
        if t == "fixed":
            if len(value) != schema["size"]:
                raise ValueError("fixed value has wrong size")
            enc.write(bytes(value))
            return
        if t == "array":
            items = list(value or [])
            if items:
                enc.write_long(len(items))
                for it in items:
                    _encode_value(enc, schema["items"], it)
            enc.write_long(0)
            return
        if t == "map":
            entries = dict(value or {})
            if entries:
                enc.write_long(len(entries))
                for k, v in entries.items():
                    enc.write_string(k)
                    _encode_value(enc, schema["values"], v)
            enc.write_long(0)
            return
        _encode_value(enc, t, value)  # {"type": "string"} style
        return
    if schema == "null":
        if value is not None:
            raise ValueError(f"non-null value {value!r} for null schema")
        return
    if schema == "boolean":
        enc.write_boolean(bool(value))
        return
    if schema in ("int", "long"):
        iv = int(value)
        if iv != value:
            # a double landing in a long field must error, not silently
            # round-trip with lost precision (advisor r3 finding)
            raise ValueError(f"non-integral value {value!r} for avro {schema}")
        enc.write_long(iv)
        return
    if schema == "float":
        enc.write_float(float(value))
        return
    if schema == "double":
        enc.write_double(float(value))
        return
    if schema == "bytes":
        enc.write_bytes(bytes(value))
        return
    if schema == "string":
        enc.write_string(str(value))
        return
    raise ValueError(f"unsupported avro type: {schema!r}")


def write_avro_records(
    path: str,
    schema: dict,
    records: Sequence[dict],
    codec: str = "deflate",
    block_records: int = 4096,
) -> int:
    """Write records to an Avro Object Container File; returns the count.
    The layout mirrors read_avro_records: magic, metadata map (schema JSON
    + codec), random sync marker, then blocks of (count, byte-length,
    payload, sync)."""
    import os as _os

    if codec not in ("null", "deflate"):
        raise ValueError(f"codec must be 'null' or 'deflate', got {codec!r}")
    sync = _os.urandom(16)
    head = _Encoder()
    head.write(MAGIC)
    meta = {
        "avro.schema": json.dumps(schema).encode(),
        "avro.codec": codec.encode(),
    }
    head.write_long(len(meta))
    for k, v in meta.items():
        head.write_string(k)
        head.write_bytes(v)
    head.write_long(0)
    head.write(sync)
    out = [head.getvalue()]
    n = 0
    for start in range(0, len(records), block_records):
        chunk = records[start : start + block_records]
        body = _Encoder()
        for rec in chunk:
            _encode_value(body, schema, rec)
        payload = body.getvalue()
        if codec == "deflate":
            # raw deflate (no zlib header), per the avro spec
            comp = zlib.compressobj(wbits=-15)
            payload = comp.compress(payload) + comp.flush()
        blk = _Encoder()
        blk.write_long(len(chunk))
        blk.write_bytes(payload)
        blk.write(sync)
        out.append(blk.getvalue())
        n += len(chunk)
    with open(path, "wb") as f:
        f.write(b"".join(out))
    return n


def _avro_field_name(name: str, seen: set) -> str:
    """Sanitize to the Avro name spec [A-Za-z_][A-Za-z0-9_]* - generated
    feature names contain '-' and would make the file unreadable by
    spec-conforming Avro implementations (java avro, spark, fastavro)."""
    import re as _re

    s = _re.sub(r"[^A-Za-z0-9_]", "_", name)
    if not s or not (s[0].isalpha() or s[0] == "_"):
        s = "_" + s
    base, k = s, 2
    while s in seen:
        s = f"{base}_{k}"
        k += 1
    seen.add(s)
    return s


def schema_for_dataset(ds: Dataset, name: str = "Row") -> dict:
    """An optional-field record schema for a Dataset's columns (every field
    ['null', T] - the reference's nullable-by-design contract).  Field
    names are sanitized to the Avro name spec; when renamed, the original
    column name is kept in the field's ``doc``."""
    from ..types.columns import (
        GeolocationColumn,
        ListColumn,
        MapColumn,
        NumericColumn,
        PredictionColumn,
        TextColumn,
    )
    from ..types import feature_types as ft

    fields = []
    seen: set = set()
    for col_name in ds.column_names():
        col = ds[col_name]
        if isinstance(col, NumericColumn):
            t = "long" if issubclass(col.feature_type, ft.Integral) else "double"
        elif isinstance(col, TextColumn):
            t = "string"
        elif isinstance(col, GeolocationColumn):
            t = {"type": "array", "items": "double"}
        elif isinstance(col, ListColumn):
            items = (
                "long"
                if issubclass(col.feature_type, (ft.DateList,))
                else "string"
            )
            t = {"type": "array", "items": items}
        elif isinstance(col, PredictionColumn):
            # Prediction rows serialize as {prediction, raw_i, prob_i}
            t = {"type": "map", "values": "double"}
        elif isinstance(col, MapColumn):
            vt = col.feature_type.value_type
            values = (
                "double"
                if vt is not None and issubclass(vt, ft.OPNumeric)
                else "string"
            )
            t = {"type": "map", "values": values}
        else:  # vectors -> array of doubles
            t = {"type": "array", "items": "double"}
        fname = _avro_field_name(col_name, seen)
        field = {"name": fname, "type": ["null", t]}
        if fname != col_name:
            field["doc"] = col_name
        fields.append(field)
    return {"type": "record", "name": name, "fields": fields}


def rows_from_dataset(ds: Dataset, schema: dict) -> list[dict]:
    """Transpose a Dataset into row dicts keyed by the schema's (possibly
    sanitized) field names; fields pair with columns positionally."""
    cols = ds.to_pylists()
    names = list(cols)
    fnames = [f["name"] for f in schema["fields"]]
    assert len(fnames) == len(names)
    return [
        {fn: cols[nm][i] for fn, nm in zip(fnames, names)}
        for i in range(len(ds))
    ]


def csv_to_avro(csv_path: str, avro_path: str, features: Sequence[Feature],
                codec: str = "deflate", **reader_kw) -> int:
    """CSV -> Avro OCF conversion (reference: utils/.../io/csv/
    CSVToAvro.scala): reads through CSVReader's typed columns and writes
    an optional-field record file; returns the row count."""
    from .csv_reader import CSVReader

    ds = CSVReader(csv_path, **reader_kw).generate_dataset(features)
    return save_dataset_avro(ds, avro_path, codec=codec)


def save_dataset_avro(ds: Dataset, path: str, name: str = "Row",
                      codec: str = "deflate") -> int:
    """Save a Dataset as an Avro OCF (the reference's df.saveAvro analog);
    returns the row count."""
    schema = schema_for_dataset(ds, name)
    return write_avro_records(path, schema, rows_from_dataset(ds, schema),
                              codec=codec)
