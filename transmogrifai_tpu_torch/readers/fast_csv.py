"""Chunked columnar CSV ingestion.

Counterpart of ``transmogrifai_tpu/readers/fast_csv.py`` (reference:
readers/src/main/scala/com/salesforce/op/readers/DataReader.scala:173
generateDataFrame, DataReaders.scala:44-198).  Fixed-size byte chunks
stream through the C++ CSV scanner (``native/txkernels.cpp``
tx_csv_index/tx_csv_cells - quote-aware row indexing + threaded cell
extraction + inline numeric parsing, built by ``utils/native.py``) and
assemble into columnar arrays with ZERO per-value python work for
numeric columns.  Chunk boundaries are aligned to newlines with even
quote parity so quoted embedded newlines never split a record.

:func:`read_csv_columnar` - file -> {name: Column} for Dataset ingest
(the CSVReader fast path).  :class:`DeviceCSVIngest` - file -> a
device-resident [n, d] design matrix with a DOUBLE-BUFFERED host->device
hand-off: the C++ parse of chunk i+1 overlaps the copy of chunk i to the
card (pinned host memory, ``non_blocking`` copies on a side stream).
"""
from __future__ import annotations

import collections
import queue
import threading
from typing import Mapping, Optional, Sequence, Type

import numpy as np
import torch

from ..obs import trace as _obs_trace
from ..types.columns import Column, NumericColumn, TextColumn
from ..types.feature_types import FeatureType, OPNumeric, Text
from ..utils import native
from ..utils.device import resolve_device

DEFAULT_CHUNK_BYTES = 64 << 20


def _count_quotes(buf: bytes) -> int:
    """Quote count for the chunk aligner: the native GIL-free counter
    when available (pipeline workers scan concurrently), bytes.count
    otherwise."""
    n = native.count_byte(buf, 0x22)
    return buf.count(b'"') if n is None else n


def _aligned_chunks(path: str, chunk_bytes: int):
    """Yield byte chunks ending on a record boundary: the cut point is a
    newline with an even number of quote bytes before it (cumulative from
    file start), so a '\\n' inside a quoted field never splits a row."""
    carry = b""
    with open(path, "rb") as f:
        while True:
            block = f.read(chunk_bytes)
            if not block:
                if carry:
                    yield carry
                return
            buf = carry + block
            # split at the last newline whose prefix has even quote parity;
            # scan newline candidates from the end (rarely more than one
            # iteration - pathological all-quoted tails degrade to carry)
            cut = -1
            search_end = len(buf)
            total_quotes = _count_quotes(buf)
            while search_end > 0:
                nl = buf.rfind(b"\n", 0, search_end)
                if nl < 0:
                    break
                quotes_after = buf.count(b'"', nl + 1)
                if (total_quotes - quotes_after) % 2 == 0:
                    cut = nl
                    break
                search_end = nl
            if cut < 0:
                carry = buf  # no safe boundary yet: grow the carry
                continue
            yield buf[: cut + 1]
            carry = buf[cut + 1 :]


def _decode_text_column(
    buf: bytes, begin: np.ndarray, end: np.ndarray
) -> np.ndarray:
    """Cell (begin, end) offsets -> object array of optional strings.
    Doubled quotes inside quoted cells are unescaped lazily (only when a
    quote byte is present in the slice)."""
    out = np.empty(len(begin), dtype=object)
    for i in range(len(begin)):
        b, e = begin[i], end[i]
        if e <= b:
            out[i] = None
            continue
        s = buf[b:e].decode("utf-8", errors="replace")
        if '"' in s:
            s = s.replace('""', '"')
        out[i] = s if s else None
    return out


def _parse_header(path: str) -> list[str]:
    with open(path, "rb") as f:
        line = f.readline()
    if line.startswith(b"\xef\xbb\xbf"):
        # Excel-style UTF-8 BOM must not leak into the first column name
        line = line[3:]
    if not line.strip():
        return []
    ncols = line.count(b",") + 1
    res = native.csv_scan(line, ncols, np.full(ncols, 2, np.uint8))
    if res is None:  # pure-python fallback
        import csv as _csv
        import io

        return next(_csv.reader(io.StringIO(line.decode("utf-8"))))
    nrows, _, _, cb, ce = res
    if nrows == 0:
        return []
    return [line[cb[c][0]:ce[c][0]].decode("utf-8").replace('""', '"')
            for c in range(cb.shape[0])]


def fast_path_available() -> bool:
    return native.csv_scan(b"x\n", 1, np.zeros(1, np.uint8)) is not None


def _retry_masked_unicode_cells(
    chunk: bytes, cb: np.ndarray, ce: np.ndarray,
    vals: np.ndarray, mask: np.ndarray,
) -> None:
    """Masked numeric cells re-tried through python float(): the C++
    parser rejects any non-ASCII byte, but float() accepts unicode
    decimal digits ('١٢٣' -> 123.0) and the python reader path uses
    float() - both native ingest routes must agree with it on every
    cell.  Mutates vals/mask in place; ASCII junk stays masked.  Callers
    gate on chunk.isascii() so pure-ASCII chunks never reach here."""
    from ..schema.quarantine import coerce_numeric

    for r in np.nonzero(~mask)[0]:
        cell = chunk[cb[r]:ce[r]]
        if not cell or cell.isascii():
            continue
        v = coerce_numeric(cell)
        if v is None:
            continue
        vals[r] = v
        mask[r] = True


class CsvChunk:
    """One decoded, keep-filtered chunk of a native CSV scan: the unit
    the sharded input pipeline (readers/pipeline.py) moves through its
    bounded queues.  ``numeric`` maps column name -> (values f64 [n],
    present-mask bool [n]); ``text`` maps name -> object array of
    optional strings.  ``row_offset`` is the chunk's first data-row
    index within its source file (header excluded)."""

    __slots__ = ("n_rows", "numeric", "text", "row_offset")

    def __init__(self, n_rows: int,
                 numeric: dict[str, tuple[np.ndarray, np.ndarray]],
                 text: dict[str, np.ndarray], row_offset: int) -> None:
        self.n_rows = n_rows
        self.numeric = numeric
        self.text = text
        self.row_offset = row_offset


def read_csv_columnar(
    path: str,
    schema: Mapping[str, Type[FeatureType]],
    headers: Optional[Sequence[str]] = None,
    has_header: bool = True,
    chunk_bytes: int = DEFAULT_CHUNK_BYTES,
    wanted: Optional[Sequence[str]] = None,
    errors: str = "coerce",
    quarantine=None,
    telemetry=None,
) -> dict[str, Column]:
    """One ``ingest.read`` trace span per native scan (obs/), wrapping
    the chunk iterator + columnar assembly."""
    with _obs_trace.span(
        "ingest.read", source=path, format="csv_native", errors=errors,
    ):
        names = [n for n in (wanted or list(schema)) if n in schema]
        chunks = iter_csv_chunks(
            path, schema, headers=headers, has_header=has_header,
            chunk_bytes=chunk_bytes, wanted=wanted, errors=errors,
            quarantine=quarantine, telemetry=telemetry,
        )
        return assemble_columns(names, schema, chunks)


def _concat_parts(parts: list, empty) -> np.ndarray:
    """Join chunk parts without the redundant single-part copy: chunk
    arrays are freshly allocated per scan (never reused buffers), so a
    lone part IS the column."""
    if not parts:
        return empty
    if len(parts) == 1:
        return parts[0]
    return np.concatenate(parts)


def assemble_columns(
    names: Sequence[str],
    schema: Mapping[str, Type[FeatureType]],
    chunks,
) -> dict[str, Column]:
    """Drain a :class:`CsvChunk` iterator into Dataset columns.  Shared
    by the serial fast path and the pipelined reader - one assembly
    implementation means serial and pipelined ingest cannot disagree
    about column semantics (NaN-as-missing, masked slots hold 0.0)."""
    num_parts: dict[str, list] = {}
    mask_parts: dict[str, list] = {}
    text_parts: dict[str, list] = {}
    for chunk in chunks:
        for n, (vals_c, mask_c) in chunk.numeric.items():
            num_parts.setdefault(n, []).append(vals_c)
            mask_parts.setdefault(n, []).append(mask_c)
        for n, txt in chunk.text.items():
            text_parts.setdefault(n, []).append(txt)
    out: dict[str, Column] = {}
    for n in names:
        t = schema[n]
        if issubclass(t, OPNumeric):
            vals = _concat_parts(num_parts.get(n, []), np.zeros(0))
            mask = _concat_parts(mask_parts.get(n, []),
                                 np.zeros(0, bool))
            # literal "nan" cells parse as NaN; the python path treats NaN
            # as missing (NumericColumn contract: masked slots hold 0.0)
            nan = np.isnan(vals)
            out[n] = NumericColumn(np.where(nan, 0.0, vals), mask & ~nan, t)
        elif issubclass(t, Text):
            vals = _concat_parts(text_parts.get(n, []),
                                 np.empty(0, object))
            out[n] = TextColumn(vals, t)
        else:
            raise TypeError(
                f"fast CSV path supports numeric/text columns; {n} is "
                f"{t.__name__}"
            )
    return out


def iter_csv_chunks(
    path: str,
    schema: Mapping[str, Type[FeatureType]],
    headers: Optional[Sequence[str]] = None,
    has_header: bool = True,
    chunk_bytes: int = DEFAULT_CHUNK_BYTES,
    wanted: Optional[Sequence[str]] = None,
    errors: str = "coerce",
    quarantine=None,
    telemetry=None,
):
    """Stream a CSV as decoded :class:`CsvChunk`s via the native scanner.

    THE chunk producer behind ``read_csv_columnar``, ``DeviceCSVIngest``,
    and the sharded input pipeline's CSV workers - one scan loop, one
    junk rule, one quarantine implementation for every consumer.

    ``schema`` types every column to materialize; ``wanted`` restricts
    which columns are materialized (all schema'd columns by default).
    Raises RuntimeError when the native path is unavailable - callers
    (CSVReader) fall back to the python reader.

    ``errors`` (schema/quarantine.py): ``"coerce"`` keeps junk numeric
    cells as missing values (legacy); ``"strict"`` raises
    MalformedRowError at the first non-empty numeric cell that fails to
    parse; ``"quarantine"`` drops such rows across ALL materialized
    columns, recording (row index, cell excerpt, reason).  The scanner
    has no per-row field counts, so ragged/truncated-row detection is
    the python reader's job (CSVReader routes checked modes there);
    this path owns type-flip detection at native speed.

    Copy discipline: chunk arrays are views into the freshly allocated
    per-scan buffers - the old per-column ``.copy()`` in the consumer
    loop is hoisted out entirely (assembly's final concatenate is the
    one copy), which closes most of the parse-vs-ingest throughput gap.
    """
    from ..schema.quarantine import (
        MalformedRowError,
        QuarantineBuffer,
        check_errors_mode,
        data_telemetry,
        excerpt_of,
    )
    from ..faults import injection as _faults

    check_errors_mode(errors)
    checked = errors != "coerce"
    if checked and quarantine is None:
        quarantine = QuarantineBuffer(source=path)
    if not fast_path_available():
        raise RuntimeError("native CSV kernels unavailable")
    header = list(headers) if headers else (
        _parse_header(path) if has_header else None
    )
    first = True
    col_idx: dict[str, int] = {}
    modes: Optional[np.ndarray] = None
    names: list[str] = []
    rows_seen = 0
    rows_kept = 0
    for chunk in _aligned_chunks(path, chunk_bytes):
        if first and chunk.startswith(b"\xef\xbb\xbf"):
            # strip the BOM on the data path too: headerless files never
            # call _parse_header, and the scanner would otherwise read
            # '﻿1' in the first cell (python fallback uses utf-8-sig)
            chunk = chunk[3:]
        if first and has_header:
            nl = chunk.find(b"\n")
            # nl == -1: header-only file with no trailing newline
            chunk = chunk[nl + 1 :] if nl >= 0 else b""
        if first:
            if header is None:
                ncols = chunk.split(b"\n", 1)[0].count(b",") + 1
                header = [f"c{i}" for i in range(ncols)]
            names = [n for n in (wanted or list(schema)) if n in schema]
            missing = [n for n in names if n not in header]
            if missing:
                raise KeyError(f"columns {missing} not in CSV {path}")
            col_idx = {n: header.index(n) for n in names}
            # per-column scan mode: 0 skip / 1 numeric / 2 text offsets -
            # unmaterialized columns cost only the delimiter walk
            modes = np.zeros(len(header), dtype=np.uint8)
            for n in names:
                modes[col_idx[n]] = (
                    1 if issubclass(schema[n], OPNumeric) else 2
                )
            first = False
        if not chunk:
            continue
        res = native.csv_scan(chunk, len(header), modes)
        if res is None:
            raise RuntimeError("native CSV kernels unavailable")
        nrows, num_vals, num_mask, cb, ce = res
        if nrows == 0:
            continue
        # pure-ASCII chunks (the hot path) skip the unicode retry check
        # entirely; isascii() short-circuits at the first high byte
        retry = not chunk.isascii()
        # copy discipline: when the numeric columns dominate the scan
        # matrix, the chunk columns stay views (the matrix IS the data;
        # the one copy is assembly's concatenate).  When they are a
        # minority — a wanted subset, or a text-heavy schema — copy the
        # wanted slices instead: a view would pin the full
        # [ncols, nrows] scan buffers until assembly drains the file
        n_numeric = sum(1 for n in names if modes[col_idx[n]] == 1)
        subset = (len(names) < len(header)
                  or n_numeric * 2 < len(header))
        chunk_num: dict[str, tuple[np.ndarray, np.ndarray]] = {}
        chunk_text: dict[str, np.ndarray] = {}
        for n in names:
            c = col_idx[n]
            if modes[c] == 1:
                vals_c = num_vals[c].copy() if subset else num_vals[c]
                mask_c = num_mask[c].copy() if subset else num_mask[c]
                if retry:
                    # in-place mutation is safe either way: the scan
                    # buffers are fresh per call, never reused
                    _retry_masked_unicode_cells(
                        chunk, cb[c], ce[c], vals_c, mask_c
                    )
                chunk_num[n] = (vals_c, mask_c)
            else:
                chunk_text[n] = _decode_text_column(chunk, cb[c], ce[c])
        keep = None
        if checked:
            # a masked-but-NON-EMPTY cell is junk the parser refused: a
            # type flip.  Empty cells (ce <= cb) and literal-nan cells
            # (parsed, mask flows from the assembly NaN handling) are
            # legitimate missing values in every mode.
            bad = np.zeros(nrows, dtype=bool)
            bad_detail: dict[int, tuple[str, str, str]] = {}
            for n, (vals_c, mask_c) in chunk_num.items():
                c = col_idx[n]
                junk = ~mask_c & (ce[c] > cb[c])
                for r in np.nonzero(junk)[0]:
                    bad_detail.setdefault(int(r), (
                        "type_flip", n,
                        excerpt_of(chunk[cb[c][r]:ce[c][r]]),
                    ))
                bad |= junk
            # drill points: corrupt the chunk's first row so the drills
            # flow through the same quarantine/strict machinery
            if _faults.fires("reader.type_flip") is not None and nrows:
                bad_detail.setdefault(
                    0, ("type_flip", names[0], "<injected>"))
                bad[0] = True
            if _faults.fires("reader.malformed_row") is not None and nrows:
                bad_detail.setdefault(
                    0, ("malformed_row", None, "<injected>"))
                bad[0] = True
            if bad.any():
                if errors == "strict":
                    (telemetry or data_telemetry()).record_strict_error(
                        path
                    )
                    r0 = int(np.nonzero(bad)[0][0])
                    reason, col, cell = bad_detail[r0]
                    raise MalformedRowError(
                        path, rows_seen + r0, reason, col, cell
                    )
                for r in sorted(bad_detail):
                    reason, col, cell = bad_detail[r]
                    quarantine.add(rows_seen + r, reason, col, cell)
                keep = ~bad
        row_offset = rows_seen
        rows_seen += nrows
        out_rows = nrows
        if keep is not None:
            out_rows = int(keep.sum())
            chunk_num = {
                n: (v[keep], m[keep]) for n, (v, m) in chunk_num.items()
            }
            chunk_text = {n: t[keep] for n, t in chunk_text.items()}
        rows_kept += out_rows
        yield CsvChunk(out_rows, chunk_num, chunk_text, row_offset)
    if checked:
        (telemetry or data_telemetry()).record_read(
            path, rows_seen, rows_kept, quarantine
        )
    if first:
        # zero-byte file: the chunk loop never ran - surface the same
        # missing-column error the python path gives
        names = [n for n in (wanted or list(schema)) if n in schema]
        missing = [n for n in names if n not in (header or [])]
        if missing:
            raise KeyError(f"columns {missing} not in CSV {path}")


def chunk_to_block(
    chunk: CsvChunk, columns: Sequence[str]
) -> tuple[np.ndarray, np.ndarray]:
    """:class:`CsvChunk` -> ([rows, d] float32 design block, [rows, d]
    bool present-mask).  One strided cast per column straight into the
    final layout - the old double copy (fancy-index [d, rows] f64
    intermediate + ``ascontiguousarray`` transpose) is hoisted out of
    the consumer loop.  Missing slots are 0 with mask False and
    literal-NaN cells count as missing (the NumericColumn contract,
    device-side).  Shared by :class:`DeviceCSVIngest` and the sharded
    input pipeline's design-matrix consumers."""
    d = len(columns)
    block = np.empty((chunk.n_rows, d), dtype=np.float32)
    mask = np.empty((chunk.n_rows, d), dtype=bool)
    for j, name in enumerate(columns):
        vals, m = chunk.numeric[name]
        block[:, j] = vals
        mask[:, j] = m
    nan = np.isnan(block)  # literal "nan" cells -> missing
    if nan.any():
        block = np.where(nan, np.float32(0.0), block)
        mask = mask & ~nan
    return block, mask


def _drain(q: queue.Queue, producer: threading.Thread) -> None:
    """Let a producer that the consumer stopped listening to run to its
    end: take what it puts until it exits, then join it."""
    while producer.is_alive():
        try:
            q.get(timeout=0.05)
        except queue.Empty:
            pass
    producer.join()


def double_buffered_to_device(producer, n_cols: int,
                              device="cuda") -> tuple:
    """Shared double-buffered host->device pump: ``producer(queue)`` runs in
    a background thread pushing (values_block [rows, d] float32, mask_block
    [rows, d] bool) tuples, then None; an exception it puts is re-raised
    here.  On the card each block and mask is copied into pinned host
    memory and sent with ``non_blocking`` copies on a side stream, one
    event recorded per block, so the parse of the next block overlaps the
    copy in flight; the current stream waits on the side stream before
    the blocks are concatenated on the card.  A block's pinned buffers are
    held until its event has completed.  With ``device="cpu"`` the blocks
    concatenate on the host.  Returns (X [n, n_cols] float32, mask [n,
    n_cols] bool, rows) on ``device``; empty input yields zero-row tensors
    of the right width.  The default device is the card: without CUDA it
    raises before the producer starts."""
    dev = resolve_device(device)
    on_card = dev.type == "cuda"
    side = torch.cuda.Stream(device=dev) if on_card else None
    q: queue.Queue = queue.Queue(maxsize=2)
    t = threading.Thread(target=producer, args=(q,), daemon=True)
    t.start()
    blocks, masks, total = [], [], 0
    in_flight: collections.deque = collections.deque()  # (event, pinned)
    finished = False
    try:
        while True:
            item = q.get()
            if item is None:
                finished = True
                break
            if isinstance(item, BaseException):
                finished = True
                raise item
            block, mask = item
            total += block.shape[0]
            hb, hm = torch.from_numpy(block), torch.from_numpy(mask)
            if not on_card:
                blocks.append(hb)
                masks.append(hm)
                continue
            hb, hm = hb.pin_memory(), hm.pin_memory()
            with torch.cuda.stream(side):
                blocks.append(hb.to(dev, non_blocking=True))
                masks.append(hm.to(dev, non_blocking=True))
                done = torch.cuda.Event()
                done.record(side)
            in_flight.append((done, (hb, hm)))
            while in_flight and in_flight[0][0].query():
                in_flight.popleft()
    finally:
        if finished:
            t.join()
        else:
            _drain(q, t)
    if not blocks:
        return (torch.zeros((0, n_cols), dtype=torch.float32, device=dev),
                torch.zeros((0, n_cols), dtype=torch.bool, device=dev), 0)
    if not on_card:
        return torch.cat(blocks), torch.cat(masks), total
    main = torch.cuda.current_stream(dev)
    main.wait_stream(side)
    X, M = torch.cat(blocks), torch.cat(masks)
    for b in blocks + masks:
        # made on the side stream, read by the concatenation on this one
        b.record_stream(main)
    if in_flight:
        in_flight[-1][0].synchronize()  # the last pinned buffers' copies
    return X, M, total


class DeviceCSVIngest:
    """CSV -> device-resident [n, d] float32 design matrix with the parse
    of chunk i+1 overlapping the device transfer of chunk i.

    A background thread runs the C++ scanner over aligned byte chunks and
    feeds a bounded queue (depth 2 = classic double buffer); the consumer
    (:func:`double_buffered_to_device`) sends each block to ``device``
    while the next chunk parses, and concatenates there.  ``device``
    defaults to the card and raises without CUDA; ``"cpu"`` concatenates
    on the host.
    """

    def __init__(self, path: str, columns: Sequence[str],
                 schema: Mapping[str, Type[FeatureType]],
                 has_header: bool = True,
                 chunk_bytes: int = DEFAULT_CHUNK_BYTES,
                 errors: str = "coerce",
                 quarantine=None,
                 telemetry=None,
                 device: str = "cuda") -> None:
        from ..schema.quarantine import QuarantineBuffer, check_errors_mode

        self.device = resolve_device(device)
        self.path = path
        self.columns = list(columns)
        self.schema = dict(schema)
        self.has_header = has_header
        self.chunk_bytes = chunk_bytes
        self.errors = check_errors_mode(errors)
        if self.errors != "coerce" and quarantine is None:
            quarantine = QuarantineBuffer(source=path)
        self.quarantine = quarantine
        self.telemetry = telemetry

    def _parse_worker(self, q: queue.Queue) -> None:
        try:
            for chunk in iter_csv_chunks(
                self.path, self.schema, has_header=self.has_header,
                chunk_bytes=self.chunk_bytes, wanted=self.columns,
                errors=self.errors, quarantine=self.quarantine,
                telemetry=self.telemetry,
            ):
                q.put(chunk_to_block(chunk, self.columns))
            q.put(None)
        except BaseException as e:  # surface parse errors to the consumer
            q.put(e)

    def to_device(self):
        """Returns (X [n, d] float32, valid_mask [n, d] bool, rows) on the
        ingest's device.  Missing numeric cells are 0 with mask False (the
        NumericColumn contract, device-side)."""
        with _obs_trace.span(
            "ingest.device", source=self.path, format="csv_native",
        ):
            return double_buffered_to_device(
                self._parse_worker, len(self.columns), self.device
            )
