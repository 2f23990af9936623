"""Async sharded input pipeline: shard -> interleave -> map -> prefetch.

Host copy of ``transmogrifai_tpu/readers/pipeline.py``, the tf.data
design (PAPERS.md: arXiv 2101.12127) applied to this engine's readers:
ingest done phase-serially - parse, then transform, then fit, each
waiting on the last - leaves the fit idle through the whole parse.  This
module is the pipelined counterpart (reference: the Spark-partition
parallel ingest the source system got from DataReaders.scala):

* :func:`shard` - declare the work-list: one :class:`ShardSpec` per
  file (CSV / Parquet / Avro by extension), shard ids in the given
  (deterministic) order.
* **parallel interleave** - N worker threads pull shards off a work
  queue and parse them concurrently.  The native CSV scanner
  (``utils/native.py``) releases the GIL for the scan and its per-call
  thread fan-out is capped while the pipeline runs, so W workers do not
  oversubscribe the host.
* **map** - decode + quarantine runs inside the worker (the per-chunk
  ``transform=`` hook), so per-chunk python work is interleaved too.
* **prefetch** - decoded chunks flow through ONE bounded queue
  (``buffer_chunks`` deep) with backpressure: a full buffer blocks
  producers (counted as producer stall), an empty one blocks the
  consumer (consumer stall).  Every blocking wait in this module is
  bounded (the tests/test_torch_style.py pipeline gate) so a crashed
  peer can never wedge ingest.
* **consumer** - downstream work (feature materialization, vectorizer
  fitting, CV fold construction) starts on the FIRST ready chunk
  instead of the last; ``ordered=True`` optionally reassembles source
  order on the fly via the (shard_id, chunk_id) pair every chunk
  carries.

Failure semantics: a worker exception is wrapped as
:class:`ShardIngestError` naming the shard id and file, forwarded
through the queue, and re-raised in the consumer; the pipeline then
stops all workers and drains the queue - no hang, no silent partial
dataset.  A device fault (``parallel.kernels.is_device_fault``: a
``KernelError`` or ``torch.AcceleratorError`` from a worker-side
``transform=``) is forwarded and re-raised as itself, never wrapped.
Per-shard :class:`~..schema.quarantine.QuarantineBuffer`\\ s merge into
exact global counts with stable global row indices, deterministic
regardless of shard completion order
(:meth:`InputPipeline.merged_quarantine`).

Parquet shards import ``pyarrow`` inside their chunk iterator only, so
the module imports on a host without it (CSV and Avro shards need
neither pyarrow nor pandas).

Observability (obs/): each shard parse is an ``ingest.shard`` span
parented to the ambient run trace (worker threads inherit the caller's
context), and the registry carries ``pipeline.buffer_depth`` /
``pipeline.producer_stall_ms`` / ``pipeline.consumer_stall_ms`` /
``pipeline.chunks`` series so the overlap is visible, not inferred.
"""
from __future__ import annotations

import contextvars
import csv as _csv
import heapq
import os
import queue
import threading
import time
import weakref
from typing import Any, Callable, Mapping, Optional, Sequence, Type

import numpy as np

from ..obs import trace as _obs_trace
from ..obs.metrics import metrics_registry
from ..parallel.kernels import is_device_fault
from ..schema.quarantine import (
    QuarantineBuffer,
    check_errors_mode,
    coerce_numeric,
    data_telemetry,
    excerpt_of,
    MalformedRowError,
)
from ..types.feature_types import FeatureType, OPNumeric
from .fast_csv import (
    CsvChunk,
    assemble_columns,
    chunk_to_block,
    fast_path_available,
    iter_csv_chunks,
)

DEFAULT_WORKERS = 4
DEFAULT_BUFFER_CHUNKS = 8
#: pipeline chunks are smaller than fast_csv's 64 MB serial default:
#: interleave needs several chunks in flight per shard for overlap
DEFAULT_CHUNK_BYTES = 16 << 20
DEFAULT_CHUNK_ROWS = 200_000  # record-oriented shards (avro)
#: bounded-wait quantum: every queue put/get blocks at most this long
#: before re-checking the stop flag (no unbounded blocking — gate-pinned)
POLL_S = 0.05
_JOIN_S = 30.0

_FMT_BY_EXT = {
    ".csv": "csv", ".parquet": "parquet", ".pq": "parquet",
    ".avro": "avro",
}


class ShardSpec:
    """One unit of the interleave work-list: a file plus its position
    in the deterministic source order."""

    __slots__ = ("shard_id", "path", "fmt")

    def __init__(self, shard_id: int, path: str,
                 fmt: Optional[str] = None) -> None:
        self.shard_id = int(shard_id)
        self.path = str(path)
        if fmt is None:
            fmt = _FMT_BY_EXT.get(os.path.splitext(path)[1].lower(), "csv")
        self.fmt = fmt

    def __repr__(self) -> str:
        return f"ShardSpec({self.shard_id}, {self.path!r}, {self.fmt!r})"


def shard(paths: Sequence[str], fmt: Optional[str] = None) -> list[ShardSpec]:
    """Build the shard list from file paths.  Order is the caller's
    order (shard ids are positional) — callers that need a canonical
    order sort first; the pipeline's global row indices and ordered
    reassembly both key off these ids."""
    return [ShardSpec(i, p, fmt) for i, p in enumerate(paths)]


class ShardDirectoryFollower:
    """Follow/tail mode for the sharded pipeline: watch a
    directory and hand out shard files that arrive AFTER start, as
    :class:`ShardSpec`\\ s whose ids keep growing monotonically across
    polls — so global row indices, quarantine attribution and ordered
    reassembly stay stable over the whole lifetime of a long-lived
    consumer (the continuous trainer), exactly as if the shards had all
    been declared up front via :func:`shard`.

    Pick-up contract: a file is eligible the first poll it exists with
    a recognized shard extension (``_FMT_BY_EXT``, or any extension
    when ``fmt=`` pins the format).  Producers must therefore publish
    shards ATOMICALLY — write to a temp name and ``os.replace`` into
    the watched directory — or set ``settle_s`` so a file is only taken
    once its mtime is at least that old.  Files arriving within one
    poll are ordered lexicographically by name; each file is consumed
    exactly once, keyed by name (a shard overwritten in place is NOT
    re-read — publish a new name instead)."""

    def __init__(self, directory: str, fmt: Optional[str] = None,
                 settle_s: float = 0.0) -> None:
        self.directory = str(directory)
        self.fmt = fmt
        self.settle_s = float(settle_s)
        self._seen: set = set()
        self._next_id = 0

    @property
    def shards_seen(self) -> int:
        """How many shards have been handed out so far."""
        return self._next_id

    def poll(self) -> list[ShardSpec]:
        """New shards since the last poll (possibly empty; never
        blocks).  A missing watch directory is 'nothing new yet', not
        an error — the producer may not have created it."""
        try:
            names = sorted(os.listdir(self.directory))
        except OSError:
            return []
        specs: list[ShardSpec] = []
        now = time.time()
        for name in names:
            if name in self._seen:
                continue
            if self.fmt is None:
                ext = os.path.splitext(name)[1].lower()
                if ext not in _FMT_BY_EXT:
                    continue
            path = os.path.join(self.directory, name)
            if not os.path.isfile(path):
                continue
            if self.settle_s > 0:
                try:
                    settling = (now - os.stat(path).st_mtime
                                < self.settle_s)
                except OSError:
                    settling = True  # vanished mid-poll: re-decide later
                if settling:
                    continue  # still settling: next poll's problem
            self._seen.add(name)
            specs.append(ShardSpec(self._next_id, path, self.fmt))
            self._next_id += 1
        return specs

    def pipeline(self, specs: Sequence[ShardSpec],
                 schema: Mapping[str, Type[FeatureType]],
                 **kw: Any) -> Optional["InputPipeline"]:
        """One single-use :class:`InputPipeline` over one poll's shards
        (None when the poll was empty) — the tail consumer's per-window
        ingest rides the exact same interleave/prefetch machinery as a
        batch read."""
        if not specs:
            return None
        return InputPipeline(list(specs), schema, **kw)


class ShardIngestError(RuntimeError):
    """A worker failed parsing one shard; names the shard and file so
    the operator knows exactly which input to look at."""

    def __init__(self, shard_id: int, path: str,
                 cause: BaseException) -> None:
        self.shard_id = shard_id
        self.path = path
        self.cause = cause
        super().__init__(
            f"shard {shard_id} ({path}): ingest failed: "
            f"{type(cause).__name__}: {cause}"
        )


class PipelineChunk:
    """Envelope the prefetch queue carries: the (shard_id, chunk_id)
    determinism seam plus the decoded payload (a fast_csv.CsvChunk, or
    whatever the worker-side ``transform=`` returned)."""

    __slots__ = ("shard_id", "chunk_id", "n_rows", "payload")

    def __init__(self, shard_id: int, chunk_id: int, n_rows: int,
                 payload: Any) -> None:
        self.shard_id = shard_id
        self.chunk_id = chunk_id
        self.n_rows = n_rows
        self.payload = payload

    @property
    def order_key(self) -> tuple[int, int]:
        return (self.shard_id, self.chunk_id)


class PipelineStats:
    """Where the wall time went: producer busy/stall, consumer stall,
    and the overlap fraction the pipeline's telemetry reports.
    ``overlap_fraction`` is the share of total producer busy time that
    ran while OTHER work (another producer or the consumer) was also
    running — 0 on a serial pipeline, approaching (W-1)/W on a
    perfectly interleaved one."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.wall_s = 0.0
        self.chunks = 0
        self.rows = 0
        self.producer_busy_s = 0.0
        self.producer_stall_s = 0.0
        self.consumer_stall_s = 0.0
        self.shards: dict[int, dict] = {}
        #: the knob settings this pipeline ran under (stamped by
        #: InputPipeline) so one snapshot carries signal + knobs for
        #: the autotune proposer (autotune/knobs.py)
        self.knobs: dict = {}

    def _add(self, **kw: float) -> None:
        with self._lock:
            for k, v in kw.items():
                setattr(self, k, getattr(self, k) + v)

    def record_stall(self, side: str, seconds: float) -> None:
        """One bounded-wait quantum spent blocked on the prefetch
        buffer (side = 'producer' on a full buffer, 'consumer' on an
        empty one) — the backpressure accounting the bench and the
        overlap telemetry read."""
        if side == "producer":
            self._add(producer_stall_s=seconds)
        else:
            self._add(consumer_stall_s=seconds)

    def _shard_done(self, shard_id: int, info: dict) -> None:
        with self._lock:
            self.shards[shard_id] = info

    @property
    def overlap_fraction(self) -> float:
        if self.wall_s <= 0 or self.producer_busy_s <= 0:
            return 0.0
        # busy time beyond one serial lane's worth of wall is provably
        # concurrent work
        return max(0.0, min(
            1.0, 1.0 - self.wall_s / self.producer_busy_s
        )) if self.producer_busy_s > self.wall_s else 0.0

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "wall_s": round(self.wall_s, 4),
                "chunks": self.chunks,
                "rows": self.rows,
                "producer_busy_s": round(self.producer_busy_s, 4),
                "producer_stall_s": round(self.producer_stall_s, 4),
                "consumer_stall_s": round(self.consumer_stall_s, 4),
                "overlap_fraction": round(self.overlap_fraction, 4),
                "knobs": dict(self.knobs),
                "shards": {k: dict(v) for k, v in self.shards.items()},
            }


# ---------------------------------------------------------------------------
# per-format shard chunk iterators (the map stage's decode half)
# ---------------------------------------------------------------------------
def _iter_csv_chunks_python(
    path: str,
    schema: Mapping[str, Type[FeatureType]],
    wanted: Sequence[str],
    chunk_rows: int,
    errors: str,
    quarantine: Optional[QuarantineBuffer],
    telemetry,
):
    """Pure-python CSV shard fallback (no native lib): same chunk
    contract and the same junk rule (schema.quarantine.coerce_numeric)
    as the native iterator, including ragged-row detection that the
    native scanner cannot do."""
    checked = errors != "coerce"
    if checked and quarantine is None:
        quarantine = QuarantineBuffer(source=path)
    with open(path, newline="", encoding="utf-8-sig") as f:
        reader = _csv.reader(f)
        header = next(reader, None)
        if header is None:
            return
        missing = [n for n in wanted if n not in header]
        if missing:
            raise KeyError(f"columns {missing} not in CSV {path}")
        col_idx = {n: header.index(n) for n in wanted}
        numeric = [n for n in wanted if issubclass(schema[n], OPNumeric)]
        ncols = len(header)
        rows_seen = rows_kept = 0
        buf_rows: list[list] = []
        chunk_start = 0

        def flush():
            num: dict[str, tuple[np.ndarray, np.ndarray]] = {}
            text: dict[str, np.ndarray] = {}
            for n in wanted:
                c = col_idx[n]
                cells = [r[c] if c < len(r) else "" for r in buf_rows]
                if n in numeric:
                    vals = np.empty(len(cells))
                    mask = np.zeros(len(cells), bool)
                    for i, cell in enumerate(cells):
                        v = coerce_numeric(cell) if cell else None
                        if v is None or v != v:
                            vals[i] = 0.0
                        else:
                            vals[i] = v
                            mask[i] = True
                    num[n] = (vals, mask)
                else:
                    out = np.empty(len(cells), dtype=object)
                    for i, cell in enumerate(cells):
                        out[i] = cell if cell else None
                    text[n] = out
            return CsvChunk(len(buf_rows), num, text, chunk_start)

        from ..faults import injection as _faults

        for i, r in enumerate(reader):
            bad_reason = bad_col = bad_cell = None
            if checked:
                # same drill points as the native and per-file readers:
                # a host without the native lib must still exercise the
                # real detection machinery under fault injection
                if _faults.fires("reader.malformed_row") is not None:
                    r = r[: max(len(r) - 1, 0)]
                if numeric and _faults.fires(
                        "reader.type_flip") is not None:
                    r = list(r)
                    c0 = col_idx[numeric[0]]
                    if c0 < len(r):
                        r[c0] = "\x00<injected-junk>"
                if len(r) != ncols:
                    bad_reason = ("truncated_row" if len(r) < ncols
                                  else "extra_fields")
                    bad_cell = ",".join(r)
                else:
                    for n in numeric:
                        cell = r[col_idx[n]]
                        if cell and coerce_numeric(cell) is None:
                            bad_reason, bad_col, bad_cell = (
                                "type_flip", n, cell)
                            break
            rows_seen += 1
            if bad_reason is not None:
                if errors == "strict":
                    (telemetry or data_telemetry()).record_strict_error(
                        path)
                    raise MalformedRowError(
                        path, i, bad_reason, bad_col, excerpt_of(bad_cell))
                quarantine.add(i, bad_reason, bad_col,
                               excerpt_of(bad_cell))
                continue
            rows_kept += 1
            buf_rows.append(r)
            if len(buf_rows) >= chunk_rows:
                yield flush()
                buf_rows = []
                chunk_start = i + 1
        if buf_rows:
            yield flush()
    if checked:
        (telemetry or data_telemetry()).record_read(
            path, rows_seen, rows_kept, quarantine)


def _iter_parquet_chunks(
    path: str,
    schema: Mapping[str, Type[FeatureType]],
    wanted: Sequence[str],
    chunk_rows: int,
    errors: str,
    quarantine: Optional[QuarantineBuffer],
    telemetry,
):
    """Parquet shard -> CsvChunk stream via Arrow record batches,
    sharing the checked block converters with DeviceParquetIngest."""
    import pyarrow.parquet as pq

    from .arrow_ingest import (
        batch_to_numeric_block,
        checked_batch_to_numeric_block,
    )

    checked = errors != "coerce"
    if checked and quarantine is None:
        quarantine = QuarantineBuffer(source=path)
    num_names = [n for n in wanted if issubclass(schema[n], OPNumeric)]
    text_names = [n for n in wanted if n not in num_names]
    if checked and text_names:
        raise TypeError(
            "parquet checked modes with text columns are not supported "
            "on the pipelined path; use ParquetReader"
        )
    pf = pq.ParquetFile(path)
    rows_seen = rows_kept = 0
    for batch in pf.iter_batches(batch_size=chunk_rows,
                                 columns=list(wanted)):
        n = batch.num_rows
        if n == 0:
            continue
        row_offset = rows_seen
        if checked and num_names:
            vals, mask, n_bad = checked_batch_to_numeric_block(
                batch, num_names, errors, quarantine, rows_seen, path,
                telemetry=telemetry,
            )
        elif num_names:
            vals, mask = batch_to_numeric_block(batch, num_names)
            n_bad = 0
        else:
            vals = np.zeros((n, 0), np.float32)
            mask = np.zeros((n, 0), bool)
            n_bad = 0
        rows_seen += n
        rows_kept += n - n_bad
        num = {
            nm: (np.asarray(vals[:, j], dtype=np.float64), mask[:, j])
            for j, nm in enumerate(num_names)
        }
        text: dict[str, np.ndarray] = {}
        for nm in text_names:
            col = np.empty(n, dtype=object)
            for i, v in enumerate(batch.column(nm).to_pylist()):
                col[i] = None if v in (None, "") else str(v)
            text[nm] = col
        yield CsvChunk(n - n_bad, num, text, row_offset)
    if checked:
        (telemetry or data_telemetry()).record_read(
            path, rows_seen, rows_kept, quarantine)


def _iter_avro_chunks(
    path: str,
    schema: Mapping[str, Type[FeatureType]],
    wanted: Sequence[str],
    chunk_rows: int,
    errors: str,
    quarantine: Optional[QuarantineBuffer],
    telemetry,
):
    """Avro shard -> CsvChunk stream: OCF blocks decode incrementally
    through :class:`~.avro_reader.AvroBlockStream` (which owns
    corrupt-block quarantine and sync-marker resync), then buffer into
    columnar slices of ``chunk_rows`` — an avro shard now streams truly
    chunk-by-chunk like CSV and Parquet, never materializing the whole
    record list."""
    from ..faults import injection as _faults
    from .avro_reader import AvroBlockStream

    checked = errors != "coerce"
    if checked and quarantine is None:
        quarantine = QuarantineBuffer(source=path)
    num_names = [n for n in wanted if issubclass(schema[n], OPNumeric)]
    rows_kept = 0

    def _columnar(chunk: list, start: int) -> CsvChunk:
        nonlocal rows_kept
        keep = np.ones(len(chunk), bool)
        if checked:
            # same per-record junk rule as AvroReader._checked_records:
            # a non-None numeric value that refuses coerce_numeric is a
            # type flip (strict raises, quarantine drops the record) -
            # the pipelined route must count exactly like the serial one
            for i, r in enumerate(chunk):
                bad_reason = bad_col = bad_cell = None
                if not isinstance(r, Mapping):
                    bad_reason, bad_cell = "malformed_record", r
                else:
                    for n in num_names:
                        v = r.get(n)
                        if v is not None and coerce_numeric(v) is None:
                            bad_reason, bad_col, bad_cell = (
                                "type_flip", n, v)
                            break
                if bad_reason is None and _faults.fires(
                        "reader.type_flip") is not None:
                    bad_reason, bad_col, bad_cell = (
                        "type_flip", num_names[0] if num_names else None,
                        "<injected>")
                if bad_reason is None and _faults.fires(
                        "reader.malformed_row") is not None:
                    bad_reason, bad_cell = "malformed_record", "<injected>"
                if bad_reason is None:
                    continue
                if errors == "strict":
                    (telemetry or data_telemetry()).record_strict_error(
                        path)
                    raise MalformedRowError(
                        path, start + i, bad_reason, bad_col,
                        excerpt_of(bad_cell))
                quarantine.add(start + i, bad_reason, bad_col,
                               excerpt_of(bad_cell))
                keep[i] = False
            if not keep.all():
                chunk = [r for r, k in zip(chunk, keep) if k]
        rows_kept += len(chunk)
        num: dict[str, tuple[np.ndarray, np.ndarray]] = {}
        text: dict[str, np.ndarray] = {}
        for n in wanted:
            if n in num_names:
                vals = np.zeros(len(chunk))
                mask = np.zeros(len(chunk), bool)
                for i, r in enumerate(chunk):
                    v = r.get(n)
                    v = None if v is None else coerce_numeric(v)
                    if v is not None and v == v:
                        vals[i] = v
                        mask[i] = True
                num[n] = (vals, mask)
            else:
                out = np.empty(len(chunk), dtype=object)
                for i, r in enumerate(chunk):
                    v = r.get(n)
                    out[i] = None if v in (None, "") else str(v)
                text[n] = out
        return CsvChunk(len(chunk), num, text, start)

    stream = AvroBlockStream(path, errors=errors, quarantine=quarantine)
    try:
        # chunk boundaries, quarantine record indexes, and rows_seen
        # must match the old materialize-then-slice path exactly:
        # `start` counts positions in the cleanly decoded record stream
        # (damaged blocks contribute nothing - the stream rolls them
        # back), so every slice is bit-identical to records[start:
        # start+chunk_rows] of a full decode
        pending: list = []
        start = 0
        for block in stream.blocks():
            pending.extend(block)
            while len(pending) >= chunk_rows:
                chunk, pending = (pending[:chunk_rows],
                                  pending[chunk_rows:])
                yield _columnar(chunk, start)
                start += chunk_rows
        if pending:
            yield _columnar(pending, start)
    finally:
        stream.close()
    if checked:
        (telemetry or data_telemetry()).record_read(
            path, stream.records_decoded + stream.damaged, rows_kept,
            quarantine)


def iter_shard_chunks(
    spec: ShardSpec,
    schema: Mapping[str, Type[FeatureType]],
    wanted: Sequence[str],
    chunk_bytes: int = DEFAULT_CHUNK_BYTES,
    chunk_rows: int = DEFAULT_CHUNK_ROWS,
    errors: str = "coerce",
    quarantine: Optional[QuarantineBuffer] = None,
    telemetry=None,
    use_native: bool = True,
):
    """Format dispatch for one shard: CSV rides the native chunk scanner
    (python fallback when unavailable), Parquet rides Arrow record
    batches, Avro decodes records then slices columnar."""
    if spec.fmt == "csv":
        if use_native and fast_path_available():
            return iter_csv_chunks(
                spec.path, schema, chunk_bytes=chunk_bytes,
                wanted=wanted, errors=errors, quarantine=quarantine,
                telemetry=telemetry,
            )
        return _iter_csv_chunks_python(
            spec.path, schema, wanted, chunk_rows, errors, quarantine,
            telemetry,
        )
    if spec.fmt == "parquet":
        return _iter_parquet_chunks(
            spec.path, schema, wanted, chunk_rows, errors, quarantine,
            telemetry,
        )
    if spec.fmt == "avro":
        return _iter_avro_chunks(
            spec.path, schema, wanted, chunk_rows, errors, quarantine,
            telemetry,
        )
    raise ValueError(f"unknown shard format {spec.fmt!r} for {spec.path}")


# ---------------------------------------------------------------------------
# the pipeline
# ---------------------------------------------------------------------------
#: weakref to the most recently constructed InputPipeline: the shared
#: ``pipeline.buffer_depth`` pull gauge reads through it so the metric
#: follows the live pipeline without the registry retaining any queue
_depth_source: Optional["weakref.ref"] = None


def _current_buffer_depth() -> float:
    pipe = _depth_source() if _depth_source is not None else None
    return float(pipe._queue.qsize()) if pipe is not None else 0.0


#: refcounted native-scan fan-out cap: concurrent pipelines in one
#: process share it — the FIRST to start installs it, the LAST to finish
#: clears it.  The cap rides an ATOMIC inside the native lib
#: (utils.native.set_csv_threads), never an os.environ mutation: glibc
#: setenv/unsetenv while another thread's scan reads getenv is
#: use-after-free UB.  An operator-set TX_CSV_THREADS env var (static,
#: never mutated — safe to read) wins over the dynamic cap being absent.
_cap_lock = threading.Lock()
_cap_active = 0


def _acquire_thread_cap(workers: int) -> bool:
    """Cap the native scanner's per-call fan-out while multi-worker
    pipelines run; returns True when this caller must later release."""
    if workers <= 1 or os.environ.get("TX_CSV_THREADS"):
        return False  # single lane, or the operator pinned a static cap
    from ..utils import native

    global _cap_active
    with _cap_lock:
        if _cap_active == 0:
            if not native.set_csv_threads(
                    max(1, (os.cpu_count() or 8) // workers)):
                return False  # no native lib: nothing to cap
        _cap_active += 1
        return True


def _release_thread_cap() -> None:
    from ..utils import native

    global _cap_active
    with _cap_lock:
        _cap_active -= 1
        if _cap_active == 0:
            native.set_csv_threads(0)


class InputPipeline:
    """shard → interleave(workers) → map(decode/quarantine/transform) →
    prefetch(bounded buffer) → consumer.

    ``transform=`` runs inside the worker on each decoded CsvChunk (the
    map stage's caller half — e.g. ``chunk_to_block`` for design-matrix
    consumers) so its cost interleaves too.  ``ordered=True`` makes
    :meth:`chunks` yield in exact (shard_id, chunk_id) source order —
    parsing stays parallel; only the hand-off reorders.  The reorder
    heap must keep draining the prefetch queue while it waits for the
    next-due chunk (stopping would deadlock against the shard still
    producing it), so under pathological shard-size skew it can grow
    toward the later shards' decoded size; consumers that only need
    DETERMINISM, not streaming order, should prefer the
    sort-at-assembly helpers (``pipelined_columns`` /
    ``pipelined_design_matrix``), which hold the same data without the
    heap bookkeeping.
    """

    def __init__(
        self,
        shards: Sequence[ShardSpec],
        schema: Mapping[str, Type[FeatureType]],
        wanted: Optional[Sequence[str]] = None,
        workers: int = DEFAULT_WORKERS,
        buffer_chunks: int = DEFAULT_BUFFER_CHUNKS,
        chunk_bytes: int = DEFAULT_CHUNK_BYTES,
        chunk_rows: int = DEFAULT_CHUNK_ROWS,
        errors: str = "coerce",
        ordered: bool = False,
        transform: Optional[Callable[[CsvChunk], Any]] = None,
        telemetry=None,
        use_native: bool = True,
        quarantine_max_rows: Optional[int] = None,
    ) -> None:
        if not shards:
            raise ValueError("input pipeline needs at least one shard")
        if workers < 1:
            raise ValueError("workers must be >= 1")
        if buffer_chunks < 1:
            raise ValueError("buffer_chunks must be >= 1")
        self.shards = list(shards)
        self.schema = dict(schema)
        self.wanted = [n for n in (wanted or list(schema)) if n in schema]
        self.workers = int(min(workers, len(self.shards)))
        self.buffer_chunks = int(buffer_chunks)
        self.chunk_bytes = int(chunk_bytes)
        self.chunk_rows = int(chunk_rows)
        self.errors = check_errors_mode(errors)
        self.ordered = bool(ordered)
        self.transform = transform
        self.telemetry = telemetry
        self.use_native = use_native
        self.quarantine_max_rows = quarantine_max_rows
        self.stats = PipelineStats()
        self.stats.knobs = {
            "workers": self.workers,
            "buffer_chunks": self.buffer_chunks,
        }
        self.shard_quarantines: dict[int, QuarantineBuffer] = {}
        self._shard_rows_seen: dict[int, int] = {}
        self._stop = threading.Event()
        # raised by the FIRST failing worker (after its error item is
        # queued): peers stop pulling shards and abandon their current
        # one at the next chunk boundary instead of parsing work the
        # consumer is about to throw away
        self._failed = threading.Event()
        self._queue: queue.Queue = queue.Queue(maxsize=self.buffer_chunks)
        self._threads: list[threading.Thread] = []
        self._consumed = False
        reg = metrics_registry()
        # the depth gauge tracks the MOST RECENT live pipeline through a
        # module-level weakref: get-or-create would otherwise freeze the
        # pull fn on the first pipeline's (long-drained) queue and pin
        # that queue alive in the registry forever
        global _depth_source
        _depth_source = weakref.ref(self)
        self._m_depth = reg.gauge(
            "pipeline.buffer_depth",
            help="prefetch queue depth (chunks) of the most recent "
                 "pipeline", fn=_current_buffer_depth,
        )
        self._m_prod_stall = reg.counter(
            "pipeline.producer_stall_ms",
            help="time producers blocked on a full prefetch buffer",
        )
        self._m_cons_stall = reg.counter(
            "pipeline.consumer_stall_ms",
            help="time the consumer blocked on an empty prefetch buffer",
        )
        self._m_chunks = reg.counter(
            "pipeline.chunks", help="chunks delivered to the consumer",
        )
        # knob visibility: the live worker/buffer settings
        # next to the stall counters they explain, so the autotune
        # pipeline proposer (autotune/knobs.propose_pipeline_knobs) and
        # a Prometheus scrape both see knob + signal in one place
        reg.gauge(
            "pipeline.workers",
            help="parser worker threads of the most recent pipeline",
        ).set(float(self.workers))
        reg.gauge(
            "pipeline.buffer_chunks",
            help="prefetch buffer capacity (chunks) of the most recent "
                 "pipeline",
        ).set(float(self.buffer_chunks))

    # -- producer side -------------------------------------------------------
    def _put(self, item) -> bool:
        """Bounded-wait put with backpressure accounting (one POLL_S
        quantum per blocked wait); returns False when the pipeline was
        stopped before the item fit."""
        while not self._stop.is_set():
            try:
                self._queue.put(item, timeout=POLL_S)
                return True
            except queue.Full:
                # backpressure: the full buffer is ACCOUNTED, not
                # swallowed - stall time drives the overlap telemetry
                self.stats.record_stall("producer", POLL_S)
                self._m_prod_stall.inc(POLL_S * 1e3)
        return False

    def _worker(self, work: "queue.Queue[ShardSpec]") -> None:
        try:
            while not (self._stop.is_set() or self._failed.is_set()):
                try:
                    spec = work.get(timeout=0.0)
                except queue.Empty:
                    break
                self._run_shard(spec)
        finally:
            with self.stats._lock:
                self._live -= 1
                last = self._live == 0
            if last:
                self._put(("done", None))

    def _run_shard(self, spec: ShardSpec) -> None:
        if self.quarantine_max_rows is not None:
            buf = QuarantineBuffer(max_rows=self.quarantine_max_rows,
                                   source=spec.path)
        else:
            buf = QuarantineBuffer(source=spec.path)
        self.shard_quarantines[spec.shard_id] = buf
        t0 = time.perf_counter()
        chunk_id = 0
        rows = 0
        try:
            with _obs_trace.span(
                "ingest.shard", shard=spec.shard_id, source=spec.path,
                format=spec.fmt, errors=self.errors,
            ) as sp:
                for chunk in iter_shard_chunks(
                    spec, self.schema, self.wanted,
                    chunk_bytes=self.chunk_bytes,
                    chunk_rows=self.chunk_rows, errors=self.errors,
                    quarantine=buf, telemetry=self.telemetry,
                    use_native=self.use_native,
                ):
                    payload = (self.transform(chunk) if self.transform
                               else chunk)
                    rows += chunk.n_rows
                    # busy windows CLOSE before the put and REOPEN after
                    # it returns: time blocked on a full buffer is stall,
                    # never busy - double-counting it would let
                    # overlap_fraction read high on a pipeline with zero
                    # real overlap
                    self.stats._add(
                        producer_busy_s=time.perf_counter() - t0)
                    ok = self._put(("chunk", PipelineChunk(
                        spec.shard_id, chunk_id, chunk.n_rows, payload,
                    )))
                    t0 = time.perf_counter()
                    if not ok or self._failed.is_set():
                        return
                    chunk_id += 1
                    # progress is recorded INCREMENTALLY so a shard that
                    # never completes (peer failure, abandoned consumer)
                    # still contributes its produced rows to the merged
                    # quarantine's global row offsets
                    self._shard_rows_seen[spec.shard_id] = (
                        rows + buf.total)
                sp.set_attr("rows", rows)
                sp.set_attr("chunks", chunk_id)
                sp.set_attr("quarantined", buf.total)
        except BaseException as e:  # forwarded: consumer re-raises
            self.stats._add(producer_busy_s=time.perf_counter() - t0)
            # a device fault reaches the consumer as itself, so every
            # caller's is_device_fault rule still sees it
            self._put(("error", e if is_device_fault(e)
                       else ShardIngestError(spec.shard_id, spec.path, e)))
            # flag AFTER the error item is queued (a pre-put flag would
            # stop our own bounded put): peers wind down without parsing
            # shards the consumer is about to discard
            self._failed.set()
            return
        self.stats._add(producer_busy_s=time.perf_counter() - t0)
        self._shard_rows_seen[spec.shard_id] = rows + buf.total
        self.stats._shard_done(spec.shard_id, {
            "path": spec.path, "chunks": chunk_id, "rows_kept": rows,
            "quarantined": buf.total,
        })
        self._put(("shard_done", (spec.shard_id, chunk_id)))

    # -- consumer side -------------------------------------------------------
    def chunks(self):
        """Yield :class:`PipelineChunk`\\ s as workers land them (or in
        exact source order with ``ordered=True``).  Re-raises
        :class:`ShardIngestError` on any worker failure after stopping
        the fleet; always leaves the pipeline drained and the workers
        joined, even when the consumer abandons iteration early."""
        if self._consumed:
            raise RuntimeError("InputPipeline.chunks() is single-use; "
                               "build a new pipeline per pass")
        self._consumed = True
        work: queue.Queue = queue.Queue()
        for spec in self.shards:
            work.put(spec, timeout=POLL_S)
        self._live = self.workers
        t_start = time.perf_counter()
        # cap the native scanner's internal fan-out while several shard
        # scans run concurrently (refcounted: safe under concurrent
        # pipelines, restored when the last one finishes)
        owns_cap = _acquire_thread_cap(self.workers)
        # worker threads inherit the caller's contextvars so their
        # ingest.shard spans parent into the ambient run trace
        for i in range(self.workers):
            ctx = contextvars.copy_context()
            t = threading.Thread(
                target=ctx.run, args=(self._worker, work),
                name=f"tx-ingest-{i}", daemon=True,
            )
            self._threads.append(t)
            t.start()
        pending: list[tuple[tuple[int, int], PipelineChunk]] = []
        done_shards: dict[int, int] = {}
        cursor = [0, 0]  # next (shard, chunk) due in source order

        def _ready():
            """Pop every heap chunk that is next in source order,
            advancing the cursor past shards whose chunk count is
            known-complete (including zero-chunk shards)."""
            while True:
                while (cursor[0] in done_shards
                       and cursor[1] >= done_shards[cursor[0]]):
                    cursor[0] += 1
                    cursor[1] = 0
                if pending and pending[0][0] == (cursor[0], cursor[1]):
                    _, nxt = heapq.heappop(pending)
                    cursor[1] += 1
                    yield nxt
                    continue
                return

        try:
            while True:
                while True:
                    try:
                        kind, item = self._queue.get(timeout=POLL_S)
                        break
                    except queue.Empty:
                        # an empty buffer is ACCOUNTED consumer stall
                        self.stats.record_stall("consumer", POLL_S)
                        self._m_cons_stall.inc(POLL_S * 1e3)
                if kind == "error":
                    raise item
                if kind == "done":
                    break
                if kind == "shard_done":
                    sid, n_chunks = item
                    done_shards[sid] = n_chunks
                    if self.ordered:
                        yield from _ready()
                    continue
                self.stats._add(chunks=1, rows=item.n_rows)
                self._m_chunks.inc()
                if not self.ordered:
                    yield item
                    continue
                heapq.heappush(pending, (item.order_key, item))
                yield from _ready()
            # drain any ordered tail (shard_done for earlier shards may
            # arrive after later shards' chunks)
            while pending:
                _, nxt = heapq.heappop(pending)
                yield nxt
        finally:
            self._stop.set()
            # drain-join-drain: a producer whose bounded put was already
            # in flight when stop was raised may still land one item, so
            # keep draining until every worker has exited (join bounded
            # by _JOIN_S total - the pipeline can never wedge teardown)
            deadline = time.perf_counter() + _JOIN_S
            while True:
                while True:
                    try:
                        self._queue.get(timeout=0.0)
                    except queue.Empty:
                        break
                alive = [t for t in self._threads if t.is_alive()]
                if not alive or time.perf_counter() > deadline:
                    break
                alive[0].join(timeout=POLL_S)
            if owns_cap:
                _release_thread_cap()
            self.stats._add(wall_s=time.perf_counter() - t_start)

    # -- quarantine merge ----------------------------------------------------
    def merged_quarantine(self) -> QuarantineBuffer:
        """One buffer with EXACT global counts and stable global row
        indices (shard-concatenation order), independent of shard
        completion order: shards merge sorted by shard_id, local row
        indices offset by the preceding shards' seen-row counts."""
        merged = QuarantineBuffer(
            max_rows=max((b.max_rows for b in
                          self.shard_quarantines.values()),
                         default=1024),
            source="+".join(s.path for s in self.shards),
        )
        offset = 0
        for spec in self.shards:
            buf = self.shard_quarantines.get(spec.shard_id)
            if buf is None:
                continue
            snap = buf.snapshot()
            for row in snap["rows"]:
                merged.add(offset + row["row_index"], row["reason"],
                           row["column"], row["excerpt"])
            # counts past the per-shard detail cap stay EXACT: roll the
            # undetailed remainder straight into total/by_reason
            extra = snap["total"] - len(snap["rows"])
            if extra:
                detailed: dict[str, int] = {}
                for row in snap["rows"]:
                    detailed[row["reason"]] = (
                        detailed.get(row["reason"], 0) + 1)
                with merged._lock:
                    merged.total += extra
                    for reason, cnt in snap["by_reason"].items():
                        undetailed = cnt - detailed.get(reason, 0)
                        if undetailed:
                            merged.by_reason[reason] = (
                                merged.by_reason.get(reason, 0)
                                + undetailed)
            offset += self._shard_rows_seen.get(
                spec.shard_id,
                snap["total"] + self.stats.shards.get(
                    spec.shard_id, {}).get("rows_kept", 0),
            )
        return merged


# ---------------------------------------------------------------------------
# consumers
# ---------------------------------------------------------------------------
def pipelined_columns(pipeline: InputPipeline) -> dict:
    """Drain a pipeline into Dataset columns with DETERMINISTIC row
    order (shard-concatenation order) without serializing the
    interleave: chunks are consumed as they land, buffered by their
    (shard_id, chunk_id) key, and concatenated in sorted order — the
    single final concat is the only ordered step."""
    parts: list[tuple[tuple[int, int], CsvChunk]] = []
    for pc in pipeline.chunks():
        parts.append((pc.order_key, pc.payload))
    parts.sort(key=lambda kv: kv[0])
    return assemble_columns(
        pipeline.wanted, pipeline.schema, (c for _, c in parts),
    )


def stack_chunk_columns(chunk: CsvChunk,
                        columns: Sequence[str]) -> np.ndarray:
    """[k, n] float64 matrix from a chunk's numeric columns: one
    contiguous copy per column (each column is already a contiguous
    slice of the scan buffer), NO [n, k] strided transpose fill — the
    cheap map-stage feed for streamed sufficient-statistics consumers
    (Gram/moment accumulators).  Masked slots hold 0 and literal-NaN
    cells are zeroed, the design-matrix missing-value contract."""
    A = np.vstack([chunk.numeric[c][0] for c in columns])
    if np.isnan(A).any():
        np.nan_to_num(A, copy=False)
    return A


def pipelined_design_matrix(
    pipeline: InputPipeline,
    columns: Sequence[str],
    on_block: Optional[Callable[[np.ndarray, np.ndarray], None]] = None,
) -> tuple[np.ndarray, np.ndarray, int]:
    """Drain a pipeline into ([n, d] float32, [n, d] bool present-mask,
    rows) in deterministic shard order.  The CsvChunk → block decode
    runs in the WORKERS when the pipeline was built with
    ``transform=chunk_to_block``-style hooks; otherwise it runs here.
    ``on_block`` observes each block as it lands (streamed consumers:
    CV fold construction, moment accumulators) before assembly."""
    blocks: list[tuple[tuple[int, int], np.ndarray, np.ndarray]] = []
    for pc in pipeline.chunks():
        payload = pc.payload
        if isinstance(payload, CsvChunk):
            block, mask = chunk_to_block(payload, columns)
        else:
            block, mask = payload
        if on_block is not None:
            on_block(block, mask)
        blocks.append((pc.order_key, block, mask))
    blocks.sort(key=lambda kv: kv[0])
    n = sum(b.shape[0] for _, b, _ in blocks)
    d = len(columns)
    X = np.empty((n, d), np.float32)
    M = np.empty((n, d), bool)
    at = 0
    for _, b, m in blocks:
        X[at:at + b.shape[0]] = b
        M[at:at + m.shape[0]] = m
        at += b.shape[0]
    return X, M, n


class PipelinedCSVReader:
    """Reader-protocol adapter over the sharded pipeline: drop-in where
    a CSVReader goes (``OpWorkflow.set_reader``), parsing all shards in
    parallel while the dataset materializes (reference: DataReader.
    generateDataFrame's partitioned read, rebuilt as thread interleave).

    Feature types are restricted to numeric/text like the native fast
    path.  Row order of the produced Dataset is the deterministic
    shard-concatenation order, identical to reading the shards
    sequentially — pinned by the serial-vs-pipelined parity tests.

    ``stream_dataset`` is the workflow streaming-ingest seam: yields
    (PipelineChunk, chunk Dataset) pairs as they land, so train() can
    overlap vectorizer stat accumulation with parsing.
    """

    def __init__(
        self,
        paths: Sequence[str],
        workers: int = DEFAULT_WORKERS,
        buffer_chunks: int = DEFAULT_BUFFER_CHUNKS,
        chunk_bytes: int = DEFAULT_CHUNK_BYTES,
        chunk_rows: int = DEFAULT_CHUNK_ROWS,
        errors: str = "coerce",
        telemetry=None,
        use_native: bool = True,
        fmt: Optional[str] = None,
    ) -> None:
        self.paths = list(paths)
        self.workers = workers
        self.buffer_chunks = buffer_chunks
        self.chunk_bytes = chunk_bytes
        self.chunk_rows = chunk_rows
        self.errors = check_errors_mode(errors)
        self.telemetry = telemetry
        self.use_native = use_native
        self.fmt = fmt
        self.last_pipeline: Optional[InputPipeline] = None

    def _pipeline(self, raw_features) -> InputPipeline:
        schema = {}
        for f in raw_features:
            if f.ftype.kind not in ("numeric", "text"):
                raise TypeError(
                    "PipelinedCSVReader supports numeric/text features; "
                    f"{f.name} is {f.ftype.__name__}"
                )
            schema[f.name] = f.ftype
        pipe = InputPipeline(
            shard(self.paths, fmt=self.fmt), schema,
            workers=self.workers, buffer_chunks=self.buffer_chunks,
            chunk_bytes=self.chunk_bytes, chunk_rows=self.chunk_rows,
            errors=self.errors, telemetry=self.telemetry,
            use_native=self.use_native,
        )
        self.last_pipeline = pipe
        return pipe

    def generate_dataset(self, raw_features, params=None):
        from ..types.dataset import Dataset

        with _obs_trace.span(
            "ingest.read", source=f"{len(self.paths)} shards",
            format="csv_pipeline", errors=self.errors,
        ) as sp:
            cols = pipelined_columns(self._pipeline(raw_features))
            ds = Dataset(cols)
            sp.set_attr("rows", len(ds))
            return ds

    def stream_dataset(self, raw_features, params=None):
        """Yield (PipelineChunk, Dataset-of-that-chunk) as chunks land
        (arrival order, NOT source order — the consumer reorders by
        ``chunk.order_key`` where determinism matters)."""
        from ..types.dataset import Dataset

        pipe = self._pipeline(raw_features)
        names = pipe.wanted
        schema = pipe.schema
        for pc in pipe.chunks():
            cols = assemble_columns(names, schema, [pc.payload])
            yield pc, Dataset(cols)

    def merged_quarantine(self) -> Optional[QuarantineBuffer]:
        if self.last_pipeline is None:
            return None
        return self.last_pipeline.merged_quarantine()
