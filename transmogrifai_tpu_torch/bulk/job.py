"""Exactly-once bulk scoring: pipelined reader -> fused programs ->
journaled output shards.

The "score a billion rows overnight" run type: stream
sharded input files through :class:`readers.pipeline.InputPipeline`
STRAIGHT into the fused scoring programs - the decoded columnar chunks
feed :meth:`score_env` directly, skipping per-record dict building,
admission control and the micro-batcher (serving machinery is pure
overhead under a throughput-bound load) - and write one exactly-ordered
output shard per input shard under the :class:`~.journal.BulkJournal`.
Each shard commits ``assigned -> scored -> committed`` durably, with the
output shard fsynced and checksummed BEFORE the ``scored`` record, so a
SIGKILL at any instant costs at most the shards in flight: resume rolls
committed/verified work forward and re-scores only what the checksums
reject.  Quarantined rows are double-entry accounted per shard
(``rows_in == rows_out + rows_quarantined`` exactly) and globally.

Fleet mode (``router=``) fans chunk batches across replicas over the
fleet's channels: the router's at-least-once failover plus the
``ReplicaHealth`` detector reassign work when a replica dies mid-shard
(``bulk.replica_die_midshard`` drill), while the journal's
commit-after-durable-write discipline keeps the OUTPUT exactly-once.
``router=`` accepts a :class:`~..fleet.FleetRouter`, a
:class:`~..fleet.FleetController`, or a zero-arg callable returning
either; the job RE-RESOLVES it at every shard boundary so an elastic
fleet growing or shrinking mid-job fans the next shard out
to the CURRENT membership, never a stale snapshot.  On a multi-model
fleet ``model_id=`` pins every batch to ONE hosted model:
the router dispatches only to replicas hosting it and raises
``UnhostedModelError`` loudly - at job start and again mid-job if
hosting vanishes - rather than silently scoring with whatever model a
replica has; the exactly-once ledger discipline is unchanged.

On a CUDA model each chunk runs through the torch-fused program
(``score_env_prediction`` of ``local/fused_torch.py``) on the card,
where a tree head launches the ``bin_matrix`` kernel; a ``device="cpu"``
model scores numpy-fused, or torch-fused on CPU tensors with
``fused_backend="torch"``.  There is no catch-all on the scoring path:
a device fault (a ``KernelError`` or a CUDA error) ends the job with the
shard it was scoring still ``assigned``, never quarantined as a bad row
and never retried as an ordinary error, and a later resume re-scores it.

Fault points: ``bulk.output_crash`` kills the job between the durable
output-shard write and its journal commit - the canonical "did the
work, lost the receipt" window a resume must re-score.
"""
from __future__ import annotations

import contextvars
import json
import os
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from functools import lru_cache
from typing import Any, Optional, Sequence

import numpy as np

from ..faults import injection as _faults
from ..obs import trace as _obs_trace
from ..obs.metrics import metrics_registry
from ..readers.pipeline import (
    DEFAULT_CHUNK_ROWS,
    DEFAULT_WORKERS,
    InputPipeline,
    ShardSpec,
    shard as plan_shards,
)
from ..stages.base import MASK_SUFFIX
from .journal import (
    STATE_ASSIGNED,
    STATE_COMMITTED,
    STATE_PENDING,
    STATE_SCORED,
    BulkJournal,
)

#: raw-feature kinds a pipelined CsvChunk can carry columnar
_CHUNK_KINDS = ("numeric", "text")


def _env_from_chunk(chunk, features) -> dict[str, Any]:
    """Build the fused decode env STRAIGHT from a decoded columnar
    chunk - the assemble_columns missing-value rule (present NaN is
    missing) so the direct feed is bit-identical to scoring the
    assembled Dataset's records through ``decode_env``."""
    env: dict[str, Any] = {}
    for f in features:
        if f.ftype.kind == "numeric":
            vals, mask = chunk.numeric[f.name]
            vals = np.asarray(vals, dtype=np.float64)
            mask = np.asarray(mask, dtype=bool)
            nan = np.isnan(vals)
            if nan.any():
                vals = np.where(nan, 0.0, vals)
                mask = mask & ~nan
            env[f.name] = vals
            env[f.name + MASK_SUFFIX] = mask
        else:
            env[f.name] = np.asarray(chunk.text[f.name], dtype=object)
    return env


def _records_from_chunk(chunk, features) -> list[dict[str, Any]]:
    """Chunk columns -> per-row record dicts (the fleet wire format and
    the interpreted-scorer fallback)."""
    cols = []
    for f in features:
        if f.ftype.kind == "numeric":
            vals, mask = chunk.numeric[f.name]
            vals = np.asarray(vals, dtype=np.float64)
            mask = np.asarray(mask, dtype=bool) & ~np.isnan(vals)
            cols.append((f.name, [
                float(v) if m else None
                for v, m in zip(vals.tolist(), mask.tolist())
            ]))
        else:
            cols.append((f.name, list(chunk.text[f.name])))
    names = [n for n, _ in cols]
    return [dict(zip(names, row)) for row in zip(*(c for _, c in cols))]


def _result_lines(rows: Sequence[Any]) -> list[bytes]:
    """Deterministic one-line-per-row JSON encoding of scored rows."""
    out = []
    for r in rows:
        if not isinstance(r, dict):
            r = {"error": getattr(r, "error", str(r))}
        out.append(json.dumps(r, sort_keys=True,
                              separators=(",", ":"),
                              default=str).encode("utf-8") + b"\n")
    return out


@lru_cache(maxsize=64)
def _prediction_fmt(name: str, keys: tuple) -> tuple:
    """(%-format template for ONE output line, sorted column order) of
    the single-Prediction result shape: the template emits the SAME
    bytes json.dumps(sort_keys, separators) produces for the assembled
    row dict (%r of a finite float IS its json spelling)."""
    order = tuple(sorted(range(len(keys)), key=lambda i: keys[i]))
    esc = lambda s: s.replace("%", "%%")  # noqa: E731
    fmt = (
        esc("{%s:{" % json.dumps(name))
        + "".join(
            esc(("" if i == 0 else ",") + json.dumps(keys[j]) + ":") + "%r"
            for i, j in enumerate(order))
        + "}}\n"
    )
    return fmt, order


def _result_lines_from_prediction(name: str, keys: Sequence[str],
                                  stacked, bad_rows: Sequence[int],
                                  ) -> list[bytes]:
    """Vectorized line encoding of the single-Prediction result shape:
    one %-format pass per row over the stacked [n, k] array.
    Non-finite rows - whose floats json spells NaN/Infinity, not
    nan/inf - are patched through json.dumps afterwards."""
    fmt, order = _prediction_fmt(name, tuple(keys))
    cols = [stacked[:, j].tolist() for j in order]
    out = [(fmt % row).encode("utf-8") for row in zip(*cols)]
    for i in bad_rows:
        row = {name: dict(zip(keys, stacked[i].tolist()))}
        out[i] = json.dumps(row, sort_keys=True, separators=(",", ":"),
                            default=str).encode("utf-8") + b"\n"
    return out


#: rows per %-format call in the blob encoder: big enough to amortise
#: the format-call overhead, small enough that the flattened value
#: tuple stays cache-friendly
_ENC_BATCH = 256


def _result_blob_from_prediction(name: str, keys: Sequence[str],
                                 stacked, bad_rows: Sequence[int],
                                 ) -> bytes:
    """The whole chunk's output bytes in ONE pass: `_ENC_BATCH` rows
    per %-format call over the row-major flattened value list, joined
    and utf-8-encoded once.  Chunks with non-finite rows (rare: the
    fallback spelling differs per row) take the per-row path."""
    if bad_rows:
        return b"".join(
            _result_lines_from_prediction(name, keys, stacked, bad_rows))
    fmt, order = _prediction_fmt(name, tuple(keys))
    k = len(order)
    n = stacked.shape[0]
    flat = stacked[:, order].ravel().tolist()
    pieces = []
    nb = (n // _ENC_BATCH) * _ENC_BATCH
    if nb:
        fmt_b = fmt * _ENC_BATCH
        step = _ENC_BATCH * k
        for i in range(0, nb * k, step):
            pieces.append(fmt_b % tuple(flat[i:i + step]))
    for i in range(nb * k, n * k, k):
        pieces.append(fmt % tuple(flat[i:i + k]))
    return "".join(pieces).encode("utf-8")


class _ShardWriter:
    """ONE background thread executing the job's journal transitions
    and durable output writes in EXACT submission order - a write-
    ahead queue.  Scoring never stalls on an fsync, while the on-disk
    journal/output sequence (and therefore the fault-point walk the
    kill drills pin) stays byte-for-byte the serial one.  Tasks run
    under a copy of the submitter's context so commit spans parent to
    the ambient ``bulk.run`` span.  Bulky (output-data) submissions
    are bounded to ``max_queued_writes`` in flight so a slow disk
    backpressures scoring instead of buffering every shard in RAM."""

    def __init__(self, max_queued_writes: int = 2) -> None:
        self._pool = ThreadPoolExecutor(max_workers=1,
                                        thread_name_prefix="bulk-writer")
        self._futures: list[Any] = []
        self._sem = threading.Semaphore(max_queued_writes)

    def submit(self, fn, *args) -> None:
        ctx = contextvars.copy_context()
        self._futures.append(self._pool.submit(ctx.run, fn, *args))

    def submit_bulky(self, fn, *args) -> None:
        self._sem.acquire()
        ctx = contextvars.copy_context()

        def run() -> None:
            try:
                ctx.run(fn, *args)
            finally:
                self._sem.release()

        self._futures.append(self._pool.submit(run))

    def check(self) -> None:
        """Re-raise the first failure of any finished task (so a dead
        disk aborts the run instead of scoring every remaining
        shard)."""
        for f in self._futures:
            if f.done():
                f.result()

    def close(self) -> None:
        """Drain the queue, then re-raise the first task failure."""
        self._pool.shutdown(wait=True)
        for f in self._futures:
            f.result()


class BulkScoringJob:
    """One checkpointed, kill-survivable batch-inference job.

    ``run()`` either plans a fresh job (journal created from
    ``inputs``) or resumes the journal already in ``job_dir``:
    committed shards whose output passes its checksum are skipped
    entirely, ``scored`` shards with a verified output roll forward to
    ``committed`` without re-scoring, and everything else (including a
    partially written or checksum-rejected output) is re-scored.
    """

    def __init__(
        self,
        model,
        job_dir: str,
        inputs: Optional[Sequence[str]] = None,
        *,
        fmt: Optional[str] = None,
        errors: str = "quarantine",
        chunk_rows: int = DEFAULT_CHUNK_ROWS,
        workers: int = DEFAULT_WORKERS,
        buffer_chunks: int = 8,
        fused_backend: Optional[str] = None,
        use_native: bool = True,
        router=None,
        model_id: Optional[str] = None,
        batch_timeout_s: float = 120.0,
        max_in_flight: int = 8,
        instance: Optional[str] = None,
    ) -> None:
        self.model = model
        self.job_dir = str(job_dir)
        self.inputs = [str(p) for p in inputs] if inputs else None
        self.fmt = fmt
        self.errors = errors
        self.chunk_rows = int(chunk_rows)
        self.workers = int(workers)
        self.buffer_chunks = int(buffer_chunks)
        self.fused_backend = fused_backend
        self.use_native = use_native
        #: what the caller handed us (router / controller / callable);
        #: ``self.router`` is the CURRENT resolution, refreshed at
        #: every shard boundary (elastic fleets change membership
        #: mid-job)
        self._router_source = router
        self.router = self._resolve_router()
        self.model_id = str(model_id) if model_id else None
        if self.model_id and self.router is None:
            raise ValueError(
                "model_id= selects a hosted model on a multi-model "
                "fleet; it requires router= (local scoring has exactly "
                "one model: the one passed in)")
        self.batch_timeout_s = float(batch_timeout_s)
        self.max_in_flight = max(int(max_in_flight), 1)
        self.instance = str(instance) if instance else (
            f"bulk-{os.getpid()}")
        self.journal: Optional[BulkJournal] = None
        #: live telemetry the ``bulk`` metrics view snapshots
        self._rows_out = 0
        self._rows_quarantined = 0
        self._rows_per_s = 0.0
        self._shards_committed_this_run = 0
        self._view_idx = metrics_registry().register_view("bulk", self)
        # build the direct scoring path once per job: torch-fused on the
        # model's device or numpy-fused, via the scorer's own
        # backend-degradation chain (which never degrades a device fault)
        from ..local.scorer import LocalScorer

        self.scorer = LocalScorer(
            model, fused=True,
            **({"fused_backend": fused_backend} if fused_backend else {}),
        )
        self._features = [f for f in self.scorer.raw_features
                          if not f.is_response]
        bad = [f.name for f in self._features
               if f.ftype.kind not in _CHUNK_KINDS]
        if bad:
            raise ValueError(
                f"bulk scoring reads columnar shards (numeric/text "
                f"features); {bad} cannot ride the pipelined chunk path"
            )
        self._schema = {f.name: f.ftype for f in self._features}
        self._wanted = [f.name for f in self._features]

    # -- metrics view --------------------------------------------------------
    def snapshot(self) -> dict[str, Any]:
        """The ``tx_bulk_*`` gauge surface riding the obs scrape."""
        j = self.journal
        states = j.states() if j is not None else {}
        resumes = j.doc.get("resumes", []) if j is not None else []
        return {
            "shards_total": j.doc.get("n_shards", 0) if j else 0,
            "shards_committed": states.get(STATE_COMMITTED, 0),
            "shards_pending": states.get(STATE_PENDING, 0),
            "rows_out": self._rows_out,
            "rows_quarantined": self._rows_quarantined,
            "rows_per_s": round(self._rows_per_s, 1),
            "resume_count": len(resumes),
            "rescored_shards": sum(
                len(r.get("rescored_shards", [])) for r in resumes),
        }

    # -- planning / recovery -------------------------------------------------
    def _check_inputs(self, j: BulkJournal) -> None:
        if self.inputs:
            recorded = [j.shard(s)["path"] for s in j.shard_ids()]
            if recorded != self.inputs:
                raise ValueError(
                    f"{self.job_dir} already journals a different "
                    f"input set ({len(recorded)} shards); refusing "
                    f"to mix jobs in one directory"
                )

    def _create_journal(self) -> BulkJournal:
        if not self.inputs:
            raise ValueError(
                f"no journal under {self.job_dir} and no inputs given")
        specs = plan_shards(self.inputs, fmt=self.fmt)
        return BulkJournal.create(
            self.job_dir,
            [(s.path, s.fmt) for s in specs],
            trace_context=_obs_trace.current_context(),
            params={
                "errors": self.errors,
                "chunk_rows": self.chunk_rows,
                "workers": self.workers,
                "mode": "fleet" if self.router is not None else "local",
                "model_id": self.model_id,
            },
        )

    def _recover(self, j: BulkJournal) -> tuple[dict[str, str], list[int]]:
        """Resume triage: roll verified work forward, reset the rest.
        Mutations are in-memory; the caller's ``record_resume`` makes
        them durable in ONE commit."""
        recovered: dict[str, str] = {}
        rescored: list[int] = []
        for sid in j.shard_ids():
            rec = j.shard(sid)
            state = rec["state"]
            if state == STATE_COMMITTED:
                if not j.verify_output(sid):
                    # committed but the bytes on disk are not the bytes
                    # the journal checksummed - re-score, loudly
                    recovered[str(sid)] = state
                    rescored.append(sid)
                    j.reset_shard(sid)
            elif state == STATE_SCORED:
                recovered[str(sid)] = state
                if j.verify_output(sid):
                    # output durable + verified: the kill landed between
                    # the scored and committed records - roll forward
                    rec["state"] = STATE_COMMITTED
                else:
                    rescored.append(sid)
                    j.reset_shard(sid)
            elif state == STATE_ASSIGNED:
                recovered[str(sid)] = state
                # scoring was in flight; any bytes on disk (a complete
                # write whose receipt never landed, or a torn partial)
                # are untrusted and re-scored
                if os.path.exists(j.output_path(sid)):
                    rescored.append(sid)
                j.reset_shard(sid)
        return recovered, rescored

    # -- the run -------------------------------------------------------------
    def run(self) -> dict[str, Any]:
        """Plan or resume, score every uncommitted shard, return the
        job summary (ledger, resume history, throughput)."""
        t0 = time.perf_counter()
        resuming = BulkJournal.exists(self.job_dir)
        j = BulkJournal.load(self.job_dir) if resuming else None
        if j is not None:
            self._check_inputs(j)
            # adopt the planning process's trace id BEFORE the run span
            # opens: plan -> score -> commit -> resume is ONE trace
            _obs_trace.tracer().adopt_context(j.doc.get("trace_context"))
        with _obs_trace.span("bulk.run", job_dir=self.job_dir,
                             resume=resuming,
                             mode="fleet" if self.router else "local"):
            if j is None:
                j = self._create_journal()
            self.journal = j
            if resuming:
                with _obs_trace.span("bulk.resume"):
                    recovered, rescored = self._recover(j)
                    j.record_resume(os.getpid(), self.instance,
                                    recovered, rescored)
            todo = j.uncommitted()
            if todo:
                self._check_model_hosted()
                self._score_shards(j, todo)
            wall = time.perf_counter() - t0
            led = j.ledger()
            self._rows_per_s = (led["rows_out"] / wall) if wall > 0 else 0.0
            return {
                "job_dir": self.job_dir,
                "resumed": resuming,
                "shards": j.doc["n_shards"],
                "shards_scored_this_run": len(todo),
                "ledger": led,
                "resumes": list(j.doc.get("resumes", [])),
                "wall_s": round(wall, 3),
                "rows_per_s": round(self._rows_per_s, 1),
                "scorer_backend": self.scorer.fused_backend,
            }

    def _score_shards(self, j: BulkJournal, todo: list[int]) -> None:
        """Stream the uncommitted shards through ONE InputPipeline.

        Shards are renumbered positionally for the pipeline (its
        ordered cursor walks 0..k-1) and mapped back to journal ids.
        ``ordered=True`` guarantees a chunk of pipeline-shard k+1 only
        arrives after shard k fully parsed (stats + quarantine final),
        so each shard finalizes - durable output write, ``scored``,
        ``committed`` - the moment its last chunk is scored, while
        later shards are still parsing on the worker threads.
        """
        sid_of = {i: sid for i, sid in enumerate(todo)}
        specs = [
            ShardSpec(i, j.shard(sid)["path"], j.shard(sid)["fmt"])
            for i, sid in sid_of.items()
        ]
        pipe = InputPipeline(
            specs, self._schema, wanted=self._wanted,
            workers=self.workers, buffer_chunks=self.buffer_chunks,
            chunk_rows=self.chunk_rows, errors=self.errors,
            ordered=True, use_native=self.use_native,
        )
        # ONE write-ahead thread executes every journal transition and
        # durable output write in EXACT submission order, so the
        # on-disk sequence - and the fault-point walk the kill drills
        # pin - is byte-for-byte the serial one, while scoring never
        # stalls on an fsync.
        writer = _ShardWriter()
        assigned: set[int] = set()
        try:
            current: Optional[int] = None
            parts: list[tuple[bytes, int]] = []
            pending_results: list[Any] = []  # fleet in-flight requests
            for pc in pipe.chunks():
                if current is not None and pc.shard_id != current:
                    for k in range(current, pc.shard_id):
                        self._seal_shard(j, pipe, k, sid_of[k], parts,
                                         pending_results, writer,
                                         assigned)
                        parts, pending_results = [], []
                if current is None and pc.shard_id > 0:
                    for k in range(0, pc.shard_id):
                        self._seal_shard(j, pipe, k, sid_of[k], [], [],
                                         writer, assigned)
                if current != pc.shard_id:
                    # shard boundary: re-resolve the replica set so an
                    # elastic fleet's grow/shrink lands on this shard
                    self.router = self._resolve_router()
                    assigned.add(sid_of[pc.shard_id])
                    writer.submit(j.mark_assigned, sid_of[pc.shard_id],
                                  self.instance)
                current = pc.shard_id
                if self.router is not None:
                    self._submit_chunk(pc.payload, parts, pending_results)
                else:
                    parts.append(self._score_chunk_local(pc.payload))
            start = 0 if current is None else current
            for k in range(start, len(specs)):
                self._seal_shard(j, pipe, k, sid_of[k], parts,
                                 pending_results, writer, assigned)
                parts, pending_results = [], []
        finally:
            writer.close()

    def _score_chunk_local(self, chunk) -> tuple[bytes, int]:
        """Direct columnar feed: chunk columns -> fused env -> device
        program -> one ``(output bytes, n_rows)`` blob, no per-record
        decode and no per-row dict building on the single-Prediction
        plan.  Falls back to the assembled-row path when fusion
        degraded to the interpreted scorer or the result shape is not
        a lone Prediction."""
        fused = self.scorer.fused
        if fused is None:
            lines = _result_lines(self.scorer.score_batch(
                _records_from_chunk(chunk, self._features)))
            return b"".join(lines), len(lines)
        with _obs_trace.span("bulk.score_chunk", n=chunk.n_rows):
            env = _env_from_chunk(chunk, self._features)
            fast = getattr(fused, "score_env_prediction", None)
            res = fast(env, chunk.n_rows) if fast is not None else None
            if res is not None:
                name, keys, stacked = res
                blob = _result_blob_from_prediction(
                    name, keys, stacked, fused.last_nonfinite_rows)
                return blob, chunk.n_rows
            lines = _result_lines(fused.score_env(env, chunk.n_rows))
            return b"".join(lines), len(lines)

    # -- fleet fan-out -------------------------------------------------------
    def _resolve_router(self):
        """The CURRENT router behind ``router=``: a FleetRouter is
        itself, a FleetController yields its live router, a zero-arg
        callable is invoked.  Re-run at shard boundaries so a fleet
        that grew or shrank mid-job fans the next shard out to current
        members instead of a snapshot taken at job start."""
        src = self._router_source
        if src is None:
            return None
        if hasattr(src, "submit"):
            return src  # a router directly
        if hasattr(src, "router"):
            return src.router  # a FleetController
        if callable(src):
            return src()
        raise TypeError(
            f"router= must be a FleetRouter, FleetController, or "
            f"callable, got {type(src).__name__}")

    def _check_model_hosted(self) -> None:
        """Fail LOUDLY before scoring starts when ``model_id=`` names
        a model no live replica hosts - a billion-row job must not
        discover an unhosted model one chunk at a time."""
        if not self.model_id or self.router is None:
            return
        if not any(h.alive and h.hosts(self.model_id)
                   for h in self.router.replicas()):
            from ..fleet.multimodel import UnhostedModelError

            raise UnhostedModelError(
                f"bulk job {self.job_dir}: model {self.model_id!r} is "
                f"not hosted by any live replica; host it "
                f"(FleetController.host_model) before scoring")

    def _submit_chunk(self, chunk, parts: list[bytes],
                      pending: list[Any]) -> None:
        """Dispatch one chunk's records to the fleet; drain the oldest
        in-flight requests (IN ORDER - the output shard is
        exactly-ordered) once the window is full."""
        records = _records_from_chunk(chunk, self._features)
        while len(pending) >= self.max_in_flight:
            parts.append(self._drain_result(pending.pop(0)))
        pending.append(self.router.submit(records=records,
                                          model_id=self.model_id))

    def _drain_result(self, req) -> tuple[bytes, int]:
        res = req.wait(timeout=self.batch_timeout_s)
        lines = _result_lines(res.results)
        return b"".join(lines), len(lines)

    def _seal_shard(self, j: BulkJournal, pipe: InputPipeline,
                    pipe_sid: int, sid: int,
                    parts: list[tuple[bytes, int]],
                    pending: list[Any], writer: "_ShardWriter",
                    assigned: set[int]) -> None:
        """One shard's chunks are all scored (or it produced none):
        drain the fleet window, merge the per-shard quarantine into
        the ledger tally, and enqueue the durable write + journal
        commits on the write-ahead thread.  Nothing is promised until
        the write is durable - the transitions run strictly after it,
        in the same task."""
        if sid not in assigned:
            # zero-chunk shard (empty, or every row quarantined): it
            # never produced a chunk, so assignment happens here
            assigned.add(sid)
            writer.submit(j.mark_assigned, sid, self.instance)
        for req in pending:
            parts.append(self._drain_result(req))
        info = pipe.stats.shards.get(pipe_sid, {})
        buf = pipe.shard_quarantines.get(pipe_sid)
        rows_q = buf.total if buf is not None else 0
        rows_in = int(info.get("rows_kept", 0)) + rows_q
        rows_out = sum(n for _, n in parts)
        data = b"".join(b for b, _ in parts)
        writer.check()
        writer.submit_bulky(self._commit_shard, j, sid, data,
                            rows_in, rows_out, rows_q)

    def _commit_shard(self, j: BulkJournal, sid: int, data: bytes,
                      rows_in: int, rows_out: int, rows_q: int) -> None:
        """Durably write one output shard, then commit
        ``scored`` -> ``committed`` (write-ahead thread)."""
        with _obs_trace.span("bulk.commit_shard", shard=sid,
                             rows=rows_out):
            sha, n_bytes = j.write_output_shard(sid, data)
            # the exactly-once window under drill: output is durable,
            # the journal still says "assigned"
            _faults.inject_kill("bulk.output_crash")
            j.mark_scored(sid, sha, n_bytes, rows_in, rows_out, rows_q)
            j.mark_committed(sid)
        self._rows_out += rows_out
        self._rows_quarantined += rows_q
        self._shards_committed_this_run += 1


def concatenated_output(job_dir: str) -> bytes:
    """Every committed output shard's bytes, in shard order - the
    byte-identity surface the resume tests and the bench drill pin."""
    j = BulkJournal.load(job_dir)
    blobs = []
    for sid in j.shard_ids():
        if j.shard(sid)["state"] == STATE_COMMITTED:
            with open(j.output_path(sid), "rb") as f:
                blobs.append(f.read())
    return b"".join(blobs)
