"""Atomic, checksummed job journal for exactly-once bulk scoring.

The journal is the ONLY durable truth a :class:`~.job.BulkScoringJob`
trusts: one ``journal.json`` document per job directory, written with
the serialization/model_io discipline (tempfile + fsync + rename, the
previous good document kept as ``journal.json.last-good``) and carrying
its own SHA-256 so a torn write can never be mistaken for state.  Every
shard moves through ``pending -> assigned -> scored -> committed``; the
``scored`` record pins the output shard's SHA-256 + byte size, so a
resume can tell a durable, complete output from a partial one without
trusting anything but the checksum.  The double-entry ledger
(``rows_in == rows_out + rows_quarantined``, per shard and globally) is
computed from the same records.

Fault points (drilled by the bulk tests and the chaos schedule):

* ``bulk.journal_torn``   - the primary journal reads back torn on
  :meth:`BulkJournal.load`; recovery must come from ``.last-good``.
* ``bulk.commit_crash``   - SIGKILL-equivalent exit immediately after
  the Nth journal commit lands (``on=N`` walks the kill across every
  state boundary).
"""
from __future__ import annotations

import hashlib
import json
import os
import time
from typing import Any, Optional, Sequence

from ..faults import injection as _faults
from ..serialization.model_io import LAST_GOOD_SUFFIX, write_bytes_atomic

#: the one journal document per job directory
JOURNAL_FILENAME = "journal.json"
#: output shards live under <job_dir>/shards/
OUTPUT_DIR = "shards"

STATE_PENDING = "pending"
STATE_ASSIGNED = "assigned"
STATE_SCORED = "scored"
STATE_COMMITTED = "committed"
#: the per-shard state machine, in order
STATES = (STATE_PENDING, STATE_ASSIGNED, STATE_SCORED, STATE_COMMITTED)

_CHECKSUM_KEY = "sha256"
_HASH_CHUNK = 1 << 20


class TornJournalError(RuntimeError):
    """``journal.json`` AND its ``.last-good`` fallback are both
    missing or fail their embedded checksum."""


def sha256_bytes(data: bytes) -> str:
    return hashlib.sha256(data).hexdigest()


def sha256_file(path: str) -> tuple[Optional[str], int]:
    """(hexdigest, size) of ``path``, chunked; ``(None, 0)`` when the
    file does not exist."""
    if not os.path.exists(path):
        return None, 0
    h = hashlib.sha256()
    size = 0
    with open(path, "rb") as f:
        while True:
            block = f.read(_HASH_CHUNK)
            if not block:
                break
            h.update(block)
            size += len(block)
    return h.hexdigest(), size


def _canonical(doc: dict) -> bytes:
    return json.dumps(doc, sort_keys=True, separators=(",", ":"),
                      default=str).encode("utf-8")


def _verify_raw(raw: Optional[bytes]) -> Optional[dict]:
    """Parse + checksum-verify one serialized journal; None on ANY
    torn/foreign state (missing, unparseable, wrong shape, bad sum)."""
    if raw is None:
        return None
    try:
        doc = json.loads(raw)
    except (ValueError, UnicodeDecodeError):
        return None
    if not isinstance(doc, dict) or not isinstance(doc.get("shards"), dict):
        return None
    want = doc.get(_CHECKSUM_KEY)
    body = {k: v for k, v in doc.items() if k != _CHECKSUM_KEY}
    if want != sha256_bytes(_canonical(body)):
        return None
    return doc


def _read_bytes(path: str) -> Optional[bytes]:
    if not os.path.exists(path):
        return None
    with open(path, "rb") as f:
        return f.read()


def output_name(shard_id: int) -> str:
    return f"part-{int(shard_id):05d}.jsonl"


class BulkJournal:
    """The per-job shard state machine + ledger, persisted atomically.

    Every mutation lands through :meth:`commit`: serialize with the
    embedded checksum, keep the previous GOOD document as
    ``.last-good``, then tempfile + fsync + rename the new one.  A kill
    at any instant leaves either the old good journal, the new good
    journal, or a torn primary with a good ``.last-good`` - never an
    unrecoverable state.
    """

    def __init__(self, job_dir: str, doc: dict,
                 recovered_from_last_good: bool = False) -> None:
        self.job_dir = str(job_dir)
        self.doc = doc
        self.recovered_from_last_good = recovered_from_last_good

    # -- paths ---------------------------------------------------------------
    @property
    def path(self) -> str:
        return os.path.join(self.job_dir, JOURNAL_FILENAME)

    def output_path(self, shard_id: int) -> str:
        return os.path.join(self.job_dir, OUTPUT_DIR,
                            self.shard(shard_id)["output"])

    # -- construction --------------------------------------------------------
    @classmethod
    def create(cls, job_dir: str, inputs: Sequence[tuple[str, Optional[str]]],
               trace_context: Optional[str] = None,
               params: Optional[dict] = None) -> "BulkJournal":
        """Plan a fresh job: one journal record per input shard, all
        ``pending``, committed durably before any scoring starts."""
        shards: dict[str, dict] = {}
        for i, (path, fmt) in enumerate(inputs):
            shards[str(i)] = {
                "shard_id": i,
                "path": str(path),
                "fmt": fmt,
                "input_bytes": (os.path.getsize(path)
                                if os.path.exists(path) else None),
                "state": STATE_PENDING,
                "output": output_name(i),
                "output_sha256": None,
                "output_bytes": None,
                "rows_in": None,
                "rows_out": None,
                "rows_quarantined": None,
                "assigned_to": None,
                "attempts": 0,
            }
        doc = {
            "version": 1,
            "created_unix": time.time(),
            "trace_context": trace_context,
            "params": dict(params or {}),
            "n_shards": len(shards),
            "shards": shards,
            "resumes": [],
        }
        j = cls(job_dir, doc)
        j.commit()
        return j

    @classmethod
    def load(cls, job_dir: str) -> "BulkJournal":
        """Checksum-verified load: primary first, ``.last-good`` on any
        torn primary, :class:`TornJournalError` when both fail."""
        path = os.path.join(str(job_dir), JOURNAL_FILENAME)
        raw = _read_bytes(path)
        if raw is not None and _faults.fires("bulk.journal_torn") is not None:
            # drill: the primary reads back half-written
            raw = raw[: max(len(raw) // 2, 1)]
        doc = _verify_raw(raw)
        if doc is not None:
            return cls(str(job_dir), doc)
        lg = _verify_raw(_read_bytes(path + LAST_GOOD_SUFFIX))
        if lg is not None:
            return cls(str(job_dir), lg, recovered_from_last_good=True)
        raise TornJournalError(
            f"{path}: journal and its {LAST_GOOD_SUFFIX} fallback are "
            f"both missing or fail their checksum"
        )

    @staticmethod
    def exists(job_dir: str) -> bool:
        path = os.path.join(str(job_dir), JOURNAL_FILENAME)
        return os.path.exists(path) or os.path.exists(
            path + LAST_GOOD_SUFFIX)

    # -- persistence ---------------------------------------------------------
    def commit(self) -> None:
        """Serialize + checksum + atomically replace, preserving the
        previous good journal as ``.last-good`` first."""
        body = {k: v for k, v in self.doc.items() if k != _CHECKSUM_KEY}
        body[_CHECKSUM_KEY] = sha256_bytes(_canonical(
            {k: v for k, v in body.items() if k != _CHECKSUM_KEY}))
        self.doc = body
        prev = _read_bytes(self.path)
        if prev is not None and _verify_raw(prev) is not None:
            write_bytes_atomic(self.path + LAST_GOOD_SUFFIX, prev)
        write_bytes_atomic(
            self.path, json.dumps(body, indent=1, sort_keys=True,
                                  default=str).encode("utf-8") + b"\n")
        # drill seam: die IMMEDIATELY after the Nth commit lands - with
        # on=N this walks a SIGKILL across every state boundary
        _faults.inject_kill("bulk.commit_crash")

    # -- shard accessors -----------------------------------------------------
    def shard(self, shard_id: int) -> dict:
        return self.doc["shards"][str(int(shard_id))]

    def shard_ids(self) -> list[int]:
        return sorted(int(k) for k in self.doc["shards"])

    def states(self) -> dict[str, int]:
        hist = {s: 0 for s in STATES}
        for sid in self.shard_ids():
            hist[self.shard(sid)["state"]] += 1
        return hist

    def uncommitted(self) -> list[int]:
        return [sid for sid in self.shard_ids()
                if self.shard(sid)["state"] != STATE_COMMITTED]

    # -- state transitions (each one durable) --------------------------------
    def mark_assigned(self, shard_id: int, instance: str) -> None:
        rec = self.shard(shard_id)
        rec["state"] = STATE_ASSIGNED
        rec["assigned_to"] = str(instance)
        rec["attempts"] = int(rec["attempts"]) + 1
        self.commit()

    def mark_scored(self, shard_id: int, sha256: str, n_bytes: int,
                    rows_in: int, rows_out: int,
                    rows_quarantined: int) -> None:
        rec = self.shard(shard_id)
        rec["state"] = STATE_SCORED
        rec["output_sha256"] = sha256
        rec["output_bytes"] = int(n_bytes)
        rec["rows_in"] = int(rows_in)
        rec["rows_out"] = int(rows_out)
        rec["rows_quarantined"] = int(rows_quarantined)
        self.commit()

    def mark_committed(self, shard_id: int) -> None:
        self.shard(shard_id)["state"] = STATE_COMMITTED
        self.commit()

    def reset_shard(self, shard_id: int) -> None:
        """Roll one shard's record back to ``pending`` (in memory; the
        caller batches the durable commit via :meth:`record_resume`)."""
        rec = self.shard(shard_id)
        rec["state"] = STATE_PENDING
        rec["output_sha256"] = None
        rec["output_bytes"] = None
        rec["rows_in"] = None
        rec["rows_out"] = None
        rec["rows_quarantined"] = None
        rec["assigned_to"] = None

    def record_resume(self, pid: int, instance: str,
                      recovered: dict[str, str],
                      rescored: Sequence[int]) -> None:
        self.doc["resumes"].append({
            "unix": time.time(),
            "pid": int(pid),
            "instance": str(instance),
            "recovered_states": dict(recovered),
            "rescored_shards": sorted(int(s) for s in rescored),
            "from_last_good": self.recovered_from_last_good,
        })
        self.commit()

    # -- output shards -------------------------------------------------------
    def write_output_shard(self, shard_id: int,
                           data: bytes) -> tuple[str, int]:
        """Durably write one output shard (tempfile + fsync + rename)
        and return its ``(sha256, byte size)`` for the journal record."""
        write_bytes_atomic(self.output_path(shard_id), data)
        return sha256_bytes(data), len(data)

    def verify_output(self, shard_id: int) -> bool:
        """Does the output shard on disk match its journal checksum?
        False on a missing/partial/foreign file or an unrecorded one."""
        rec = self.shard(shard_id)
        if rec["output_sha256"] is None:
            return False
        sha, size = sha256_file(self.output_path(shard_id))
        return sha == rec["output_sha256"] and size == rec["output_bytes"]

    # -- the double-entry ledger ---------------------------------------------
    def ledger(self) -> dict[str, Any]:
        """``rows_in == rows_out + rows_quarantined``, per shard and
        globally.  ``balanced`` is None for shards not yet scored;
        the global verdict requires every shard scored AND balanced."""
        per: dict[str, dict] = {}
        tot_in = tot_out = tot_q = 0
        complete = True
        all_balanced = True
        for sid in self.shard_ids():
            rec = self.shard(sid)
            if rec["rows_in"] is None:
                balanced = None
                complete = False
            else:
                balanced = (rec["rows_in"]
                            == rec["rows_out"] + rec["rows_quarantined"])
                tot_in += rec["rows_in"]
                tot_out += rec["rows_out"]
                tot_q += rec["rows_quarantined"]
                all_balanced = all_balanced and balanced
            per[str(sid)] = {
                "state": rec["state"],
                "rows_in": rec["rows_in"],
                "rows_out": rec["rows_out"],
                "rows_quarantined": rec["rows_quarantined"],
                "balanced": balanced,
            }
        return {
            "shards": per,
            "rows_in": tot_in,
            "rows_out": tot_out,
            "rows_quarantined": tot_q,
            "complete": complete,
            "balanced": complete and all_balanced
            and tot_in == tot_out + tot_q,
        }

    # -- operator surface ----------------------------------------------------
    def status_doc(self) -> dict[str, Any]:
        """The one-document job status ``tx bulk status`` prints."""
        resumes = self.doc.get("resumes", [])
        return {
            "job_dir": self.job_dir,
            "n_shards": self.doc.get("n_shards"),
            "states": self.states(),
            "shards": {str(sid): dict(self.shard(sid))
                       for sid in self.shard_ids()},
            "ledger": self.ledger(),
            "resumes": list(resumes),
            "resume_count": len(resumes),
            "rescored_shards": sorted(
                {s for r in resumes for s in r.get("rescored_shards", [])}),
            "trace_context": self.doc.get("trace_context"),
            "recovered_from_last_good": self.recovered_from_last_good,
            "params": dict(self.doc.get("params", {})),
        }
