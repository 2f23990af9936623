"""Exactly-once bulk scoring.

A checkpointed, kill-survivable batch-inference job joining the
pipelined reader to the fused scoring programs (and, in fleet mode,
the replica fleet): sharded inputs stream through
:class:`readers.pipeline.InputPipeline` straight into
``score_env`` - no admission controller, no micro-batcher - while an
atomic, checksummed :class:`BulkJournal` walks every shard through
``pending -> assigned -> scored -> committed`` so a SIGKILL at any
instant resumes with zero duplicated and zero lost rows, and the
double-entry ledger accounts every quarantined row exactly.

On a CUDA model (the default ``OpWorkflow`` device) every chunk scores
through the torch-fused program on the card
(``local/fused_torch.py``); a ``device="cpu"`` model scores
numpy-fused.  A device fault (``parallel.kernels.is_device_fault``)
raised while scoring a chunk ends the job: that shard stays
uncommitted, so the journal is consistent and a later resume scores
it.

    summary = BulkScoringJob(model, job_dir, shards).run()
    summary = BulkScoringJob(model, job_dir).run()   # resume
"""
from .job import BulkScoringJob, concatenated_output
from .journal import (
    JOURNAL_FILENAME,
    OUTPUT_DIR,
    STATE_ASSIGNED,
    STATE_COMMITTED,
    STATE_PENDING,
    STATE_SCORED,
    STATES,
    BulkJournal,
    TornJournalError,
)

__all__ = [
    "BulkJournal",
    "BulkScoringJob",
    "JOURNAL_FILENAME",
    "OUTPUT_DIR",
    "STATES",
    "STATE_ASSIGNED",
    "STATE_COMMITTED",
    "STATE_PENDING",
    "STATE_SCORED",
    "TornJournalError",
    "concatenated_output",
]
