"""transmogrifai_tpu_torch.continuous: the self-operating training loop.

Host copy of ``transmogrifai_tpu/continuous/``: a drift-triggered refit
controller that closes the data -> drift -> refit -> canary -> promote
loop - the sharded reader's follow mode tails a shard directory, the
drift monitor scores each window against the stable model's training
contract, the governor's hysteresis and cooldown decide, and the refit
trains on the workflow's device (the card by default) before it is published and
promoted, directly or through a serving fleet's canary.  See
:mod:`.trainer` for the state machine.
"""
from __future__ import annotations

from .governor import RefitGovernor
from .trainer import (
    STATUS_FILENAME,
    ContinuousError,
    ContinuousTrainer,
)

__all__ = [
    "STATUS_FILENAME",
    "ContinuousError",
    "ContinuousTrainer",
    "RefitGovernor",
]
