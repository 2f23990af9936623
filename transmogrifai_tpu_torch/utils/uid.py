"""Unique id generation for features and stages.

Counterpart of the reference's ``UID`` generator
(reference: utils/src/main/scala/com/salesforce/op/utils/UID.scala:40-50):
sequential per-class counters so ids are deterministic within a process,
plus a reset hook used by tests for reproducible DAG construction.
"""
from __future__ import annotations

import itertools
import threading
from collections import defaultdict

_lock = threading.Lock()
_counters: dict[str, itertools.count] = defaultdict(lambda: itertools.count(0))


def make_uid(prefix: str) -> str:
    """Return a deterministic sequential uid like ``Real_003``."""
    with _lock:
        n = next(_counters[prefix])
    return f"{prefix}_{n:09x}"


def reset_uids() -> None:
    """Reset all counters (test use only, mirrors UID.reset in the reference)."""
    with _lock:
        _counters.clear()
