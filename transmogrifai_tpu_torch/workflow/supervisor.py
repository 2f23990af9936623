"""Preemption detection and re-dispatch for long training runs.

Counterpart of ``transmogrifai_tpu/workflow/supervisor.py``.  Two halves:

* **Heartbeat emission** - ``OpValidator`` touches ``<checkpoint>.heartbeat``
  when validation starts and after every completed (model, grid point) row
  (``selector/validator.py`` ``_ckpt_save``), so liveness is progress: a
  wedged launch or a killed host stops the beat.
* **Supervision** - :func:`supervise` runs the training command as a child
  process, polls the heartbeat, kills the child when the beat goes stale,
  and re-dispatches it.  The restarted run restores the completed CV rows
  from the checkpoint and continues, so the final selection is the one an
  uninterrupted run makes.

Re-dispatch is budgeted: attempts are separated by exponential backoff
with jitter, and a child that keeps exiting with the same non-zero code
fails fast (a deterministic bug, not a preemption).  The
``supervisor.child_kill`` fault point (``faults/injection.py``) drills the
kill -> backoff -> resume path.
"""
from __future__ import annotations

import os
import random
import subprocess
import time
from dataclasses import dataclass, field
from typing import Optional, Sequence

from ..faults import injection as _faults
from ..obs import trace as _obs_trace
from ..obs.fleet import child_env as _child_env

# the environment of one dispatch attempt: obs.fleet.child_env exports
# the ambient trace context through the TX_OBS_TRACE_CONTEXT seam, so a
# re-dispatched child's spans join the supervising run's trace, and
# strips a stale inherited context when there is none to export


def beat(heartbeat_path: str) -> None:
    """Touch the heartbeat file (creates it on first beat)."""
    try:
        with open(heartbeat_path, "a"):
            os.utime(heartbeat_path, None)
    except OSError:
        pass  # a missed beat must never kill the training step itself


def staleness(heartbeat_path: str) -> Optional[float]:
    """Seconds since the last beat, clamped at 0; None when no beat has
    happened yet.  The clamp matters on clock skew / coarse-mtime
    filesystems: a beat stamped in the future would otherwise read as
    NEGATIVE staleness, and negative values poison every downstream
    ``staleness > threshold`` comparison (a hung child could look
    freshly-beating for the whole skew window)."""
    try:
        return max(0.0, time.time() - os.path.getmtime(heartbeat_path))
    except OSError:
        return None


@dataclass
class SuperviseResult:
    returncode: int
    attempts: int
    restarts: list = field(default_factory=list)  # (attempt, reason, backoff_s)


def backoff_delay_s(
    restart_index: int,
    base_s: float,
    max_s: float,
    jitter_frac: float,
    rng: random.Random,
) -> float:
    """Exponential backoff with jitter for restart ``restart_index``
    (0-based): min(max_s, base_s * 2**i) stretched by up to
    ``jitter_frac`` of itself so a preempted fleet does not re-dispatch
    in lockstep."""
    delay = min(max_s, base_s * (2.0 ** restart_index))
    if jitter_frac > 0:
        delay *= 1.0 + rng.uniform(0.0, jitter_frac)
    return delay


def supervise(
    cmd: Sequence[str],
    heartbeat_path: str,
    stale_after_s: float = 300.0,
    max_restarts: int = 2,
    poll_s: float = 0.5,
    grace_s: Optional[float] = None,
    env: Optional[dict] = None,
    backoff_base_s: float = 0.5,
    backoff_max_s: float = 30.0,
    backoff_jitter: float = 0.1,
    fail_fast_identical: int = 3,
    backoff_seed: Optional[int] = None,
) -> SuperviseResult:
    """Run ``cmd`` under heartbeat supervision.

    A child that exits non-zero (crash/preemption) or whose heartbeat goes
    stale for ``stale_after_s`` (hang) is killed and re-dispatched, up to
    ``max_restarts`` times.  ``grace_s`` bounds the no-beat-yet startup
    window (defaults to stale_after_s).  Re-dispatches are separated by
    exponential backoff (``backoff_base_s`` doubling per restart, capped
    at ``backoff_max_s``, stretched by up to ``backoff_jitter`` of
    itself; ``backoff_seed`` pins the jitter for deterministic tests),
    and each restart-log entry records the wait actually taken:
    ``(attempt, reason, backoff_s)``.  A child that exits with the SAME
    non-zero code ``fail_fast_identical`` times in a row fails fast -
    that is a deterministic bug, not a preemption, and burning the
    remaining restart budget on it only delays the alarm.  Returns the
    final returncode and the restart log; raises RuntimeError when
    restarts are exhausted or fail-fast trips.
    """
    grace = stale_after_s if grace_s is None else grace_s
    rng = random.Random(backoff_seed)
    restarts: list = []
    identical_exits = 0
    last_exit: Optional[int] = None
    for attempt in range(max_restarts + 1):
        start = time.monotonic()  # durations never ride the epoch
        # clock (the tests/test_style.py timing gate)
        # one span per dispatch attempt, its context exported to the
        # child while the span is ambient: the child's spans parent
        # under THIS attempt, so a merged fleet trace shows
        # re-dispatches as sibling subtrees (the span covers dispatch,
        # not the child's lifetime)
        with _obs_trace.span("supervisor.dispatch", attempt=attempt):
            proc = subprocess.Popen(list(cmd), env=_child_env(env))
        killed_reason = None
        while True:
            rc = proc.poll()
            if rc is not None:
                break
            if _faults.fires("supervisor.child_kill") is not None:
                killed_reason = "injected child kill (fault drill)"
            s = staleness(heartbeat_path)
            age = time.monotonic() - start
            # a beat older than this attempt's start is a leftover from a
            # previous attempt/run - it must not void the startup grace
            if s is not None and s > age:
                s = None
            if killed_reason is None:
                if s is None:
                    if age > grace:
                        killed_reason = f"no heartbeat within {grace:.0f}s"
                elif s > stale_after_s and age > stale_after_s:
                    killed_reason = f"heartbeat stale for {s:.0f}s"
            if killed_reason:
                proc.kill()
                try:
                    # bounded reap (the no-unbounded-blocking-waits gate,
                    # tests/test_style.py): SIGKILL is not catchable, but
                    # a D-state child could still wedge an unbounded wait
                    proc.wait(timeout=30.0)
                except subprocess.TimeoutExpired:
                    pass  # killed_reason already records the outcome
                break
            time.sleep(poll_s)
        if proc.returncode == 0 and killed_reason is None:
            return SuperviseResult(0, attempt + 1, restarts)
        reason = killed_reason or f"exit code {proc.returncode}"
        # identical-exit tracking: only clean (unkilled) non-zero exits
        # count - a kill is the supervisor's doing, not determinism
        if killed_reason is None:
            identical_exits = (
                identical_exits + 1 if proc.returncode == last_exit else 1
            )
            last_exit = proc.returncode
        else:
            identical_exits, last_exit = 0, None
        fail_fast = (
            fail_fast_identical > 0
            and identical_exits >= fail_fast_identical
        )
        wait_s = 0.0
        if not fail_fast and attempt < max_restarts:
            wait_s = backoff_delay_s(
                len(restarts), backoff_base_s, backoff_max_s,
                backoff_jitter, rng,
            )
        restarts.append((attempt, reason, round(wait_s, 3)))
        if fail_fast:
            raise RuntimeError(
                f"command failed after {attempt + 1} attempts (fail-fast: "
                f"exit code {proc.returncode} repeated {identical_exits} "
                f"times - deterministic failure, not preemption); restart "
                f"log: {restarts}"
            )
        if wait_s > 0:
            time.sleep(wait_s)
    raise RuntimeError(
        f"command failed after {max_restarts + 1} attempts; restart log: "
        f"{restarts}"
    )
