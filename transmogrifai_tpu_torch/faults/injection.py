"""Deterministic fault injection: named failure points, seeded triggers.

Every recovery path carries a NAMED injection point, so drills
exercise the real detection and recovery code rather than a mock.

Faults arm via the ``TX_FAULTS`` environment variable (read once at
import, so child processes drill crash paths with zero code changes) or
programmatically via :func:`configure`.  Spec grammar - entries split on
``;`` or whitespace, fields on ``:``::

    TX_FAULTS="serving.batch:every=1:times=5 io.save_model.crash_window:on=1"

Trigger fields (all optional; an armed point with none always fires):

* ``on=N``     - fire only on the Nth call (1-based)
* ``every=N``  - fire on every Nth call
* ``prob=P``   - fire with probability P from a seeded per-point RNG
* ``seed=S``   - RNG seed for ``prob`` (default 42: deterministic drills)
* ``times=K``  - stop after K total fires
* ``delay=S``  - sleep duration for :func:`inject_sleep` points (also
  the impairment-window length for the fleet channel's timed faults)
* ``exit=C``   - process exit code for :func:`inject_kill` points

The fleet channel's timed seams (``fleet.partition``, ``fleet.half_open``,
``fleet.slow_peer``, ``channel.corrupt_frame``, ``fleet.reconnect_storm``)
parse here too.

Determinism note: only DATA sends consume an armed spec's trigger
counters - recv-side idle polls honor an open impairment window but
never advance ``on=``/``every=`` counts, so drills fire on exactly the
Nth batch regardless of poll timing.

Injection is dormant by default: every helper returns immediately when
no plan is configured, so production hot paths pay one attribute read.
This module must import nothing from the rest of the package (it is
threaded through utils/serving/serialization/workflow and cycles would
be easy to create).
"""
from __future__ import annotations

import math
import os
import random
import threading
import time
from dataclasses import dataclass, field
from typing import Optional

ENV_VAR = "TX_FAULTS"

#: exit code used by inject_kill unless the spec overrides it; chosen to
#: look like a SIGKILL'd process (128 + 9), the crash being simulated
DEFAULT_KILL_EXIT = 137

DEFAULT_SLEEP_S = 0.05


class InjectedFault(RuntimeError):
    """Raised by an armed :func:`inject` point (drills catch precisely)."""


class FaultSpecError(ValueError):
    """A TX_FAULTS entry failed to parse - misconfigured drills must be
    loud, never silently inert."""


@dataclass
class FaultSpec:
    """One armed failure point plus its trigger state."""

    point: str
    on: Optional[int] = None
    every: Optional[int] = None
    prob: Optional[float] = None
    seed: int = 42
    times: Optional[int] = None
    delay: float = DEFAULT_SLEEP_S
    exit_code: int = DEFAULT_KILL_EXIT
    calls: int = 0
    fired: int = 0
    _rng: random.Random = field(default=None, repr=False)  # type: ignore

    def __post_init__(self) -> None:
        if self.on is not None and self.on < 1:
            raise FaultSpecError(f"{self.point}: on must be >= 1")
        if self.every is not None and self.every < 1:
            raise FaultSpecError(f"{self.point}: every must be >= 1")
        if self.prob is not None and not (0.0 <= self.prob <= 1.0):
            raise FaultSpecError(f"{self.point}: prob must be in [0, 1]")
        self._rng = random.Random(self.seed)

    def should_fire(self) -> bool:
        """Consume one call at this point; True when the fault fires."""
        self.calls += 1
        if self.times is not None and self.fired >= self.times:
            return False
        if self.on is not None and self.calls != self.on:
            return False
        if self.every is not None and self.calls % self.every != 0:
            return False
        if self.prob is not None and self._rng.random() >= self.prob:
            return False
        self.fired += 1
        return True


def parse_spec(text: str) -> dict[str, FaultSpec]:
    """Parse a TX_FAULTS string into specs keyed by point name."""
    specs: dict[str, FaultSpec] = {}
    for entry in text.replace(";", " ").split():
        parts = entry.split(":")
        point = parts[0].strip()
        if not point:
            raise FaultSpecError(f"empty point name in entry {entry!r}")
        kw: dict = {}
        for f in parts[1:]:
            if "=" not in f:
                raise FaultSpecError(
                    f"{point}: field {f!r} is not key=value"
                )
            k, v = f.split("=", 1)
            try:
                if k in ("on", "every", "times", "seed"):
                    kw[k] = int(v)
                elif k in ("prob", "delay"):
                    kw[k] = float(v)
                elif k == "exit":
                    kw["exit_code"] = int(v)
                else:
                    raise FaultSpecError(
                        f"{point}: unknown trigger field {k!r}"
                    )
            except ValueError as e:
                raise FaultSpecError(
                    f"{point}: bad value for {k!r}: {v!r}"
                ) from e
        if point in specs:
            raise FaultSpecError(
                f"duplicate entry for point {point!r}: a silently "
                "overwritten trigger is an inert drill"
            )
        specs[point] = FaultSpec(point=point, **kw)
    return specs


class FaultPlan:
    """Thread-safe registry of armed points for one process."""

    def __init__(self, specs: dict[str, FaultSpec]) -> None:
        self._specs = specs
        self._lock = threading.Lock()

    def fires(self, point: str) -> Optional[FaultSpec]:
        spec = self._specs.get(point)
        if spec is None:
            return None
        with self._lock:
            return spec if spec.should_fire() else None

    def spec(self, point: str) -> Optional[FaultSpec]:
        return self._specs.get(point)

    def points(self) -> tuple[str, ...]:
        return tuple(sorted(self._specs))


_plan: Optional[FaultPlan] = None


def configure(spec: Optional[str]) -> Optional[FaultPlan]:
    """Arm (or with None/empty, disarm) fault injection in-process."""
    global _plan
    _plan = FaultPlan(parse_spec(spec)) if spec else None
    return _plan


def reset() -> None:
    """Disarm all injection (test teardown)."""
    configure(None)


def active() -> bool:
    return _plan is not None


def fires(point: str) -> Optional[FaultSpec]:
    """Consume one call at ``point``; the spec when the fault fires."""
    if _plan is None:
        return None
    return _plan.fires(point)


def inject(point: str) -> None:
    """Raise InjectedFault when ``point`` fires (kernel-exception drills)."""
    if _plan is None:
        return
    if _plan.fires(point) is not None:
        raise InjectedFault(f"injected fault at {point}")


def inject_sleep(point: str) -> float:
    """Sleep ``delay`` seconds when ``point`` fires (slow-batch drills);
    returns the seconds slept."""
    if _plan is None:
        return 0.0
    spec = _plan.fires(point)
    if spec is None:
        return 0.0
    time.sleep(spec.delay)
    return spec.delay


def inject_kill(point: str) -> None:
    """Hard-kill this process when ``point`` fires (crash-mid-write
    drills: ``os._exit`` skips atexit/finally exactly like SIGKILL, so
    no cleanup code can accidentally 'finish' the interrupted write)."""
    if _plan is None:
        return
    spec = _plan.fires(point)
    if spec is not None:
        os._exit(spec.exit_code)


def inject_unavailable(point: str) -> bool:
    """True when ``point`` fires (dependency-unavailable drills, e.g.
    the native kernel library failing to load)."""
    return _plan is not None and _plan.fires(point) is not None


def poison_nonfinite(results: list) -> int:
    """Overwrite every float leaf of per-row score dicts with NaN
    (NaN/Inf-output drills for the serving guard); returns rows touched.
    Mutates in place; non-dict rows are left alone."""
    touched = 0
    for row in results:
        if not isinstance(row, dict):
            continue
        hit = _poison_dict(row)
        touched += 1 if hit else 0
    return touched


def _poison_dict(d: dict) -> bool:
    hit = False
    for k, v in d.items():
        if isinstance(v, dict):
            hit = _poison_dict(v) or hit
        elif isinstance(v, float) and math.isfinite(v):
            d[k] = float("nan")
            hit = True
    return hit


# arm from the environment at import: child processes spawned for crash
# drills (supervisor re-dispatch, save_model kill) inherit TX_FAULTS and
# need no in-process configure() call
if os.environ.get(ENV_VAR):
    configure(os.environ[ENV_VAR])
