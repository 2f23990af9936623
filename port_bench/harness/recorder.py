"""What a traced run records beside the program: the benchmark's spans
around calls into the program, the shapes of the hand kernels' calls, and
the program's own stage spans.

Spans come from shims that this module installs on the program's classes
and module functions for the traced window and takes off afterwards; the
program itself is not edited.  A per-layer metric's reader names the
shims it needs (``SHIMS``: ``(module, class or None, attribute, group)``)
and the harness installs the union.  A shim synchronises the card at both
ends of its call, so a span holds its device work; a span opened while
another span of the same group family (the part of ``group`` before the
first dot) is open counts as that outer span and is not recorded apart.
"""
from __future__ import annotations

import importlib
import sys
import time
from dataclasses import dataclass, field
from typing import Callable, Optional

#: the program's package; its modules are searched for the kernel wrappers
PROGRAM = "transmogrifai_tpu_torch"


@dataclass
class Span:
    group: str
    t0: float            # perf_counter seconds
    t1: float
    outer: Optional[str]  # the innermost open span of another family


@dataclass
class KernelCall:
    kernel: str
    n: int
    d: int
    n_edges: int = 0
    out_bytes: int = 0


@dataclass
class Recording:
    """Everything a per-layer reader may read of one traced window."""

    trains: int = 0
    window: tuple = (0.0, 0.0)          # perf_counter seconds
    spans: list = field(default_factory=list)
    stage_spans: list = field(default_factory=list)  # (module, phase, t0, wall_s)
    kernel_calls: list = field(default_factory=list)
    device_events: list = field(default_factory=list)  # (name, t0_s, dur_s)
    busy_s: Optional[float] = None

    def span_seconds(self, prefix: str, within: Optional[str] = None) -> float:
        """Seconds of the recorded spans whose group starts with
        ``prefix`` (only those opened inside a span of ``within``)."""
        return sum(s.t1 - s.t0 for s in self.spans
                   if s.group.startswith(prefix)
                   and (within is None or (s.outer or "").startswith(within)))

    def stage_seconds(self, module_prefix: str) -> float:
        return sum(w for m, _, _, w in self.stage_spans
                   if m.startswith(module_prefix))

    def per_train_ms(self, seconds: float) -> Optional[float]:
        if self.trains <= 0:
            return None
        return 1e3 * seconds / self.trains


def _family(group: str) -> str:
    return group.split(".", 1)[0]


class Shims:
    """Installs span shims and kernel-call shims; ``remove`` restores every
    attribute it replaced."""

    def __init__(self, rec: Recording, sync: Callable[[], None]) -> None:
        self.rec = rec
        self.sync = sync
        self._saved: list = []
        self._open: list[str] = []

    def _wrap(self, fn, group: str):
        rec, sync, open_ = self.rec, self.sync, self._open
        fam = _family(group)

        def shim(*args, **kw):
            nested = any(_family(g) == fam for g in open_)
            outer = next((g for g in reversed(open_)
                          if _family(g) != fam), None)
            open_.append(group)
            sync()
            t0 = time.perf_counter()
            try:
                return fn(*args, **kw)
            finally:
                sync()
                t1 = time.perf_counter()
                open_.pop()
                if not nested:
                    rec.spans.append(Span(group, t0, t1, outer))

        return shim

    def span(self, module: str, cls: Optional[str], attr: str,
             group: str) -> None:
        owner = importlib.import_module(module)
        if cls is not None:
            owner = getattr(owner, cls)
        raw = owner.__dict__[attr] if cls is not None else getattr(owner, attr)
        if isinstance(raw, (staticmethod, classmethod)):
            new = type(raw)(self._wrap(raw.__func__, group))
        else:
            new = self._wrap(raw, group)
        self._saved.append((owner, attr, raw))
        setattr(owner, attr, new)

    def kernel(self, wrapper: Callable, describe: Callable) -> None:
        """Record the shape of every call of the kernel wrapper ``wrapper``
        (``describe(args) -> KernelCall``), wherever the program's modules
        bound it by name - except in the module that defines it, whose
        wrapper counts its launches on its own name."""
        calls = self.rec.kernel_calls

        def shim(*args, **kw):
            calls.append(describe(*args, **kw))
            return wrapper(*args, **kw)

        for name, mod in list(sys.modules.items()):
            if mod is None or name == wrapper.__module__ or not (
                    name == PROGRAM or name.startswith(PROGRAM + ".")):
                continue
            for attr, val in list(vars(mod).items()):
                if val is wrapper:
                    self._saved.append((mod, attr, val))
                    setattr(mod, attr, shim)

    def remove(self) -> None:
        for owner, attr, raw in reversed(self._saved):
            setattr(owner, attr, raw)
        self._saved.clear()
