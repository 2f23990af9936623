"""The program's own spans on a traced window's timeline, and the device
time charged to them.

The port records spans with its one tracer (``transmogrifai_tpu_torch/
obs/trace.py``): ``tree.fit`` around each tree, ``cv.score`` around each
candidate-fold's scoring, ``kernel.<name>`` around each hand-kernel call,
and the rest.  A traced window starts with a fresh ring big enough for
every span of the window, and the readers of this module take the spans
from that ring after the window.

**One clock.**  A span carries ``t_epoch``, a ``time.time()`` stamp, and
its wall.  The harness puts the program's stage spans on the window's
``perf_counter`` timeline with one offset (``cell.traced_window``), which
:func:`place` recovers from the first stage span and gives every span of
the ring.  A window with no stage span, or a ring holding none of the
window's spans, places nothing.

**Charging.**  :func:`charge` gives each device event to the innermost
program span open at its device start.  The accepted harness keeps no
kernel's launch, so a kernel that runs after the span that launched it
has closed is charged to the span open when it starts.
"""
from __future__ import annotations

import bisect
from dataclasses import dataclass, field
from typing import Optional

#: the harness's stage spans, which tie the ring's clock to the window's
STAGE = ("stage.fit", "stage.transform")


@dataclass(frozen=True)
class ProgramSpan:
    name: str
    t0: float                      # window seconds (perf_counter)
    t1: float
    span: int
    parent: Optional[int] = None
    attrs: dict = field(default_factory=dict, compare=False)


def ring() -> list:
    """The records of the port's tracer ring."""
    from transmogrifai_tpu_torch.obs import trace

    return trace.tracer().spans()


def place(records, rec) -> Optional[list]:
    """The ring's ``records`` inside ``rec``'s window, on its timeline and
    sorted by start (outer spans first at a tie); None when ``rec`` holds
    no stage span to tie the clocks with, or the ring none of them."""
    stage = [r for r in records if r["name"] in STAGE]
    if not rec.stage_spans or len(stage) != len(rec.stage_spans):
        return None
    offset = rec.stage_spans[0][2] - stage[0]["t_epoch"]
    lo, hi = rec.window
    out = []
    for r in records:
        t0 = r["t_epoch"] + offset
        t1 = t0 + 1e-3 * r["wall_ms"]
        if lo <= t0 and t1 <= hi:
            out.append(ProgramSpan(r["name"], t0, t1, r["span"],
                                   r.get("parent"), r.get("attrs") or {}))
    out.sort(key=lambda s: (s.t0, -s.t1))
    return out


def program_spans(rec) -> Optional[list]:
    """:func:`place` of the ring as it stands after ``rec``'s window."""
    return place(ring(), rec)


def cuda_wall_us(rec, name: str) -> Optional[float]:
    """The mean wall, in microseconds, of the ``name`` spans of ``rec``'s
    window on the ``cuda`` route (a hand kernel's wrapper, from its entry
    to its launch's return); None when there is none."""
    walls = [s.t1 - s.t0 for s in program_spans(rec) or []
             if s.name == name and s.attrs.get("route") == "cuda"]
    if not walls:
        return None
    return 1e6 * sum(walls) / len(walls)


class Innermost:
    """The innermost span open at a time, over spans that nest (one
    thread's spans): a sweep turns them into stretches, each with the one
    span innermost all along it."""

    def __init__(self, spans) -> None:
        self.starts: list = []
        self.owner: list = []
        stack: list = []
        for s in sorted(spans, key=lambda s: (s.t0, -s.t1)):
            self._close(stack, s.t0)
            stack.append(s)
            self._mark(s.t0, s)
        self._close(stack, float("inf"))

    def _mark(self, t: float, s) -> None:
        if self.starts and self.starts[-1] == t:
            self.owner[-1] = s
        else:
            self.starts.append(t)
            self.owner.append(s)

    def _close(self, stack: list, t: float) -> None:
        while stack and stack[-1].t1 <= t:
            end = stack.pop().t1
            self._mark(end, stack[-1] if stack else None)

    def at(self, t: float):
        i = bisect.bisect_right(self.starts, t) - 1
        return self.owner[i] if i >= 0 else None


def charge(spans, events) -> dict:
    """Device seconds of the events (name, start, duration) by the
    innermost span open at each one's start: the span's id, or None
    outside every span."""
    inner = Innermost(spans)
    out: dict = {}
    for _, start, dur in events:
        s = inner.at(start)
        key = None if s is None else s.span
        out[key] = out.get(key, 0.0) + dur
    return out


def seconds(charged: dict, spans) -> float:
    """The seconds ``charged`` to any of ``spans``."""
    return sum(charged.get(s.span, 0.0) for s in spans)


def union(spans) -> list:
    """The union of the spans' intervals, as sorted [start, end] pairs."""
    out: list = []
    for s in sorted(spans, key=lambda s: s.t0):
        if out and s.t0 <= out[-1][1]:
            out[-1][1] = max(out[-1][1], s.t1)
        else:
            out.append([s.t0, s.t1])
    return out


def overlap(a, b) -> float:
    """Seconds that two sorted lists of disjoint intervals share."""
    i = j = 0
    total = 0.0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total
