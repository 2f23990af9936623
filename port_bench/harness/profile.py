"""The device trace of a traced window, read from the profiler's raw events.

A frozen copy of the reader in ``chip_smoke.py`` (``profile``): only the
card's activity is recorded (``ProfilerActivity.CUDA``) and the raw kineto
events are read as they are, since a train launches some 10^5-10^6
kernels and building the profiler's per-event Python objects, or
recording every host op as well, would take minutes.

The device's clock is tied to the host's ``perf_counter`` by a marker: a
synchronised launch of one small kernel right after the profiler starts,
whose recorded start is taken as the host time just before its launch.
"""
from __future__ import annotations

import time
from typing import Optional

import torch

#: the profiler's own bookkeeping, not the program's work
_NOT_WORK = ("Activity Buffer Request",)


class DeviceTrace:
    """Start with ``start()``, stop with ``stop()``; ``events`` then holds
    (name, start in host seconds, duration in seconds) of every device
    activity, sorted by start."""

    def __init__(self) -> None:
        self._prof = None
        self._t_marker = 0.0
        self.events: list = []
        self.read_s = 0.0

    def start(self) -> None:
        self._prof = torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA])
        self._prof.__enter__()
        torch.cuda.synchronize()
        self._t_marker = time.perf_counter()
        torch.ones(1, device="cuda").add_(1.0)
        torch.cuda.synchronize()

    def stop(self) -> None:
        torch.cuda.synchronize()
        self._prof.__exit__(None, None, None)
        t0 = time.perf_counter()
        raw = []
        for e in self._prof.profiler.kineto_results.events():
            if (e.device_type() == torch.autograd.DeviceType.CUDA
                    and e.name() not in _NOT_WORK):
                start = e.start_ns() if hasattr(e, "start_ns") \
                    else 1e3 * e.start_us()
                raw.append((e.name(), 1e-9 * start, 1e-9 * e.duration_ns()))
        raw.sort(key=lambda r: r[1])
        if not raw:
            raise RuntimeError("the traced window recorded no device activity")
        offset = raw[0][1] - self._t_marker
        self.events = [(n, s - offset, d) for n, s, d in raw]
        self._prof = None
        self.read_s = time.perf_counter() - t0


def busy_intervals(events, lo: float, hi: float) -> list:
    """The union of the events' intervals, clipped to [lo, hi]."""
    out: list = []
    for _, s, d in events:
        a, b = max(s, lo), min(s + d, hi)
        if b <= a:
            continue
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def busy_seconds(events, lo: float, hi: float) -> float:
    return sum(b - a for a, b in busy_intervals(events, lo, hi))


def idle_gaps(events, lo: float, hi: float) -> list:
    """(start, length) of every stretch of [lo, hi] with no device
    activity, longest first."""
    gaps, at = [], lo
    for a, b in busy_intervals(events, lo, hi):
        if a > at:
            gaps.append((at, a - at))
        at = max(at, b)
    if hi > at:
        gaps.append((at, hi - at))
    return sorted(gaps, key=lambda g: -g[1])


def top_ops(events, k: int = 10) -> list:
    by: dict = {}
    for n, _, d in events:
        by[n] = by.get(n, 0.0) + d
    return sorted(([n, s] for n, s in by.items()), key=lambda r: -r[1])[:k]


def kernel_seconds(events, match) -> Optional[float]:
    """Summed device seconds of the events whose name ``match`` accepts;
    None when none ran."""
    hits = [d for n, _, d in events if match(n)]
    return sum(hits) if hits else None
