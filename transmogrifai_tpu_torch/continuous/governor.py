"""Refit governor: when does a drift signal become a refit decision?

Host copy of ``transmogrifai_tpu/continuous/governor.py``.  The
:class:`~transmogrifai_tpu_torch.schema.drift.DriftMonitor` produces a
per-window JS-divergence score; this module owns the POLICY that turns
scores into exactly one of four window verdicts - never a human.  Two
dampers keep the loop from thrashing:

* **hysteresis** - a single over-threshold window is routinely sampling
  noise (the monitor's own min_warn_rows rationale); only
  ``consecutive`` windows over the threshold IN A ROW trip a refit.
  Any clear window resets the streak.
* **cooldown** - right after a trigger, the next ``cooldown`` windows
  cannot trigger again no matter what they score: the freshly-refit
  model is still being judged, and the windows feeding the governor were
  scored against the OLD contract anyway.  Over-threshold windows inside
  the cooldown are counted as ``suppressed`` (surfaced in the
  ``continuous`` metrics view) rather than silently dropped.

``forced=True`` models an operator- or fault-forced trigger
(``drift.false_positive``): it bypasses the hysteresis streak but NOT
the cooldown - a forced trigger during cooldown is suppressed like any
other.
"""
from __future__ import annotations

#: the four window verdicts observe_window can return
VERDICTS = ("clear", "over", "trigger", "suppressed")


class RefitGovernor:
    """Hysteresis + cooldown state machine over per-window drift
    scores.  Single-threaded by design: one governor per trainer, fed
    from the trainer's own cycle loop."""

    def __init__(self, threshold: float = 0.1, consecutive: int = 3,
                 cooldown: int = 2) -> None:
        if consecutive < 1:
            raise ValueError("consecutive must be >= 1")
        if cooldown < 0:
            raise ValueError("cooldown must be >= 0")
        self.threshold = float(threshold)
        self.consecutive = int(consecutive)
        self.cooldown = int(cooldown)
        self.over_streak = 0
        self.cooldown_left = 0
        self.windows = 0
        self.triggers = 0
        self.suppressed = 0

    def observe_window(self, max_js: float,
                       forced: bool = False) -> str:
        """Fold one window's worst per-feature JS score (and the forced
        flag) into the state machine; returns the window verdict."""
        self.windows += 1
        over = forced or max_js > self.threshold
        if self.cooldown_left > 0:
            self.cooldown_left -= 1
            if over:
                self.suppressed += 1
                return "suppressed"
            return "clear"
        if not over:
            self.over_streak = 0
            return "clear"
        self.over_streak += 1
        if not forced and self.over_streak < self.consecutive:
            return "over"
        self.over_streak = 0
        self.triggers += 1
        self.cooldown_left = self.cooldown
        return "trigger"

    def snapshot(self) -> dict:
        return {
            "threshold": self.threshold,
            "consecutive": self.consecutive,
            "cooldown": self.cooldown,
            "over_streak": self.over_streak,
            "cooldown_left": self.cooldown_left,
            "windows": self.windows,
            "triggers": self.triggers,
            "suppressed": self.suppressed,
        }
