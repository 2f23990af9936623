"""device_idle_pct: the share of the traced window in which nothing runs
on the card: one less the union of the device activities' intervals in
the profiler's raw events, over the window."""

SHIMS = []
KERNELS = {}


def read(rec):
    lo, hi = rec.window
    if rec.busy_s is None or hi <= lo:
        return None
    return 100.0 * (1.0 - rec.busy_s / (hi - lo))
