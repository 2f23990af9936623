"""tree_idle_pct: the share of the tree learner's fits (the union of the
traced window's ``tree.fit`` spans, ``models/tree_kernel.py`` ``fit_tree``)
in which no device activity runs: how far the host's launches pace the
level loop."""

from port_bench.harness import attribution, profile

SHIMS = []
KERNELS = {}


def read(rec):
    spans = attribution.program_spans(rec) or []
    fits = attribution.union(s for s in spans if s.name == "tree.fit")
    total = sum(b - a for a, b in fits)
    if total <= 0:
        return None
    busy = attribution.overlap(
        fits, profile.busy_intervals(rec.device_events, *rec.window))
    return 100.0 * (1.0 - busy / total)
