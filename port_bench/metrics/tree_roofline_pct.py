"""tree_roofline_pct: the tree learner's level loop (``models/
tree_kernel.py`` ``fit_tree``) as a share of its roofline: the least time
for the level work of every ``tree.fit`` span of the traced window, at
3.35 TB/s, over the device time of the kernels charged to those spans.

The work of a tree is counted from its span's attributes alone (rows
``n``, columns ``d``, ``bins`` B, ``stats`` channels C, ``depth`` D and
``bin_bytes``): each of its D + 1 levels reads every row's bins, its node
and its stat rows once, and each level's full histogram [2^l, d, B, C] of
float32 is written once.  So it reads the same work whatever implements
the loop.  A kernel is charged to the innermost program span open at its
device start (``harness/attribution.py``): the harness keeps no kernel's
launch."""

from port_bench.harness import attribution
from port_bench.harness.yardsticks import HBM_BYTES_PER_S

SHIMS = []
KERNELS = {}


def tree_level_bytes(n: int, d: int, bins: int, stats: int, depth: int,
                     bin_bytes: int) -> int:
    """The bytes of one tree's level loop (see the module docstring)."""
    rows = (depth + 1) * n * (d * bin_bytes + 4 + 4 * stats)
    hists = (2 ** (depth + 1) - 1) * d * bins * stats * 4
    return rows + hists


def read(rec):
    spans = attribution.program_spans(rec) or []
    trees = [s for s in spans if s.name == "tree.fit"]
    if not trees:
        return None
    dev = attribution.seconds(
        attribution.charge(spans, rec.device_events), trees)
    if dev <= 0:
        return None
    work = sum(tree_level_bytes(a["n"], a["d"], a["bins"], a["stats"],
                                a["depth"], a["bin_bytes"])
               for a in (s.attrs for s in trees))
    return 100.0 * work / HBM_BYTES_PER_S / dev
