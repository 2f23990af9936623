"""The design matrix by TransmogrifAI's default vectorizers, written plainly.

Layout (Transmogrifier.scala): the features are grouped by type - Integral,
PickList, Real - and the groups taken in the order of their names
("integral", "pivot", "real"), each group's features by name.  A numeric
feature gives its value, missing values filled (Real: the mean of the
present values; Integral: their most frequent value, the smallest on
ties), and a null indicator.  A PickList feature gives one indicator per
value among its 20 most frequent with at least 10 rows (more rows first,
then by value), its values cleaned (trimmed, lower-cased, spaces taken
out), then OTHER and a null indicator.  With a label, each numeric group
is followed by one bucket block per feature of the group: a one-feature
tree of depth 4 over 32 quantile bins against the label (gini, gain at
least 0.01) cuts the present values at its split thresholds, one
indicator per bucket.

Each column also carries its (parent feature, group, indicator) so the
SanityChecker's categorical groups can be found.
"""
from __future__ import annotations

from collections import Counter

import numpy as np
import torch

from . import constants as K
from . import trees

NULL = "NullIndicatorValue"
OTHER = "OTHER"
_GROUP = {"Integral": "integral", "PickList": "pivot", "Real": "real",
          "RealNN": "realnn"}


def _clean(v: str) -> str:
    return v.strip().lower().replace(" ", "")


def _fill(kind: str, values: np.ndarray, mask: np.ndarray) -> float:
    if not mask.any():
        return 0.0
    present = values[mask]
    if kind == "Integral":
        u, c = np.unique(present, return_counts=True)
        return float(u[np.argmax(c)])
    return float(present.sum() / mask.sum())


def _top_labels(values) -> list:
    counts: Counter = Counter()
    for v, c in Counter(v for v in values if v is not None).items():
        counts[_clean(v)] += c
    items = sorted(((v, c) for v, c in counts.items() if c >= K.MIN_SUPPORT),
                   key=lambda vc: (-vc[1], vc[0]))
    return [v for v, _ in items[:K.TOP_K]]


def _bucket_splits(x: np.ndarray, y: np.ndarray, device) -> list:
    """Split thresholds of the one-feature gini tree of x against y."""
    if x.size == 0:
        return []
    x32 = np.asarray(x, np.float32).reshape(-1, 1)
    classes = np.unique(y)
    onehot = (y[:, None] == classes[None, :]).astype(np.float64)
    stats = torch.as_tensor(
        np.concatenate([np.ones((len(y), 1)), onehot], axis=1),
        dtype=torch.float64, device=device)
    edges = trees.quantile_edges(x32, K.BUCKET_MAX_BINS)
    bins = trees.to_bins(torch.as_tensor(x32, device=device), edges)
    heap = trees.fit_tree(bins, stats, K.BUCKET_MAX_DEPTH, K.BUCKET_MAX_BINS,
                          "gini", float(K.BUCKET_MIN_INSTANCES),
                          float(K.BUCKET_MIN_INFO_GAIN))
    return trees.split_points(heap, edges[0])


class Vectorizer:
    """Fitted on the training rows; ``transform`` gives [n, d] float64."""

    def __init__(self, config: dict, raw: dict, label: np.ndarray,
                 device) -> None:
        by_group: dict = {}
        for spec in config["columns"]:
            by_group.setdefault(_GROUP[spec["type"]], []).append(spec)
        self.plan = []       # ("num", spec, fill) / ("pivot", spec, labels)
        #                      / ("bucket", spec, splits)
        self.columns = []    # (parent, group, indicator)
        for key in sorted(by_group):
            specs = sorted(by_group[key], key=lambda s: s["name"])
            for spec in specs:
                r = raw[spec["name"]]
                name = spec["name"]
                if key == "pivot":
                    labels = _top_labels(
                        [v if m else None for v, m in zip(r.values, r.mask)])
                    self.plan.append(("pivot", spec, labels))
                    self.columns += [(name, name, v)
                                     for v in labels + [OTHER, NULL]]
                else:
                    fill = _fill(spec["type"], r.values, r.mask)
                    self.plan.append(("num", spec, fill))
                    self.columns += [(name, None, None), (name, name, NULL)]
            if key in ("real", "integral"):
                for spec in specs:
                    r = raw[spec["name"]]
                    splits = _bucket_splits(r.values[r.mask],
                                            label[r.mask], device)
                    self.plan.append(("bucket", spec, splits))
                    edges = [-np.inf] + splits + [np.inf]
                    self.columns += [
                        (spec["name"], spec["name"],
                         f"[{edges[i]:.4g}-{edges[i + 1]:.4g})")
                        for i in range(len(splits) + 1)]

    def transform(self, raw: dict) -> np.ndarray:
        blocks = []
        for kind, spec, state in self.plan:
            r = raw[spec["name"]]
            n = len(r.values)
            if kind == "num":
                blocks.append(np.where(r.mask, r.values, state)[:, None])
                blocks.append((~r.mask).astype(np.float64)[:, None])
            elif kind == "pivot":
                index = {v: j for j, v in enumerate(state)}
                code_of = {v: index.get(_clean(v), len(state))
                           for v in set(r.values.tolist()) if v is not None}
                codes = np.array([code_of[v] if m and v is not None else -1
                                  for v, m in zip(r.values, r.mask)],
                                 dtype=np.int64)
                block = np.zeros((n, len(state) + 2))
                present = codes >= 0
                block[np.nonzero(present)[0], codes[present]] = 1.0
                block[:, -1] = ~present
                blocks.append(block)
            else:
                which = np.searchsorted(np.asarray(state, np.float64),
                                        r.values, side="right")
                block = np.zeros((n, len(state) + 1))
                rows = np.nonzero(r.mask)[0]
                block[rows, which[rows]] = 1.0
                blocks.append(block)
        return np.concatenate(blocks, axis=1)
