"""Data splitters: holdout reservation + class rebalancing as sample weights.

A host-numpy copy of ``transmogrifai_tpu/selector/splitters.py``
(counterparts of Splitter / DataSplitter / DataBalancer / DataCutter;
reference: core/.../impl/tuning/Splitter.scala:57, DataSplitter.scala,
DataBalancer.scala:45-90, DataCutter.scala:48-141).  Instead of
materializing up/down-sampled copies of the data (Spark RDD resampling),
rebalancing is expressed as per-row SAMPLE WEIGHTS so the design matrix
stays fixed on the device and every candidate/fold sees the same arrays -
the rebalance rides the weight vector of the CV fan-out.  Weights, keep
masks and summaries are bit-equal to the JAX package's.  Each splitter
emits a SplitterSummary into metadata.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np


@dataclass
class PreparedData:
    """Outcome of splitter preparation: kept row indices (None = all rows),
    per-row weights, and the summary."""

    weights: np.ndarray
    keep_mask: Optional[np.ndarray]
    summary: dict


class Splitter:
    """(reference: tuning/Splitter.scala - reserveTestFraction default 0.1)"""

    def __init__(self, reserve_test_fraction: float = 0.1, seed: int = 42) -> None:
        self.reserve_test_fraction = reserve_test_fraction
        self.seed = seed

    def prepare(self, y: np.ndarray) -> PreparedData:
        return PreparedData(
            weights=np.ones(len(y)),
            keep_mask=None,
            summary={"splitter": type(self).__name__},
        )


class DataSplitter(Splitter):
    """Regression: plain holdout reservation, pass-through prep (reference:
    DataSplitter.scala)."""


class DataBalancer(Splitter):
    """Binary-classification rebalancing (reference: DataBalancer.scala:45-90):
    if the positive fraction is below ``sample_fraction``, up-weight the
    minority class / down-weight the majority so the effective positive
    fraction equals sample_fraction, capping effective size at
    ``max_training_sample``."""

    def __init__(
        self,
        sample_fraction: float = 0.1,
        max_training_sample: int = 1_000_000,
        reserve_test_fraction: float = 0.1,
        seed: int = 42,
    ) -> None:
        super().__init__(reserve_test_fraction, seed)
        self.sample_fraction = sample_fraction
        self.max_training_sample = max_training_sample

    def prepare(self, y: np.ndarray) -> PreparedData:
        n = len(y)
        pos = float((y == 1).sum())
        neg = float(n - pos)
        small, big = (pos, neg) if pos <= neg else (neg, pos)
        small_label = 1.0 if pos <= neg else 0.0
        weights = np.ones(n)
        summary = {
            "splitter": "DataBalancer",
            "positiveCount": pos,
            "negativeCount": neg,
            "desiredFraction": self.sample_fraction,
            "upSampled": False,
            "downSampled": False,
        }
        frac = small / max(n, 1)
        if small > 0 and frac < self.sample_fraction:
            # target: small_w*small / (small_w*small + big) = sample_fraction
            small_w = self.sample_fraction * big / (
                (1.0 - self.sample_fraction) * small
            )
            weights = np.where(y == small_label, small_w, 1.0)
            summary["upSampled"] = True
            summary["minorityWeight"] = float(small_w)
        # cap effective training size by uniform down-weighting
        eff = float(weights.sum())
        if eff > self.max_training_sample:
            weights *= self.max_training_sample / eff
            summary["downSampled"] = True
        return PreparedData(weights=weights, keep_mask=None, summary=summary)


class DataCutter(Splitter):
    """Multiclass label curation (reference: DataCutter.scala:48-141): drop
    rows whose label falls below ``min_label_fraction`` or beyond
    ``max_label_categories`` most-frequent labels."""

    def __init__(
        self,
        min_label_fraction: float = 0.0,
        max_label_categories: int = 100,
        reserve_test_fraction: float = 0.1,
        seed: int = 42,
    ) -> None:
        super().__init__(reserve_test_fraction, seed)
        self.min_label_fraction = min_label_fraction
        self.max_label_categories = max_label_categories

    def prepare(self, y: np.ndarray) -> PreparedData:
        n = len(y)
        labels, counts = np.unique(y, return_counts=True)
        order = np.argsort(-counts, kind="stable")
        labels, counts = labels[order], counts[order]
        kept = [
            l
            for i, (l, c) in enumerate(zip(labels, counts))
            if c / n >= self.min_label_fraction and i < self.max_label_categories
        ]
        kept_set = set(float(l) for l in kept)
        keep_mask = np.array([float(v) in kept_set for v in y], dtype=bool)
        summary = {
            "splitter": "DataCutter",
            "labelsKept": sorted(kept_set),
            "labelsDropped": sorted(set(float(l) for l in labels) - kept_set),
            "rowsDropped": int(n - keep_mask.sum()),
        }
        return PreparedData(
            weights=np.ones(n), keep_mask=keep_mask, summary=summary
        )
