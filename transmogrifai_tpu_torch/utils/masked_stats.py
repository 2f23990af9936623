"""Masked column statistics helpers.

Null-aware reductions over (values, mask) pairs - the columnar counterpart of
the reference's SequenceAggregators (reference: utils/.../spark/
SequenceAggregators.scala:41-212: SumNumSeq, MeanSeqNullNum, ModeSeqNullInt).
All reductions ignore masked-out entries.
"""
from __future__ import annotations

import numpy as np


def masked_mean(values: np.ndarray, mask: np.ndarray, default: float = 0.0) -> float:
    n = mask.sum()
    if n == 0:
        return default
    return float(values[mask].sum() / n)


def masked_mode(values: np.ndarray, mask: np.ndarray, default: float = 0.0) -> float:
    """Most frequent value among present entries; ties -> smallest value
    (reference ModeSeqNullInt picks min on ties)."""
    present = values[mask]
    if present.size == 0:
        return default
    uniq, counts = np.unique(present, return_counts=True)
    return float(uniq[np.argmax(counts)])  # np.unique sorts -> min on ties


def masked_variance(values: np.ndarray, mask: np.ndarray) -> float:
    present = values[mask]
    if present.size < 2:
        return 0.0
    return float(present.var(ddof=1))


def masked_min_max(values: np.ndarray, mask: np.ndarray) -> tuple[float, float]:
    present = values[mask]
    if present.size == 0:
        return (0.0, 0.0)
    return float(present.min()), float(present.max())
