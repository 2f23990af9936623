"""Statistical helpers: contingency-table association measures.

Counterpart of OpStatistics (reference: utils/.../stats/OpStatistics.scala:384
- chiSquaredTest/CramersV, pointwise mutual information, association-rule
max confidence/support, computeCorrelationsWithLabel).  Contingency tables
arrive as dense [n_label_classes, n_categories] count matrices (built by one
matmul on device); everything here is cheap host math on those small tables.
"""
from __future__ import annotations

import numpy as np


def chi_squared(contingency: np.ndarray) -> float:
    """Pearson chi-squared statistic of a contingency table."""
    c = np.asarray(contingency, dtype=np.float64)
    total = c.sum()
    if total == 0:
        return 0.0
    row = c.sum(axis=1, keepdims=True)
    col = c.sum(axis=0, keepdims=True)
    expected = row @ col / total
    with np.errstate(divide="ignore", invalid="ignore"):
        terms = np.where(expected > 0, (c - expected) ** 2 / expected, 0.0)
    return float(terms.sum())


def cramers_v(contingency: np.ndarray) -> float:
    """Cramer's V with the reference's bias handling: V = sqrt(chi2 / (n *
    min(r-1, c-1))) over columns/rows that are non-empty (reference:
    OpStatistics.cramersV - empty rows/cols are filtered before the test)."""
    c = np.asarray(contingency, dtype=np.float64)
    c = c[c.sum(axis=1) > 0][:, c.sum(axis=0) > 0] if c.size else c
    if c.size == 0 or min(c.shape) < 2:
        return 0.0
    n = c.sum()
    dof = min(c.shape[0] - 1, c.shape[1] - 1)
    if n == 0 or dof == 0:
        return 0.0
    v2 = chi_squared(c) / (n * dof)
    return float(np.sqrt(max(v2, 0.0)))


def pointwise_mutual_info(contingency: np.ndarray) -> np.ndarray:
    """PMI per cell in log2 (reference: OpStatistics contingencyStats PMI):
    pmi[i,j] = log2( p(i,j) / (p(i) p(j)) ); zero cells -> 0."""
    c = np.asarray(contingency, dtype=np.float64)
    total = c.sum()
    if total == 0:
        return np.zeros_like(c)
    p = c / total
    pr = p.sum(axis=1, keepdims=True)
    pc = p.sum(axis=0, keepdims=True)
    with np.errstate(divide="ignore", invalid="ignore"):
        pmi = np.log2(p / (pr @ pc))
    pmi[~np.isfinite(pmi)] = 0.0
    return pmi


def max_rule_confidences(contingency: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Association rule category -> label-class: per category (column),
    confidence = max_i c[i,j]/colsum_j and support = colsum_j / n
    (reference: OpStatistics.maxConfidences)."""
    c = np.asarray(contingency, dtype=np.float64)
    n = c.sum()
    colsum = c.sum(axis=0)
    with np.errstate(divide="ignore", invalid="ignore"):
        conf = np.where(colsum > 0, c.max(axis=0) / colsum, 0.0)
    support = colsum / n if n > 0 else np.zeros_like(colsum)
    return conf, support


def average_ranks(a: np.ndarray) -> np.ndarray:
    """Average (fractional) ranks, 1-based, ties averaged - scipy
    rankdata(method='average') semantics, vectorized per column for 2-D
    input.  Host-side by design: Spearman runs under the SanityChecker
    sample cap (<= 1M rows), where host ranking is cheap, and it
    matches the JAX package's ranks exactly."""
    a = np.asarray(a, dtype=np.float64)
    if a.ndim == 1:
        return _average_ranks_1d(a)
    out = np.empty_like(a)
    for j in range(a.shape[1]):
        out[:, j] = _average_ranks_1d(a[:, j])
    return out


def _average_ranks_1d(v: np.ndarray) -> np.ndarray:
    order = np.argsort(v, kind="stable")
    sv = v[order]
    new_group = np.r_[True, sv[1:] != sv[:-1]]
    group_ids = np.cumsum(new_group) - 1
    firsts = np.nonzero(new_group)[0]
    counts = np.diff(np.r_[firsts, len(v)])
    avg = firsts + (counts - 1) / 2.0 + 1.0  # 1-based average rank per group
    ranks = np.empty(len(v), dtype=np.float64)
    ranks[order] = avg[group_ids]
    return ranks


def pearson_correlation(
    x_sum: np.ndarray,
    x_sq_sum: np.ndarray,
    xy_sum: np.ndarray,
    y_sum: float,
    y_sq_sum: float,
    n: float,
) -> np.ndarray:
    """Column-wise Pearson correlation with a label from moment sums
    (single-pass, psum-friendly).  NaN where variance is 0 (matching
    Spark's Statistics.corr behavior of NaN for constant columns)."""
    cov = xy_sum / n - (x_sum / n) * (y_sum / n)
    vx = x_sq_sum / n - (x_sum / n) ** 2
    vy = y_sq_sum / n - (y_sum / n) ** 2
    with np.errstate(divide="ignore", invalid="ignore"):
        corr = cov / np.sqrt(vx * vy)
    return corr
