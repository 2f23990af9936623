"""The SanityChecker's statistics and drops, written plainly.

Per column: the mean, the sample variance and the Pearson correlation
with the label; per categorical group (the indicator columns of one
parent feature and group) Cramer's V of the label-by-indicator counts and
each indicator's best association-rule confidence and support.  A column
is dropped for a variance under 1e-5, a |correlation| over 0.95 (or under
the minimum), a group's V over 0.95, or a rule of confidence over 1.0 with
support over 0.3; a group flagged for V or a rule goes whole.
"""
from __future__ import annotations

import numpy as np
import torch

from . import constants as K


def _chi2(c: np.ndarray) -> float:
    total = c.sum()
    if total == 0:
        return 0.0
    exp = c.sum(1, keepdims=True) @ c.sum(0, keepdims=True) / total
    with np.errstate(divide="ignore", invalid="ignore"):
        return float(np.where(exp > 0, (c - exp) ** 2 / exp, 0.0).sum())


def cramers_v(c: np.ndarray) -> float:
    c = c[c.sum(1) > 0][:, c.sum(0) > 0] if c.size else c
    if c.size == 0 or min(c.shape) < 2:
        return 0.0
    dof = min(c.shape[0] - 1, c.shape[1] - 1)
    return float(np.sqrt(max(_chi2(c) / (c.sum() * dof), 0.0)))


def check(X: torch.Tensor, y: np.ndarray, columns: list):
    """(stats {mean, variance, corr}, kept column indices) of the design
    matrix X [n, d] against the label y."""
    n, d = X.shape
    yt = torch.as_tensor(y, dtype=X.dtype, device=X.device)
    xs = X.sum(0)
    xss = (X * X).sum(0)
    xys = yt @ X
    ys, yss = yt.sum(), (yt * yt).sum()
    xs, xss, xys = (t.double().cpu().numpy() for t in (xs, xss, xys))
    ys, yss = float(ys), float(yss)
    mean = xs / n
    var = np.maximum(xss / n - mean ** 2, 0.0) * (n / max(n - 1, 1))
    cov = xys / n - mean * (ys / n)
    vx = xss / n - mean ** 2
    vy = yss / n - (ys / n) ** 2
    with np.errstate(divide="ignore", invalid="ignore"):
        corr = cov / np.sqrt(vx * vy)

    groups: dict = {}
    for i, (parent, group, indicator) in enumerate(columns):
        if indicator is not None:
            groups.setdefault((parent, group or parent), []).append(i)
    classes = np.unique(y)
    onehot = torch.as_tensor((y[:, None] == classes[None, :]).astype(np.float64),
                             dtype=X.dtype, device=X.device)
    reasons: dict = {}
    group_of, v_of, conf_of = {}, {}, {}
    for key, idx in groups.items():
        table = (onehot.T @ X[:, idx]).double().cpu().numpy()
        v_of[key] = cramers_v(table)
        colsum = table.sum(0)
        total = table.sum()
        with np.errstate(divide="ignore", invalid="ignore"):
            conf = np.where(colsum > 0, table.max(0) / colsum, 0.0)
        support = colsum / total if total > 0 else np.zeros_like(colsum)
        for i, c, s in zip(idx, conf, support):
            group_of[i] = key
            conf_of[i] = (float(c), float(s))
    for i in range(d):
        why = reasons.setdefault(i, [])
        if var[i] < K.MIN_VARIANCE:
            why.append("variance")
        if np.isfinite(corr[i]):
            if abs(corr[i]) > K.MAX_CORRELATION or \
                    abs(corr[i]) < K.MIN_CORRELATION:
                why.append("correlation")
        if i in group_of and v_of[group_of[i]] > K.MAX_CRAMERS_V:
            why.append("group")
        if i in conf_of:
            c, s = conf_of[i]
            if c > K.MAX_RULE_CONFIDENCE and s > K.MIN_RULE_SUPPORT:
                why.append("group")
    flagged = {group_of[i] for i, w in reasons.items()
               if "group" in w and i in group_of}
    for key in flagged:
        for i in groups[key]:
            reasons[i].append("group removed")
    keep = [i for i in range(d) if not reasons[i]]
    return {"mean": mean, "variance": var, "corr": corr}, keep
