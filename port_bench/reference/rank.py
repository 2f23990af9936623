"""AuROC: exact with tied scores grouped (the trapezoid over the ROC at
each distinct score), and over 1 024 score bins (the bins spanning each
candidate's scores on all rows, the validation rows counted in them)."""
from __future__ import annotations

import numpy as np


def auroc(y: np.ndarray, score: np.ndarray) -> float:
    order = np.argsort(-score, kind="stable")
    ys, ss = y[order], score[order]
    idx = np.concatenate([np.nonzero(np.diff(ss))[0], [len(ss) - 1]])
    tp = np.cumsum(ys)[idx]
    fp = (idx + 1) - tp
    P = y.sum()
    N = len(y) - P
    if P == 0 or N == 0:
        return 0.0
    tpr = np.concatenate([[0.0], tp / P])
    fpr = np.concatenate([[0.0], fp / N])
    return float(np.trapezoid(tpr, fpr))


def binned_auroc(y: np.ndarray, score: np.ndarray, val: np.ndarray,
                 bins: int) -> float:
    """AuROC of the rows where ``val`` holds, each score put in one of
    ``bins`` equal bins between the lowest and highest score of ALL rows
    (rounded to the nearest bin)."""
    lo, hi = score.min(), score.max()
    span = max(hi - lo, 1e-12)
    idx = np.clip(np.floor((score - lo) / span * (bins - 1) + 0.5), 0,
                  bins - 1).astype(np.int64)
    v = val.astype(np.float64)
    hp = np.bincount(idx, weights=v * y, minlength=bins)[::-1]
    hn = np.bincount(idx, weights=v * (1.0 - y), minlength=bins)[::-1]
    P, N = hp.sum(), hn.sum()
    cum_excl = np.cumsum(hp) - hp
    return float((hn * (cum_excl + 0.5 * hp)).sum() / max(P * N, 1e-12))
