"""Binary classification evaluation.

Counterpart of OpBinaryClassificationEvaluator (reference: core/.../
evaluators/OpBinaryClassificationEvaluator.scala:56-113): AuROC/AuPR by rank
statistics over sorted scores (the mllib BinaryClassificationMetrics
analog) and confusion counts at the 0.5 prediction, all on the host.

The JAX package's device ``masked_rank_metrics`` serves only the
cross-validating model selector and comes with it (ROADMAP.md queue 1,
item 5); its OpBinScoreEvaluator comes with the other evaluators (item 8).
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..types.columns import PredictionColumn
from .base import EvaluationMetrics, OpEvaluatorBase


def _roc_pr_areas(y: np.ndarray, score: np.ndarray) -> tuple[float, float]:
    """AuROC + AuPR from score ranking, ties handled by threshold grouping
    (trapezoidal ROC, step-wise PR like mllib)."""
    order = np.argsort(-score, kind="stable")
    y_sorted = y[order]
    s_sorted = score[order]
    # group ties: cum counts at each distinct threshold
    distinct = np.nonzero(np.diff(s_sorted))[0]
    idx = np.concatenate([distinct, [len(s_sorted) - 1]])
    tp = np.cumsum(y_sorted)[idx]
    fp = (idx + 1) - tp
    P = y.sum()
    N = len(y) - P
    if P == 0 or N == 0:
        return 0.0, 0.0
    tpr = np.concatenate([[0.0], tp / P])
    fpr = np.concatenate([[0.0], fp / N])
    auroc = float(np.trapezoid(tpr, fpr))
    precision = np.concatenate([[1.0], tp / (tp + fp)])
    recall = np.concatenate([[0.0], tp / P])
    aupr = float(np.sum(np.diff(recall) * precision[1:]))
    return auroc, aupr


@dataclass
class BinaryClassificationMetrics(EvaluationMetrics):
    AuROC: float = 0.0
    AuPR: float = 0.0
    Precision: float = 0.0
    Recall: float = 0.0
    F1: float = 0.0
    Error: float = 0.0
    TP: float = 0.0
    TN: float = 0.0
    FP: float = 0.0
    FN: float = 0.0
    thresholds: list = field(default_factory=list)
    precision_by_threshold: list = field(default_factory=list)
    recall_by_threshold: list = field(default_factory=list)


class OpBinaryClassificationEvaluator(OpEvaluatorBase):
    metric_name = "AuROC"
    larger_better = True

    def __init__(self, num_thresholds: int = 100) -> None:
        self.num_thresholds = num_thresholds

    def evaluate_arrays(self, y, pred: PredictionColumn):
        score = (
            pred.probability[:, 1]
            if pred.probability is not None and pred.probability.shape[1] > 1
            else pred.prediction
        )
        yhat = pred.prediction
        auroc, aupr = _roc_pr_areas(y, score)
        tp = float(((yhat == 1) & (y == 1)).sum())
        tn = float(((yhat == 0) & (y == 0)).sum())
        fp = float(((yhat == 1) & (y == 0)).sum())
        fn = float(((yhat == 0) & (y == 1)).sum())
        precision = tp / (tp + fp) if tp + fp > 0 else 0.0
        recall = tp / (tp + fn) if tp + fn > 0 else 0.0
        f1 = (
            2 * precision * recall / (precision + recall)
            if precision + recall > 0
            else 0.0
        )
        error = (fp + fn) / max(len(y), 1)
        ths = np.linspace(0.0, 1.0, self.num_thresholds + 1)
        p_by, r_by = [], []
        P = y.sum()
        for t in ths:
            yh = (score >= t).astype(np.float64)
            tpt = float(((yh == 1) & (y == 1)).sum())
            fpt = float(((yh == 1) & (y == 0)).sum())
            p_by.append(tpt / (tpt + fpt) if tpt + fpt > 0 else 1.0)
            r_by.append(tpt / P if P > 0 else 0.0)
        return BinaryClassificationMetrics(
            AuROC=auroc, AuPR=aupr, Precision=precision, Recall=recall,
            F1=f1, Error=error, TP=tp, TN=tn, FP=fp, FN=fn,
            thresholds=ths.tolist(),
            precision_by_threshold=p_by, recall_by_threshold=r_by,
        )
