"""Binary classification evaluation.

Counterpart of OpBinaryClassificationEvaluator (reference: core/.../
evaluators/OpBinaryClassificationEvaluator.scala:56-113): AuROC/AuPR by rank
statistics over sorted scores (the mllib BinaryClassificationMetrics
analog) and confusion counts at the 0.5 prediction, all on the host.

``masked_rank_metrics`` is the cross-validating model selector's batched
1024-bin AuROC/AuPR on the device.  The JAX package builds each
candidate's score histogram as a 32x32 one-hot outer-product matmul for
the TPU's matrix unit; here it is a ``scatter_add_`` into B x 1024 float64
bins.  The masks are 0/1 and y is 0/1, so every bin is an integer count:
exact in any summation order, so deterministic on the card.

``OpBinScoreEvaluator`` (reference: OpBinScoreEvaluator.scala) bins the
positive-class scores into ``num_bins`` equal-width bins on [0, 1] and
reports each bin's count, mean score and mean label, and the Brier score
(host numpy, the JAX package's code).
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from ..types.columns import PredictionColumn
from ..utils.device import resolve_device
from .base import EvaluationMetrics, OpEvaluatorBase

_N_BINS = 1024  # threshold groups (mllib BinaryClassificationMetrics bins
                # at ~1000 thresholds for big data the same way)


def _masked_rank_metrics_kernel(scores, y, w):
    """Batched AuROC + AuPR on the inputs' device: scores [B, n] float32
    (higher = more positive), y [n] in {0, 1}, w [B, n] 0/1 validation-row
    masks.  Scores quantize to 1024 threshold bins between each
    candidate's min and max over ALL n rows (masked or not, as the JAX
    package does); AuROC is the trapezoid over the binned ROC and AuPR the
    step-wise area, as the host evaluator's tie-grouped ``_roc_pr_areas``
    computes them when binning is lossless."""
    smin = scores.min(dim=1, keepdim=True).values
    smax = scores.max(dim=1, keepdim=True).values
    span = torch.clamp(smax - smin, min=1e-12)
    idx = torch.clamp(
        torch.floor((scores - smin) / span * (_N_BINS - 1) + 0.5).to(torch.int64),
        0, _N_BINS - 1,
    )
    w64 = w.to(torch.float64)
    y64 = y.to(torch.float64)[None, :]
    B = scores.shape[0]
    zeros = torch.zeros((B, _N_BINS), dtype=torch.float64, device=scores.device)
    hp = zeros.scatter_add(1, idx, w64 * y64).flip(1)  # descending score order
    hn = zeros.scatter_add(1, idx, w64 * (1.0 - y64)).flip(1)
    P = hp.sum(dim=1)
    N = hn.sum(dim=1)
    cum_p = torch.cumsum(hp, dim=1)                     # inclusive
    cum_n = torch.cumsum(hn, dim=1)
    cum_p_excl = cum_p - hp
    denom = torch.clamp(P * N, min=1e-12)[:, None]
    auroc = ((hn * (cum_p_excl + 0.5 * hp)) / denom).sum(dim=1)
    prec = cum_p / torch.clamp(cum_p + cum_n, min=1e-12)
    aupr = (hp * prec).sum(dim=1) / torch.clamp(P, min=1e-12)
    return auroc, aupr


def masked_rank_metrics(scores, y, val_masks, device=None):
    """Returns (auroc [B], aupr [B]) float64 numpy arrays for B candidates
    evaluated on their masked validation rows.  The computation runs on
    ``device``: by default the device of ``scores`` when it is a tensor,
    else ``"cuda"`` (raising when CUDA is missing); host inputs go there.
    Scores go in as float32, as in the JAX package.  Metrics are
    1024-threshold-binned (error O(1/1024) against the exact host
    evaluator)."""
    if device is None:
        device = scores.device if isinstance(scores, torch.Tensor) else "cuda"
    device = resolve_device(device)

    def _t(a, dtype):
        if isinstance(a, torch.Tensor):
            return a.to(device=device, dtype=dtype)
        return torch.as_tensor(np.asarray(a), device=device).to(dtype)

    a, p = _masked_rank_metrics_kernel(
        _t(scores, torch.float32), _t(y, torch.float32),
        _t(val_masks, torch.float32),
    )
    return a.cpu().numpy(), p.cpu().numpy()


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


@dataclass
class BinScoreMetrics(EvaluationMetrics):
    bin_centers: list = field(default_factory=list)
    n_per_bin: list = field(default_factory=list)
    avg_score_per_bin: list = field(default_factory=list)
    avg_label_per_bin: list = field(default_factory=list)
    brier_score: float = 0.0


class OpBinScoreEvaluator(OpEvaluatorBase):
    """Score-bin calibration (reference: OpBinScoreEvaluator.scala)."""

    metric_name = "brier_score"
    larger_better = False

    def __init__(self, num_bins: int = 100) -> None:
        self.num_bins = num_bins

    def evaluate_arrays(self, y, pred: PredictionColumn):
        score = (
            pred.probability[:, 1]
            if pred.probability is not None and pred.probability.shape[1] > 1
            else pred.prediction
        )
        edges = np.linspace(0.0, 1.0, self.num_bins + 1)
        which = np.clip(np.digitize(score, edges) - 1, 0, self.num_bins - 1)
        centers, counts, avg_s, avg_y = [], [], [], []
        for b in range(self.num_bins):
            m = which == b
            centers.append(float((edges[b] + edges[b + 1]) / 2))
            counts.append(int(m.sum()))
            avg_s.append(float(score[m].mean()) if m.any() else 0.0)
            avg_y.append(float(y[m].mean()) if m.any() else 0.0)
        brier = float(np.mean((score - y) ** 2))
        return BinScoreMetrics(
            bin_centers=centers, n_per_bin=counts,
            avg_score_per_bin=avg_s, avg_label_per_bin=avg_y,
            brier_score=brier,
        )
