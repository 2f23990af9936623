"""Multiclass classification evaluation.

Counterpart of OpMultiClassificationEvaluator (reference: core/.../
evaluators/OpMultiClassificationEvaluator.scala:79-151): weighted
precision/recall/F1/error plus ThresholdMetrics - correct/incorrect/
no-prediction counts per topN in {1, 3} across a confidence-threshold grid
0..1 step 0.01.  A host (numpy) copy of
``transmogrifai_tpu/evaluators/multiclass.py``: its metrics are bit-equal
to the JAX package's on the same inputs.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..types.columns import PredictionColumn
from .base import EvaluationMetrics, OpEvaluatorBase


@dataclass
class ThresholdMetrics(EvaluationMetrics):
    topns: list = field(default_factory=list)
    thresholds: list = field(default_factory=list)
    correct_counts: dict = field(default_factory=dict)
    incorrect_counts: dict = field(default_factory=dict)
    no_prediction_counts: dict = field(default_factory=dict)


@dataclass
class MultiClassificationMetrics(EvaluationMetrics):
    Precision: float = 0.0
    Recall: float = 0.0
    F1: float = 0.0
    Error: float = 0.0
    threshold_metrics: dict = field(default_factory=dict)


class OpMultiClassificationEvaluator(OpEvaluatorBase):
    metric_name = "F1"
    larger_better = True

    def __init__(self, topns=(1, 3), threshold_step: float = 0.01) -> None:
        self.topns = tuple(topns)
        self.threshold_step = threshold_step

    def evaluate_arrays(self, y, pred: PredictionColumn):
        yhat = pred.prediction
        n = len(y)
        classes = np.unique(np.concatenate([y, yhat]))
        # weighted precision/recall (Spark MulticlassMetrics semantics)
        precisions, recalls, weights = [], [], []
        for c in classes:
            tp = float(((yhat == c) & (y == c)).sum())
            fp = float(((yhat == c) & (y != c)).sum())
            fn = float(((yhat != c) & (y == c)).sum())
            p = tp / (tp + fp) if tp + fp > 0 else 0.0
            r = tp / (tp + fn) if tp + fn > 0 else 0.0
            precisions.append(p)
            recalls.append(r)
            weights.append(float((y == c).sum()) / n)
        precision = float(np.dot(precisions, weights))
        recall = float(np.dot(recalls, weights))
        f1 = (
            2 * precision * recall / (precision + recall)
            if precision + recall > 0
            else 0.0
        )
        error = float((yhat != y).sum()) / max(n, 1)

        tm: dict = {}
        if pred.probability is not None and pred.probability.shape[1] >= 2:
            prob = pred.probability
            ths = np.arange(0.0, 1.0 + 1e-9, self.threshold_step)
            order = np.argsort(-prob, axis=1)
            sorted_prob = np.take_along_axis(prob, order, axis=1)
            correct: dict = {}
            incorrect: dict = {}
            nopred: dict = {}
            for topn in self.topns:
                k = min(topn, prob.shape[1])
                topk_classes = order[:, :k].astype(np.float64)
                top_conf = sorted_prob[:, 0]
                hit = (topk_classes == y[:, None]).any(axis=1)
                ccounts, icounts, ncounts = [], [], []
                for t in ths:
                    confident = top_conf >= t
                    ccounts.append(int((confident & hit).sum()))
                    icounts.append(int((confident & ~hit).sum()))
                    ncounts.append(int((~confident).sum()))
                correct[str(topn)] = ccounts
                incorrect[str(topn)] = icounts
                nopred[str(topn)] = ncounts
            tm = ThresholdMetrics(
                topns=list(self.topns), thresholds=ths.tolist(),
                correct_counts=correct, incorrect_counts=incorrect,
                no_prediction_counts=nopred,
            ).to_json()
        return MultiClassificationMetrics(
            Precision=precision, Recall=recall, F1=f1, Error=error,
            threshold_metrics=tm,
        )
