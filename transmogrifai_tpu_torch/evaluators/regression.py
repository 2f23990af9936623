"""Regression evaluation.

Counterpart of OpRegressionEvaluator + OPLogLoss (reference: core/.../
evaluators/OpRegressionEvaluator.scala, core/.../impl/evaluator/
OPLogLoss.scala): RMSE/MSE/R2/MAE.  A host (numpy) copy of
``transmogrifai_tpu/evaluators/regression.py``: its metrics are bit-equal
to the JAX package's on the same inputs.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..types.columns import PredictionColumn
from .base import EvaluationMetrics, OpEvaluatorBase


@dataclass
class RegressionMetrics(EvaluationMetrics):
    RootMeanSquaredError: float = 0.0
    MeanSquaredError: float = 0.0
    R2: float = 0.0
    MeanAbsoluteError: float = 0.0


class OpRegressionEvaluator(OpEvaluatorBase):
    metric_name = "RootMeanSquaredError"
    larger_better = False

    def evaluate_arrays(self, y, pred: PredictionColumn):
        yhat = pred.prediction
        err = y - yhat
        mse = float(np.mean(err**2))
        mae = float(np.mean(np.abs(err)))
        ss_tot = float(np.sum((y - y.mean()) ** 2))
        r2 = 1.0 - float(np.sum(err**2)) / ss_tot if ss_tot > 0 else 0.0
        return RegressionMetrics(
            RootMeanSquaredError=float(np.sqrt(mse)),
            MeanSquaredError=mse, R2=r2, MeanAbsoluteError=mae,
        )


@dataclass
class LogLossMetrics(EvaluationMetrics):
    LogLoss: float = 0.0


class OpLogLossEvaluator(OpEvaluatorBase):
    """Multiclass log loss (reference: OPLogLoss.scala)."""

    metric_name = "LogLoss"
    larger_better = False

    def evaluate_arrays(self, y, pred: PredictionColumn):
        if pred.probability is None:
            raise ValueError("log loss needs probabilities")
        p = np.clip(pred.probability, 1e-15, 1.0)
        idx = y.astype(int)
        ll = -float(np.mean(np.log(p[np.arange(len(y)), idx])))
        return LogLossMetrics(LogLoss=ll)
