"""Evaluator base + factory.

Counterpart of OpEvaluatorBase / Evaluators factory (reference: core/.../
evaluators/Evaluators.scala:40-260, OpEvaluatorBase hierarchy): evaluators
consume a scored Dataset (label column + Prediction column) and return a
typed metrics object serializable to JSON.
"""
from __future__ import annotations

from dataclasses import asdict, dataclass

import numpy as np

from ..types.columns import NumericColumn, PredictionColumn
from ..types.dataset import Dataset


@dataclass
class EvaluationMetrics:
    def to_json(self) -> dict:
        return asdict(self)


class OpEvaluatorBase:
    """metric_name: the default metric; larger_better drives model selection
    direction (reference: OpEvaluatorBase.isLargerBetter)."""

    metric_name: str = "metric"
    larger_better: bool = True

    def evaluate(self, ds: Dataset, label_col: str, pred_col: str) -> EvaluationMetrics:
        label = ds[label_col]
        pred = ds[pred_col]
        assert isinstance(label, NumericColumn)
        assert isinstance(pred, PredictionColumn)
        return self.evaluate_arrays(
            np.asarray(label.values, dtype=np.float64), pred
        )

    def evaluate_arrays(
        self, y: np.ndarray, pred: PredictionColumn
    ) -> EvaluationMetrics:
        raise NotImplementedError

    def default_metric(self, metrics: EvaluationMetrics) -> float:
        return float(getattr(metrics, self.metric_name))
