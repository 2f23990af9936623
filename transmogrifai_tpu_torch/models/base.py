"""Predictor stage bases.

Counterpart of the reference's OpPredictorWrapper / OpPredictionModel
machinery (reference: core/.../stages/sparkwrappers/specific/
OpPredictorWrapper.scala:67-90, SparkModelConverter.scala): a predictor
estimator takes (label RealNN, features OPVector) and produces a Prediction
column.  Predictors implement two array-level methods and everything else
is shared:

* ``fit_arrays(X, y, w) -> params`` - train on [n, d] + [n] (+ sample
  weights), as torch computations on the estimator's ``device``;
* ``predict_arrays(params, X) -> (pred, raw, prob)`` - batched scoring.

Sample weights thread through every fit so splitter rebalancing and CV
fold membership are weight masks, not data copies.  ``with_params``,
``hyper_params`` and ``batched_needs_binary_y`` are what the model
selector calls on every candidate.

The JAX package's ``lower``/``lower_xla`` seams come with the fused-scoring
slice (ROADMAP.md queue 1, item 7).
"""
from __future__ import annotations

from typing import Any, Optional, Sequence

import numpy as np
import torch

from ..stages.base import Estimator, Transformer
from ..types.columns import Column, NumericColumn, PredictionColumn, VectorColumn
from ..types.dataset import Dataset
from ..types.feature_types import OPVector, Prediction, RealNN


def _check_label_mask(label: NumericColumn, stage) -> None:
    """Missing labels must fail loudly at EVERY predictor fit - raw
    responses are gated at train() time, but a derived label (e.g. a
    string response through StringIndexer) reaches here with its own
    mask."""
    if not bool(label.mask.all()):
        n_bad = int((~label.mask).sum())
        raise ValueError(
            f"label input of {type(stage).__name__} ({stage.uid}) has "
            f"{n_bad} missing values; labels cannot be imputed - drop "
            "those rows before training"
        )


class PredictorModel(Transformer):
    """Fitted predictor: holds opaque params + the predict function."""

    input_types = [RealNN, OPVector]
    output_type = Prediction

    def __init__(self, estimator: "PredictorEstimator", params: Any, **kw) -> None:
        super().__init__(**kw)
        self.estimator_ref = estimator
        self.model_params = params

    def transform_columns(self, cols: Sequence[Column], ds: Dataset) -> Column:
        vec = cols[-1]
        assert isinstance(vec, VectorColumn)
        pred, raw, prob = self.estimator_ref.predict_arrays(
            self.model_params, np.asarray(vec.values, dtype=np.float64)
        )
        return PredictionColumn(pred, raw, prob)

    # interpretability hooks (reference: ModelInsights contributions)
    def feature_contributions(self) -> Optional[np.ndarray]:
        return self.estimator_ref.contributions(self.model_params)


class PredictorEstimator(Estimator):
    """Base estimator over (label, features).  ``device`` is where its
    torch computations run; ``OpWorkflow`` overrides it with its own."""

    input_types = [RealNN, OPVector]
    output_type = Prediction
    model_type: str = "Predictor"
    # Whether fit_arrays_batched's kernel assumes y in {0,1}: classifiers
    # keep the conservative True so multiclass labels take the validator's
    # per-candidate route; regressors override it to False.
    batched_needs_binary_y: bool = True

    def __init__(self, device: str = "cuda", **kw) -> None:
        super().__init__(**kw)
        self.device = str(device)

    def _check_binary_labels(self, y, hint: str = "") -> None:
        """Binary-loss kernels must fail loudly on labels they cannot
        represent - >2 classes OR values outside {0,1} (y in {1,2} passes
        a count-only check yet maps both classes to the positive side).
        Device-resident labels skip the scan: pulling a label column off
        the card to check it would stall the fit."""
        if isinstance(y, torch.Tensor):
            return
        vals = np.unique(np.asarray(y))
        if len(vals) > 2:
            raise ValueError(
                f"{self.model_type} supports only binary classification; "
                f"the label column has {len(vals)} classes{hint}"
            )
        if len(vals) and not np.isin(vals, (0.0, 1.0)).all():
            raise ValueError(
                f"{self.model_type} expects labels in {{0, 1}}; got "
                f"values {vals.tolist()} (index the label first)"
            )

    def fit_arrays(
        self, X: np.ndarray, y: np.ndarray, w: Optional[np.ndarray] = None
    ) -> Any:
        raise NotImplementedError

    def predict_arrays(self, params: Any, X: np.ndarray):
        raise NotImplementedError

    def predict_arrays_np(self, params: Any, X: np.ndarray):
        """Pure-numpy scoring; the default assumes ``predict_arrays`` is
        already host-side."""
        return self.predict_arrays(params, X)

    def contributions(self, params: Any) -> Optional[np.ndarray]:
        return None

    def hyper_params(self) -> dict:
        """Hyperparameters relevant to model selection grids."""
        return dict(self.params)

    def with_params(self, **hp) -> "PredictorEstimator":
        """A copy with ``hp`` merged into its params; it keeps ``device``."""
        clone = self.copy()
        clone.params = dict(self.params)
        clone.params.update(hp)
        return clone

    def fit_model(self, cols: Sequence[Column], ds: Dataset):
        label, vec = cols
        assert isinstance(label, NumericColumn)
        assert isinstance(vec, VectorColumn)
        if len(label) == 0:
            raise ValueError("cannot fit on empty dataset")
        _check_label_mask(label, self)
        params = self.fit_arrays(
            np.asarray(vec.values, dtype=np.float64),
            np.asarray(label.values, dtype=np.float64),
        )
        return PredictorModel(self, params)
