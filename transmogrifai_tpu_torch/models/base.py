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

Serving adds two scoring routes per family, both gated on the family's
``lowerable`` opt-in: ``predict_arrays_np`` (pure numpy, the local
scorer's interpreted and numpy-fused route) and ``predict_arrays_torch``
(torch ops on the device program's tensors, the JAX package's
``predict_arrays_xla``).  A family prepares its fitted params for the
device once per device through ``torch_params``.
"""
from __future__ import annotations

from typing import Any, Optional, Sequence

import numpy as np
import torch

from ..stages.base import (
    PROB_SUFFIX,
    RAW_SUFFIX,
    Estimator,
    Lowering,
    TorchLowering,
    Transformer,
)
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
        self.holdout_metrics: Optional[dict] = None

    #: when True, scoring uses the estimator's pure-numpy predict path -
    #: set by the local scorer (local/scorer.py) on its own copies of the
    #: predictor stages, so an interpreted row never dispatches to a device
    prefer_numpy = False

    def transform_columns(self, cols: Sequence[Column], ds: Dataset) -> Column:
        vec = cols[-1]
        assert isinstance(vec, VectorColumn)
        predict = (
            self.estimator_ref.predict_arrays_np
            if self.prefer_numpy
            else self.estimator_ref.predict_arrays
        )
        pred, raw, prob = predict(
            self.model_params, np.asarray(vec.values, dtype=np.float64)
        )
        return PredictionColumn(pred, raw, prob)

    # interpretability hooks (reference: ModelInsights contributions)
    def feature_contributions(self) -> Optional[np.ndarray]:
        return self.estimator_ref.contributions(self.model_params)

    def lower(self) -> Optional[Lowering]:
        """Compile the fitted head to one closed-over array call through
        the estimator family's pure-numpy predict path.  Gated on the
        family's ``lowerable`` opt-in."""
        est = self.estimator_ref
        if not getattr(est, "lowerable", False):
            return None
        vec_name = self.input_features[-1].name
        out = self.output_name
        params = self.model_params
        # the interpreted path feeds predict float64; families whose
        # kernel is float32-exact (trees: the first predict step is a
        # float32 binning, and f32->f64->f32 is the identity) skip the
        # float64 round trip without changing a single output bit
        in_dtype = (
            np.float32 if getattr(est, "predict_f32_exact", False)
            else np.float64
        )

        def fn(env: dict) -> dict:
            pred, raw, prob = est.predict_arrays_np(
                params, np.asarray(env[vec_name], dtype=in_dtype)
            )
            # PredictionColumn's canonical shapes: pred flat float64,
            # raw/prob [n, k] float64
            res = {out: np.asarray(pred, dtype=np.float64).reshape(-1)}
            if raw is not None:
                raw = np.asarray(raw, dtype=np.float64)
                res[out + RAW_SUFFIX] = (
                    raw[:, None] if raw.ndim == 1 else raw
                )
            if prob is not None:
                prob = np.asarray(prob, dtype=np.float64)
                res[out + PROB_SUFFIX] = (
                    prob[:, None] if prob.ndim == 1 else prob
                )
            return res

        # raw/prob presence is fixed by the fitted family but not knowable
        # here without running predict, so only the guaranteed key is
        # declared; the result assembler reads the suffixed keys tolerantly
        return Lowering(
            fn=fn, inputs=(vec_name,),
            outputs=(out,),
            signature={out: "float64[n]"},
        )

    def lower_torch(self) -> Optional[TorchLowering]:
        """Compile the fitted head to a torch call through the family's
        ``predict_arrays_torch`` mirror of its numpy predict path, over
        params the family prepares once per device (``torch_params``).
        Gated on the ``lowerable`` opt-in and on the family providing the
        mirror - a family without one keeps the whole pipeline on the
        numpy-fused path."""
        est = self.estimator_ref
        predict_torch = getattr(est, "predict_arrays_torch", None)
        if not getattr(est, "lowerable", False) or predict_torch is None:
            return None
        vec_name = self.input_features[-1].name
        out = self.output_name
        params = self.model_params
        in_dtype = (
            torch.float32 if getattr(est, "predict_f32_exact", False)
            else torch.float64
        )
        on_device: dict = {}  # device -> the params prepared there

        def fn(env: dict) -> dict:
            X = env[vec_name]
            tparams = on_device.get(X.device)
            if tparams is None:
                tparams = on_device[X.device] = est.torch_params(
                    params, X.device)
            pred, raw, prob = predict_torch(tparams, X.to(in_dtype))
            res = {out: pred.to(torch.float64).reshape(-1)}
            if raw is not None:
                raw = raw.to(torch.float64)
                res[out + RAW_SUFFIX] = raw[:, None] if raw.dim() == 1 else raw
            if prob is not None:
                prob = prob.to(torch.float64)
                res[out + PROB_SUFFIX] = (
                    prob[:, None] if prob.dim() == 1 else prob
                )
            return res

        return TorchLowering(
            fn=fn, inputs=(vec_name,),
            outputs=(out,),
            signature={out: "float64[n]"},
        )


class PredictorEstimator(Estimator):
    """Base estimator over (label, features).  ``device`` is where its
    torch computations run; ``OpWorkflow`` overrides it with its own."""

    input_types = [RealNN, OPVector]
    output_type = Prediction
    model_type: str = "Predictor"
    #: opt-in to whole-pipeline fused compilation (local/fused.py): True
    #: promises ``predict_arrays_np`` is a pure host-side function of
    #: (params, X) safe to close over in a per-shape-bucket program
    lowerable: bool = False
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
        already host-side.  Every ``lowerable`` family overrides it with
        the JAX package's numpy path."""
        return self.predict_arrays(params, X)

    def torch_params(self, params: Any, device: torch.device) -> Any:
        """The fitted ``params`` as ``predict_arrays_torch`` reads them on
        ``device``: host arrays copied there once, when a device program
        first scores on it."""
        return params

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
