"""Naive Bayes classifier.

Counterpart of OpNaiveBayes (reference: core/.../impl/classification/
OpNaiveBayes.scala wrapping Spark MLlib multinomial NaiveBayes, smoothing
1.0) and of ``transmogrifai_tpu/models/naive_bayes.py``.  The fit is closed
form in float32 on the estimator's ``device``: one matmul for the
per-class feature sums and the log posteriors vectorized.  Multinomial
over non-negative features; negative inputs are shifted per feature by the
training rows' minimum (the vectorizers emit one-hot and count columns, so
the transmogrified inputs are non-negative already).
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from ..utils.device import resolve_device
from .base import PredictorEstimator
from .logistic_regression import _f32


def _nb_fit(X: torch.Tensor, onehot: torch.Tensor, w: torch.Tensor,
            smoothing: float):
    """(theta [K, d], log prior [K], shift [d]) of one weighted fit."""
    # non-negativity shift from TRAIN rows only (w > 0): a held-out fold's
    # outlier must not move the multinomial offsets of other folds
    train = (w > 0)[:, None]
    shift = torch.clamp(
        torch.where(train, X, torch.full_like(X, float("inf"))).amin(dim=0),
        max=0.0)
    Xs = X - shift
    cw = onehot * w[:, None]                       # [n, K]
    feat = cw.T @ Xs                               # [K, d]
    class_w = cw.sum(dim=0)                        # [K]
    theta = torch.log(feat + smoothing) - torch.log(
        (feat + smoothing).sum(dim=1, keepdim=True))
    prior = torch.log(class_w / torch.clamp(class_w.sum(), min=1e-12))
    return theta, prior, shift


class OpNaiveBayes(PredictorEstimator):
    model_type = "OpNaiveBayes"

    def __init__(self, smoothing: float = 1.0, device: str = "cuda",
                 **kw) -> None:
        super().__init__(device=device, **kw)
        self.params.setdefault("smoothing", smoothing)

    def _onehot(self, y, dev: torch.device):
        classes = np.unique(y)
        onehot = (np.asarray(y)[:, None] == classes[None, :]).astype(np.float32)
        return classes, _f32(onehot, dev)

    def fit_arrays(self, X, y, w=None) -> Any:
        w = np.ones(len(y)) if w is None else w
        return self.fit_arrays_folds(X, y, np.asarray(w)[None, :])[0]

    def fit_arrays_folds(self, X, y, W) -> list:
        """CV fan-out: one closed-form fit per weight row of W [F, n] over
        one upload of X.  The non-negativity shift is each fold's own (its
        train rows); the class set is the full data's label set, as the JAX
        package fixes it (in the reference the multinomial class count is
        likewise fixed by the label indexer, not re-derived per fold)."""
        dev = resolve_device(self.device)
        classes, onehot = self._onehot(y, dev)
        X_d, W_d = _f32(X, dev), _f32(W, dev)
        smoothing = float(np.float32(self.params["smoothing"]))
        out = []
        for f in range(W_d.shape[0]):
            theta, prior, shift = _nb_fit(X_d, onehot, W_d[f], smoothing)
            out.append({"theta": theta.cpu().numpy(),
                        "prior": prior.cpu().numpy(),
                        "classes": classes,
                        "shift": shift.cpu().numpy()})
        return out

    def predict_arrays(self, params: Any, X: np.ndarray):
        dev = resolve_device(self.device)
        raw = (_f32(X - params["shift"], dev) @ _f32(params["theta"], dev).T
               + _f32(params["prior"], dev)[None, :])   # [n, K] log posterior
        prob = torch.softmax(raw, dim=1)
        raw = raw.cpu().numpy().astype(np.float64)
        prob = prob.cpu().numpy().astype(np.float64)
        pred = params["classes"][np.argmax(prob, axis=1)].astype(np.float64)
        return pred, raw, prob

    def predict_arrays_np(self, params: Any, X: np.ndarray):
        raw = (X - params["shift"]) @ params["theta"].T + params["prior"][None, :]
        ex = np.exp(raw - raw.max(axis=1, keepdims=True))
        prob = ex / ex.sum(axis=1, keepdims=True)
        pred = params["classes"][np.argmax(prob, axis=1)].astype(np.float64)
        return pred, raw, prob
