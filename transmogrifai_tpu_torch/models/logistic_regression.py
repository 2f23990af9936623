"""Logistic regression trained by Newton/IRLS in torch.

Counterpart of OpLogisticRegression (reference: core/.../impl/
classification/OpLogisticRegression.scala:43-75, training done inside Spark
MLlib's LBFGS/OWL-QN) and of ``transmogrifai_tpu/models/
logistic_regression.py``'s binary route:

* the fit is a fixed number of Newton steps over the dense [n, d] design
  matrix on the estimator's ``device``, in float32 (the JAX package's
  float32 arithmetic: with x64 off, ``jnp.asarray`` of its float64 inputs
  gives float32), each step a couple of matmuls and a [d, d] Cholesky
  solve;
* features are standardized inside the step (Spark standardization=true
  semantics) and coefficients folded back to raw scale;
* elastic-net L1 is handled with iterated reweighted approximation.

The Hessian stays float32: the JAX package's bf16 Hessian is a TPU-only
choice.  Multiclass families (softmax, one-vs-rest) and the batched CV
fan-out come with the model-selector slice (ROADMAP.md queue 1, item 5).
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from ..utils.device import resolve_device
from .base import PredictorEstimator
from .packed_newton import guarded_step, pd_jitter, run_newton, solve_pos


def lr_newton_core(
    X: torch.Tensor,
    y: torch.Tensor,
    w: torch.Tensor,
    reg: torch.Tensor,
    elastic_net: torch.Tensor,
    iters: int = 25,
):
    """Weighted L2(+approx L1) logistic regression via Newton/IRLS.

    X: [n, d] WITHOUT intercept column; y: [n] in {0,1}; w: [n] sample
    weights; reg: 0-d regParam; elastic_net: 0-d alpha in [0,1] - all on
    one device, in one float dtype.  Returns (beta [d], intercept 0-d) on
    the raw feature scale.
    """
    n, d = X.shape
    wsum = w.sum()
    # GLOBAL pre-centering: the folded-standardization identities below
    # compute centered moments by subtracting outer products, which
    # catastrophically cancels in f32 when |mean| >> std
    m0 = X.mean(dim=0)
    X = X - m0
    mu = (w @ X) / wsum
    msq = (w @ (X * X)) / wsum
    var = msq - mu**2
    # (near-)constant-under-w columns are EXCLUDED like Spark's std==0
    # handling (coefficient pinned to 0)
    active = var > 1e-6 * msq + 1e-30
    activef = active.to(X.dtype)
    sd = torch.where(active, torch.sqrt(torch.clamp(var, min=1e-12)),
                     torch.ones_like(var))
    # Standardization is folded into the algebra instead of materializing a
    # standardized copy of X:
    #   Xs = (X - mu) D^{-1},  D = diag(sd)
    #   Xs^T r = D^{-1} (X^T r - mu sum(r))
    #   Xs^T W Xs = D^{-1} (X^T W X - mu a^T - a mu^T + s mu mu^T) D^{-1},
    #     a = X^T W 1, s = 1^T W 1
    lam_l2 = reg * (1.0 - elastic_net)
    lam_l1 = reg * elastic_net
    eps = 1e-8
    eye = torch.eye(d, dtype=X.dtype, device=X.device)

    def step(carry):
        beta, b0 = carry  # beta in standardized space
        gamma = beta / sd
        z = X @ gamma + (b0 - mu @ gamma)
        p = torch.sigmoid(z)
        wt = w * p * (1.0 - p) + eps
        resid = w * (p - y)
        l1_diag = lam_l1 / (beta.abs() + 1e-3)
        Xr = X.T @ resid
        sr = resid.sum()
        g = ((Xr - mu * sr) / sd / wsum + (lam_l2 + l1_diag) * beta) * activef
        XtWX = X.T @ (X * wt[:, None])
        a = wt @ X
        s = wt.sum()
        Hs = (
            XtWX - torch.outer(mu, a) - torch.outer(a, mu)
            + s * torch.outer(mu, mu)
        ) / torch.outer(sd, sd) / wsum
        # curvature-relative, dimension-aware PD jitter + guarded step
        jitter = pd_jitter(torch.trace(Hs) / d, d)
        # excluded columns: identity row/col so the solve leaves them 0
        Hs_m = Hs * torch.outer(activef, activef)
        H = (
            Hs_m + torch.diag(lam_l2 + l1_diag)
            + jitter * eye
            + torch.diag(1.0 - activef)
        )
        g0 = sr / wsum
        h0 = s / wsum
        delta = guarded_step(solve_pos(H, g), g)
        return beta - delta, b0 - g0 / h0

    beta_s, b0 = run_newton(
        step,
        (torch.zeros(d, dtype=X.dtype, device=X.device),
         torch.zeros((), dtype=X.dtype, device=X.device)),
        iters,
    )
    beta = beta_s / sd
    intercept = b0 - ((mu + m0) * beta).sum()  # un-center the intercept
    return beta, intercept


def _lr_predict(X: torch.Tensor, beta: torch.Tensor, intercept: torch.Tensor):
    z = X @ beta + intercept
    p1 = torch.sigmoid(z)
    prob = torch.stack([1.0 - p1, p1], dim=1)
    raw = torch.stack([-z, z], dim=1)
    pred = (p1 > 0.5).to(z.dtype)
    return pred, raw, prob


def _f32(a, device: torch.device) -> torch.Tensor:
    """Host array or scalar -> float32 tensor on ``device`` (a copy: the
    input may be a read-only view)."""
    return torch.tensor(np.asarray(a, dtype=np.float32), device=device)


class OpLogisticRegression(PredictorEstimator):
    """(reference: OpLogisticRegression.scala; default grid in
    DefaultSelectorParams.scala:36-61 - regParam {0.001,0.01,0.1,0.2},
    elasticNet {0.1,0.5})"""

    model_type = "OpLogisticRegression"

    def __init__(
        self,
        reg_param: float = 0.0,
        elastic_net_param: float = 0.0,
        max_iter: int = 25,
        fit_intercept: bool = True,
        family: str = "auto",
        device: str = "cuda",
        **kw,
    ) -> None:
        super().__init__(device=device, **kw)
        self.params.setdefault("reg_param", reg_param)
        self.params.setdefault("elastic_net_param", elastic_net_param)
        self.params.setdefault("max_iter", max_iter)
        self.params.setdefault("fit_intercept", fit_intercept)
        fam = str(family).lower()
        if fam not in ("auto", "binomial", "multinomial", "ovr"):
            raise ValueError(f"unknown logistic family: {family!r}")
        self.params.setdefault("family", fam)

    def fit_arrays(self, X, y, w=None):
        n = len(y)
        w = np.ones(n) if w is None else w
        classes = np.unique(np.asarray(y))
        if len(classes) > 2:
            raise NotImplementedError(
                f"multiclass logistic regression ({len(classes)} label "
                "classes) is not ported to the torch package yet "
                "(ROADMAP.md queue 1, item 5)"
            )
        dev = resolve_device(self.device)
        beta, b0 = lr_newton_core(
            _f32(X, dev), _f32(y, dev), _f32(w, dev),
            _f32(self.params["reg_param"], dev),
            _f32(self.params["elastic_net_param"], dev),
            iters=int(self.params["max_iter"]),
        )
        return {"beta": beta.cpu().numpy(), "intercept": float(b0)}

    def predict_arrays(self, params: Any, X: np.ndarray):
        if "betas" in params:
            raise NotImplementedError(
                "multiclass logistic regression scoring is not ported to "
                "the torch package yet (ROADMAP.md queue 1, item 5)"
            )
        dev = resolve_device(self.device)
        pred, raw, prob = _lr_predict(
            _f32(X, dev), _f32(params["beta"], dev),
            _f32(params["intercept"], dev),
        )
        return tuple(
            t.cpu().numpy().astype(np.float64) for t in (pred, raw, prob)
        )
