"""Linear SVM classifier (squared hinge, L2) trained by Newton steps in torch.

Counterpart of OpLinearSVC (reference: core/.../impl/classification/
OpLinearSVC.scala wrapping Spark MLlib LinearSVC - hinge loss + OWLQN) and
of ``transmogrifai_tpu/models/linear_svc.py``: the squared hinge keeps the
objective twice differentiable, so the fit is logistic regression's
Newton/solve pattern (``packed_newton.run_newton``, ``pd_jitter``,
``guarded_step``, ``solve_pos``) in float32 on the estimator's ``device``,
with the standardization folded into the algebra and the coefficients
folded back to the raw scale.

``svc_fit_batched_core`` fits B candidates (fold x grid weight vectors
W [B, n], each with its own regParam) over one shared design matrix as one
explicitly batched Newton loop, as ``lr_fit_batched_core`` does: every
[B, n] quantity is one matmul against the shared X, and each candidate's
Hessian Gram is its own ``X.T @ (X * act_b[:, None])`` with an [n, d]
temporary, never a [B, n, d] one.  The JAX package's MXU-packed Gram and
bf16 Hessian are TPU-only routes and are not here.

The SVM has no probability: scoring gives the 0/1 prediction and the
margins ``[-z, z]``, so the host evaluator ranks the prediction while the
validator's device rank metrics rank the margins, as in the JAX package.
"""
from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch

from ..utils.device import resolve_device
from .base import PredictorEstimator
from .logistic_regression import _f32, _f64
from .packed_newton import (
    _batched_diag,
    guarded_step,
    pd_jitter,
    run_newton,
    solve_pos,
)

#: the SVM's PD-safety ridge floor (the JAX package's ``base=1e-8``)
_JITTER_BASE = 1e-8


def svc_newton_core(
    X: torch.Tensor,
    y: torch.Tensor,
    w: torch.Tensor,
    reg: torch.Tensor,
    iters: int = 20,
):
    """Weighted L2 squared-hinge SVM via Newton steps over the active set.

    X: [n, d] WITHOUT intercept column; y: [n] in {0,1}; w: [n] sample
    weights; reg: 0-d regParam - all on one device, in one float dtype.
    Returns (beta [d], intercept 0-d) on the raw feature scale."""
    n, d = X.shape
    ypm = 2.0 * y - 1.0  # {0,1} -> {-1,+1}
    wsum = torch.clamp(w.sum(), min=1e-12)
    # global pre-centering and inactive-column exclusion, as in
    # logistic_regression.lr_newton_core
    m0 = X.mean(dim=0)
    X = X - m0
    mu = (w @ X) / wsum
    msq = (w @ (X * X)) / wsum
    var = msq - mu**2
    active = var > 1e-6 * msq + 1e-30
    activef = active.to(X.dtype)
    sd = torch.where(active, torch.sqrt(torch.clamp(var, min=1e-12)),
                     torch.ones_like(var))
    eye = torch.eye(d, dtype=X.dtype, device=X.device)
    ridge = torch.diag(2.0 * reg * torch.ones(d, dtype=X.dtype, device=X.device))

    def step(carry):
        beta, b0 = carry  # beta in standardized space
        gamma = beta / sd
        margin = ypm * (X @ gamma + (b0 - mu @ gamma))
        act_rows = (margin < 1.0).to(X.dtype) * w
        # squared hinge: L = sum_active (1 - m)^2 / wsum + reg |beta|^2
        r = act_rows * (margin - 1.0) * ypm
        sr = r.sum()
        g = ((X.T @ r - mu * sr) / sd / wsum + 2.0 * reg * beta) * activef
        XtAX = X.T @ (X * act_rows[:, None])
        a = act_rows @ X
        s = act_rows.sum()
        Hs = (
            XtAX - torch.outer(mu, a) - torch.outer(a, mu)
            + s * torch.outer(mu, mu)
        ) / torch.outer(sd, sd) / wsum
        Hs = Hs * torch.outer(activef, activef)
        jitter = pd_jitter(torch.trace(Hs) / d, d, base=_JITTER_BASE)
        H = Hs + ridge + jitter * eye + torch.diag(1.0 - activef)
        g0 = sr / wsum
        h0 = s / wsum + 1e-8
        delta = guarded_step(solve_pos(H, g), g)
        return beta - delta, b0 - g0 / h0

    beta_s, b0 = run_newton(
        step,
        (torch.zeros(d, dtype=X.dtype, device=X.device),
         torch.zeros((), dtype=X.dtype, device=X.device)),
        iters,
    )
    beta = beta_s / sd
    return beta, b0 - ((mu + m0) * beta).sum()


def svc_fit_batched_core(
    X: torch.Tensor,
    y: torch.Tensor,
    W: torch.Tensor,
    regs: torch.Tensor,
    iters: int = 20,
    fixed_point: bool = False,
):
    """B squared-hinge fits in one Newton loop over the shared X [n, d]:
    W [B, n] per-candidate sample weights, regs [B].  Per candidate the
    math is :func:`svc_newton_core`'s; ``fixed_point`` ends the loop at
    the bitwise fixed point (the same betas).  Returns (betas [B, d],
    intercepts [B]) on the raw scale."""
    n, d = X.shape
    B = W.shape[0]
    ypm = 2.0 * y - 1.0
    wsum = torch.clamp(W.sum(dim=1), min=1e-12)[:, None]   # [B, 1]
    m0 = X.mean(dim=0)
    X = X - m0
    mu = (W @ X) / wsum                                    # [B, d]
    msq = (W @ (X * X)) / wsum
    var = msq - mu**2
    active = var > 1e-6 * msq + 1e-30
    activef = active.to(X.dtype)
    sd = torch.where(active, torch.sqrt(torch.clamp(var, min=1e-12)),
                     torch.ones_like(var))
    lam = regs[:, None]                                    # [B, 1]
    eye = torch.eye(d, dtype=X.dtype, device=X.device)
    amask = activef[:, :, None] * activef[:, None, :]
    sd2 = sd[:, :, None] * sd[:, None, :]
    mumu = mu[:, :, None] * mu[:, None, :]
    ridge = _batched_diag(2.0 * lam.expand(B, d))

    def step(carry):
        beta, b0 = carry  # [B, d] in standardized space, [B]
        gamma = beta / sd
        z = (X @ gamma.T).T + (b0 - (mu * gamma).sum(dim=1))[:, None]
        margin = ypm[None, :] * z                          # [B, n]
        act_rows = (margin < 1.0).to(X.dtype) * W
        r = act_rows * (margin - 1.0) * ypm[None, :]
        sr = r.sum(dim=1)
        g = ((r @ X - mu * sr[:, None]) / sd / wsum
             + 2.0 * lam * beta) * activef
        XtAX = torch.stack([X.T @ (X * act_rows[b][:, None]) for b in range(B)])
        a = act_rows @ X
        s = act_rows.sum(dim=1)
        Hs = (
            XtAX - mu[:, :, None] * a[:, None, :] - a[:, :, None] * mu[:, None, :]
            + s[:, None, None] * mumu
        ) / sd2 / wsum[:, :, None]
        Hs = Hs * amask
        jitter = pd_jitter(torch.diagonal(Hs, dim1=1, dim2=2).sum(dim=1) / d, d,
                           base=_JITTER_BASE)
        H = (Hs + ridge + jitter[:, None, None] * eye
             + _batched_diag(1.0 - activef))
        g0 = sr / wsum[:, 0]
        h0 = s / wsum[:, 0] + 1e-8
        delta = guarded_step(solve_pos(H, g), g, axis=1)
        return beta - delta, b0 - g0 / h0

    beta_s, b0 = run_newton(
        step,
        (torch.zeros((B, d), dtype=X.dtype, device=X.device),
         torch.zeros((B,), dtype=X.dtype, device=X.device)),
        iters, fixed_point,
    )
    beta = beta_s / sd
    return beta, b0 - ((mu + m0) * beta).sum(dim=1)


class OpLinearSVC(PredictorEstimator):
    """(reference: OpLinearSVC.scala; the selector's default grid is
    logistic regression's: regParam {0.001,0.01,0.1,0.2}, and the
    elasticNet values it also carries are ignored)"""

    model_type = "OpLinearSVC"
    lowerable = True
    #: the fused training program scores the validator's own rows in their
    #: dtype (the host margin head's), not its float32 device copy
    fused_score_rows = "source"

    def __init__(self, reg_param: float = 0.0, max_iter: int = 20,
                 device: str = "cuda", **kw) -> None:
        super().__init__(device=device, **kw)
        self.params.setdefault("reg_param", reg_param)
        self.params.setdefault("max_iter", max_iter)

    def fit_arrays(self, X, y, w=None) -> Any:
        # Spark contract: 'LinearSVC only supports binary classification'
        self._check_binary_labels(y)
        n = len(y)
        w = np.ones(n) if w is None else w
        dev = resolve_device(self.device)
        beta, b0 = svc_newton_core(
            _f32(X, dev), _f32(y, dev), _f32(w, dev),
            _f32(float(self.params.get("reg_param", 0.0)), dev),
            iters=int(self.params.get("max_iter", 20)),
        )
        return {"beta": beta.cpu().numpy(), "intercept": float(b0)}

    def fit_arrays_batched(self, X, y, W, regs, ens):
        """Batched fit: W [B, n] weight masks, regs [B] -> (betas [B, d],
        intercepts [B]) as numpy; the whole CV fold x grid fan-out as one
        Newton loop (the contract of
        ``OpLogisticRegression.fit_arrays_batched``; the SVM has no
        elastic-net term, so ``ens`` is accepted and ignored).  Inputs may
        be host arrays or tensors; they go to the estimator's device as
        float32 (a tensor already there is not copied)."""
        self._check_binary_labels(y)
        dev = resolve_device(self.device)
        beta, b0 = svc_fit_batched_core(
            _f32(X, dev), _f32(y, dev), _f32(W, dev), _f32(regs, dev),
            iters=int(self.params.get("max_iter", 20)),
        )
        return beta.cpu().numpy(), b0.cpu().numpy()

    def fused_train_core(self, packed: bool = False):
        """The fused training program's seam (the contract of
        ``OpLogisticRegression.fused_train_core``).  The SVM has no
        probability, so the evaluator ranks its 0/1 prediction: ``score``
        is ``predict_arrays``' margin sign over the validator's own rows
        (``fused_score_rows``: float64 for a float64 host X), in their
        dtype, as the host head computes it."""
        if packed:
            raise ValueError("the MXU-packed Gram is a TPU-only route")
        iters = int(self.params.get("max_iter", 20))

        def fit(X, y, W, regs, ens):
            return svc_fit_batched_core(X, y, W, regs, iters,
                                        fixed_point=True)

        def score(X, beta, b0):
            z = X @ beta.to(X.dtype) + b0.to(X.dtype)
            return (z > 0).to(torch.float64)

        return {"fit": fit, "score": score,
                "sig": ("svc", iters, packed, False)}

    def predict_arrays(self, params: Any, X: np.ndarray):
        """The margin head on the host in float64, as the JAX package's:
        (0/1 prediction, margins [-z, z], no probability)."""
        z = X @ params["beta"] + params["intercept"]
        pred = (z > 0).astype(np.float64)
        raw = np.stack([-z, z], axis=1)
        return pred, raw, None

    def torch_params(self, params: Any, device: torch.device) -> dict:
        return {"beta": _f64(params["beta"], device),
                "intercept": float(params["intercept"])}

    def predict_arrays_torch(self, params: dict, X: torch.Tensor):
        """Torch mirror of the numpy margin head over float64 ``X``."""
        z = X @ params["beta"] + params["intercept"]
        pred = (z > 0).to(torch.float64)
        raw = torch.stack([-z, z], dim=1)
        return pred, raw, None

    def contributions(self, params: Any) -> Optional[np.ndarray]:
        return np.abs(params["beta"])
