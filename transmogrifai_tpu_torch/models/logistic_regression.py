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
choice.

The cross-validation fan-out, ``lr_fit_batched_core``, fits B candidates
(fold x grid weight vectors W [B, n] with their own regParam and
elasticNet) over one shared design matrix as one explicitly batched
Newton loop: the JAX package's ``vmap`` of ``lr_newton_core`` (its
off-TPU route).  A vmap of ``X * wt[:, None]`` would materialize a
[B, n, d] temporary (1.06 GB at 24 candidates x 1M x 11); here every
[B, n] quantity is one matmul against the shared X, and each candidate's
Hessian Gram is its own ``X.T @ (X * wt_b[:, None])``, the one-fit
product, with an [n, d] temporary.  Convergence (``guarded_step``) and a
failed Cholesky (``solve_pos``) are per candidate.

Multiclass families (softmax, one-vs-rest) are not ported yet (ROADMAP.md
queue 1, item 5); they raise.
"""
from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch

from ..utils.device import resolve_device
from .base import PredictorEstimator
from .packed_newton import (
    _batched_diag,
    guarded_step,
    pd_jitter,
    run_newton,
    solve_pos,
)


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


def lr_fit_batched_core(
    X: torch.Tensor,
    y: torch.Tensor,
    W: torch.Tensor,
    regs: torch.Tensor,
    ens: torch.Tensor,
    iters: int = 25,
):
    """B binary fits in one Newton loop over the shared X [n, d]: W [B, n]
    per-candidate sample weights, regs/ens [B].  Per candidate the math is
    :func:`lr_newton_core`'s; see the module docstring for the batched
    layout.  Returns (betas [B, d], intercepts [B]) on the raw scale."""
    n, d = X.shape
    B = W.shape[0]
    wsum = W.sum(dim=1)[:, None]                       # [B, 1]
    m0 = X.mean(dim=0)
    X = X - m0
    mu = (W @ X) / wsum                                # [B, d]
    msq = (W @ (X * X)) / wsum
    var = msq - mu**2
    active = var > 1e-6 * msq + 1e-30
    activef = active.to(X.dtype)
    sd = torch.where(active, torch.sqrt(torch.clamp(var, min=1e-12)),
                     torch.ones_like(var))
    lam_l2 = (regs * (1.0 - ens))[:, None]
    lam_l1 = (regs * ens)[:, None]
    eps = 1e-8
    eye = torch.eye(d, dtype=X.dtype, device=X.device)
    amask = activef[:, :, None] * activef[:, None, :]
    sd2 = sd[:, :, None] * sd[:, None, :]
    mumu = mu[:, :, None] * mu[:, None, :]

    def step(carry):
        beta, b0 = carry  # [B, d] in standardized space, [B]
        gamma = beta / sd
        z = (X @ gamma.T).T + (b0 - (mu * gamma).sum(dim=1))[:, None]  # [B, n]
        p = torch.sigmoid(z)
        wt = W * p * (1.0 - p) + eps
        resid = W * (p - y[None, :])
        l1_diag = lam_l1 / (beta.abs() + 1e-3)
        Xr = resid @ X
        sr = resid.sum(dim=1)
        g = ((Xr - mu * sr[:, None]) / sd / wsum
             + (lam_l2 + l1_diag) * beta) * activef
        XtWX = torch.stack([X.T @ (X * wt[b][:, None]) for b in range(B)])
        a = wt @ X
        s = wt.sum(dim=1)
        Hs = (
            XtWX - mu[:, :, None] * a[:, None, :] - a[:, :, None] * mu[:, None, :]
            + s[:, None, None] * mumu
        ) / sd2 / wsum[:, :, None]
        jitter = pd_jitter(torch.diagonal(Hs, dim1=1, dim2=2).sum(dim=1) / d, d)
        H = (
            Hs * amask + _batched_diag(lam_l2 + l1_diag)
            + jitter[:, None, None] * eye
            + _batched_diag(1.0 - activef)
        )
        g0 = sr / wsum[:, 0]
        h0 = s / wsum[:, 0]
        delta = guarded_step(solve_pos(H, g), g, axis=1)
        return beta - delta, b0 - g0 / h0

    beta_s, b0 = run_newton(
        step,
        (torch.zeros((B, d), dtype=X.dtype, device=X.device),
         torch.zeros((B,), dtype=X.dtype, device=X.device)),
        iters,
    )
    beta = beta_s / sd
    intercept = b0 - ((mu + m0) * beta).sum(dim=1)
    return beta, intercept


def _lr_predict(X: torch.Tensor, beta: torch.Tensor, intercept: torch.Tensor):
    z = X @ beta + intercept
    p1 = torch.sigmoid(z)
    prob = torch.stack([1.0 - p1, p1], dim=1)
    raw = torch.stack([-z, z], dim=1)
    pred = (p1 > 0.5).to(z.dtype)
    return pred, raw, prob


def _f32(a, device: torch.device) -> torch.Tensor:
    """Host array, scalar or tensor -> float32 tensor on ``device`` (a host
    input is copied: it may be a read-only view; a tensor already there
    passes through)."""
    if isinstance(a, torch.Tensor):
        return a.to(device=device, dtype=torch.float32)
    return torch.tensor(np.asarray(a, dtype=np.float32), device=device)


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to the torch package yet "
        "(ROADMAP.md queue 1, item 5)"
    )


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
            raise _not_ported(
                f"multiclass logistic regression ({len(classes)} label "
                "classes)"
            )
        dev = resolve_device(self.device)
        beta, b0 = lr_newton_core(
            _f32(X, dev), _f32(y, dev), _f32(w, dev),
            _f32(self.params["reg_param"], dev),
            _f32(self.params["elastic_net_param"], dev),
            iters=int(self.params["max_iter"]),
        )
        return {"beta": beta.cpu().numpy(), "intercept": float(b0)}

    def fit_arrays_batched(self, X, y, W, regs, ens):
        """Batched binary fit: W [B, n] weight masks, regs/ens [B] ->
        (betas [B, d], intercepts [B]) as numpy.  One Newton loop is the
        whole CV fold x grid fan-out.  Inputs may be host arrays or
        tensors; they go to the estimator's device as float32 (a tensor
        already there is not copied)."""
        dev = resolve_device(self.device)
        beta, b0 = lr_fit_batched_core(
            _f32(X, dev), _f32(y, dev), _f32(W, dev),
            _f32(regs, dev), _f32(ens, dev),
            iters=int(self.params.get("max_iter", 25)),
        )
        return beta.cpu().numpy(), b0.cpu().numpy()

    def fit_arrays_folds(self, X, y, W):
        """One config, k folds in one batched fit: W [k, n] per-fold sample
        weights -> list of per-fold param dicts (binary labels; the
        multiclass families raise)."""
        classes = np.unique(np.asarray(y))
        if len(classes) > 2:
            raise _not_ported(
                f"multiclass logistic regression ({len(classes)} label "
                "classes)"
            )
        k = np.shape(W)[0]
        betas, b0s = self.fit_arrays_batched(
            X, y, W,
            np.full(k, float(self.params["reg_param"])),
            np.full(k, float(self.params["elastic_net_param"])),
        )
        return [
            {"beta": betas[f], "intercept": float(b0s[f])} for f in range(k)
        ]

    def predict_arrays(self, params: Any, X: np.ndarray):
        if "betas" in params:
            raise _not_ported("multiclass logistic regression scoring")
        dev = resolve_device(self.device)
        pred, raw, prob = _lr_predict(
            _f32(X, dev), _f32(params["beta"], dev),
            _f32(params["intercept"], dev),
        )
        return tuple(
            t.cpu().numpy().astype(np.float64) for t in (pred, raw, prob)
        )

    def predict_arrays_np(self, params: Any, X: np.ndarray):
        if "betas" in params:
            raise _not_ported("multiclass logistic regression scoring")
        z = X @ params["beta"] + params["intercept"]
        p1 = 1.0 / (1.0 + np.exp(-np.clip(z, -500, 500)))
        prob = np.stack([1.0 - p1, p1], axis=1)
        raw = np.stack([-z, z], axis=1)
        pred = (p1 > 0.5).astype(np.float64)
        return pred, raw, prob

    def contributions(self, params: Any) -> Optional[np.ndarray]:
        return np.abs(params["beta"])
