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

More than two label classes take the JAX package's multiclass routes:

* ``family="multinomial"`` (and ``"auto"`` while K(d+1) <= 2048) is one
  full Newton over the K(d+1) softmax parameters, ``_softmax_fit_folds``,
  with the binary kernel's conditioning (global pre-centring, weighted
  standardization - materialized here, one [n, d] copy per fit - near-
  constant column exclusion, iterated reweighting for L1), the curvature
  floor ``1e-8 * eye(K)``, the ridge of ``pd_jitter`` at dimension
  K*d + K and ``guarded_step`` on every step.  The K^2 class-pair blocks
  of the Hessian come from ``packed_newton._gram_2d``.  The k folds of a
  cross-validation fit as one batched Newton while k*n*(d + K*K) stays
  within ``TX_LR_FOLDS_ELEMS`` (default 2^27), else one fold at a time -
  the JAX package's rule, so both take the same route for a shape;
* ``family="ovr"`` (and ``"auto"`` past 2048 parameters) is K binary fits
  of ``lr_newton_core``, one class against the rest each.

Multiclass params (``"betas"`` [K, d], ``"intercepts"``, ``"classes"``)
score in float64, as the JAX package's numpy head does: on the
estimator's device in ``predict_arrays``, in numpy in
``predict_arrays_np``.
"""
from __future__ import annotations

import os
from typing import Any, Optional

import numpy as np
import torch

from ..utils.device import resolve_device
from .base import PredictorEstimator
from .packed_newton import (
    _batched_diag,
    _gram_2d,
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


def _softmax_fit_folds(
    X: torch.Tensor,
    Yoh: torch.Tensor,
    W: torch.Tensor,
    reg: torch.Tensor,
    elastic_net: torch.Tensor,
    iters: int = 25,
):
    """Weighted multinomial (softmax) logistic regression via full Newton,
    F fits over one shared design matrix as one batched loop.

    X: [n, d] WITHOUT intercept column; Yoh: [n, K] one-hot labels; W:
    [F, n] per-fit sample weights (the folds); reg, elastic_net: 0-d - all
    on one device, in one float dtype.  Per fit the math is the JAX
    package's ``_softmax_fit_kernel``: probabilities are a softmax over the
    K linear scores (jointly normalized, not an OvR renormalization), and
    each Newton step solves the [K*d + K]^2 system.  Returns (betas
    [F, K, d], intercepts [F, K]) on the raw feature scale."""
    n, d = X.shape
    K = Yoh.shape[1]
    F = W.shape[0]
    dim = K * d + K
    wsum = W.sum(dim=1)                                    # [F]
    ws3 = wsum[:, None, None]
    m0 = X.mean(dim=0)
    X = X - m0
    mu = (W @ X) / wsum[:, None]                           # [F, d]
    msq = (W @ (X * X)) / wsum[:, None]
    var = msq - mu**2
    active = var > 1e-6 * msq + 1e-30
    activef = active.to(X.dtype)
    sd = torch.where(active, torch.sqrt(torch.clamp(var, min=1e-12)),
                     torch.ones_like(var))
    # the standardized copy is materialized, one [n, d] per fit (hence the
    # caller's element budget on the fold batch)
    Xs = (X[None] - mu[:, None, :]) / sd[:, None, :] * activef[:, None, :]
    lam_l2 = reg * (1.0 - elastic_net)
    lam_l1 = reg * elastic_net
    eyeK = torch.eye(K, dtype=X.dtype, device=X.device)
    eyeD = torch.eye(dim, dtype=X.dtype, device=X.device)
    zerosK = torch.zeros((F, K), dtype=X.dtype, device=X.device)

    def step(carry):
        B, b0 = carry  # [F, K, d] standardized space, [F, K]
        z = Xs @ B.transpose(1, 2) + b0[:, None, :]        # [F, n, K]
        Pm = torch.softmax(z, dim=2)
        R = W[:, :, None] * (Pm - Yoh[None])               # [F, n, K]
        l1d = lam_l1 / (B.abs() + 1e-3)                    # [F, K, d]
        gB = (R.transpose(1, 2) @ Xs) / ws3 + (lam_l2 + l1d) * B
        gB = gB * activef[:, None, :]
        g0 = R.sum(dim=1) / wsum[:, None]                  # [F, K]
        # class-pair curvature weights M[n, a, b] = w p_a (d_ab - p_b); the
        # eps diagonal floor keeps H bounded below when saturated
        # probabilities zero the curvature (separable data, reg = 0)
        M = W[:, :, None, None] * Pm[:, :, :, None] * (
            eyeK - Pm[:, :, None, :]) + 1e-8 * eyeK
        M2 = M.reshape(F, n, K * K)
        G = torch.stack([_gram_2d(Xs[f], M2[f]) for f in range(F)])
        Hbb = (G.reshape(F, d, K, K, d).permute(0, 2, 1, 3, 4)
               .reshape(F, K * d, K * d) / ws3)
        HbB = (M2.transpose(1, 2) @ Xs).reshape(F, K, K, d) / ws3[..., None]
        Hb0 = M.sum(dim=1) / ws3                           # [F, K, K]
        top = torch.cat(
            [Hbb, HbB.permute(0, 2, 3, 1).reshape(F, K * d, K)], dim=2)
        bot = torch.cat([HbB.reshape(F, K, K * d), Hb0], dim=2)
        H = torch.cat([top, bot], dim=1)
        # the softmax shift invariance makes H singular along K flat
        # directions whose gradient is zero too: a ridge relative to the
        # curvature and growing with the dimension bounds the step without
        # moving the fixed point (an absolute 1e-8 NaN'd the float32
        # Cholesky on the Iris matrix, a 1e-6*s one at K*d + K ~ 1.6k)
        s = torch.diagonal(H, dim1=1, dim2=2).sum(dim=1) / dim   # [F]
        jitter = pd_jitter(s, dim)
        # the excluded-column diagonal is scaled to the curvature, not a
        # flat 1.0, which against decayed curvature on separable data
        # would break the float32 Cholesky's conditioning
        diagB = (
            (lam_l2 + l1d) * activef[:, None, :]
            + (s + 1e-9)[:, None, None] * (1.0 - activef)[:, None, :]
        ).reshape(F, K * d)
        H = (H + _batched_diag(torch.cat([diagB, zerosK], dim=1))
             + jitter[:, None, None] * eyeD)
        g = torch.cat([gB.reshape(F, K * d), g0], dim=1)
        # converged fits take a ZERO step: at float32 noise the remaining
        # iterations only exercise the collapsed-curvature solve
        delta = guarded_step(solve_pos(H, g), g, axis=1)
        return (B - delta[:, :K * d].reshape(F, K, d),
                b0 - delta[:, K * d:])

    B_s, b0 = run_newton(
        step,
        (torch.zeros((F, K, d), dtype=X.dtype, device=X.device),
         torch.zeros((F, K), dtype=X.dtype, device=X.device)),
        iters,
    )
    betas = B_s * activef[:, None, :] / sd[:, None, :]
    intercepts = b0 - (betas @ (mu + m0)[:, :, None])[..., 0]
    return betas, intercepts


def _softmax_fit_kernel(X, Yoh, w, reg, elastic_net, iters: int = 25):
    """One softmax fit (``_softmax_fit_folds`` of the single weight row
    ``w`` [n]): (betas [K, d], intercepts [K])."""
    betas, b0s = _softmax_fit_folds(X, Yoh, w[None], reg, elastic_net, iters)
    return betas[0], b0s[0]


def _one_hot(y: np.ndarray, classes: np.ndarray) -> np.ndarray:
    idx = np.searchsorted(classes, y)
    Yoh = np.zeros((len(y), len(classes)), np.float32)
    Yoh[np.arange(len(y)), idx] = 1.0
    return Yoh


def _multinomial_params(betas, b0s, classes: np.ndarray) -> dict:
    """The one param-dict schema of every multinomial fit path (single,
    fold-batched), so fold params cannot drift from final-fit params."""
    return {
        "betas": np.asarray(betas, np.float64),
        "intercepts": np.asarray(b0s, np.float64),
        "classes": classes.astype(np.float64),
        "family": "multinomial",
    }


def _softmax_head(z: torch.Tensor, classes):
    """(pred, raw, prob) of multiclass margins ``z`` [n, K] (float64):
    the margins clipped to +-500, a softmax over them, the argmax class.
    For ``"ovr"`` params the softmax normalizes the independent OvR
    scores, as the JAX package does."""
    z = torch.clamp(z, -500, 500)
    e = torch.exp(z - z.amax(dim=1, keepdim=True))
    prob = e / e.sum(dim=1, keepdim=True)
    idx = torch.argmax(prob, dim=1).cpu().numpy()
    pred = np.asarray(classes, np.float64)[idx]
    return pred, z.cpu().numpy(), prob.cpu().numpy()


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


def _f64(a, device: torch.device) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a.to(device=device, dtype=torch.float64)
    return torch.tensor(np.asarray(a, dtype=np.float64), device=device)


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
        # reference semantics (OpLogisticRegression.scala:110-116): 'auto'
        # -> binomial on <=2 classes, multinomial (softmax) otherwise;
        # 'ovr' is one-vs-rest on request
        fam = str(family).lower()
        if fam not in ("auto", "binomial", "multinomial", "ovr"):
            raise ValueError(f"unknown logistic family: {family!r}")
        self.params.setdefault("family", fam)

    def _multiclass_family(self, K: int, d: int) -> str:
        fam = str(self.params.get("family", "auto")).lower()
        if fam == "ovr":
            return "ovr"
        if fam == "binomial":
            # MLlib contract: binomial refuses >2 outcome classes rather
            # than silently fitting something else
            raise ValueError(
                f"family='binomial' supports at most 2 outcome classes; "
                f"the label column has {K}"
            )
        if fam == "multinomial":
            return "multinomial"  # an explicit request is always honoured
        if fam == "auto":
            # the softmax Newton solves a [K(d+1)]^2 system; past ~2048
            # params the OvR route's K independent [d, d] solves win
            return "ovr" if K * (d + 1) > 2048 else "multinomial"
        raise ValueError(f"unknown logistic family: {fam!r}")

    def _scalars(self, dev: torch.device):
        return (_f32(self.params["reg_param"], dev),
                _f32(self.params["elastic_net_param"], dev),
                int(self.params["max_iter"]))

    def fit_arrays(self, X, y, w=None):
        n = len(y)
        w = np.ones(n) if w is None else w
        y_np = np.asarray(y)
        classes = np.unique(y_np)
        dev = resolve_device(self.device)
        reg, en, iters = self._scalars(dev)
        if len(classes) > 2:
            X_d, w_d = _f32(X, dev), _f32(w, dev)
            if self._multiclass_family(len(classes), np.shape(X)[1]) \
                    == "multinomial":
                betas, b0s = _softmax_fit_kernel(
                    X_d, _f32(_one_hot(y_np, classes), dev), w_d, reg, en,
                    iters=iters)
                return _multinomial_params(betas.cpu().numpy(),
                                           b0s.cpu().numpy(), classes)
            # one-vs-rest: K binary fits of the same Newton core
            betas, b0s = [], []
            for c in classes:
                beta, b0 = lr_newton_core(
                    X_d, _f32((y_np == c).astype(np.float32), dev), w_d,
                    reg, en, iters=iters)
                betas.append(beta.cpu().numpy())
                b0s.append(float(b0))
            return {
                "betas": np.stack(betas).astype(np.float64),
                "intercepts": np.asarray(b0s),
                "classes": classes.astype(np.float64),
                "family": "ovr",
            }
        beta, b0 = lr_newton_core(
            _f32(X, dev), _f32(y, dev), _f32(w, dev), reg, en, iters=iters)
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
        """One config, k folds: W [k, n] per-fold sample weights -> list of
        per-fold param dicts.  The validator sends multiclass labels here
        (binary grids ride the fold x grid batch): the k softmax fits run
        as one batched Newton within the ``TX_LR_FOLDS_ELEMS`` element
        budget, else one fold at a time; OvR fits fold by fold; binary
        labels take the batched binary fit with the config tiled."""
        y_np = np.asarray(y)
        classes = np.unique(y_np)
        n, d = np.shape(X)
        k = np.shape(W)[0]
        if len(classes) > 2:
            K = len(classes)
            W_np = np.asarray(W)
            if self._multiclass_family(K, d) != "multinomial":
                return [self.fit_arrays(X, y, W_np[f]) for f in range(k)]
            # the batch materializes k standardized copies and [n, K, K]
            # curvature tensors: past the budget, one fold at a time
            budget = int(os.environ.get("TX_LR_FOLDS_ELEMS", 1 << 27))
            if k * n * (d + K * K) > budget:
                return [self.fit_arrays(X, y, W_np[f]) for f in range(k)]
            dev = resolve_device(self.device)
            reg, en, iters = self._scalars(dev)
            betas, b0s = _softmax_fit_folds(
                _f32(X, dev), _f32(_one_hot(y_np, classes), dev),
                _f32(W_np, dev), reg, en, iters=iters)
            betas, b0s = betas.cpu().numpy(), b0s.cpu().numpy()
            return [_multinomial_params(betas[f], b0s[f], classes)
                    for f in range(k)]
        betas, b0s = self.fit_arrays_batched(
            X, y, W,
            np.full(k, float(self.params["reg_param"])),
            np.full(k, float(self.params["elastic_net_param"])),
        )
        return [
            {"beta": betas[f], "intercept": float(b0s[f])} for f in range(k)
        ]

    def predict_arrays(self, params: Any, X: np.ndarray):
        dev = resolve_device(self.device)
        if "betas" in params:
            z = (_f64(X, dev) @ _f64(params["betas"], dev).T
                 + _f64(params["intercepts"], dev))
            return _softmax_head(z, params["classes"])
        pred, raw, prob = _lr_predict(
            _f32(X, dev), _f32(params["beta"], dev),
            _f32(params["intercept"], dev),
        )
        return tuple(
            t.cpu().numpy().astype(np.float64) for t in (pred, raw, prob)
        )

    def predict_arrays_np(self, params: Any, X: np.ndarray):
        if "betas" in params:
            z = X @ params["betas"].T + params["intercepts"]  # [n, K]
            z = np.clip(z, -500, 500)
            e = np.exp(z - z.max(axis=1, keepdims=True))
            prob = e / e.sum(axis=1, keepdims=True)
            pred = params["classes"][np.argmax(prob, axis=1)]
            return pred.astype(np.float64), z, prob
        z = X @ params["beta"] + params["intercept"]
        p1 = 1.0 / (1.0 + np.exp(-np.clip(z, -500, 500)))
        prob = np.stack([1.0 - p1, p1], axis=1)
        raw = np.stack([-z, z], axis=1)
        pred = (p1 > 0.5).astype(np.float64)
        return pred, raw, prob

    def contributions(self, params: Any) -> Optional[np.ndarray]:
        if "betas" in params:
            return np.abs(params["betas"]).mean(axis=0)
        return np.abs(params["beta"])
