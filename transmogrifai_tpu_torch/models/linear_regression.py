"""Linear regression by the normal equations, with ridge and approximate L1.

Counterpart of OpLinearRegression (reference: core/.../impl/regression/
OpLinearRegression.scala, Spark MLlib WLS/LBFGS internals) and of
``transmogrifai_tpu/models/linear_regression.py``: a weighted ridge solved
in closed form on the estimator's ``device`` in float32 - one [d, d] Gram
matmul and a Cholesky solve - with elastic-net L1 by reweighted ridge
iterations.  The conditioning is the logistic kernels': global
pre-centring, standardization folded into the Gram, near-constant columns
excluded, and ``pd_jitter``'s dimension-aware ridge.

The cross-validation fan-out, ``linreg_fit_batched_core``, fits B
candidates (fold x grid weight vectors W [B, n] with their own regParam
and elasticNet) as one explicitly batched loop, the JAX package's
``vmap`` of ``linreg_core``: each candidate's Gram is its own
``X.T @ (X * w_b[:, None])`` (no [B, n, d] temporary), the solves are
batched, and a NaN solve keeps that candidate's previous iterate alone.
Squared loss takes any real label, so ``batched_needs_binary_y`` is
False and the validator batches regression grids.

Scoring has the numpy route (``predict_arrays_np``) and its torch mirror
for the device-fused program (``predict_arrays_torch``).
``fused_train_core`` is the fused training program's seam
(``local/fused_train.py``).  The streamed sufficient-statistics fit
(``streaming_fit_stats`` per chunk, ``fit_from_stats`` over the merged
moments) is host float64 numpy, as in the JAX package.
"""
from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch

from ..parallel.distributed import RowReducer
from ..utils.device import resolve_device
from .base import PredictorEstimator
from .logistic_regression import _f32
from .packed_newton import (
    _batched_diag, fit_batched, pd_jitter, run_newton, solve_pos)


def linreg_core(X, y, w, reg, elastic_net, l1_iters: int = 8):
    """Weighted ridge (+ approximate L1) regression of one fit.

    X: [n, d] WITHOUT intercept column; y, w: [n]; reg, elastic_net: 0-d -
    all on one device, in one float dtype.  Returns (beta [d], intercept
    0-d) on the raw feature scale."""
    n, d = X.shape
    wsum = w.sum()
    m0 = X.mean(dim=0)
    X = X - m0
    mu = (w @ X) / wsum
    msq = (w @ (X * X)) / wsum
    var = msq - mu**2
    active = var > 1e-6 * msq + 1e-30
    activef = active.to(X.dtype)
    sd = torch.where(active, torch.sqrt(torch.clamp(var, min=1e-12)),
                     torch.ones_like(var))
    ybar = (w @ y) / wsum
    lam_l2 = reg * (1.0 - elastic_net)
    lam_l1 = reg * elastic_net
    # standardized Gram and moment from raw-space reductions (the logistic
    # kernel's identities: no standardized [n, d] temporary)
    XtWX = X.T @ (X * w[:, None])
    a = w @ X
    G = (
        XtWX - torch.outer(mu, a) - torch.outer(a, mu)
        + wsum * torch.outer(mu, mu)
    ) / torch.outer(sd, sd) / wsum
    G = G * torch.outer(activef, activef)
    r = w * (y - ybar)
    c = ((X.T @ r - mu * r.sum()) / sd / wsum) * activef
    # G is fixed, so the dimension-aware ridge prices once
    ridge = pd_jitter(torch.trace(G) / d, d)

    def step(beta):
        l1_diag = lam_l1 / (beta.abs() + 1e-3)
        H = G + torch.diag(lam_l2 + l1_diag + ridge + (1.0 - activef))
        new = solve_pos(H, c)
        return torch.where(torch.isfinite(new), new, beta)

    beta_s = run_newton(
        step, torch.zeros(d, dtype=X.dtype, device=X.device), l1_iters)
    beta = beta_s / sd
    intercept = ybar - ((mu + m0) * beta).sum()
    return beta, intercept


def linreg_fit_batched_core(X, y, W, regs, ens, l1_iters: int = 8,
                            fixed_point: bool = False, rows=None):
    """B fits over the shared X [n, d] in one loop: W [B, n] per-candidate
    sample weights, regs/ens [B].  Per candidate the math is
    :func:`linreg_core`'s; ``fixed_point`` ends the reweighting loop at
    the bitwise fixed point (the same betas); ``rows``: the row reducer of
    a mesh fit (see ``logistic_regression.lr_fit_batched_core``).  Returns
    (betas [B, d], intercepts [B])."""
    red = rows if rows is not None else RowReducer()
    n, d = X.shape
    B = W.shape[0]
    (wsum,) = red.sum(W.sum(dim=1))                     # [B]
    m0 = red.mean_rows(X)
    X = X - m0
    mu, msq, ybar = red.sum(W @ X, W @ (X * X), W @ y)
    mu, msq = mu / wsum[:, None], msq / wsum[:, None]   # [B, d]
    var = msq - mu**2
    active = var > 1e-6 * msq + 1e-30
    activef = active.to(X.dtype)
    sd = torch.where(active, torch.sqrt(torch.clamp(var, min=1e-12)),
                     torch.ones_like(var))
    ybar = ybar / wsum
    lam_l2 = (regs * (1.0 - ens))[:, None]
    lam_l1 = (regs * ens)[:, None]
    XtWX, a = red.sum(
        torch.stack([X.T @ (X * W[b][:, None]) for b in range(B)]), W @ X)
    G = (
        XtWX - mu[:, :, None] * a[:, None, :] - a[:, :, None] * mu[:, None, :]
        + wsum[:, None, None] * mu[:, :, None] * mu[:, None, :]
    ) / (sd[:, :, None] * sd[:, None, :]) / wsum[:, None, None]
    G = G * (activef[:, :, None] * activef[:, None, :])
    r = W * (y[None, :] - ybar[:, None])                # [B, n]
    rX, rs = red.sum(r @ X, r.sum(dim=1))
    c = ((rX - mu * rs[:, None]) / sd / wsum[:, None]) * activef
    ridge = pd_jitter(torch.diagonal(G, dim1=1, dim2=2).sum(dim=1) / d, d)

    def step(beta):
        l1_diag = lam_l1 / (beta.abs() + 1e-3)
        H = G + _batched_diag(lam_l2 + l1_diag + ridge[:, None]
                              + (1.0 - activef))
        new = solve_pos(H, c)
        return torch.where(torch.isfinite(new), new, beta)

    beta_s = run_newton(
        step, torch.zeros((B, d), dtype=X.dtype, device=X.device), l1_iters,
        fixed_point, red)
    beta = beta_s / sd
    intercept = ybar - ((mu + m0) * beta).sum(dim=1)
    return beta, intercept


class OpLinearRegression(PredictorEstimator):
    """(reference: OpLinearRegression.scala; grid: regParam
    {0.001,0.01,0.1,0.2}, elasticNet {0.1,0.5})"""

    model_type = "OpLinearRegression"
    lowerable = True
    batched_needs_binary_y = False  # squared loss: any real y batches

    def __init__(
        self,
        reg_param: float = 0.0,
        elastic_net_param: float = 0.0,
        fit_intercept: bool = True,
        device: str = "cuda",
        **kw,
    ) -> None:
        super().__init__(device=device, **kw)
        self.params.setdefault("reg_param", reg_param)
        self.params.setdefault("elastic_net_param", elastic_net_param)
        self.params.setdefault("fit_intercept", fit_intercept)

    def fit_arrays(self, X, y, w=None):
        w = np.ones(len(y)) if w is None else w
        dev = resolve_device(self.device)
        beta, b0 = linreg_core(
            _f32(X, dev), _f32(y, dev), _f32(w, dev),
            _f32(self.params["reg_param"], dev),
            _f32(self.params["elastic_net_param"], dev),
        )
        return {"beta": beta.cpu().numpy(), "intercept": float(b0)}

    def fit_arrays_batched(self, X, y, W, regs, ens, mesh=None):
        """Batched fit: W [B, n] weight masks, regs/ens [B] -> (betas
        [B, d], intercepts [B]) as numpy; host arrays or tensors go to the
        estimator's device as float32.  ``mesh``: the validator's CV mesh
        (``packed_newton.fit_batched``)."""
        dev = resolve_device(self.device)
        beta, b0 = fit_batched(
            linreg_fit_batched_core,
            (_f32(X, dev), _f32(y, dev), _f32(W, dev),
             _f32(regs, dev), _f32(ens, dev)),
            mesh,
        )
        return beta.cpu().numpy(), b0.cpu().numpy()

    def fused_train_core(self, packed: bool = False):
        """The fused training program's seam (the contract of
        ``OpLogisticRegression.fused_train_core``): the score is the raw
        prediction, the float32 matvec of ``predict_arrays``."""
        if packed:
            raise ValueError("the MXU-packed Gram is a TPU-only route")

        def fit(X, y, W, regs, ens):
            return linreg_fit_batched_core(X, y, W, regs, ens,
                                           fixed_point=True)

        def score(X, beta, b0):
            return X @ beta + b0

        return {"fit": fit, "score": score,
                "sig": ("linreg", packed)}

    # -- streamed sufficient-statistics fit (readers/pipeline.py) ----------
    @staticmethod
    def streaming_fit_stats(X_block, y_block) -> tuple:
        """Per-chunk sufficient statistics for the closed-form ridge fit:
        (n, sum x [d], X^T X [d, d], sum y, X^T y [d]).  Mergeable by
        addition, so the sharded input pipeline can accumulate them while
        later shards parse; ``fit_from_stats`` then completes the fit in
        O(d^2) after the last chunk lands."""
        Xb = np.asarray(X_block, dtype=np.float64)
        yb = np.asarray(y_block, dtype=np.float64)
        return (
            len(yb), Xb.sum(axis=0), Xb.T @ Xb, float(yb.sum()),
            Xb.T @ yb,
        )

    def fit_from_stats(self, stats) -> dict:
        """Fit from accumulated :meth:`streaming_fit_stats` chunks: the
        centered/standardized ridge + reweighted-L1 math of the batch fit,
        reconstructed from the merged moments (the [n, d] matrix never
        needs to exist).  Chunks are summed in the given (deterministic
        source) order."""
        stats = list(stats)
        if not stats:
            raise ValueError("fit_from_stats needs at least one chunk")
        n = sum(s[0] for s in stats)
        S1 = np.sum([s[1] for s in stats], axis=0)
        S2 = np.sum([s[2] for s in stats], axis=0)
        Sy = float(sum(s[3] for s in stats))
        Sxy = np.sum([s[4] for s in stats], axis=0)
        d = len(S1)
        m0 = S1 / n
        # centered second moments: Xc^T Xc = X^T X - n m0 m0^T (Xc sums
        # to 0, so the batch fit's mean terms vanish exactly here)
        XtX_c = S2 - n * np.outer(m0, m0)
        var = np.maximum(np.diag(XtX_c) / n, 0.0)
        msq = var  # mu == 0
        active = var > 1e-6 * msq + 1e-30
        sd = np.where(active, np.sqrt(np.maximum(var, 1e-12)), 1.0)
        ybar = Sy / n
        G = (XtX_c / np.outer(sd, sd) / n) * np.outer(active, active)
        c = ((Sxy - m0 * Sy) / sd / n) * active
        reg = float(self.params["reg_param"])
        en = float(self.params["elastic_net_param"])
        lam_l2 = reg * (1.0 - en)
        lam_l1 = reg * en
        ridge = float(pd_jitter(np.trace(G) / d, d))
        beta_s = np.zeros(d)
        for _ in range(8):  # same reweighted-L1 schedule as the batch fit
            l1_diag = lam_l1 / (np.abs(beta_s) + 1e-3)
            H = G + np.diag(lam_l2 + l1_diag + ridge + (1.0 - active))
            new = np.linalg.solve(H, c)
            beta_s = np.where(np.isfinite(new), new, beta_s)
        beta = beta_s / sd
        intercept = ybar - float(m0 @ beta)
        return {"beta": beta, "intercept": float(intercept)}

    def predict_arrays(self, params: Any, X: np.ndarray):
        dev = resolve_device(self.device)
        pred = _f32(X, dev) @ _f32(params["beta"], dev) + _f32(
            params["intercept"], dev)
        return pred.cpu().numpy().astype(np.float64), None, None

    def predict_arrays_np(self, params: Any, X: np.ndarray):
        pred = (X @ params["beta"] + params["intercept"]).astype(np.float64)
        return pred, None, None

    def torch_params(self, params: Any, device: torch.device) -> dict:
        return {"beta": torch.tensor(np.asarray(params["beta"], np.float64),
                                     device=device),
                "intercept": float(params["intercept"])}

    def predict_arrays_torch(self, params: dict, X: torch.Tensor):
        """Torch mirror of ``predict_arrays_np`` over float64 ``X``."""
        pred = X @ params["beta"] + params["intercept"]
        return pred.to(torch.float64), None, None

    def contributions(self, params: Any) -> Optional[np.ndarray]:
        return np.abs(params["beta"])
