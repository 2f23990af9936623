"""Binary logistic regression with an elastic net, written plainly.

Spark's semantics as TransmogrifAI's OpLogisticRegression states them:
the features standardized by their weighted standard deviation (a column
that does not vary under the weights is left out, its coefficient 0), the
penalty reg * ((1 - a) |b|^2 / 2 + a |b|_1) on the standardized
coefficients and not on the intercept, the coefficients folded back to
the raw scale.  It is solved by a fixed number of Newton steps, the L1
part by iterated reweighting (a ridge of reg * a / (|b| + 1e-3)), each
step a small positive ridge relative to the mean curvature, a step taken
only while the gradient is above 1e-7.
"""
from __future__ import annotations

import torch

from .constants import LR_EPS, LR_ITERS, LR_L1_SMOOTH


def _solve(H: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    # a Cholesky solve; lower precisions are solved in float32
    dt = H.dtype if H.dtype in (torch.float32, torch.float64) else torch.float32
    L, info = torch.linalg.cholesky_ex(H.to(dt))
    x = torch.cholesky_solve(g.to(dt)[:, None], L)[:, 0]
    if int(info) != 0:
        x = torch.full_like(x, float("nan"))
    return x.to(H.dtype)


def fit(X: torch.Tensor, y: torch.Tensor, w: torch.Tensor, reg: float,
        alpha: float, iters: int = LR_ITERS):
    """(beta [d], intercept) on the raw scale for the weighted rows of X
    [n, d] (all tensors in one dtype)."""
    n, d = X.shape
    wsum = w.sum()
    m0 = X.mean(dim=0)  # a global centring, folded into the intercept
    X = X - m0
    mu = (w @ X) / wsum
    msq = (w @ (X * X)) / wsum
    var = msq - mu * mu
    active = var > 1e-6 * msq + 1e-30
    af = active.to(X.dtype)
    sd = torch.where(active, torch.sqrt(torch.clamp(var, min=1e-12)),
                     torch.ones_like(var))
    l2 = reg * (1.0 - alpha)
    l1 = reg * alpha
    eye = torch.eye(d, dtype=X.dtype, device=X.device)
    beta = torch.zeros(d, dtype=X.dtype, device=X.device)
    b0 = torch.zeros((), dtype=X.dtype, device=X.device)
    for _ in range(iters):
        gamma = beta / sd
        z = X @ gamma + (b0 - mu @ gamma)
        p = torch.sigmoid(z)
        wt = w * p * (1.0 - p) + LR_EPS
        r = w * (p - y)
        l1d = l1 / (beta.abs() + LR_L1_SMOOTH)
        sr = r.sum()
        g = ((X.T @ r - mu * sr) / sd / wsum + (l2 + l1d) * beta) * af
        a = wt @ X
        s = wt.sum()
        Hs = (X.T @ (X * wt[:, None]) - torch.outer(mu, a)
              - torch.outer(a, mu) + s * torch.outer(mu, mu)) \
            / torch.outer(sd, sd) / wsum
        jitter = 1e-9 + (1e-6 + 1.2e-7 * d) * (torch.trace(Hs) / d)
        H = (Hs * torch.outer(af, af) + torch.diag(l2 + l1d) + jitter * eye
             + torch.diag(1.0 - af))
        delta = _solve(H, g)
        if float(g.abs().max()) <= 1e-7:
            delta = torch.zeros_like(delta)
        delta = torch.where(torch.isfinite(delta), delta,
                            torch.zeros_like(delta))
        beta = beta - delta
        b0 = b0 - (sr / wsum) / (s / wsum)
    raw = beta / sd
    return raw, b0 - ((mu + m0) * raw).sum()


def margin(X: torch.Tensor, beta: torch.Tensor, intercept) -> torch.Tensor:
    return X @ beta + intercept
