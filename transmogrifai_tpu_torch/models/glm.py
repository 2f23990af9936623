"""Generalized linear regression by IRLS on the estimator's device.

Counterpart of ``transmogrifai_tpu/models/glm.py`` (reference: core/.../
impl/regression/OpGeneralizedLinearRegression.scala wrapping Spark GLR;
default grid families gaussian/poisson).  Links: gaussian-identity,
poisson-log, gamma-log, binomial-logit, tweedie log (``link_power`` 0,
the default) or the power link eta = mu^link_power.  Each family's IRLS
step uses the score (y - mu) * (dmu/deta) / V(mu) and the Fisher weight
(dmu/deta)^2 / V(mu), in float32 as the JAX package runs it.

The conditioning is the logistic kernels': global pre-centring,
standardization folded into the Gram (no standardized [n, d] copy), near-
constant columns excluded, ``pd_jitter``'s ridge and ``solve_pos``'s
Cholesky solve, a non-finite step dropped.  ``glm_fit_batched_core`` fits
B weight vectors W [B, n] over the one design matrix (the JAX package's
vmap over fold weights), so ``fit_arrays_folds`` uploads X once and the
folds ride a leading axis.

Scoring: ``predict_arrays`` is the JAX package's numpy link function in
float64 (``predict_arrays_np`` the same), ``predict_arrays_torch`` its
torch mirror for the device-fused program.
"""
from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch

from ..utils.device import resolve_device
from .base import PredictorEstimator
from .logistic_regression import _f32
from .packed_newton import _batched_diag, pd_jitter, solve_pos

_FAMILIES = ("gaussian", "poisson", "gamma", "binomial", "tweedie")


def _norm_family(fam) -> str:
    """Validated where it is consumed: grids set ``family`` through
    ``with_params``, which bypasses ``__init__``."""
    f = str(fam).lower()
    if f not in _FAMILIES:
        raise ValueError(f"unknown GLM family: {fam!r}")
    return f


def _check_var_power(p: float) -> float:
    """Tweedie distributions do not exist for 0 < p < 1."""
    p = float(p)
    if 0.0 < p < 1.0:
        raise ValueError(f"tweedie variance_power must be 0 or >= 1, got {p}")
    return p


def _mean_weight_score(eta, family: str, var_power: float, link_power: float):
    """(mu, Fisher weight, score factor) of the linear predictor ``eta``:
    ``w * (mu - y) * factor`` is minus the eta-score."""
    if family == "poisson":
        mu = torch.exp(torch.clamp(eta, -30, 30))
        return mu, mu, torch.ones_like(mu)
    if family == "gamma":
        mu = torch.exp(torch.clamp(eta, -30, 30))
        return mu, torch.ones_like(mu), 1.0 / torch.clamp(mu, min=1e-12)
    if family == "tweedie":
        if link_power == 0.0:
            mu = torch.exp(torch.clamp(eta, -30, 30))
            ms = torch.clamp(mu, min=1e-12)
            return mu, ms ** (2.0 - var_power), ms ** (1.0 - var_power)
        lp = link_power
        # an iterate can leave the link's domain (eta = mu^lp > 0): clamp
        # mu, or one bad step explodes the weights into NaN
        mu = torch.clamp(torch.clamp(eta, min=1e-6) ** (1.0 / lp), 1e-6, 1e8)
        return (mu, mu ** (2.0 - 2.0 * lp - var_power) / (lp * lp),
                mu ** (1.0 - lp - var_power) / lp)
    if family == "binomial":
        mu = torch.sigmoid(eta)
        return mu, mu * (1 - mu), torch.ones_like(mu)
    return eta, torch.ones_like(eta), torch.ones_like(eta)  # gaussian


def _b0_init(ybar, family: str, link_power: float):
    if family == "tweedie" and link_power != 0.0:
        return torch.clamp(ybar, min=1e-6) ** link_power
    if family in ("poisson", "gamma", "tweedie"):
        return torch.log(torch.clamp(ybar, min=1e-6))
    if family == "binomial":
        p = torch.clamp(ybar, 1e-6, 1 - 1e-6)
        return torch.log(p / (1 - p))
    return ybar


def glm_fit_batched_core(X, y, W, reg, family: str, iters: int = 25,
                         var_power: float = 1.5, link_power: float = 0.0):
    """B IRLS fits over the shared X [n, d] (no intercept column), one per
    weight row of W [B, n]; y [n]; ``reg`` a float - all tensors on one
    device in one float dtype.  Returns (betas [B, d], intercepts [B]) on
    the raw feature scale."""
    n, d = X.shape
    wsum = torch.clamp(W.sum(dim=1), min=1e-12)          # [B]
    m0 = X.mean(dim=0)
    X = X - m0
    mu_x = (W @ X) / wsum[:, None]                        # [B, d]
    msq = (W @ (X * X)) / wsum[:, None]
    var = msq - mu_x**2
    active = var > 1e-6 * msq + 1e-30
    activef = active.to(X.dtype)
    sd = torch.where(active, torch.sqrt(torch.clamp(var, min=1e-12)),
                     torch.ones_like(var))
    ybar = (W @ y) / wsum
    beta = torch.zeros_like(mu_x)
    b0 = _b0_init(ybar, family, link_power)
    act2 = activef[:, :, None] * activef[:, None, :]
    for _ in range(iters):
        gamma = beta / sd
        eta = (gamma @ X.T) + (b0 - (mu_x * gamma).sum(dim=1))[:, None]
        mu, wt, fac = _mean_weight_score(eta, family, var_power, link_power)
        wt = W * wt + 1e-8
        resid = W * (mu - y[None, :]) * fac
        sr = resid.sum(dim=1)
        g = ((resid @ X - mu_x * sr[:, None]) / sd / wsum[:, None]
             + reg * beta) * activef
        XtWX = torch.stack([X.T @ (X * wt[b][:, None])
                            for b in range(W.shape[0])])
        a = wt @ X
        s = wt.sum(dim=1)
        Hs = (
            XtWX - mu_x[:, :, None] * a[:, None, :]
            - a[:, :, None] * mu_x[:, None, :]
            + s[:, None, None] * mu_x[:, :, None] * mu_x[:, None, :]
        ) / (sd[:, :, None] * sd[:, None, :]) / wsum[:, None, None]
        Hs = Hs * act2
        ridge = pd_jitter(torch.diagonal(Hs, dim1=1, dim2=2).sum(dim=1) / d, d)
        H = Hs + _batched_diag(reg + ridge[:, None] + (1.0 - activef))
        delta = solve_pos(H, g)
        # a non-finite step (singular H after a domain excursion) must not
        # poison the carry
        delta = torch.where(torch.isfinite(delta), delta,
                            torch.zeros_like(delta))
        step0 = (sr / wsum) / (s / wsum)
        step0 = torch.where(torch.isfinite(step0), step0,
                            torch.zeros_like(step0))
        beta = beta - delta
        b0 = b0 - step0
    beta = beta / sd
    return beta, b0 - ((mu_x + m0) * beta).sum(dim=1)


def _link_np(eta: np.ndarray, family: str, lp: float) -> np.ndarray:
    if family == "tweedie" and lp != 0.0:
        return np.clip(np.maximum(eta, 1e-6) ** (1.0 / lp), 1e-6, 1e8)
    if family in ("poisson", "gamma", "tweedie"):
        return np.exp(np.clip(eta, -30, 30))
    if family == "binomial":
        return 1.0 / (1.0 + np.exp(-eta))
    return eta


class OpGeneralizedLinearRegression(PredictorEstimator):
    """(reference: OpGeneralizedLinearRegression.scala; family, regParam,
    maxIter, variancePower, linkPower)"""

    lowerable = True
    model_type = "OpGeneralizedLinearRegression"
    batched_needs_binary_y = False

    def __init__(
        self, family: str = "gaussian", reg_param: float = 0.0,
        max_iter: int = 25, variance_power: float = 1.5,
        link_power: float = 0.0, device: str = "cuda", **kw,
    ) -> None:
        super().__init__(device=device, **kw)
        self.params.setdefault("family", _norm_family(family))
        self.params.setdefault("reg_param", reg_param)
        self.params.setdefault("max_iter", max_iter)
        # tweedie link: 0 = log, else the power link eta = mu^lp (Spark
        # GLR's default is lp = 1 - variancePower)
        self.params.setdefault("link_power", float(link_power))
        self.params.setdefault("variance_power",
                               _check_var_power(variance_power))

    def _fit(self, X, y, W) -> tuple[np.ndarray, np.ndarray]:
        p = self.params
        dev = resolve_device(self.device)
        betas, b0s = glm_fit_batched_core(
            _f32(X, dev), _f32(y, dev), _f32(W, dev),
            float(np.float32(p["reg_param"])),
            family=_norm_family(p["family"]), iters=int(p["max_iter"]),
            var_power=_check_var_power(p.get("variance_power", 1.5)),
            link_power=float(p.get("link_power", 0.0)),
        )
        return betas.cpu().numpy(), b0s.cpu().numpy()

    def _params(self, beta, b0) -> dict:
        return {"beta": beta, "intercept": float(b0),
                "family": self.params["family"],
                "link_power": float(self.params.get("link_power", 0.0))}

    def fit_arrays(self, X, y, w=None) -> Any:
        w = np.ones(len(y)) if w is None else np.asarray(w)
        betas, b0s = self._fit(X, y, w[None, :])
        return self._params(betas[0], b0s[0])

    def fit_arrays_folds(self, X, y, W) -> list:
        """CV fan-out: the folds are the weight rows of W [F, n], fitted as
        one batched IRLS over one upload of X."""
        betas, b0s = self._fit(X, y, np.asarray(W, np.float64))
        return [self._params(betas[f], b0s[f]) for f in range(len(betas))]

    def predict_arrays(self, params: Any, X: np.ndarray):
        eta = X @ params["beta"] + params["intercept"]
        pred = _link_np(eta, _norm_family(params["family"]),
                        float(params.get("link_power", 0.0)))
        return pred.astype(np.float64), None, None

    def predict_arrays_np(self, params: Any, X: np.ndarray):
        return self.predict_arrays(params, X)

    def torch_params(self, params: Any, device: torch.device) -> dict:
        return {"beta": torch.tensor(np.asarray(params["beta"], np.float64),
                                     device=device),
                "intercept": float(params["intercept"]),
                "family": _norm_family(params["family"]),
                "link_power": float(params.get("link_power", 0.0))}

    def predict_arrays_torch(self, params: dict, X: torch.Tensor):
        """Torch mirror of ``predict_arrays_np`` over float64 ``X``."""
        eta = X @ params["beta"] + params["intercept"]
        fam, lp = params["family"], params["link_power"]
        if fam == "tweedie" and lp != 0.0:
            pred = torch.clamp(torch.clamp(eta, min=1e-6) ** (1.0 / lp),
                               1e-6, 1e8)
        elif fam in ("poisson", "gamma", "tweedie"):
            pred = torch.exp(torch.clamp(eta, -30, 30))
        elif fam == "binomial":
            pred = 1.0 / (1.0 + torch.exp(-eta))
        else:
            pred = eta
        return pred.to(torch.float64), None, None

    def contributions(self, params: Any) -> Optional[np.ndarray]:
        return np.abs(params["beta"])
