"""Multilayer perceptron classifier: full-batch Adam on the estimator's device.

Counterpart of ``transmogrifai_tpu/models/mlp.py`` (reference: core/.../
impl/classification/OpMultilayerPerceptronClassifier.scala wrapping Spark
MLlib's MultilayerPerceptronClassifier).  The layers are a plain forward
of matmuls and ReLUs with a softmax cross-entropy head; training is the
JAX package's loop: weighted standardization from the training rows
only, He-normal weights drawn as ``jax.random.normal`` draws them (the
port's ``utils/threefry``, bit for bit), zero biases, then ``max_iter``
full-batch Adam steps (b1 0.9, b2 0.999, eps 1e-8; the bias correction
takes the step as a float32 ``t``) on ``torch.autograd`` gradients.

``fit_arrays_folds`` trains the folds as one batched network: the layer
weights carry a leading fold axis and every matmul of the chain is a
batched one over the per-fold standardized design matrix, cut into row
chunks (the JAX package's vmap over fold weights), so the folds share
each step's launches.  All folds start from the same draw, as in the JAX
package.

Scoring: ``predict_arrays`` runs the float32 forward on the estimator's
device; ``predict_arrays_np`` is the JAX package's float64 numpy forward
and ``predict_arrays_torch`` its torch mirror for the device-fused
program.
"""
from __future__ import annotations

from typing import Any, Sequence

import numpy as np
import torch

from ..utils import threefry
from ..utils.device import resolve_device
from .base import PredictorEstimator


def init_params(seed: int, sizes: Sequence[int]) -> list:
    """The JAX package's ``_init_params(PRNGKey(seed), sizes)``: for each
    layer, a key split, a standard normal [in, out] scaled by
    float32 sqrt(2 / in), and zero biases.  float32 numpy."""
    key = threefry.prng_key(int(seed))
    params = []
    for i in range(len(sizes) - 1):
        key, sub = threefry.split(key)
        scale = np.sqrt(np.float32(2.0 / sizes[i]))
        W = threefry.normal(sub, (sizes[i], sizes[i + 1])) * scale
        params.append((W.astype(np.float32),
                       np.zeros((sizes[i + 1],), np.float32)))
    return params


#: rows of one chunk of the training matmuls (see ``mlp_fit_folds_core``)
CHUNK_ROWS = 4096


def _forward(layers, X):
    """Logits of ``X`` [..., n, d] through ``layers`` [(W, b)], each
    broadcasting against the rows (W [..., i, o], b [..., o]): ReLU
    hidden layers, a linear output layer."""
    h = X
    for W, b in layers[:-1]:
        h = torch.relu(h @ W + b)
    W, b = layers[-1]
    return h @ W + b


def mlp_fit_folds_core(X, onehot, W, init, steps: int, lr: float = 1e-2):
    """Full-batch Adam fits of the network, one per weight row of
    W [F, n], over X [n, d] and onehot [n, K] - float32 tensors on one
    device; ``init`` the float32 numpy [(W, b)] every fold starts from.
    Returns (layers [(W [F, i, o], b [F, o])], mu [F, d], sd [F, d]).

    The rows are cut into chunks of CHUNK_ROWS (the last padded with
    zero-weight rows, which add nothing to any gradient) and every layer
    is one matmul batched over (fold, chunk): a weight's gradient is then
    a batch of small products summed over the chunks, where one product
    per fold over all n rows (the plain batched form) runs as a few thread
    blocks on the card (98% of a step's device time at 0.9M rows)."""
    dev = X.device
    F, n = W.shape
    wsum = torch.clamp(W.sum(dim=1), min=1e-12)                 # [F]
    mu = (W @ X) / wsum[:, None]
    sd = torch.sqrt(torch.clamp((W @ (X * X)) / wsum[:, None] - mu**2,
                                min=0.0)) + 1e-8
    m = min(CHUNK_ROWS, n)
    c = -(-n // m)
    pad = c * m - n
    Xs = (X[None, :, :] - mu[:, None, :]) / sd[:, None, :]      # [F, n, d]
    wcol = W[:, :, None] * onehot[None, :, :]                   # [F, n, K]
    if pad:
        Xs = torch.nn.functional.pad(Xs, (0, 0, 0, pad))
        wcol = torch.nn.functional.pad(wcol, (0, 0, 0, pad))
    Xs = Xs.view(F, c, m, -1)
    wcol = wcol.view(F, c, m, -1)
    params = []
    for Wl, bl in init:
        for a in (Wl, bl):
            t = torch.tensor(a, device=dev).expand(F, *a.shape).clone()
            params.append(t.requires_grad_(True))
    m = [torch.zeros_like(p) for p in params]
    v = [torch.zeros_like(p) for p in params]
    b1, b2, eps = 0.9, 0.999, 1e-8
    # the bias corrections take the step as a float32 t, as the JAX
    # package's scan does; built on the device once, so the loop never
    # copies from the host
    ts = torch.arange(1, steps + 1, dtype=torch.float32, device=dev)
    c1s = 1 - torch.pow(torch.tensor(b1, dtype=torch.float32, device=dev), ts)
    c2s = 1 - torch.pow(torch.tensor(b2, dtype=torch.float32, device=dev), ts)
    for i in range(steps):
        # [F, 1, i, o] weights and [F, 1, 1, o] biases against the
        # [F, c, m, i] chunks
        layers = [(Wl[:, None], bl[:, None, None, :])
                  for Wl, bl in zip(params[0::2], params[1::2])]
        logp = torch.log_softmax(_forward(layers, Xs), dim=-1)
        # the folds' losses add: each fold's gradient is its own loss's
        loss = (-(wcol * logp).sum(dim=(1, 2, 3)) / wsum).sum()
        grads = torch.autograd.grad(loss, params)
        c1, c2 = c1s[i], c2s[i]
        with torch.no_grad():
            for j, (p, g) in enumerate(zip(params, grads)):
                m[j] = b1 * m[j] + (1 - b1) * g
                v[j] = b2 * v[j] + (1 - b2) * g**2
                p -= lr * (m[j] / c1) / (torch.sqrt(v[j] / c2) + eps)
    layers = [(Wl.detach(), bl.detach())
              for Wl, bl in zip(params[0::2], params[1::2])]
    return layers, mu, sd


class OpMultilayerPerceptronClassifier(PredictorEstimator):
    """(reference: layers input -> hidden(s) -> classes, maxIter; the
    hidden default mirrors the reference grids' [10, 10])"""

    lowerable = True
    model_type = "OpMultilayerPerceptronClassifier"

    def __init__(
        self,
        hidden_layers: Sequence[int] = (10, 10),
        max_iter: int = 200,
        step_size: float = 0.01,
        seed: int = 42,
        device: str = "cuda",
        **kw,
    ) -> None:
        super().__init__(device=device, **kw)
        self.params.setdefault("hidden_layers", tuple(hidden_layers))
        self.params.setdefault("max_iter", max_iter)
        self.params.setdefault("step_size", step_size)
        self.params.setdefault("seed", seed)

    def _fit_folds(self, X, y, W) -> list:
        """One batched fit over the weight rows of W [F, n]; the output
        width is the full label set's, a static shape as in the JAX
        package."""
        n, d = X.shape
        dev = resolve_device(self.device)
        classes = np.unique(y)
        onehot = (y[:, None] == classes[None, :]).astype(np.float32)
        p = self.params
        sizes = (d, *p["hidden_layers"], len(classes))
        layers, mu, sd = mlp_fit_folds_core(
            torch.tensor(np.asarray(X, np.float32), device=dev),
            torch.tensor(onehot, device=dev),
            torch.tensor(np.asarray(W, np.float32), device=dev),
            init_params(int(p["seed"]), sizes), int(p["max_iter"]),
            float(p["step_size"]),
        )
        layers = [(Wl.cpu().numpy(), bl.cpu().numpy()) for Wl, bl in layers]
        mu = mu.cpu().numpy().astype(np.float64)
        sd = sd.cpu().numpy().astype(np.float64)
        return [{"layers": [(Wl[f], bl[f]) for Wl, bl in layers],
                 "classes": classes, "mu": mu[f], "sd": sd[f]}
                for f in range(len(mu))]

    def fit_arrays(self, X, y, w=None) -> Any:
        w = np.ones(len(y)) if w is None else np.asarray(w)
        return self._fit_folds(X, y, w[None, :])[0]

    def fit_arrays_folds(self, X, y, W) -> list:
        """CV fan-out: the folds are a leading axis of one batched fit;
        standardization is weighted per fold."""
        return self._fit_folds(X, y, W)

    def predict_arrays(self, params: Any, X: np.ndarray):
        dev = resolve_device(self.device)
        Xs = torch.tensor(((X - params["mu"]) / params["sd"]).astype(np.float32),
                          device=dev)
        layers = [(torch.tensor(W, device=dev), torch.tensor(b, device=dev))
                  for W, b in params["layers"]]
        with torch.no_grad():
            logits = _forward(layers, Xs).cpu().numpy().astype(np.float64)
        return self._finalize_np(params, logits)

    def predict_arrays_np(self, params: Any, X: np.ndarray):
        h = ((X - params["mu"]) / params["sd"]).astype(np.float64)
        for W, b in params["layers"][:-1]:
            h = np.maximum(h @ W + b, 0.0)
        W, b = params["layers"][-1]
        return self._finalize_np(params, h @ W + b)

    @staticmethod
    def _finalize_np(params, logits):
        prob = np.exp(logits - logits.max(axis=1, keepdims=True))
        prob /= prob.sum(axis=1, keepdims=True)
        pred = params["classes"][prob.argmax(axis=1)].astype(np.float64)
        return pred, logits, prob

    def torch_params(self, params: Any, device: torch.device) -> dict:
        def t(a):
            return torch.tensor(np.asarray(a, np.float64), device=device)

        return {"layers": [(t(W), t(b)) for W, b in params["layers"]],
                "classes": t(params["classes"]),
                "mu": t(params["mu"]), "sd": t(params["sd"])}

    def predict_arrays_torch(self, params: dict, X: torch.Tensor):
        """Torch mirror of ``predict_arrays_np`` over float64 ``X``: the
        float64 ReLU matmul chain and the softmax head."""
        h = (X - params["mu"]) / params["sd"]
        for W, b in params["layers"][:-1]:
            h = torch.clamp(h @ W + b, min=0.0)
        W, b = params["layers"][-1]
        logits = h @ W + b
        prob = torch.exp(logits - logits.max(dim=1, keepdim=True).values)
        prob = prob / prob.sum(dim=1, keepdim=True)
        pred = params["classes"][torch.argmax(prob, dim=1)]
        return pred, logits, prob
