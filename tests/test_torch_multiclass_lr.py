"""Multiclass logistic regression in the torch package against the JAX
package's: the softmax Newton (``_softmax_fit_kernel``, its fold batch
``_softmax_fit_folds``), the one-vs-rest route, the family rule, the
``TX_LR_FOLDS_ELEMS`` route choice, scoring and contributions of
``"betas"`` params, and the class-pair Gram ``packed_newton._gram_2d``.
These mirror the reference's own cases in ``tests/test_models.py``
(:385-800); its bf16-Hessian case is a TPU route and stays out.

Tolerances: with reg > 0 the softmax betas within rtol 1e-4, atol 1e-5 of
the reference's.  The intercepts (never penalized), and with reg = 0 the
betas too, are fixed only up to a common shift across classes (the
softmax's shift invariance): those are compared centred across classes
(atol 1e-5) and through the probabilities (atol 1e-5).  Against an
independent scipy L-BFGS optimum of the same objective: probabilities
within 2e-3 (3e-3 in the sweep), the reference's own bounds.  The Gram
within rtol 1e-5.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import PORT, mod
from transmogrifai_tpu.models import logistic_regression as ref_lr
from transmogrifai_tpu.models import packed_newton as ref_pn

lr = mod(PORT, "models.logistic_regression")
pn = mod(PORT, "models.packed_newton")


def _f32(a):
    return torch.as_tensor(np.asarray(a, np.float32))


def _blobs(n=600, seed=4, sd=0.5):
    rng = np.random.RandomState(seed)
    centers = np.array([[2.0, 0.0], [-2.0, 1.5], [0.0, -2.5]])
    y = np.repeat(np.arange(3.0), n // 3)
    X = centers[y.astype(int)] + sd * rng.randn(n, 2)
    return X, y


def _softmax_problem(seed=0, n=600, d=7, K=4):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, d).astype(np.float32)
    X[:, 2] = X[:, 2] * 30 + 100  # ill-conditioned scale and offset
    X[:, 5] = 3.0  # constant column
    Xz = (X - X.mean(0)) / np.where(X.std(0) > 0, X.std(0), 1.0)
    z = Xz @ (rng.randn(K, d) * 1.5).T
    P = np.exp(z - z.max(1, keepdims=True))
    P /= P.sum(1, keepdims=True)
    y = np.array([rng.choice(K, p=pp) for pp in P])
    w = (rng.rand(n) + 0.5).astype(np.float32)
    Yoh = np.zeros((n, K), np.float32)
    Yoh[np.arange(n), y] = 1.0
    return X, y, w, Yoh


def _centred(a):
    a = np.asarray(a, np.float64)
    return a - a.mean(axis=0)


def _probs(X, betas, b0s):
    z = np.asarray(X, np.float64) @ np.asarray(betas, np.float64).T + b0s
    p = np.exp(z - z.max(1, keepdims=True))
    return p / p.sum(1, keepdims=True)


def _assert_same_softmax(got_b, got_b0, want_b, want_b0, X, identified):
    if identified:
        np.testing.assert_allclose(got_b, want_b, rtol=1e-4, atol=1e-5)
    else:
        np.testing.assert_allclose(_centred(got_b), _centred(want_b),
                                   rtol=0, atol=1e-5)
    np.testing.assert_allclose(_centred(got_b0), _centred(want_b0),
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(_probs(X, got_b, got_b0),
                               _probs(X, want_b, want_b0), rtol=0, atol=1e-5)


def _ref_softmax(X, Yoh, w, reg, en=0.0, iters=30):
    b, b0 = ref_lr._softmax_fit_kernel(
        jnp.asarray(X), jnp.asarray(Yoh), jnp.asarray(w), jnp.asarray(reg),
        jnp.asarray(en), iters=iters)
    return np.asarray(b, np.float64), np.asarray(b0, np.float64)


def _port_softmax(X, Yoh, w, reg, en=0.0, iters=30):
    b, b0 = lr._softmax_fit_kernel(_f32(X), _f32(Yoh), _f32(w), _f32(reg),
                                   _f32(en), iters=iters)
    return b.numpy().astype(np.float64), b0.numpy().astype(np.float64)


@pytest.mark.parametrize("family,expect", [
    ("auto", "multinomial"), ("ovr", "ovr"), ("multinomial", "multinomial")])
def test_families_match_reference(family, expect):
    """(reference test_models.py:385) Both routes recover a separable
    3-class problem, and each equals the reference's fit."""
    X, y = _blobs()
    kw = dict(reg_param=0.01, max_iter=25, family=family)
    ref = ref_lr.OpLogisticRegression(**kw)
    port = lr.OpLogisticRegression(device="cpu", **kw)
    want, got = ref.fit_arrays(X, y), port.fit_arrays(X, y)
    assert got["family"] == want["family"] == expect
    np.testing.assert_array_equal(got["classes"], want["classes"])
    _assert_same_softmax(got["betas"], got["intercepts"], want["betas"],
                         want["intercepts"], X, identified=True)
    pred, raw, prob = port.predict_arrays(got, X)
    assert (pred == y).mean() > 0.97
    np.testing.assert_allclose(prob.sum(axis=1), 1.0, atol=1e-9)
    pred_np, raw_np, prob_np = port.predict_arrays_np(got, X)
    np.testing.assert_array_equal(pred, pred_np)
    np.testing.assert_allclose(prob, prob_np, rtol=0, atol=1e-12)
    np.testing.assert_allclose(raw, raw_np, rtol=0, atol=1e-12)
    # the reference's scoring of its own params against the port's of its
    # own: the same classes, probabilities within the fit tolerance
    want_pred, _, want_prob = ref.predict_arrays(want, X)
    np.testing.assert_array_equal(pred, want_pred)
    np.testing.assert_allclose(prob, want_prob, rtol=0, atol=1e-5)
    # the same params score alike in both packages
    ref_pred, ref_raw, ref_prob = ref.predict_arrays(got, X)
    np.testing.assert_array_equal(pred, ref_pred)
    np.testing.assert_allclose(prob, ref_prob, rtol=0, atol=1e-12)
    assert port.contributions(got).shape == (2,)
    np.testing.assert_allclose(port.contributions(got),
                               ref.contributions(got), rtol=0, atol=0)


@pytest.mark.parametrize("reg", [0.05, 0.0])
def test_softmax_kernel_matches_reference(reg):
    X, y, w, Yoh = _softmax_problem()
    want_b, want_b0 = _ref_softmax(X, Yoh, w, reg)
    got_b, got_b0 = _port_softmax(X, Yoh, w, reg)
    assert np.abs(got_b[:, 5]).max() == 0.0  # excluded column pinned
    _assert_same_softmax(got_b, got_b0, want_b, want_b0, X,
                         identified=reg > 0)


def _scipy_optimum(X, y, w, K, reg, active_mask=True):
    from scipy.optimize import minimize

    n, d = X.shape
    wsum = w.sum()
    mu = (w @ X) / wsum
    msq = (w @ (X * X)) / wsum
    var = msq - mu**2
    active = var > 1e-6 * msq + 1e-30 if active_mask else np.ones(d, bool)
    sd = np.where(active, np.sqrt(np.maximum(var, 1e-12)), 1.0)
    Xs = (X - mu) / sd * active

    def nll(theta):
        B = theta[: K * d].reshape(K, d)
        zz = Xs @ B.T + theta[K * d:]
        zz = zz - zz.max(axis=1, keepdims=True)
        logp = zz - np.log(np.exp(zz).sum(axis=1, keepdims=True))
        return (-(w * logp[np.arange(n), y]).sum() / wsum
                + 0.5 * reg * (B**2).sum())

    res = minimize(nll, np.zeros(K * d + K), method="L-BFGS-B",
                   options={"maxiter": 5000, "ftol": 1e-15, "gtol": 1e-11})
    beta = res.x[: K * d].reshape(K, d) * active / sd
    return beta, res.x[K * d:] - beta @ mu, nll, res.fun, sd, mu


def test_softmax_matches_independent_reference():
    """(reference test_models.py:417) The port's softmax Newton lands on
    the penalized optimum of an independent scipy L-BFGS minimization."""
    X, y, w, Yoh = _softmax_problem()
    K, reg = 4, 0.05
    betas, b0 = _port_softmax(X, Yoh, w, reg)
    assert np.abs(betas[:, 5]).max() == 0.0
    beta_ref, b0_ref, nll, fun, sd, mu = _scipy_optimum(X, y, w, K, reg)
    assert np.abs(_probs(X, betas, b0) - _probs(X, beta_ref, b0_ref)).max() \
        < 2e-3
    theta = np.concatenate([(betas * sd).reshape(-1), b0 + betas @ mu])
    assert nll(theta) <= fun + 1e-6


@pytest.mark.parametrize("seed,K", [(1, 3), (2, 4), (3, 5), (4, 3)])
def test_softmax_sweep_vs_scipy(seed, K):
    """(reference test_models.py:711) Random multiclass problems over
    seeds and class counts: the port's probabilities at the scipy
    optimum's."""
    rng = np.random.RandomState(seed)
    n, d = 400, 6
    X = rng.randn(n, d).astype(np.float32)
    z = X @ (rng.randn(K, d) * 1.2).T
    P = np.exp(z - z.max(1, keepdims=True))
    P /= P.sum(1, keepdims=True)
    y = np.array([rng.choice(K, p=pp) for pp in P])
    assert len(np.unique(y)) == K
    Yoh = np.zeros((n, K), np.float32)
    Yoh[np.arange(n), y] = 1.0
    w = (rng.rand(n) + 0.5).astype(np.float32)
    betas, b0 = _port_softmax(X, Yoh, w, 0.03)
    beta_ref, b0_ref, *_ = _scipy_optimum(X, y, w, K, 0.03,
                                          active_mask=False)
    assert np.abs(_probs(X, betas, b0) - _probs(X, beta_ref, b0_ref)).max() \
        < 3e-3


def test_default_multiclass_lr_grid_gives_real_metrics():
    """(reference test_models.py:488) The multiclass LR grid through the
    validator takes the fold route (not the binary batch): F1 > 0.9 on
    separable data, every candidate's fold metrics equal to the
    reference's within 1e-5."""
    rng = np.random.RandomState(11)
    n = 450
    centers = np.array([[2.5, 0.0], [-2.5, 1.0], [0.0, -3.0]])
    y = np.repeat(np.arange(3.0), n // 3)
    X = centers[y.astype(int)] + 0.6 * rng.randn(n, 2)
    out = []
    for pkg in ("transmogrifai_tpu", PORT):
        kw = {"device": "cpu"} if pkg == PORT else {}
        cv = mod(pkg, "selector.validator").OpCrossValidation(
            num_folds=3, stratify=True, seed=0,
            evaluator=mod(pkg, "evaluators.multiclass")
            .OpMultiClassificationEvaluator(), **kw)
        est = mod(pkg, "models.logistic_regression").OpLogisticRegression(
            max_iter=15, **kw)
        out.append(cv.validate(
            [(est, mod(pkg, "selector.factories").lr_grid())], X, y))
    want, got = out
    assert got.best_metric > 0.9
    assert got.best_params == want.best_params
    for g, r in zip(got.all_results, want.all_results):
        assert g["params"] == r["params"]
        np.testing.assert_allclose(g["fold_metrics"], r["fold_metrics"],
                                   rtol=0, atol=1e-5)


@pytest.mark.parametrize("reg", [0.0, 0.01])
def test_separable_and_zero_variance_columns(reg):
    """(reference test_models.py:578) Near-separable classes, reg 0 and
    constant-zero columns: finite, accurate, the excluded columns pinned
    at 0, and the reference's fit (probabilities; betas centred at
    reg = 0)."""
    rng = np.random.RandomState(5)
    n, K = 450, 3
    centers = np.array([[3.0, 0.0], [-3.0, 1.0], [0.0, -4.0]])
    y = np.repeat(np.arange(K), n // K)
    Xn = centers[y] + 0.1 * rng.randn(n, 2)
    X = np.zeros((n, 6), np.float32)
    X[:, 0], X[:, 2] = Xn[:, 0], Xn[:, 1]
    Yoh = np.zeros((n, K), np.float32)
    Yoh[np.arange(n), y] = 1.0
    w = np.ones(n, np.float32)
    b, b0 = _port_softmax(X, Yoh, w, reg, iters=20)
    assert np.isfinite(b).all() and np.isfinite(b0).all()
    assert ((X @ b.T + b0).argmax(1) == y).mean() > 0.97
    assert np.abs(b[:, [1, 3, 4, 5]]).max() == 0.0
    want_b, want_b0 = _ref_softmax(X, Yoh, w, reg, iters=20)
    if reg > 0:
        _assert_same_softmax(b, b0, want_b, want_b0, X, identified=True)
    else:
        # separable with reg 0: the optimum is at infinity and both fits
        # stop where the curvature floor leaves them; their decisions and
        # saturated probabilities agree
        np.testing.assert_array_equal((X @ b.T + b0).argmax(1),
                                      (X @ want_b.T + want_b0).argmax(1))
        np.testing.assert_allclose(_probs(X, b, b0),
                                   _probs(X, want_b, want_b0),
                                   rtol=0, atol=1e-3)


def test_family_contract():
    """(reference test_models.py:615) Unknown families raise at
    construction; binomial refuses > 2 classes; an explicit multinomial
    is honoured at any size; auto takes OvR past K(d+1) = 2048."""
    with pytest.raises(ValueError, match="unknown logistic family"):
        lr.OpLogisticRegression(family="multinominal", device="cpu")
    X = np.random.RandomState(0).randn(90, 2)
    y3 = np.repeat(np.arange(3.0), 30)
    with pytest.raises(ValueError, match="at most 2 outcome classes"):
        lr.OpLogisticRegression(family="binomial",
                                device="cpu").fit_arrays(X, y3)
    for fam, K, d in [("multinomial", 3, 1023), ("auto", 3, 1023),
                      ("auto", 3, 681), ("auto", 4, 511), ("ovr", 3, 2)]:
        got = lr.OpLogisticRegression(family=fam)._multiclass_family(K, d)
        want = ref_lr.OpLogisticRegression(family=fam)._multiclass_family(
            K, d)
        assert got == want, (fam, K, d)
    assert lr.OpLogisticRegression()._multiclass_family(3, 1023) == "ovr"
    assert lr.OpLogisticRegression()._multiclass_family(3, 681) \
        == "multinomial"


@pytest.mark.parametrize("budget", [None, "1000"])
@pytest.mark.parametrize("family", ["multinomial", "ovr"])
def test_fit_arrays_folds_matches_reference(monkeypatch, budget, family):
    """The k folds of one config: the batched softmax within the element
    budget, the per-fold fallback past it (TX_LR_FOLDS_ELEMS), OvR fold
    by fold - the same route in both packages, the same params."""
    if budget is not None:
        monkeypatch.setenv("TX_LR_FOLDS_ELEMS", budget)
    X, y = _blobs(n=450, seed=7, sd=1.2)
    masks = mod(PORT, "selector.validator").stratified_kfold_masks(
        y, 3, 0, True)
    W = masks.astype(np.float64) * np.random.RandomState(1).uniform(
        0.5, 1.5, len(y))
    calls = {"ref": 0, "port": 0}

    def spy(fn, key):
        def wrapped(*a, **kw):
            calls[key] += 1
            return fn(*a, **kw)
        return wrapped

    monkeypatch.setattr(ref_lr, "_softmax_fit_folds",
                        spy(ref_lr._softmax_fit_folds, "ref"))
    monkeypatch.setattr(lr, "_softmax_fit_folds",
                        spy(lr._softmax_fit_folds, "port"))
    kw = dict(reg_param=0.01, elastic_net_param=0.1, family=family)
    want = ref_lr.OpLogisticRegression(**kw).fit_arrays_folds(X, y, W)
    got = lr.OpLogisticRegression(device="cpu", **kw).fit_arrays_folds(
        X, y, W)
    batched = family == "multinomial" and budget is None
    assert calls["ref"] == int(batched)
    # the port's single fit is a one-row fold batch: 3 calls per fallback
    assert calls["port"] == (1 if batched else
                             3 if family == "multinomial" else 0)
    for g, r in zip(got, want):
        assert g["family"] == r["family"] == family
        _assert_same_softmax(g["betas"], g["intercepts"], r["betas"],
                             r["intercepts"], X, identified=True)


def test_fold_batch_equals_per_fold_fallback(monkeypatch):
    X, y = _blobs(n=450, seed=8, sd=1.0)
    W = mod(PORT, "selector.validator").stratified_kfold_masks(
        y, 3, 3, True).astype(np.float64)
    est = lr.OpLogisticRegression(reg_param=0.1, elastic_net_param=0.5,
                                  device="cpu")
    batched = est.fit_arrays_folds(X, y, W)
    monkeypatch.setenv("TX_LR_FOLDS_ELEMS", "1")
    per_fold = est.fit_arrays_folds(X, y, W)
    for b, p in zip(batched, per_fold):
        _assert_same_softmax(b["betas"], b["intercepts"], p["betas"],
                             p["intercepts"], X, identified=True)


@pytest.mark.parametrize("elems", [None, "4096"])
def test_gram_2d_matches_reference(monkeypatch, elems):
    """The class-pair Gram, in one piece and row-chunked: each chunk
    within the element budget, the partials added in row order."""
    if elems is not None:
        monkeypatch.setenv("TX_PACKED_GRAM_ELEMS", elems)
    rng = np.random.RandomState(2)
    n, d, B = 1003, 5, 9
    X = rng.randn(n, d).astype(np.float32)
    M = rng.rand(n, B).astype(np.float32)
    assert pn._gram_chunk_rows(n, B, d) == ref_pn._gram_chunk_rows(n, B, d)
    if elems is not None:
        assert pn._gram_chunk_rows(n, B, d) < n
    got = pn._gram_2d(_f32(X), _f32(M)).numpy()
    want = np.asarray(ref_pn._gram_2d(jnp.asarray(X), jnp.asarray(M)))
    assert got.shape == (d, B * d)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)
    exact = np.einsum("nj,nb,nl->jbl", X.astype(np.float64),
                      M.astype(np.float64), X.astype(np.float64))
    np.testing.assert_allclose(got.reshape(d, B, d), exact, rtol=1e-5,
                               atol=1e-4)
