"""Linear regression and the tree regressors in the torch package against
the JAX package's.

``linreg_core`` (one fit) and ``linreg_fit_batched_core`` (the fold x grid
batch) are held against the reference's ``_linreg_fit_kernel`` and its
vmapped ``_linreg_fit_batched`` on the same numpy inputs - an informative
design matrix with a constant column and a column of high mean and low
spread - at the default grid's reg/elastic-net pairs: betas within rtol
1e-4, atol 1e-5, intercepts within rtol 1e-4, atol 1e-5.  The estimator's
fit and scoring mirror the reference's cases (``tests/test_models.py``
:108-127, :515); the random forest and GBT regressors equal the
reference's trees (``torch_parity.tree_fits_agree``) and predictions
within 1e-5 on rows no split tie touches.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import PORT, REF, mod, tree_fits_agree
from transmogrifai_tpu.models import linear_regression as ref_lin

lin = mod(PORT, "models.linear_regression")
GRID = [(0.0, 0.0), (0.001, 0.1), (0.01, 0.5), (0.2, 0.5)]


def _f32(a):
    return torch.as_tensor(np.asarray(a, np.float32))


def _data(n=1500, seed=3):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, 6) * np.array([1.0, 3.0, 0.5, 10.0, 1.0, 2.0])
    X[:, 3] += 170.0  # |mean| >> sd: the global pre-centring
    X[:, 4] = 1.25   # constant: excluded, its coefficient stays 0
    y = (1.5 * X[:, 0] - 0.4 * X[:, 1] + 0.05 * (X[:, 3] - 170.0) + 0.7
         + 0.3 * rng.randn(n))
    w = rng.uniform(0.5, 1.5, n)
    return X, y, w


@pytest.fixture
def regression_data():
    rng = np.random.RandomState(0)
    X = rng.randn(500, 6)
    y = X @ np.array([1.0, 2.0, 0.0, -1.0, 0.5, 0.0]) + 0.7 + 0.1 * rng.randn(500)
    return X, y


@pytest.mark.parametrize("reg,en", GRID)
@pytest.mark.parametrize("weighted", [False, True])
def test_linreg_core_matches_reference(reg, en, weighted):
    X, y, w = _data()
    if not weighted:
        w = np.ones(len(y))
    beta_ref, b0_ref = ref_lin._linreg_fit_kernel(
        jnp.asarray(X), jnp.asarray(y), jnp.asarray(w), jnp.asarray(reg),
        jnp.asarray(en))
    beta, b0 = lin.linreg_core(_f32(X), _f32(y), _f32(w), _f32(reg), _f32(en))
    np.testing.assert_allclose(beta.numpy(), np.asarray(beta_ref),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(float(b0), float(b0_ref), rtol=1e-4, atol=1e-5)
    assert float(beta[4]) == 0.0 == float(beta_ref[4])


def test_batched_core_matches_reference_and_single_fits():
    """The fold x grid batch: 3 fold masks x the 4 grid points, fold-major
    as the validator tiles them, against the reference's vmapped batch
    and against the port's own single fits."""
    X, y, w = _data(seed=4)
    masks = mod(PORT, "selector.validator").stratified_kfold_masks(
        y, 3, 0, False)
    W = np.repeat(masks.astype(np.float64) * w[None, :], len(GRID), axis=0)
    regs = np.tile([g[0] for g in GRID], 3)
    ens = np.tile([g[1] for g in GRID], 3)
    beta_ref, b0_ref = ref_lin._linreg_fit_batched(
        jnp.asarray(X), jnp.asarray(y), jnp.asarray(W), jnp.asarray(regs),
        jnp.asarray(ens))
    est = lin.OpLinearRegression(device="cpu")
    betas, b0s = est.fit_arrays_batched(X, y, W, regs, ens)
    np.testing.assert_allclose(betas, np.asarray(beta_ref), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(b0s, np.asarray(b0_ref), rtol=1e-4, atol=1e-5)
    for b in range(len(regs)):
        one = est.with_params(reg_param=regs[b],
                              elastic_net_param=ens[b]).fit_arrays(X, y, W[b])
        np.testing.assert_allclose(betas[b], one["beta"], rtol=1e-4,
                                   atol=1e-5)
        np.testing.assert_allclose(b0s[b], one["intercept"], rtol=1e-4,
                                   atol=1e-5)


def test_batched_nan_guard_is_per_candidate():
    """A candidate whose weights select no rows has no finite solve: it
    keeps its zero start, the others fit as alone."""
    X, y, _ = _data(n=300, seed=5)
    W = np.ones((2, len(y)))
    W[1] = 0.0
    W[1, :1] = 1.0  # one row: every column is constant under w
    est = lin.OpLinearRegression(device="cpu")
    betas, b0s = est.fit_arrays_batched(X, y, W, np.array([0.01, 0.01]),
                                        np.zeros(2))
    alone = est.with_params(reg_param=0.01).fit_arrays(X, y)
    np.testing.assert_allclose(betas[0], alone["beta"], rtol=1e-4, atol=1e-5)
    assert np.isfinite(betas).all() and np.isfinite(b0s).all()
    np.testing.assert_array_equal(betas[1], 0.0)
    np.testing.assert_allclose(b0s[1], y[0], rtol=1e-6)


def test_linear_regression_recovers_the_planted_model(regression_data):
    """(reference test_models.py:108) RMSE < 0.2 and the intercept near
    0.7; the fit, the device and numpy scoring equal the reference's."""
    X, y = regression_data
    ref = ref_lin.OpLinearRegression(reg_param=0.001)
    est = lin.OpLinearRegression(reg_param=0.001, device="cpu")
    params, want = est.fit_arrays(X, y), ref.fit_arrays(X, y)
    pred, raw, prob = est.predict_arrays(params, X)
    assert raw is None and prob is None and pred.dtype == np.float64
    assert float(np.sqrt(np.mean((pred - y) ** 2))) < 0.2
    assert abs(params["intercept"] - 0.7) < 0.1
    np.testing.assert_allclose(params["beta"], want["beta"], rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(params["intercept"], want["intercept"],
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(pred, ref.predict_arrays(params, X)[0],
                               rtol=0, atol=1e-5)
    pred_np = est.predict_arrays_np(params, X)[0]
    np.testing.assert_array_equal(pred_np, ref.predict_arrays_np(params, X)[0])
    np.testing.assert_allclose(pred, pred_np, rtol=0, atol=1e-5)
    np.testing.assert_array_equal(est.contributions(params),
                                  ref.contributions(params))
    assert est.batched_needs_binary_y is False


def test_high_mean_low_variance_columns():
    """(reference test_models.py:515) Two distinct rows, 40 columns of
    mean/spread ~ 300: finite betas and predictions that track y, for
    linear regression and for the logistic families (binary and a
    3-class label)."""
    row_a = 0.03 + 0.0003 * np.arange(40)
    row_b = row_a + 0.0005 * ((-1.0) ** np.arange(40))
    X = np.tile(np.stack([row_a, row_b]), (20, 1))
    y = np.tile([0.0, 1.0], 20)
    est = lin.OpLinearRegression(reg_param=0.01, device="cpu")
    p = est.fit_arrays(X, y)
    assert np.isfinite(p["beta"]).all() and np.isfinite(p["intercept"])
    yhat = est.predict_arrays(p, X)[0]
    assert np.corrcoef(yhat, y)[0, 1] > 0.99
    lr = mod(PORT, "models.logistic_regression").OpLogisticRegression(
        reg_param=0.01, max_iter=25, device="cpu")
    pl = lr.fit_arrays(X, y)
    assert np.isfinite(pl["beta"]).all() and np.isfinite(pl["intercept"])
    assert (lr.predict_arrays(pl, X)[0] == y).mean() == 1.0
    X3 = np.tile(np.stack([row_a, row_b, row_a - 0.0004]), (20, 1))
    y3 = np.tile([0.0, 1.0, 2.0], 20)
    p3 = lr.fit_arrays(X3, y3)
    assert p3["family"] == "multinomial"
    assert np.isfinite(p3["betas"]).all()
    assert np.isfinite(p3["intercepts"]).all()


def test_unported_routes_raise():
    """The streamed fit raises with its item; the fused training seam is
    ported (``fused_train_core`` gives the reference's keys, and its fit
    is the batched fit's, bit for bit), and so is the scoring mirror of
    the device-fused program (``predict_arrays_torch``: a float64 matmul,
    whose row sums may take another order than numpy's BLAS, so within a
    few ULP of it)."""
    est = lin.OpLinearRegression(device="cpu")
    for call in (lambda: est.streaming_fit_stats(None, None),
                 lambda: est.fit_from_stats([])):
        with pytest.raises(NotImplementedError, match="item 12"):
            call()
    core = est.fused_train_core(False)
    want = mod(REF, "models.linear_regression").OpLinearRegression() \
        .fused_train_core(False)
    assert sorted(core) == sorted(want) == ["fit", "score", "sig"]
    assert core["sig"] == want["sig"]
    rng = np.random.RandomState(5)
    Xf = torch.tensor(rng.randn(200, 4), dtype=torch.float32)
    yf = Xf @ torch.tensor([1.0, -2.0, 0.5, 0.0]) + 0.1
    W = torch.tensor((rng.rand(3, 200) > 0.3).astype(np.float32))
    regs, ens = torch.tensor([0.0, 0.1, 0.1]), torch.tensor([0.0, 0.0, 0.5])
    for a, b in zip(core["fit"](Xf, yf, W, regs, ens),
                    lin.linreg_fit_batched_core(Xf, yf, W, regs, ens)):
        assert torch.equal(a, b)
    assert not hasattr(est, "predict_arrays_xla")
    rng = np.random.RandomState(4)
    X = rng.randn(50, 3)
    params = est.fit_arrays(X, X @ [1.0, -2.0, 0.5] + 0.1)
    got = est.predict_arrays_torch(
        est.torch_params(params, torch.device("cpu")), torch.from_numpy(X))
    np.testing.assert_allclose(got[0].numpy(),
                               est.predict_arrays_np(params, X)[0],
                               rtol=16 * 2.0 ** -52, atol=0)


REGRESSORS = [
    ("OpRandomForestRegressor", dict(num_trees=20, max_depth=6), 0.7),
    ("OpGBTRegressor", dict(num_trees=30, max_depth=4), 0.8),
    ("OpDecisionTreeRegressor", dict(max_depth=6), 0.7),
]


@pytest.mark.parametrize("cls_name,kw,r2_min", REGRESSORS,
                         ids=[r[0] for r in REGRESSORS])
def test_tree_regressors_match_reference(regression_data, cls_name, kw,
                                         r2_min):
    """(reference test_models.py:117-127) The forest (n_stats 3, variance,
    a third of the features per node), the GBT and the single tree on the
    planted linear model: R2 above the reference's bound, and the
    reference's trees and predictions."""
    X, y = regression_data
    ref = getattr(mod(REF, "models.trees"), cls_name)(backend="jax", **kw)
    port = getattr(mod(PORT, "models.trees"), cls_name)(device="cpu", **kw)
    want, got = ref.fit_arrays(X, y), port.fit_arrays(X, y)
    tied = tree_fits_agree(want, got, X, classification=False,
                           gbt="f0" in want)
    # kind-2 ties (two features splitting a node's few rows alike) are
    # common in 500-row depth-6 trees: the trees test's bound
    assert tied.mean() < 0.2
    pred = port.predict_arrays(got, X)[0]
    r2 = 1 - np.sum((pred - y) ** 2) / np.sum((y - y.mean()) ** 2)
    assert r2 > r2_min
    np.testing.assert_allclose(pred[~tied],
                               np.asarray(ref.predict_arrays(want, X)[0])[~tied],
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(port.predict_arrays_np(got, X)[0], pred,
                               rtol=0, atol=1e-5)
