"""models/linear_svc.py of the torch package against the JAX package's.

Single fits against ``_svc_fit_kernel`` and batched fold x grid fits
against ``_svc_fit_batched``: betas and intercepts within rtol 1e-4, atol
1e-5 (float32 Newton steps in another summation order); the batched fit
also within rtol 1e-5, atol 1e-6 of the port's own one-candidate fits.
``predict_arrays`` gives the reference's prediction and margins and no
probability; labels that are not binary raise as in the reference.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import PORT, REF, mod


def _data(n=500, d=7, seed=0, offset=False):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, d) * np.linspace(0.5, 4.0, d)
    if offset:  # |mean| >> std columns: the pre-centering path
        X = X + np.linspace(0.0, 30.0, d)
    X[:, -1] = 2.5  # a constant column: excluded, its coefficient 0
    z = (X - X.mean(0)) @ np.linspace(0.8, -0.5, d) / 2.0 + rng.randn(n)
    return X, (z > 0).astype(np.float64)


def _port(**kw):
    return mod(PORT, "models.linear_svc").OpLinearSVC(device="cpu", **kw)


def _fold_grid(y, k=3):
    masks = mod(REF, "selector.validator").stratified_kfold_masks(
        y, k, 42, True).astype(np.float64)
    grid = mod(REF, "selector.factories").lr_grid()
    g = len(grid)
    regs = np.tile([p["reg_param"] for p in grid], k)
    ens = np.tile([p["elastic_net_param"] for p in grid], k)
    return np.repeat(masks, g, axis=0), regs, ens


@pytest.mark.parametrize("reg", [0.0, 0.01, 0.2])
@pytest.mark.parametrize("offset", [False, True], ids=["X_plain", "X_offset"])
def test_fit_matches_reference(reg, offset):
    from transmogrifai_tpu.models.linear_svc import _svc_fit_kernel

    X, y = _data(offset=offset, seed=int(reg * 100))
    w = np.where(y == 1, 1.5, 1.0)
    want_b, want_b0 = _svc_fit_kernel(
        jnp.asarray(X, jnp.float32), jnp.asarray(y, jnp.float32),
        jnp.asarray(w, jnp.float32), jnp.asarray(reg, jnp.float32), iters=20)
    got = _port(reg_param=reg).fit_arrays(X, y, w)
    np.testing.assert_allclose(got["beta"], np.asarray(want_b), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(got["intercept"], float(want_b0), rtol=1e-4,
                               atol=1e-5)
    assert got["beta"][-1] == 0.0
    # the estimator's surface matches the reference's
    ref = mod(REF, "models.linear_svc").OpLinearSVC(reg_param=reg)
    want = ref.fit_arrays(X, y, w)
    np.testing.assert_allclose(got["beta"], want["beta"], rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("offset", [False, True], ids=["X_plain", "X_offset"])
def test_batched_fit_matches_reference(offset):
    from transmogrifai_tpu.models.linear_svc import _svc_fit_batched

    X, y = _data(offset=offset, seed=3)
    W, regs, ens = _fold_grid(y)
    want_b, want_b0 = _svc_fit_batched(
        jnp.asarray(X, jnp.float32), jnp.asarray(y, jnp.float32),
        jnp.asarray(W, jnp.float32), jnp.asarray(regs, jnp.float32), iters=20)
    got_b, got_b0 = _port().fit_arrays_batched(X, y, W, regs, ens)
    assert got_b.shape == (24, X.shape[1]) and got_b0.shape == (24,)
    np.testing.assert_allclose(got_b, np.asarray(want_b), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(got_b0, np.asarray(want_b0), rtol=1e-4, atol=1e-5)
    # and the reference estimator's own batched entry point
    ref = mod(REF, "models.linear_svc").OpLinearSVC()
    ref_b, _ = ref.fit_arrays_batched(X, y, W, regs, ens)
    np.testing.assert_allclose(got_b, ref_b, rtol=1e-4, atol=1e-5)


def test_batched_fit_matches_one_candidate_fits():
    X, y = _data(seed=4)
    W, regs, ens = _fold_grid(y)
    est = _port()
    got_b, got_b0 = est.fit_arrays_batched(X, y, W, regs, ens)
    for b in range(0, len(W), 3):
        one = _port(reg_param=regs[b]).fit_arrays(X, y, W[b])
        np.testing.assert_allclose(got_b[b], one["beta"], rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(got_b0[b], one["intercept"], rtol=1e-5,
                                   atol=1e-6)
    # device tensors are taken as they are
    dev = est.fit_arrays_batched(
        torch.tensor(X, dtype=torch.float32), torch.tensor(y, dtype=torch.float32),
        torch.tensor(W, dtype=torch.float32), regs, ens)
    np.testing.assert_array_equal(dev[0], got_b)


def test_predict_arrays_matches_reference():
    X, y = _data(seed=5)
    port = _port(reg_param=0.01)
    params = port.fit_arrays(X, y)
    ref = mod(REF, "models.linear_svc").OpLinearSVC(reg_param=0.01)
    pred_w, raw_w, prob_w = ref.predict_arrays(params, X)
    pred_g, raw_g, prob_g = port.predict_arrays(params, X)
    assert prob_g is None and prob_w is None
    np.testing.assert_array_equal(pred_g, np.asarray(pred_w))
    np.testing.assert_array_equal(raw_g, np.asarray(raw_w))
    assert ((pred_g == 1) == (raw_g[:, 1] > 0)).all()
    assert 0.6 < (pred_g == y).mean()
    np.testing.assert_array_equal(port.predict_arrays_np(params, X)[1], raw_g)
    np.testing.assert_array_equal(port.contributions(params),
                                  ref.contributions(params))


def test_non_binary_labels_raise_as_reference():
    X, y = _data(n=60)
    W = np.ones((2, 60))
    for labels in (np.arange(60) % 3.0, y + 1.0):
        for pkg in (REF, PORT):
            est = mod(pkg, "models.linear_svc").OpLinearSVC(
                **({"device": "cpu"} if pkg == PORT else {}))
            with pytest.raises(ValueError):
                est.fit_arrays(X, labels)
            with pytest.raises(ValueError):
                est.fit_arrays_batched(X, labels, W, np.zeros(2), np.zeros(2))


def test_defaults_match_reference():
    ref = mod(REF, "models.linear_svc").OpLinearSVC()
    port = mod(PORT, "models.linear_svc").OpLinearSVC()
    assert port.params == ref.params
    assert port.device == "cuda"
    if not torch.cuda.is_available():
        X, y = _data(n=20)
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            port.fit_arrays(X, y)
