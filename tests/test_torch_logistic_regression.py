"""Logistic regression in the torch package against the JAX package's.

``lr_newton_core`` (torch, float32, a Python loop of max_iter Newton steps)
is held against the JAX package's ``_lr_fit_kernel`` (jitted float32
``lax.scan``) on the same numpy inputs: an informative design matrix with
an inactive (constant) column, at reg/elastic-net pairs of the default
grid.  Betas and intercept agree within rtol 1e-4, atol 1e-5; the two sum
float32 matmuls in different orders and the Newton fixed point absorbs
the difference.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import PORT, mod
from transmogrifai_tpu.models import logistic_regression as ref_lr
from transmogrifai_tpu.models import packed_newton as ref_pn

lr = mod(PORT, "models.logistic_regression")
pn = mod(PORT, "models.packed_newton")


def _data(n=1500, d=6, seed=5):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, d) * np.array([1.0, 3.0, 0.5, 10.0, 1.0, 2.0])[:d]
    X[:, 3] += 170.0  # |mean| >> sd: exercises the global pre-centering
    X[:, 4] = 1.25  # constant: inactive, its coefficient stays 0
    logit = X[:, 0] - 0.4 * X[:, 1] + 0.05 * (X[:, 3] - 170.0) + 0.3
    y = (rng.rand(n) < 1.0 / (1.0 + np.exp(-logit))).astype(np.float64)
    w = rng.uniform(0.5, 1.5, n)
    return X, y, w


@pytest.mark.parametrize(
    "reg,en,weighted",
    [(0.0, 0.0, False), (0.001, 0.1, False), (0.2, 0.5, False),
     (0.001, 0.1, True)],
)
def test_lr_newton_core_matches_reference(reg, en, weighted):
    X, y, w = _data()
    if not weighted:
        w = np.ones(len(y))
    beta_ref, b0_ref = ref_lr._lr_fit_kernel(
        jnp.asarray(X), jnp.asarray(y), jnp.asarray(w),
        jnp.asarray(reg), jnp.asarray(en), iters=25,
    )
    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32))  # noqa: E731
    beta, b0 = lr.lr_newton_core(f32(X), f32(y), f32(w), f32(reg), f32(en),
                                 iters=25)
    np.testing.assert_allclose(beta.numpy(), np.asarray(beta_ref),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(float(b0), float(b0_ref), rtol=1e-4, atol=1e-5)
    assert float(beta[4]) == 0.0 == float(beta_ref[4])


def test_estimator_fit_and_predict_match_reference():
    X, y, _ = _data(seed=9)
    est_ref = ref_lr.OpLogisticRegression(reg_param=0.01, elastic_net_param=0.1)
    est = lr.OpLogisticRegression(reg_param=0.01, elastic_net_param=0.1,
                                  device="cpu")
    p_ref, p = est_ref.fit_arrays(X, y), est.fit_arrays(X, y)
    np.testing.assert_allclose(p["beta"], p_ref["beta"], rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(p["intercept"], p_ref["intercept"],
                               rtol=1e-4, atol=1e-5)
    # the same params score to the same predictions.  The margin is a
    # float32 dot whose terms reach ~10 before the intercept cancels them,
    # so it agrees to a few float32 ulps of 10 (atol 1e-5); probabilities
    # damp that by p(1-p) <= 1/4
    got = est.predict_arrays(p_ref, X)
    want = [np.asarray(a, np.float64) for a in est_ref.predict_arrays(p_ref, X)]
    assert all(a.dtype == np.float64 for a in got)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_allclose(got[1], want[1], rtol=0, atol=1e-5)
    np.testing.assert_allclose(got[2], want[2], rtol=0, atol=1e-6)


def test_non_pd_solve_zeroes_the_step():
    """A non-PD Hessian: the JAX solve gives NaN and guarded_step zeroes
    the step; solve_pos must do the same instead of raising."""
    H = np.array([[1.0, 2.0, 0.0], [2.0, 1.0, 0.0], [0.0, 0.0, 3.0]],
                 np.float32)
    g = np.array([1.0, -2.0, 0.5], np.float32)
    want = ref_pn.guarded_step(
        jax.scipy.linalg.solve(jnp.asarray(H), jnp.asarray(g), assume_a="pos"),
        jnp.asarray(g),
    )
    x = pn.solve_pos(torch.from_numpy(H), torch.from_numpy(g))
    assert torch.isnan(x).all()
    got = pn.guarded_step(x, torch.from_numpy(g))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got.numpy(), np.zeros(3, np.float32))


def test_guarded_step_matches_reference():
    """Converged (|g| at float32 noise) -> zero step; finite -> kept;
    a non-finite entry alone is zeroed."""
    delta = np.array([0.5, np.inf, -0.25], np.float32)
    for g in (np.array([1e-8, -1e-8, 0.0], np.float32),
              np.array([0.1, 0.0, -0.3], np.float32)):
        want = ref_pn.guarded_step(jnp.asarray(delta), jnp.asarray(g))
        got = pn.guarded_step(torch.from_numpy(delta), torch.from_numpy(g))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_multiclass_raises_with_roadmap_item():
    """Multiclass labels no longer raise the item-5 NotImplementedError:
    they take the reference's multinomial route (its betas within rtol
    1e-4, atol 1e-5 at reg > 0).  What still raises is the reference's
    own contract: ``family="binomial"`` refuses more than two classes."""
    X, _, _ = _data(n=60)
    y = (np.arange(60) % 3).astype(np.float64)
    est = lr.OpLogisticRegression(reg_param=0.1, device="cpu")
    got = est.fit_arrays(X, y)
    want = ref_lr.OpLogisticRegression(reg_param=0.1).fit_arrays(X, y)
    assert got["family"] == want["family"] == "multinomial"
    np.testing.assert_allclose(got["betas"], want["betas"], rtol=1e-4,
                               atol=1e-5)
    with pytest.raises(ValueError, match="at most 2 outcome classes"):
        lr.OpLogisticRegression(family="binomial", device="cpu").fit_arrays(
            X, y)
