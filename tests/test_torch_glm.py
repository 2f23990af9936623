"""models/glm.py of the torch package against the JAX package's.

The same numpy inputs (an informative design matrix with a constant column
and an off-centre column) go through the reference's
``OpGeneralizedLinearRegression`` and the port's on the CPU, for each of
the five families and the tweedie log and power links: betas within rtol
1e-4, atol 1e-5; intercepts the same; predictions within rtol 1e-4.  The
fold fan-out (one batched IRLS over fold weights) is held against single
fits within atol 1e-5, the reference's own bar
(``tests/test_cv_batching.py:126-128``), and against the reference's
vmapped folds.  The serving mirror (``predict_arrays_torch``) equals the
numpy route.
"""
import numpy as np
import pytest
import torch

from torch_parity import PORT, REF, mod

CASES = [
    ("gaussian", {}),
    ("poisson", {}),
    ("gamma", {}),
    ("binomial", {}),
    ("tweedie", {"variance_power": 1.5, "link_power": 0.0}),
    ("tweedie", {"variance_power": 1.5, "link_power": -0.5}),
]


def _data(n=1200, seed=5):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, 5) * np.array([1.0, 0.5, 2.0, 1.0, 0.3])
    X[:, 3] = 0.75                 # constant: excluded
    X[:, 2] += 40.0               # off-centre: the global pre-centring
    z = 0.4 * X[:, 0] - 0.3 * X[:, 1] + 0.1 * (X[:, 2] - 40.0) + 0.2
    return X, z, rng


def _target(family: str, z, rng):
    if family == "gaussian":
        return z + 0.3 * rng.randn(len(z))
    if family == "poisson":
        return rng.poisson(np.exp(z)).astype(np.float64)
    if family == "binomial":
        return (rng.rand(len(z)) < 1 / (1 + np.exp(-z))).astype(np.float64)
    if family == "gamma":
        return rng.gamma(2.0, np.exp(z) / 2.0)
    # tweedie 1 < p < 2: compound Poisson-gamma, zeros included
    counts = rng.poisson(np.exp(z) * 0.8)
    return np.array([rng.gamma(2.0, 0.6, c).sum() for c in counts])


def _ests(family, kw, **more):
    ref = mod(REF, "models.glm").OpGeneralizedLinearRegression(
        family=family, reg_param=0.01, **kw, **more)
    port = mod(PORT, "models.glm").OpGeneralizedLinearRegression(
        family=family, reg_param=0.01, device="cpu", **kw, **more)
    return ref, port


@pytest.mark.parametrize("family,kw", CASES)
def test_fit_matches_reference(family, kw):
    X, z, rng = _data()
    y = _target(family, z, rng)
    w = rng.uniform(0.5, 1.5, len(y))
    ref, port = _ests(family, kw)
    want, got = ref.fit_arrays(X, y, w), port.fit_arrays(X, y, w)
    assert got["family"] == want["family"]
    assert got["link_power"] == want["link_power"]
    np.testing.assert_allclose(got["beta"], want["beta"], rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(got["intercept"], want["intercept"],
                               rtol=1e-4, atol=1e-5)
    assert got["beta"][3] == 0.0
    np.testing.assert_allclose(port.predict_arrays(got, X)[0],
                               ref.predict_arrays(want, X)[0], rtol=1e-4,
                               atol=1e-6)
    t = port.predict_arrays_torch(port.torch_params(got, torch.device("cpu")),
                                  torch.as_tensor(X))[0].numpy()
    np.testing.assert_allclose(t, port.predict_arrays_np(got, X)[0],
                               rtol=1e-12)
    np.testing.assert_array_equal(port.contributions(got), np.abs(got["beta"]))


@pytest.mark.parametrize("family,kw", CASES)
def test_folds_batched_match_single_fits_and_reference(family, kw):
    X, z, rng = _data(n=600, seed=8)
    y = _target(family, z, rng)
    fold = rng.randint(0, 3, len(y))
    W = np.stack([(fold != f).astype(np.float64) for f in range(3)])
    ref, port = _ests(family, kw, max_iter=10)
    batched = port.fit_arrays_folds(X, y, W)
    want = ref.fit_arrays_folds(X, y, W)
    assert len(batched) == 3
    for f in range(3):
        single = port.fit_arrays(X, y, W[f])
        np.testing.assert_allclose(batched[f]["beta"], single["beta"],
                                   atol=1e-5)
        np.testing.assert_allclose(batched[f]["intercept"],
                                   single["intercept"], atol=1e-5)
        np.testing.assert_allclose(batched[f]["beta"], want[f]["beta"],
                                   rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(batched[f]["intercept"],
                                   want[f]["intercept"], rtol=1e-4, atol=1e-5)


def test_family_and_power_checks():
    glm = mod(PORT, "models.glm")
    with pytest.raises(ValueError, match="unknown GLM family"):
        glm.OpGeneralizedLinearRegression(family="cauchy", device="cpu")
    with pytest.raises(ValueError, match="variance_power"):
        glm.OpGeneralizedLinearRegression(family="tweedie",
                                          variance_power=0.5, device="cpu")
    X, z, rng = _data(n=200)
    est = glm.OpGeneralizedLinearRegression(device="cpu").with_params(
        family="typo")
    with pytest.raises(ValueError, match="unknown GLM family"):
        est.fit_arrays(X, z)
    with pytest.raises(RuntimeError, match="CUDA"):
        if not torch.cuda.is_available():
            glm.OpGeneralizedLinearRegression().fit_arrays(X, z)
        else:
            raise RuntimeError("CUDA present")


@pytest.mark.parametrize("family", ["gaussian", "poisson"])
def test_carry_across_save_and_load(family, tmp_path):
    """The reference's fitted GLM (beta, intercept, family, link power)
    carried across scores as the reference's within rtol 1e-12; the port's
    own, saved and loaded, scores bit for bit as before."""
    from torch_parity import carry_and_reload, labelled_passengers, passenger_features

    def build(pkg):
        fb = mod(pkg, "features.feature_builder").FeatureBuilder
        label = fb.RealNN("response").as_response()
        _, preds = passenger_features(pkg)
        vec = mod(pkg, "ops.transmogrifier").transmogrify(preds)
        kw = {"device": "cpu"} if pkg == PORT else {}
        est = mod(pkg, "models.glm").OpGeneralizedLinearRegression(
            family=family, reg_param=0.01, **kw)
        return [est.set_input(label, vec).get_output()]

    def data(pkg):
        ds = labelled_passengers(pkg, 400)
        if family == "poisson":   # a count target from the same latent
            col = ds["response"]
            cols = mod(pkg, "types.columns")
            vals = np.floor(np.exp(0.5 * np.asarray(col.values)))
            ds = ds.with_column("response", cols.NumericColumn(
                vals, np.asarray(col.mask), col.feature_type))
        return ds

    carry_and_reload(build, data, tmp_path, rtol=1e-12)
