"""models/naive_bayes.py of the torch package against the JAX package's.

``fit_arrays``, ``fit_arrays_folds`` (each fold's shift from its own train
rows, the class set of the full data) and ``predict_arrays`` /
``predict_arrays_np`` on the same seeded data: theta, prior and shift
within 1e-6 (float32 sums in another order).  Scores: the float32 log
posteriors sum d terms x_j * theta_kj of magnitude up to ~10, so theta's
1e-6 carries to ~5e-5 in them; the log posteriors are held within rtol
1e-5 and the probabilities within 5e-5 when each package scores its own
fit, and within 1e-5 when both score the same params; the float64 host
route within 1e-6 of the reference's on the same params; predictions
equal.
"""
import numpy as np
import pytest
import torch

from torch_parity import PORT, REF, mod


def _data(n=400, d=6, k=2, seed=0, negative=False):
    rng = np.random.RandomState(seed)
    y = rng.randint(0, k, n).astype(np.float64)
    X = rng.poisson(1.0 + y[:, None] * np.linspace(0.2, 1.5, d),
                    size=(n, d)).astype(np.float64)
    if negative:  # a shifted column: the non-negativity shift
        X[:, 1] -= 3.0
        X[5, 2] = -40.0  # one outlier row
    return X, y


def _pair(**kw):
    return (mod(REF, "models.naive_bayes").OpNaiveBayes(**kw),
            mod(PORT, "models.naive_bayes").OpNaiveBayes(device="cpu", **kw))


def _close(got, want):
    for key in ("theta", "prior", "shift"):
        np.testing.assert_allclose(got[key], want[key], rtol=0, atol=1e-6)
    np.testing.assert_array_equal(got["classes"], want["classes"])


@pytest.mark.parametrize("k,negative,smoothing", [
    (2, False, 1.0), (3, True, 1.0), (2, True, 0.5)])
def test_fit_and_predict_match_reference(k, negative, smoothing):
    X, y = _data(k=k, negative=negative, seed=k)
    w = np.where(y == 1, 2.0, 1.0)
    ref, port = _pair(smoothing=smoothing)
    want, got = ref.fit_arrays(X, y, w), port.fit_arrays(X, y, w)
    _close(got, want)
    pred_w, raw_w, prob_w = ref.predict_arrays(want, X)
    pred_g, raw_g, prob_g = port.predict_arrays(got, X)
    np.testing.assert_allclose(raw_g, raw_w, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(prob_g, prob_w, rtol=0, atol=5e-5)
    np.testing.assert_array_equal(pred_g, pred_w)
    same = port.predict_arrays(want, X)
    np.testing.assert_allclose(same[2], prob_w, rtol=0, atol=1e-5)
    # the float64 host route: the reference's on the same params, and the
    # device route's scores on the port's own
    for g, w in zip(port.predict_arrays_np(want, X),
                    ref.predict_arrays_np(want, X)):
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-6)
    np.testing.assert_allclose(port.predict_arrays_np(got, X)[2], prob_g,
                               rtol=0, atol=1e-5)


def test_fit_arrays_folds_matches_reference():
    X, y = _data(k=3, negative=True, seed=7)
    W = mod(REF, "selector.validator").stratified_kfold_masks(
        y, 3, 42, True).astype(np.float64)
    W[0, :10] = 0.0  # a fold without some class-0 rows
    ref, port = _pair()
    want, got = ref.fit_arrays_folds(X, y, W), port.fit_arrays_folds(X, y, W)
    assert len(got) == len(want) == 3
    for f in range(3):
        _close(got[f], want[f])
        # a fold is a one-fold fit
        one = port.fit_arrays(X, y, W[f])
        for key in ("theta", "prior", "shift"):
            np.testing.assert_array_equal(one[key], got[f][key])
    # the outlier row sits in one fold's validation split: only the folds
    # that train on it shift by it
    shifts = [g["shift"][2] for g in got]
    assert sorted(shifts)[0] == -40.0 and max(shifts) > -40.0


def test_defaults_match_reference():
    ref, _ = _pair()
    port = mod(PORT, "models.naive_bayes").OpNaiveBayes()
    assert port.params == ref.params
    assert port.device == "cuda"
    if not torch.cuda.is_available():
        X, y = _data(n=20)
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            port.fit_arrays(X, y)
