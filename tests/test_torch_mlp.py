"""models/mlp.py of the torch package against the JAX package's.

The initial layers are bit-equal to the reference's ``_init_params``
(``jax.random.split`` and ``jax.random.normal`` through the port's
threefry).  On the same numpy inputs, binary and three-class, the trained
layers agree within atol 1e-4 (the bar of ``tests/test_cv_batching.py:
142-143``) and the probabilities within 1e-4; the batched fold fit agrees
with single fits within atol 1e-4 and with the reference's vmapped folds.
The numpy forward and its torch mirror agree with the reference's numpy
forward on the same params.
"""
import jax
import numpy as np
import pytest
import torch

from torch_parity import PORT, REF, mod

mlp = mod(PORT, "models.mlp")


def _data(n=300, d=4, k=2, seed=0):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, d) * np.array([1.0, 2.0, 0.5, 3.0])[:d]
    X[:, 1] += 7.0
    z = X[:, 0] - 0.5 * (X[:, 1] - 7.0)
    if k == 2:
        y = (z + 0.5 * rng.randn(n) > 0).astype(np.float64)
    else:
        y = np.digitize(z + 0.5 * rng.randn(n), [-0.7, 0.7]).astype(np.float64)
    return X, y, rng


@pytest.mark.parametrize("seed,sizes", [(42, (4, 10, 10, 2)), (7, (15, 20, 3)),
                                        (0, (539, 10, 10, 2))])
def test_init_bit_equal(seed, sizes):
    ref = mod(REF, "models.mlp")._init_params(jax.random.PRNGKey(seed), sizes)
    got = mlp.init_params(seed, sizes)
    assert len(got) == len(ref)
    for (W, b), (Wr, br) in zip(got, ref):
        np.testing.assert_array_equal(W, np.asarray(Wr))
        np.testing.assert_array_equal(b, np.asarray(br))


@pytest.mark.parametrize("k,hidden", [(2, (10, 10)), (3, (6,))])
def test_fit_matches_reference(k, hidden):
    X, y, rng = _data(k=k)
    w = rng.uniform(0.5, 1.5, len(y))
    kw = dict(hidden_layers=hidden, max_iter=60)
    ref = mod(REF, "models.mlp").OpMultilayerPerceptronClassifier(**kw)
    port = mlp.OpMultilayerPerceptronClassifier(device="cpu", **kw)
    want, got = ref.fit_arrays(X, y, w), port.fit_arrays(X, y, w)
    np.testing.assert_array_equal(got["classes"], want["classes"])
    np.testing.assert_allclose(got["mu"], want["mu"], rtol=1e-6)
    np.testing.assert_allclose(got["sd"], want["sd"], rtol=1e-6)
    for (W, b), (Wr, br) in zip(got["layers"], want["layers"]):
        np.testing.assert_allclose(W, Wr, atol=1e-4)
        np.testing.assert_allclose(b, br, atol=1e-4)
    pred, raw, prob = port.predict_arrays(got, X)
    rpred, rraw, rprob = ref.predict_arrays(want, X)
    np.testing.assert_allclose(prob, rprob, atol=1e-4)
    # the serving routes on the same params: the numpy forward is the
    # reference's, the torch mirror within float64 rounding of it
    np_out = port.predict_arrays_np(got, X)
    for a, b in zip(np_out, ref.predict_arrays_np(got, X)):
        np.testing.assert_array_equal(a, b)
    t_out = port.predict_arrays_torch(
        port.torch_params(got, torch.device("cpu")), torch.as_tensor(X))
    np.testing.assert_array_equal(t_out[0].numpy(), np_out[0])
    np.testing.assert_allclose(t_out[2].numpy(), np_out[2], rtol=1e-12,
                               atol=1e-15)


def test_folds_batched_match_single_fits_and_reference():
    X, y, rng = _data(n=200, d=4)
    fold = rng.randint(0, 3, len(y))
    W = np.stack([(fold != f).astype(np.float64) for f in range(3)])
    kw = dict(hidden_layers=(5,), max_iter=30)
    port = mlp.OpMultilayerPerceptronClassifier(device="cpu", **kw)
    ref = mod(REF, "models.mlp").OpMultilayerPerceptronClassifier(**kw)
    batched = port.fit_arrays_folds(X, y, W)
    want = ref.fit_arrays_folds(X, y, W)
    for f in range(3):
        single = port.fit_arrays(X, y, W[f])
        for (Wb, bb), (Ws, bs), (Wr, br) in zip(
                batched[f]["layers"], single["layers"], want[f]["layers"]):
            np.testing.assert_allclose(Wb, Ws, atol=1e-4)
            np.testing.assert_allclose(bb, bs, atol=1e-4)
            np.testing.assert_allclose(Wb, Wr, atol=1e-4)
            np.testing.assert_allclose(bb, br, atol=1e-4)


def test_carry_across_save_and_load(tmp_path):
    """The reference's fitted MLP (layers, classes, mu, sd) carried across
    scores as the reference's within 1e-6; the port's own, saved and
    loaded, scores bit for bit as before."""
    from torch_parity import carry_and_reload, passenger_features, passengers

    def build(pkg):
        survived, preds = passenger_features(pkg)
        vec = mod(pkg, "ops.transmogrifier").transmogrify(preds)
        kw = {"device": "cpu"} if pkg == PORT else {}
        est = mod(pkg, "models.mlp").OpMultilayerPerceptronClassifier(
            hidden_layers=(5,), max_iter=20, **kw)
        return [est.set_input(survived, vec).get_output()]

    carry_and_reload(build, lambda pkg: passengers(pkg, 300), tmp_path,
                     atol=1e-6)


def test_row_chunks_match_one_chunk(monkeypatch):
    """The training matmuls cut the rows into chunks (the last padded with
    zero-weight rows): the same fit as one chunk within atol 1e-5, and
    the reference's within 1e-4."""
    X, y, rng = _data(n=500)
    W = np.stack([(np.arange(500) % 3 != f).astype(np.float64)
                  for f in range(3)])
    kw = dict(hidden_layers=(5,), max_iter=30)
    port = mlp.OpMultilayerPerceptronClassifier(device="cpu", **kw)
    whole = port.fit_arrays_folds(X, y, W)
    monkeypatch.setattr(mlp, "CHUNK_ROWS", 64)   # 8 chunks, 12 rows padded
    chunked = port.fit_arrays_folds(X, y, W)
    want = mod(REF, "models.mlp").OpMultilayerPerceptronClassifier(
        **kw).fit_arrays_folds(X, y, W)
    for c, w, r in zip(chunked, whole, want):
        for (Wc, bc), (Ww, bw), (Wr, br) in zip(c["layers"], w["layers"],
                                                r["layers"]):
            np.testing.assert_allclose(Wc, Ww, atol=1e-5)
            np.testing.assert_allclose(bc, bw, atol=1e-5)
            np.testing.assert_allclose(Wc, Wr, atol=1e-4)
            np.testing.assert_allclose(bc, br, atol=1e-4)
