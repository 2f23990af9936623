"""models/unsupervised.py of the torch package against the JAX package's.

LDA: the initial topics equal ``jax.random.dirichlet``'s within rtol 1e-5
(the port's threefry draws the gamma variates key for key); the EM topics
from the same initial topics, the EM topics of the whole fit, and the
inferred document mixtures agree within rtol 1e-4.  word2vec: on the same
token lists the vocabulary is equal and the embeddings agree within rtol
1e-4, atol 1e-5 (the numpy-drawn pairs, negatives and initial vectors are
the reference's draw for draw).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import PORT, REF, mod, reset_uids, workflow

uns = mod(PORT, "models.unsupervised")
ref_uns = mod(REF, "models.unsupervised")


def _counts(n=200, v=60, k=4, seed=0):
    rng = np.random.RandomState(seed)
    topics = rng.dirichlet(np.full(v, 0.3), size=k)
    theta = rng.dirichlet(np.full(k, 0.5), size=n)
    lengths = rng.poisson(30, n) + 1
    return np.stack([rng.multinomial(m, t @ topics)
                     for m, t in zip(lengths, theta)]).astype(np.float32)


def _t(a):
    return torch.tensor(np.asarray(a, np.float32))


@pytest.mark.parametrize("seed,k,v", [(42, 4, 60), (3, 10, 300)])
def test_initial_topics_match_jax_dirichlet(seed, k, v):
    want = np.asarray(jax.random.dirichlet(jax.random.PRNGKey(seed),
                                           jnp.full((v,), 1.0), (k,)))
    np.testing.assert_allclose(uns.initial_topics(seed, k, v), want,
                               rtol=1e-5)


def test_lda_em_and_inference_match_reference():
    counts = _counts()
    init = np.asarray(jax.random.dirichlet(jax.random.PRNGKey(42),
                                           jnp.full((60,), 1.0), (4,)))
    # the EM from the reference's own initial topics
    got = uns.lda_em_core(_t(counts), _t(init), float(np.float32(1.1)),
                          float(np.float32(1.01)), iters=30).numpy()
    want = np.asarray(ref_uns._lda_em_kernel(
        jnp.asarray(counts), 4, jnp.asarray(1.1), jnp.asarray(1.01),
        jax.random.PRNGKey(42), iters=30))
    np.testing.assert_allclose(got, want, rtol=1e-4)
    theta = uns.lda_infer_core(_t(counts), _t(want),
                               float(np.float32(1.1))).numpy()
    theta_ref = np.asarray(ref_uns._lda_infer_kernel(
        jnp.asarray(counts), jnp.asarray(want), jnp.asarray(1.1)))
    np.testing.assert_allclose(theta, theta_ref, rtol=1e-4)


def _vector_dataset(pkg, counts):
    ds = mod(pkg, "types.dataset").Dataset
    cols = mod(pkg, "types.columns")
    meta = mod(pkg, "types.vector_metadata")
    m = meta.VectorMetadata("counts", tuple(
        meta.VectorColumnMeta("counts", "OPVector", descriptor_value=f"w{j}")
        for j in range(counts.shape[1]))).reindexed()
    return ds({"counts": cols.VectorColumn(counts, m)})


def test_lda_estimator_fit_and_transform_match_reference():
    counts = _counts(n=150, v=40, seed=1)
    out = {}
    for pkg in (REF, PORT):
        reset_uids(pkg)
        fb = mod(pkg, "features.feature_builder").FeatureBuilder
        vec = fb.OPVector("counts").as_predictor()
        kw = {"device": "cpu"} if pkg == PORT else {}
        lda = mod(pkg, "models.unsupervised").OpLDA(k=5, max_iter=10, **kw)
        topics = lda.set_input(vec).get_output()
        model = workflow(pkg, topics, _vector_dataset(pkg, counts)).train()
        fitted = [s for s in model.stages if type(s).__name__ == "OpLDAModel"]
        out[pkg] = (fitted[0].topics, model.score()[topics.name])
    np.testing.assert_allclose(out[PORT][0], out[REF][0], rtol=1e-4)
    np.testing.assert_allclose(out[PORT][1].values, out[REF][1].values,
                               rtol=1e-4)
    assert out[PORT][1].metadata.column_names() == \
        out[REF][1].metadata.column_names()


def _token_lists(n=300, seed=2):
    rng = np.random.RandomState(seed)
    words = [f"w{i}" for i in range(25)]
    p = rng.dirichlet(np.full(25, 0.5))
    return [list(rng.choice(words, size=rng.randint(2, 12), p=p))
            for _ in range(n)]


@pytest.mark.parametrize("kw", [dict(vector_size=8, min_count=2, steps=300,
                                     batch=64),
                                dict(vector_size=16, min_count=5, steps=200,
                                     batch=256, window_size=2)])
def test_word2vec_matches_reference(kw):
    toks = _token_lists()
    models = {}
    for pkg in (REF, PORT):
        reset_uids(pkg)
        fb = mod(pkg, "features.feature_builder").FeatureBuilder
        f = fb.TextList("toks").as_predictor()
        dev = {"device": "cpu"} if pkg == PORT else {}
        est = mod(pkg, "models.unsupervised").OpWord2Vec(**kw, **dev)
        emb = est.set_input(f).get_output()
        ds = mod(pkg, "types.dataset").Dataset
        col = mod(pkg, "types.columns").column_from_list(
            toks, mod(pkg, "types.feature_types").TextList)
        model = workflow(pkg, emb, ds({"toks": col})).train()
        fitted = [s for s in model.stages
                  if type(s).__name__ == "OpWord2VecModel"][0]
        models[pkg] = (fitted, model.score()[emb.name].values)
    (got, gv), (want, wv) = models[PORT], models[REF]
    assert got.vocab == want.vocab and len(got.vocab) > 5
    np.testing.assert_allclose(got.vectors, want.vectors, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(gv, wv, rtol=1e-4, atol=1e-5)
    assert got.similar_words("w0", 3) and \
        [w for w, _ in got.similar_words("w0", 3)] == \
        [w for w, _ in want.similar_words("w0", 3)]


@pytest.mark.parametrize("family", ["lda", "word2vec"])
def test_carry_across_save_and_load(family, tmp_path):
    """``OpLDAModel``'s topics and alpha and ``OpWord2VecModel``'s vocab and
    vectors carried across give the reference's columns; the port's own
    models, saved and loaded, give the same columns bit for bit."""
    from torch_parity import carry_and_reload

    toks = _token_lists(n=120)

    def build(pkg):
        mod(pkg, "dsl")
        f = mod(pkg, "features.feature_builder").FeatureBuilder.TextList(
            "toks").as_predictor()
        if family == "lda":
            return [f.count_vec(vocab_size=20).lda(k=3, max_iter=4)]
        return [f.word2vec(vector_size=4, min_count=2)]

    def data(pkg):
        col = mod(pkg, "types.columns").column_from_list(
            toks, mod(pkg, "types.feature_types").TextList)
        return mod(pkg, "types.dataset").Dataset({"toks": col})

    carry_and_reload(build, data, tmp_path, rtol=1e-5, atol=1e-6)
