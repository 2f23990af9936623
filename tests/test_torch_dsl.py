"""The torch package's feature DSL (``dsl.py``) against the JAX package's:
every ported operator gives the reference's column (arithmetic with x/0
and missing values giving nulls, scalar and reversed forms, the scalers,
pivots, vectorizers, bucketizers, percentiles, the row functions over
``map_values``, the sanity check, combine and alias, and the text, date,
geolocation, map and collection methods on the type lattice), LDA and
word2vec (their values within rtol 1e-4, their metadata equal)."""
import numpy as np
import pytest

from torch_parity import (
    PORT, REF, REFERENCE_DATE_MS, assert_features_match, mod, passengers,
    reset_uids, run_features, workflow,
)

N = 1500


def _dsl_features(pkg: str) -> list:
    """The same DSL expressions in ``pkg``, in one order."""
    mod(pkg, "dsl")
    fb = mod(pkg, "features.feature_builder").FeatureBuilder
    ft = mod(pkg, "types.feature_types")
    survived = fb.RealNN("survived").as_response()
    age = fb.Real("age").as_predictor()
    height = fb.Real("height").as_predictor()
    weight = fb.Real("weight").as_predictor()
    gender = fb.PickList("gender").as_predictor()
    near_zero = age - 30           # 0 where age is 30: x/0 below
    filled = age.fill_missing_with_mean()
    normed = filled.z_normalize()
    vec_num = age.vectorize(others=[height])
    vec_cat = gender.vectorize()
    transmogrify = mod(pkg, "ops.transmogrifier").transmogrify
    vec = transmogrify([age, height, gender, normed])
    kw = {"device": "cpu"} if pkg == PORT else {}
    return [
        age + height, age - height, age * height, height / near_zero,
        age / weight, age + 2, 2 + age, 10 - age, 3 * age, age * 0.5,
        100 / age, age / 0, near_zero, age - age,
        filled, normed, age.z_normalize(),
        filled.fill_missing_with_mean(default=7.0),
        gender.pivot(), gender.pivot(top_k=2, min_support=1,
                                     track_nulls=False),
        vec_num, vec_cat, survived.vectorize(),
        survived.vectorize().vectorize(others=[vec_num]),
        age.bucketize([20.0, 40.0, 60.0]),
        age.bucketize([30.0], track_nulls=False),
        height.auto_bucketize(survived), age.auto_bucketize(
            survived, track_nulls=False, max_depth=2),
        height.to_percentile(), age.to_percentile(buckets=10),
        gender.map_values(lambda v: v and v.upper(), ft.Text),
        age.map_values(lambda v: None if v is None else v // 10, ft.Real),
        gender.alias("sex"),
        gender.to_email_prefix(), gender.to_protocol(),
        gender.is_valid_url(), age.exists(lambda v: v > 40),
        gender.replace_with("other", "unknown"),
        age.filter_values(lambda v: v < 50, default=-1.0),
        gender.tokenize_regex("a"), gender.to_multi_pick_list(),
        survived.sanity_check(vec, remove_bad_features=True, **kw),
        vec_num.combine(vec_cat),
        vec.drop_indices_by(lambda meta: meta.indicator_value is not None),
    ]


def _values(col):
    if hasattr(col, "mask"):
        return (np.asarray(col.values).tolist(), np.asarray(col.mask).tolist())
    if hasattr(col, "metadata") and hasattr(col.metadata, "column_names"):
        return (np.asarray(col.values).tolist(), col.metadata.column_names())
    return list(col.to_list())


def test_every_ported_operator_matches_reference():
    outs = []
    for pkg in (REF, PORT):
        reset_uids(pkg)
        feats = _dsl_features(pkg)
        model = workflow(pkg, feats[0], passengers(pkg, N))
        model.set_result_features(*feats)
        data = model.train().score()
        outs.append([(type(data[f.name]).__name__, f.ftype.__name__,
                      _values(data[f.name])) for f in feats])
    ref, port = outs
    assert len(port) == len(ref)
    for i, (got, want) in enumerate(zip(port, ref)):
        assert got == want, f"expression {i}: {got[:2]} != {want[:2]}"


def test_arithmetic_gives_nulls_for_non_finite_and_missing():
    """x/0 (age 30), 0/0 and a missing operand are nulls, not inf or
    NaN values, as in the JAX package."""
    reset_uids(PORT)
    feats = _dsl_features(PORT)
    data = workflow(PORT, feats[3], passengers(PORT, N)).train().score()
    ratio, age = data[feats[3].name], data["age"]
    at_30 = np.asarray(age.mask) & (np.asarray(age.values) == 30.0)
    assert at_30.any()
    assert not np.asarray(ratio.mask)[at_30].any()
    assert not np.asarray(ratio.mask)[~np.asarray(age.mask)].any()
    assert np.isfinite(np.asarray(ratio.values)).all()


def _lattice_feature(pkg: str, type_name: str):
    fb = mod(pkg, "features.feature_builder").FeatureBuilder
    return getattr(fb, type_name)(f"f_{type_name.lower()}").as_predictor()


def _b64(v):
    import base64

    return None if v is None else base64.b64encode(v.encode()).decode()


#: one call of each method that came with the vectorizer slice (ROADMAP.md
#: queue 1, item 2), on the type lattice's features
ITEM_2_CALLS = {
    "tokenize": lambda f, ft: f("Text").tokenize(),
    "smart_vectorize": lambda f, ft: f("Text").smart_vectorize(),
    "scale": lambda f, ft: f("Real").scale(slope=2.0, intercept=1.0),
    "descale": lambda f, ft: (lambda s: s.descale(s))(f("Real").scale(
        scaling_type="log")),
    "to_isotonic_calibrated": lambda f, ft: f("Real").to_isotonic_calibrated(
        f("label")),
    "indexed": lambda f, ft: f("PickList").indexed(),
    "deindexed": lambda f, ft: f("PickList").indexed().deindexed(
        ["red", "green"]),
    "to_ngram_similarity": lambda f, ft: f("Text").to_ngram_similarity(
        f("TextArea")),
    "detect_languages": lambda f, ft: f("TextArea").detect_languages(),
    "recognize_entities": lambda f, ft: f("Text").recognize_entities(),
    "text_len": lambda f, ft: f("TextArea").text_len(),
    "to_email_domain": lambda f, ft: f("Email").to_email_domain(),
    "to_domain": lambda f, ft: f("URL").to_domain(),
    "is_valid_phone": lambda f, ft: f("Phone").is_valid_phone(),
    "detect_mime_types": lambda f, ft: f("Text").map_values(
        _b64, ft.Base64).detect_mime_types(),
    "jaccard_similarity": lambda f, ft: f("MultiPickList").jaccard_similarity(
        f("PickList").to_multi_pick_list()),
    "filter_map": lambda f, ft: f("TextMap").filter_map(
        allow_keys=["k1", "k3"]),
    "to_occur": lambda f, ft: f("Integral").to_occur(),
    "tf": lambda f, ft: f("TextList").tf(num_features=64),
    "idf": lambda f, ft: f("TextList").tf(num_features=64).idf(),
    "tfidf": lambda f, ft: f("TextList").tfidf(num_features=32,
                                               min_doc_freq=2),
    "count_vec": lambda f, ft: f("TextList").count_vec(vocab_size=50),
    "remove_stop_words": lambda f, ft: f("Text").tokenize().remove_stop_words(),
    "parse_phone": lambda f, ft: f("Phone").parse_phone(),
    "to_unit_circle": lambda f, ft: f("DateTime").to_unit_circle("DayOfWeek"),
}


@pytest.mark.parametrize("name", sorted(ITEM_2_CALLS) + ["lda", "word2vec"])
def test_unported_methods_raise_with_their_item(name):
    """No method is left unported (``UNPORTED`` is empty): every method of
    item 2 gives the JAX package's column on the type lattice, and LDA and
    word2vec (item 8) give it within rtol 1e-4, atol 1e-5, their metadata
    equal."""
    dsl = mod(PORT, "dsl")
    assert dsl.UNPORTED == {}
    if name in ("lda", "word2vec"):
        def build_unsupervised(pkg):
            mod(pkg, "dsl")
            toks = _lattice_feature(pkg, "TextList")
            if name == "lda":
                return [toks.count_vec(vocab_size=40).lda(k=3, max_iter=5)]
            return [toks.word2vec(vector_size=6, min_count=1)]

        want = run_features(REF, build_unsupervised, 300)
        got = run_features(PORT, build_unsupervised, 300)
        (gk, gv, gm), (wk, wv, wm) = ((s[:2], s[2], s[3:]) for s in
                                      (got[0], want[0]))
        assert gk == wk and gm == wm and gv.dtype == wv.dtype
        np.testing.assert_allclose(gv, wv, rtol=1e-4, atol=1e-5)
        assert np.abs(gv).sum() > 0
        return

    def build(pkg):
        mod(pkg, "dsl")
        ft = mod(pkg, "types.feature_types")

        def feature(t):
            if t == "label":
                return mod(pkg, "features.feature_builder").FeatureBuilder \
                    .RealNN("label").as_response()
            return _lattice_feature(pkg, t)

        return [ITEM_2_CALLS[name](feature, ft)]

    assert_features_match(build, n=300)


@pytest.mark.parametrize("ftype", ["Text", "TextList", "Date", "DateList",
                                   "Geolocation", "TextMap", "RealMap",
                                   "MultiPickListMap"])
def test_vectorize_of_every_vectorizer_group(ftype):
    """``vectorize()`` of the groups that came with item 2, as the JAX
    package's (the reference date pinned)."""
    def build(pkg):
        mod(pkg, "dsl")
        kw = ({"reference_date_ms": REFERENCE_DATE_MS}
              if ftype in ("Date", "DateList") else {})
        return [_lattice_feature(pkg, ftype).vectorize(**kw)]

    assert_features_match(build, n=300)


def test_every_reference_method_is_on_the_port():
    """``import transmogrifai_tpu_torch.dsl`` puts every method of the
    JAX package's DSL on ``Feature``."""
    mod(REF, "dsl")
    mod(PORT, "dsl")
    ref = {k for k, v in vars(mod(REF, "features.feature").Feature).items()
           if callable(v)}
    port = {k for k, v in vars(mod(PORT, "features.feature").Feature).items()
            if callable(v)}
    assert ref <= port, sorted(ref - port)
