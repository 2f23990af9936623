"""The torch package's feature DSL (``dsl.py``) against the JAX package's:
every ported operator gives the reference's column (arithmetic with x/0
and missing values giving nulls, scalar and reversed forms, the scalers,
pivots, vectorizers, bucketizers, percentiles, the row functions over
``map_values``, the sanity check, combine and alias), and every method
whose stage is not ported raises ``NotImplementedError`` naming its
ROADMAP item."""
import numpy as np
import pytest

from torch_parity import PORT, REF, mod, passengers, reset_uids, workflow

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


def test_unported_methods_raise_with_their_item():
    dsl = mod(PORT, "dsl")
    fb = mod(PORT, "features.feature_builder").FeatureBuilder
    text = fb.Text("note").as_predictor()
    assert set(dsl.UNPORTED.values()) == {2, 8}
    assert dsl.UNPORTED["lda"] == dsl.UNPORTED["word2vec"] == 8
    ref_feature = mod(REF, "features.feature").Feature
    mod(REF, "dsl")
    for name, item in dsl.UNPORTED.items():
        assert hasattr(ref_feature, name), name
        with pytest.raises(NotImplementedError,
                           match=rf"Feature\.{name} .*queue 1, item {item}\)"):
            getattr(text, name)()
    for ftype in ("Text", "TextList", "Date", "DateList", "Geolocation",
                  "TextMap"):
        feat = getattr(fb, ftype)("x").as_predictor()
        with pytest.raises(NotImplementedError, match=r"item 2\)"):
            feat.vectorize()


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
