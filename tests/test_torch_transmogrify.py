"""transmogrify in the torch package against the JAX package's.

The vectorizers are host numpy in both packages, so the design matrices
must be bit-equal and the VectorMetadata column names equal.
"""
import numpy as np
import pytest

from torch_parity import (
    PORT, REF, REFERENCE_DATE_MS, assert_features_match, mod,
    passenger_features, passengers, reset_uids, workflow,
)


def _mixed_data(n: int, seed: int) -> dict:
    """Every vectorizer group this slice ports: Real (with nulls),
    Integral, Binary, RealNN, PickList and MultiPickList."""
    rng = np.random.RandomState(seed)
    real = rng.randn(n) * 4.0 + 2.0
    real[rng.rand(n) < 0.2] = np.nan
    return {
        "r": [None if np.isnan(v) else float(v) for v in real],
        "i": [None if u < 0.1 else int(k) for u, k in
              zip(rng.rand(n), rng.randint(0, 5, n))],
        "b": [None if u < 0.1 else bool(k) for u, k in
              zip(rng.rand(n), rng.randint(0, 2, n))],
        "nn": [float(v) for v in rng.rand(n)],
        "pick": [None if u < 0.05 else str(k) for u, k in
                 zip(rng.rand(n), rng.choice(list("abcdefg"), n))],
        "multi": [sorted(set(rng.choice(list("xyz"), rng.randint(0, 3))))
                  for _ in range(n)],
    }


def _mixed_features(pkg: str):
    fb = mod(pkg, "features.feature_builder").FeatureBuilder
    return [
        fb.Real("r").as_predictor(), fb.Integral("i").as_predictor(),
        fb.Binary("b").as_predictor(), fb.RealNN("nn").as_predictor(),
        fb.PickList("pick").as_predictor(),
        fb.MultiPickList("multi").as_predictor(),
    ]


def _design(pkg: str, case: str):
    reset_uids(pkg)
    if case == "passengers":
        _, feats = passenger_features(pkg)
        data = passengers(pkg, 2000)
    else:
        feats = _mixed_features(pkg)
        data = _mixed_data(1500, seed=7)
    vec = mod(pkg, "ops.transmogrifier").transmogrify(feats)
    scored = workflow(pkg, vec, data).train().score()
    col = scored[vec.name]
    return np.asarray(col.values), col.metadata.column_names()


@pytest.mark.parametrize("case", ["passengers", "mixed"])
def test_design_matrix_bit_equal(case):
    x_ref, names_ref = _design(REF, case)
    x_port, names_port = _design(PORT, case)
    assert x_port.dtype == x_ref.dtype
    assert x_port.shape == x_ref.shape
    np.testing.assert_array_equal(x_port, x_ref)
    assert names_port == names_ref


@pytest.mark.parametrize("type_name", ["Text", "Date", "TextMap", "Geolocation", "TextList"])
def test_unported_vectorizer_group_raises(type_name):
    """The groups that raised until the vectorizer slice (ROADMAP.md queue
    1, item 2) came: transmogrify of a Real and one feature of each gives
    the JAX package's design matrix and metadata, bit for bit (the
    reference date pinned)."""
    def build(pkg):
        fb = mod(pkg, "features.feature_builder").FeatureBuilder
        tm = mod(pkg, "ops.transmogrifier")
        feats = [fb.Real("f_real").as_predictor(),
                 getattr(fb, type_name)(f"f_{type_name.lower()}")
                 .as_predictor()]
        return [tm.transmogrify(feats, defaults=tm.TransmogrifierDefaults(
            reference_date_ms=REFERENCE_DATE_MS))]

    got = assert_features_match(build, n=500)
    assert got[0][2].shape[1] > 2
    assert "PORTED_GROUPS" not in vars(mod(PORT, "ops.transmogrifier"))


def test_label_aware_bucketizing_raises():
    """With a label, Real and Integral features get one decision-tree
    bucketizer each (tests/test_torch_bucketizers.py holds them against
    the JAX package); beside a map group, the design matrix is the JAX
    package's, bit for bit."""
    fb = mod(PORT, "features.feature_builder").FeatureBuilder
    label = fb.RealNN("y").as_response()
    transmogrify = mod(PORT, "ops.transmogrifier").transmogrify
    vec = transmogrify([fb.Real("r").as_predictor(),
                        fb.Integral("i").as_predictor(),
                        fb.Binary("b").as_predictor()], label=label)
    parts = [type(f.origin_stage).__name__
             for f in vec.origin_stage.input_features]
    assert parts.count("DecisionTreeNumericBucketizer") == 2

    def build(pkg):
        fb = mod(pkg, "features.feature_builder").FeatureBuilder
        label = fb.RealNN("label").as_response()
        return [mod(pkg, "ops.transmogrifier").transmogrify(
            [fb.Real("f_real").as_predictor(),
             fb.TextMap("f_textmap").as_predictor()], label=label)]

    got = assert_features_match(build, n=500)
    parents = {m[0] for m in got[0][4]}
    assert parents == {"f_real", "f_textmap"}
