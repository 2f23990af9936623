"""ops/bucketizers.py and ``transmogrify(label=...)`` of the torch package
against the JAX package's.

``DecisionTreeNumericBucketizer`` must find exactly the reference's splits
on the passenger data's numeric columns (the port bins the column through
``bin_matrix`` and grows the tree in torch; the reference bins on the
host and grows it in JAX), and the label-aware ``transmogrify`` must give
a bit-equal design matrix with the same column names.
"""
import numpy as np

from torch_parity import PORT, REF, mod, passenger_features, passengers, reset_uids

N = 2000


def _fit_bucketizer(pkg, col: str, data, **kw):
    fb = mod(pkg, "features.feature_builder").FeatureBuilder
    survived = fb.RealNN("survived").as_response()
    feat = fb.Real(col).as_predictor()
    if pkg == PORT:
        kw["device"] = "cpu"
    buck = mod(pkg, "ops.bucketizers").DecisionTreeNumericBucketizer(**kw)
    buck.set_input(survived, feat)
    ds = mod(pkg, "workflow.workflow")._as_dataset(data, [survived, feat])
    model = buck.fit(ds)
    return model, model.transform(ds)[buck.output_name]


def test_tree_splits_match_reference():
    data_ref, data = passengers(REF, N), passengers(PORT, N)
    for col in ("age", "height", "weight"):
        for kw in ({}, {"max_depth": 2, "min_info_gain": 0.0},
                   {"min_instances_per_node": 50, "track_nulls": False}):
            m_ref, v_ref = _fit_bucketizer(REF, col, data_ref, **kw)
            m, v = _fit_bucketizer(PORT, col, data, **kw)
            assert m.splits == m_ref.splits, (col, kw)
            assert m.metadata == m_ref.metadata
            np.testing.assert_array_equal(v.values, v_ref.values)
            assert v.metadata.column_names() == v_ref.metadata.column_names()
    # the default gain gate keeps some columns' splits and drops others'
    kept = [bool(_fit_bucketizer(PORT, c, data)[0].splits)
            for c in ("age", "height", "weight")]
    assert any(kept)


def test_numeric_bucketizer_fixed_splits():
    outs = []
    for pkg in (REF, PORT):
        reset_uids(pkg)
        fb = mod(pkg, "features.feature_builder").FeatureBuilder
        age = fb.Real("age").as_predictor()
        nb = mod(pkg, "ops.bucketizers").NumericBucketizer([20.0, 40.0, 60.0])
        nb.set_input(age)
        ds = mod(pkg, "workflow.workflow")._as_dataset(passengers(pkg, 50), [age])
        outs.append(nb.transform(ds)[nb.output_name])
    np.testing.assert_array_equal(outs[1].values, outs[0].values)
    assert outs[1].metadata.column_names() == outs[0].metadata.column_names()


def _design(pkg):
    reset_uids(pkg)
    survived, preds = passenger_features(pkg)
    vec = mod(pkg, "ops.transmogrifier").transmogrify(preds, label=survived)
    kw = {"device": "cpu"} if pkg == PORT else {}
    wf = mod(pkg, "workflow.workflow").OpWorkflow(**kw)
    model = wf.set_result_features(vec).set_input_dataset(
        passengers(pkg, N)).train()
    return model.score()[vec.name]


def test_transmogrify_with_label_matches_reference():
    want, got = _design(REF), _design(PORT)
    assert got.values.dtype == want.values.dtype
    np.testing.assert_array_equal(got.values, want.values)
    assert got.metadata.column_names() == want.metadata.column_names()
    # the bucketizers added columns beyond the plain vectorizers'
    assert any("[" in name for name in got.metadata.column_names())
