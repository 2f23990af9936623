"""The torch package's collection, indexing and calibration stages
(``ops/collections.py``, ``ops/categorical.py``'s ``StringIndexer`` and
``IndexToString``, ``preparators/deindexer.py``) against the JAX
package's: ``FilterMap``, ``ToOccurTransformer``, the scaler and descalers,
the string indexer and its inverses equal; the isotonic calibrator within
1e-12."""
import numpy as np
import pytest

from torch_parity import (
    PORT, REF, assert_features_match, assert_same, column_state, mod,
    run_features, workflow,
)

N = 400


def _collection_features(pkg: str) -> list:
    mod(pkg, "dsl")
    col = mod(pkg, "ops.collections")
    cat = mod(pkg, "ops.categorical")
    fb = mod(pkg, "features.feature_builder").FeatureBuilder
    real = fb.Real("f_real").as_predictor()
    integral = fb.Integral("f_integral").as_predictor()
    text = fb.Text("f_text").as_predictor()
    pick = fb.PickList("f_picklist").as_predictor()
    tlist = fb.TextList("f_textlist").as_predictor()
    tmap = fb.TextMap("f_textmap").as_predictor()
    rmap = fb.RealMap("f_realmap").as_predictor()
    geo = fb.Geolocation("f_geolocation").as_predictor()
    scaled = col.ScalerTransformer(slope=2.5, intercept=-1.0) \
        .set_input(real).get_output()
    logged = col.ScalerTransformer(scaling_type="log") \
        .set_input(real).get_output()
    indexed = cat.StringIndexer().set_input(pick).get_output()
    return [
        col.FilterMap(allow_keys=["k1", "k2"]).set_input(tmap).get_output(),
        col.FilterMap(block_keys=["k2"], clean_keys=False)
        .set_input(rmap).get_output(),
        rmap.filter_map(block_keys=["k3"]),
        col.ToOccurTransformer().set_input(real).get_output(),
        col.ToOccurTransformer().set_input(text).get_output(),
        col.ToOccurTransformer().set_input(tlist).get_output(),
        col.ToOccurTransformer().set_input(tmap).get_output(),
        col.ToOccurTransformer().set_input(geo).get_output(),
        integral.to_occur(),
        scaled, logged, real.scale(slope=-3.0, intercept=0.5),
        col.DescalerTransformer().set_input(scaled, scaled).get_output(),
        col.DescalerTransformer().set_input(logged, logged).get_output(),
        scaled.descale(scaled),
        indexed, text.indexed(),
        cat.IndexToString(labels=["red", "green"]).set_input(indexed)
        .get_output(),
        indexed.deindexed(["blue", "red", "green", "x"]),
    ]


def test_collection_stages_match_reference():
    got = assert_features_match(_collection_features, n=N)
    indexed = got[15]
    assert set(np.unique(indexed[2][indexed[3]])) == {0.0, 1.0, 2.0}
    assert not indexed[3].all()  # a missing pick list stays missing


def test_to_occur_with_a_match_function():
    """(A stage holding a function is refused by both packages' workflow
    checks, so the transform is called directly.)"""
    outs = []
    for pkg in (REF, PORT):
        col = mod(pkg, "ops.collections")
        cols = mod(pkg, "types.columns")
        ftm = mod(pkg, "types.feature_types")
        c = cols.column_from_list([3, None, 70, 51, 50], ftm.Integral)
        out = col.ToOccurTransformer(
            matches=lambda v: v is not None and v > 50
        ).transform_columns([c], None)
        outs.append(column_state(out))
    assert_same(outs[1], outs[0])
    assert list(outs[1][2]) == [0.0, 0.0, 1.0, 1.0, 0.0]


def test_string_indexer_order_and_unseen_values():
    """Frequency descending, then value ascending; an unseen value takes
    the reserved tail index, a missing one stays missing."""
    outs = []
    for pkg in (REF, PORT):
        cat = mod(pkg, "ops.categorical")
        cols = mod(pkg, "types.columns")
        ftm = mod(pkg, "types.feature_types")
        train = cols.column_from_list(
            ["b", "a", "c", "b", "a", None, "d", "b"], ftm.Text)
        model = cat.StringIndexer().fit_model([train], None)
        test = cols.column_from_list(["a", "z", None, "d", "b"], ftm.Text)
        out = model.transform_columns([test], None)
        outs.append((model.labels, out.values, out.mask))
    assert_same(outs[1], outs[0])
    assert outs[1][0] == ["b", "a", "c", "d"]


@pytest.mark.parametrize("isotonic", [True, False])
def test_isotonic_calibrator(isotonic):
    def build(pkg):
        col = mod(pkg, "ops.collections")
        fb = mod(pkg, "features.feature_builder").FeatureBuilder
        label = fb.RealNN("label").as_response()
        real = fb.Real("f_real").as_predictor()
        return [col.IsotonicRegressionCalibrator(isotonic=isotonic)
                .set_input(label, real).get_output(),
                real.to_isotonic_calibrated(label, is_isotonic=isotonic)]

    want = run_features(REF, build, N)
    got = run_features(PORT, build, N)
    for g, w in zip(got, want):
        assert g[:2] == w[:2]
        np.testing.assert_allclose(g[2], w[2], rtol=0, atol=1e-12)
        assert_same(g[3], w[3])
    # the label rises with the real column: a staircase, or one level
    # when the fit must fall
    assert (len(np.unique(got[0][2])) > 1) == isotonic


def _indexed_prediction(pkg: str) -> tuple:
    """pick list -> StringIndexer -> a softmax LR on the real and integral
    columns -> PredictionDeIndexer; and the real column scaled -> a linear
    regression on the integral column -> PredictionDescaler."""
    cat, col = mod(pkg, "ops.categorical"), mod(pkg, "ops.collections")
    fb = mod(pkg, "features.feature_builder").FeatureBuilder
    kw = {"device": "cpu"} if pkg == PORT else {}
    pick = fb.PickList("f_picklist").as_response()
    real = fb.Real("f_real").as_predictor()
    integral = fb.Integral("f_integral").as_predictor()
    vec = mod(pkg, "ops.transmogrifier").transmogrify([real, integral])
    indexed = cat.StringIndexer().set_input(pick).get_output()
    pred = mod(pkg, "models.logistic_regression").OpLogisticRegression(
        **kw).set_input(indexed, vec).get_output()
    deindexed = mod(pkg, "preparators.deindexer").PredictionDeIndexer() \
        .set_input(pick, pred).get_output()
    scaled = col.ScalerTransformer(slope=4.0, intercept=2.0) \
        .set_input(real).get_output()
    ivec = mod(pkg, "ops.transmogrifier").transmogrify([integral])
    reg = mod(pkg, "models.linear_regression").OpLinearRegression(
        **kw).set_input(scaled, ivec).get_output()
    descaled = col.PredictionDescaler().set_input(reg, scaled).get_output()
    return pred, deindexed, reg, descaled


def test_prediction_deindexer_and_descaler():
    outs = []
    for pkg in (REF, PORT):
        mod(pkg, "utils.uid").reset_uids()
        mod(pkg, "dsl")
        from torch_parity import lattice_dataset

        data = lattice_dataset(pkg, N)
        # the labels must be present on every row
        ftm = mod(pkg, "types.feature_types")
        cols = mod(pkg, "types.columns")
        picks = [v or "red" for v in data["f_picklist"].values]
        real = data["f_real"]
        data = mod(pkg, "types.dataset").Dataset({
            **{c: data[c] for c in data.column_names()},
            "f_picklist": cols.column_from_list(picks, ftm.PickList),
            "f_real": cols.NumericColumn(real.values, np.ones(N, bool),
                                         ftm.Real)})
        feats = _indexed_prediction(pkg)
        scored = workflow(pkg, feats[0], data).set_result_features(
            *feats).train().score()
        outs.append((np.asarray(scored[feats[0].name].prediction),
                     list(scored[feats[1].name].values),
                     np.asarray(scored[feats[2].name].prediction),
                     np.asarray(scored[feats[3].name].values)))
    (p_ref, d_ref, r_ref, s_ref), (p_port, d_port, r_port, s_port) = outs
    np.testing.assert_array_equal(p_port, p_ref)
    assert d_port == d_ref and set(d_port) <= {"red", "green", "blue"}
    np.testing.assert_allclose(r_port, r_ref, rtol=1e-5, atol=1e-5)
    # the descaled prediction is (prediction - 2) / 4 of the port's own
    np.testing.assert_array_equal(s_port, (r_port - 2.0) / 4.0)
    np.testing.assert_allclose(s_port, s_ref, rtol=1e-5, atol=1e-5)


def test_scaler_without_metadata_is_refused():
    def build(pkg):
        col = mod(pkg, "ops.collections")
        fb = mod(pkg, "features.feature_builder").FeatureBuilder
        real = fb.Real("f_real").as_predictor()
        return [col.DescalerTransformer().set_input(real, real).get_output()]

    with pytest.raises(ValueError, match="no scaler metadata"):
        run_features(PORT, build, 20)
