"""insights/loco.py, OpBinScoreEvaluator and the stage metrics of the torch
package against the JAX package's.

LOCO and the correlation insights run over the same fitted params in both
packages (fitted by the reference, carried into the port's estimator), so
they compare the record insights themselves: for a logistic regression, a
forest (its zero-out passes binned by K2's plain version here), a
regression GLM and a three-class MLP - the same top-k keys per row in the
same order, deltas within 1e-6, and the detailed map's keys equal with
``parse_insights`` round-tripping it.  ``OpBinScoreEvaluator`` gives the
reference's metrics; ``summary_json()["stageMetrics"]`` names the same
stages, phases and rows.
"""
import json

import numpy as np
import pytest

from torch_parity import PORT, REF, mod, passenger_slice, passengers, reset_uids, workflow

N, D = 300, 6


def _data(k=2, seed=0):
    rng = np.random.RandomState(seed)
    X = rng.randn(N, D)
    X[:, 4] = np.round(X[:, 4])       # a few ties within the column
    z = X[:, 0] - 0.7 * X[:, 1] + 0.3 * X[:, 2]
    if k == 1:
        y = z + 0.2 * rng.randn(N)
    elif k == 2:
        y = (z + 0.5 * rng.randn(N) > 0).astype(np.float64)
    else:
        y = np.digitize(z + 0.5 * rng.randn(N), [-0.6, 0.6]).astype(np.float64)
    return X, y


def _vec_dataset(pkg, X):
    meta = mod(pkg, "types.vector_metadata")
    m = meta.VectorMetadata("vec", tuple(
        meta.VectorColumnMeta("vec", "OPVector", grouping=f"g{j % 2}",
                              descriptor_value=f"x{j}")
        for j in range(X.shape[1]))).reindexed()
    col = mod(pkg, "types.columns").VectorColumn(X.astype(np.float32), m)
    return mod(pkg, "types.dataset").Dataset({"vec": col})


FAMILIES = {
    "lr": ("models.logistic_regression", "OpLogisticRegression", 2, {}),
    "forest": ("models.trees", "OpRandomForestClassifier", 2,
               {"num_trees": 5, "max_depth": 4}),
    "glm": ("models.glm", "OpGeneralizedLinearRegression", 1,
            {"family": "gaussian"}),
    "mlp": ("models.mlp", "OpMultilayerPerceptronClassifier", 3,
            {"hidden_layers": (6,), "max_iter": 40}),
}


def _insights(family: str, cls_name: str, **kw):
    path, est_name, k, est_kw = FAMILIES[family]
    X, y = _data(k)
    ref_kw = dict(est_kw, backend="jax") if family == "forest" else est_kw
    ref_est = getattr(mod(REF, path), est_name)(**ref_kw)
    params = ref_est.fit_arrays(X.astype(np.float32).astype(np.float64), y)
    out = {}
    for pkg in (REF, PORT):
        reset_uids(pkg)
        est = ref_est if pkg == REF else getattr(mod(PORT, path), est_name)(
            device="cpu", **est_kw)
        model = mod(pkg, "models.base").PredictorModel(est, params)
        vec = mod(pkg, "features.feature_builder").FeatureBuilder.OPVector(
            "vec").as_predictor()
        stage = getattr(mod(pkg, "insights.loco"), cls_name)(model, **kw)
        feat = stage.set_input(vec).get_output()
        out[pkg] = stage.transform(_vec_dataset(pkg, X))[feat.name].values
    return out[PORT], out[REF]


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_loco_matches_reference(family):
    got, want = _insights(family, "RecordInsightsLOCO", top_k=4)
    assert len(got) == len(want) == N
    for g, w in zip(got, want):
        assert list(g) == list(w)
        np.testing.assert_allclose(list(g.values()), list(w.values()),
                                   atol=1e-6)


@pytest.mark.parametrize("family", ["lr", "mlp"])
def test_detailed_loco_and_parser_match_reference(family):
    got, want = _insights(family, "RecordInsightsLOCO", top_k=3,
                          detailed=True)
    loco = mod(PORT, "insights.loco")
    for g, w in zip(got, want):
        assert list(g) == list(w)
        parsed = loco.parse_insights(g)
        wparsed = mod(REF, "insights.loco").parse_insights(w)
        for (h, sc), (wh, wsc) in zip(parsed, wparsed):
            assert h == wh and [i for i, _ in sc] == [i for i, _ in wsc]
            np.testing.assert_allclose([s for _, s in sc],
                                       [s for _, s in wsc], atol=1e-6)
        assert loco.insights_to_text_map(parsed) == g


def test_correlation_insights_match_reference():
    got, want = _insights("lr", "RecordInsightsCorr", top_k=3)
    for g, w in zip(got, want):
        assert list(g) == list(w)
        np.testing.assert_allclose(list(g.values()), list(w.values()),
                                   rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("num_bins", [10, 100])
def test_bin_score_evaluator_matches_reference(num_bins):
    rng = np.random.RandomState(4)
    y = (rng.rand(500) < 0.4).astype(np.float64)
    p1 = np.clip(0.4 * y + 0.6 * rng.rand(500), 0, 1)
    prob = np.stack([1 - p1, p1], axis=1)
    out = []
    for pkg in (REF, PORT):
        col = mod(pkg, "types.columns").PredictionColumn(
            (p1 > 0.5).astype(np.float64), prob, prob)
        ev = mod(pkg, "evaluators.binary").OpBinScoreEvaluator(num_bins)
        m = ev.evaluate_arrays(y, col)
        out.append((type(m).__name__, m.to_json() if hasattr(m, "to_json")
                    else vars(m), ev.metric_name, ev.larger_better,
                    ev.default_metric(m)))
    assert json.dumps(out[0], sort_keys=True) == \
        json.dumps(out[1], sort_keys=True)


def test_stage_metrics_match_reference():
    rows = {}
    for pkg in (REF, PORT):
        reset_uids(pkg)
        _, checked, pred = passenger_slice(pkg)
        model = workflow(pkg, pred, passengers(pkg, 400)).train()
        sm = model.summary_json()["stageMetrics"]
        rows[pkg] = [(s["operation"], s["phase"], s["n_rows"], s["stage_uid"])
                     for s in sm["stages"]]
        assert set(sm) >= {"total_wall_s", "stages", "by_operation"}
        assert set(sm["by_operation"]) == {s[0] for s in rows[pkg]}
        assert all(s["wall_s"] >= 0 for s in sm["stages"])
    assert rows[PORT] == rows[REF]
    assert {p for _, p, _, _ in rows[PORT]} == {"fit", "transform"}
