"""The multiclass and regression model selectors in both packages on the
passenger data with planted labels (``synthetic_passengers_labelled``,
the same numpy columns in each package's ``Dataset``):
transmogrify(label=...) -> SanityChecker -> MultiClassificationModelSelector
(label ``tier``: LR, the forest, the decision tree, naive Bayes) or
RegressionModelSelector (label ``response``: linear regression, the forest
and GBT regressors) -> holdout evaluation -> score(), plain and under
``with_workflow_cv()``; the reference's fitted multinomial, OvR and linear
regression winners carried over by ``interop.load_reference_state``; the
forest, the decision tree and naive Bayes at K > 2; the factories.

The forest and GBT grids are trimmed to test size through
``models_and_parameters``; the reference's trees run on their JAX backend
and the reference takes its single-device route (``TX_PRODUCT_MESH=0``).

Tolerances: the same kept columns and winner; every candidate's mean CV
metric within 5e-4 for F1 (one flipped argmax row moves a fold's F1 by
about 2e-3 at this size; none flips here, the fits agree to float32
noise), within rtol 1e-5 for linear regression's RMSE and rtol 1e-4 for
the trees'; holdout metrics within the same bounds; scored probabilities
within 1e-4 (LR) and predictions within rtol 1e-4 (linear regression);
a carried-over model's scores within 1e-6 of the reference's own.
"""
import numpy as np
import pytest

from torch_parity import (
    PORT,
    REF,
    labelled_passengers,
    mod,
    problem_models,
    problem_selector_slice,
    reference_states,
    reset_uids,
    stage_of,
    tree_fits_agree,
    workflow,
)

N = 1500
EVALUATOR = {"multiclass": "OpMultiClassificationEvaluator",
             "regression": "OpRegressionEvaluator"}
F1_ATOL = 5e-4


def _metric_close(problem: str, model_type: str, got: float, want: float):
    if problem == "multiclass":
        assert abs(got - want) <= F1_ATOL, (model_type, got, want)
    else:
        rtol = 1e-5 if model_type == "OpLinearRegression" else 1e-4
        np.testing.assert_allclose(got, want, rtol=rtol, atol=0)


def _train(pkg, problem, models=None, workflow_cv=False, n=N):
    reset_uids(pkg)
    label, checked, pred = problem_selector_slice(
        pkg, problem, models=models or problem_models(pkg, problem))
    data = labelled_passengers(pkg, n)
    wf = workflow(pkg, pred, data)
    if workflow_cv:
        wf.with_workflow_cv()
    model = wf.train()
    return model, model.score(data), label, pred


def _scores(scored, name):
    col = scored[name]
    out = col.probability if col.probability is not None else col.prediction
    return np.asarray(out, np.float64)


@pytest.mark.parametrize("workflow_cv", [False, True], ids=["plain", "wcv"])
@pytest.mark.parametrize("problem", ["multiclass", "regression"])
def test_selector_matches_reference(monkeypatch, problem, workflow_cv):
    monkeypatch.setenv("TX_PRODUCT_MESH", "0")
    m_ref, s_ref, label, p_ref = _train(REF, problem, workflow_cv=workflow_cv)
    m_port, s_port, _, p_port = _train(PORT, problem, workflow_cv=workflow_cv)
    assert (stage_of(m_port, "SanityCheckerModel").indices_to_keep
            == stage_of(m_ref, "SanityCheckerModel").indices_to_keep)
    got, want = [stage_of(m, "SelectedModel").metadata[
        "model_selector_summary"] for m in (m_port, m_ref)]
    assert got["best_model_type"] == want["best_model_type"]
    assert got["best_params"] == want["best_params"]
    assert got["validation_metric"]["larger_better"] \
        is want["validation_metric"]["larger_better"] \
        is (problem == "multiclass")
    assert len(got["validation_results"]) == len(want["validation_results"])
    for g, r in zip(got["validation_results"], want["validation_results"]):
        assert (g["model_type"], g["params"]) == (r["model_type"], r["params"])
        assert g.get("rank_metric_mode") == r.get("rank_metric_mode")
        _metric_close(problem, g["model_type"], g["metric"], r["metric"])
    hold = [s["holdout_metrics"][EVALUATOR[problem]] for s in (got, want)]
    assert set(hold[0]) == set(hold[1])
    for key in hold[0]:
        _metric_close(problem, got["best_model_type"], hold[0][key],
                      hold[1][key])
    winner = got["best_model_type"]
    if winner == "OpLogisticRegression":
        np.testing.assert_allclose(_scores(s_port, p_port.name),
                                   _scores(s_ref, p_ref.name),
                                   rtol=0, atol=1e-4)
    elif winner == "OpLinearRegression":
        np.testing.assert_allclose(_scores(s_port, p_port.name),
                                   _scores(s_ref, p_ref.name),
                                   rtol=1e-4, atol=1e-6)
    # evaluate() on the scored rows: the selector's evaluator in each
    want_m = mod(REF, f"evaluators.{problem}")
    got_m = mod(PORT, f"evaluators.{problem}")
    ev_want = getattr(want_m, EVALUATOR[problem])()
    ev_got = getattr(got_m, EVALUATOR[problem])()
    a = m_port.evaluate(ev_got).to_json()
    b = m_ref.evaluate(ev_want).to_json()
    for key, v in b.items():
        if isinstance(v, float):
            _metric_close(problem, winner, a[key], v)


CARRIED = {
    "multinomial": ("multiclass", {"family": "multinomial"}),
    "ovr": ("multiclass", {"family": "ovr"}),
    "linreg": ("regression", {}),
}


@pytest.mark.parametrize("case", list(CARRIED))
def test_reference_winner_carried_over(monkeypatch, case):
    """A reference-fitted multinomial, OvR or linear regression winner
    scored by the port: its params pass through as they are."""
    monkeypatch.setenv("TX_PRODUCT_MESH", "0")
    problem, kw = CARRIED[case]

    def models(pkg):
        dev = {"device": "cpu"} if pkg == PORT else {}
        fac = mod(pkg, "selector.factories")
        if problem == "multiclass":
            est = mod(pkg, "models.logistic_regression").OpLogisticRegression(
                **kw, **dev)
            return [(est, fac.lr_grid()[:2])]
        est = mod(pkg, "models.linear_regression").OpLinearRegression(**dev)
        return [(est, fac.linreg_grid()[:2])]

    m_ref, _, _, p_ref = _train(REF, problem, models(REF), n=600)
    params = stage_of(m_ref, "SelectedModel").model_params
    if problem == "multiclass":
        assert params["family"] == kw["family"]
        assert params["betas"].shape[0] == 3
    want = _scores(m_ref.score(labelled_passengers(REF, 400, seed=7)),
                   p_ref.name)
    reset_uids(PORT)
    _, _, pred = problem_selector_slice(PORT, problem, models=models(PORT))
    data = labelled_passengers(PORT, 400, seed=7)
    carried = mod(PORT, "interop").load_reference_state(
        workflow(PORT, pred, data), reference_states(m_ref))
    selected = stage_of(carried, "SelectedModel")
    assert selected.estimator_ref.device == "cpu"
    got = _scores(carried.score(data), pred.name)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("cls_name", ["OpRandomForestClassifier",
                                      "OpDecisionTreeClassifier"])
def test_forest_and_tree_grids_at_three_classes(cls_name):
    """The fold x grid fit at K = 3 (K + 1 = 4 stat channels): grid points
    grouped by the forest key, one binning per group, each fold's trees
    and class probabilities equal to the reference's."""
    rng = np.random.RandomState(3)
    n = 900
    X = rng.randn(n, 5)
    X[:, 4] = np.round(rng.rand(n) * 3)
    z = X[:, 0] - 0.6 * X[:, 1] + 0.4 * X[:, 4] + 0.4 * rng.randn(n)
    y = np.digitize(z, np.quantile(z, [1 / 3, 2 / 3])).astype(np.float64)
    W = mod(PORT, "selector.validator").stratified_kfold_masks(
        y, 3, 0, True).astype(np.float64)
    grid = [{"max_depth": d, "min_info_gain": g, "min_instances_per_node": m}
            for d in (2, 4) for g in (0.001, 0.1) for m in (1, 20)]
    kw = {"num_trees": 4} if cls_name == "OpRandomForestClassifier" else {}
    ref = getattr(mod(REF, "models.trees"), cls_name)(backend="jax", **kw)
    port = getattr(mod(PORT, "models.trees"), cls_name)(device="cpu", **kw)
    want = ref.fit_arrays_folds_grid(X, y, W, grid)
    got = port.fit_arrays_folds_grid(X, y, W, grid)
    for j, pmap in enumerate(grid):
        for f in range(3):
            g, w = got[j][f], want[j][f]
            np.testing.assert_array_equal(g["classes"], [0.0, 1.0, 2.0])
            assert g["heaps"][3].shape[-1] == 4  # [count, 3 class counts]
            tied = tree_fits_agree(w, g, X, classification=True)
            assert tied.mean() < 0.2
            cand_r, cand_p = ref.with_params(**pmap), port.with_params(**pmap)
            pw, _, qw = cand_r.predict_arrays(w, X)
            pg, _, qg = cand_p.predict_arrays(g, X)
            np.testing.assert_allclose(qg[~tied], np.asarray(qw)[~tied],
                                       rtol=0, atol=1e-5)
            assert qg.shape == (n, 3)


def test_naive_bayes_folds_at_four_classes():
    rng = np.random.RandomState(6)
    n = 800
    y = rng.randint(0, 4, n).astype(np.float64)
    X = rng.poisson(1.0 + y[:, None] * np.arange(1, 6)[None, :] / 5.0,
                    (n, 5)).astype(np.float64)
    W = mod(PORT, "selector.validator").stratified_kfold_masks(
        y, 3, 1, True).astype(np.float64)
    want = mod(REF, "models.naive_bayes").OpNaiveBayes().fit_arrays_folds(
        X, y, W)
    port = mod(PORT, "models.naive_bayes").OpNaiveBayes(device="cpu")
    got = port.fit_arrays_folds(X, y, W)
    for g, w in zip(got, want):
        for key in ("theta", "prior", "shift"):
            np.testing.assert_allclose(g[key], w[key], rtol=0, atol=1e-6)
        pred, _, prob = port.predict_arrays(g, X)
        ref_pred, _, ref_prob = mod(REF, "models.naive_bayes").OpNaiveBayes(
        ).predict_arrays(w, X)
        np.testing.assert_array_equal(pred, ref_pred)
        np.testing.assert_allclose(prob, ref_prob, rtol=0, atol=1e-5)


@pytest.mark.parametrize("factory", ["MultiClassificationModelSelector",
                                     "RegressionModelSelector"])
def test_factories_match_reference(factory):
    """The parameterless call: the same families and grids, splitter,
    stratification, folds, evaluators and validation metric; neither
    factory has a train-validation-split entry point."""
    want = getattr(mod(REF, "selector.factories"), factory)()
    got = getattr(mod(PORT, "selector.factories"), factory)(device="cpu")
    assert [(type(e).__name__, list(g)) for e, g in got.models] == \
        [(type(e).__name__, list(g)) for e, g in want.models]
    assert {e.device for e, _ in got.models} == {"cpu"}
    n_grid = sum(len(g) for _, g in got.models)
    assert n_grid == (36 if factory.startswith("Multi") else 35)
    assert type(got.splitter).__name__ == type(want.splitter).__name__
    assert got.splitter.reserve_test_fraction == 0.1
    for attr in ("num_folds", "stratify", "seed"):
        assert getattr(got.validator, attr) == getattr(want.validator, attr)
    assert type(got.validator.evaluator).__name__ == \
        type(want.validator.evaluator).__name__
    assert [type(e).__name__ for e in got.evaluators] == \
        [type(e).__name__ for e in want.evaluators]
    cls = getattr(mod(PORT, "selector.factories"), factory)
    assert not hasattr(cls, "with_train_validation_split")
    picked = cls.with_cross_validation(
        model_types_to_use=[type(got.models[0][0]).__name__], device="cpu")
    assert len(picked.models) == 1


def test_gbt_classifier_refuses_three_classes():
    X = np.random.RandomState(0).randn(90, 3)
    y3 = np.repeat(np.arange(3.0), 30)
    est = mod(PORT, "models.trees").OpGBTClassifier(num_trees=2, max_depth=2,
                                                    device="cpu")
    with pytest.raises(ValueError, match="only binary"):
        est.fit_arrays_folds_grid(X, y3, np.ones((2, 90)), [{}])


def test_planted_labels():
    """The planted columns: the passenger columns bit-equal to
    ``synthetic_passengers``, the tiers about a third each, and the
    constants those of ``planted_label_ceilings``; the most probable tier
    and E[response | observed] reach the ceilings on a sample."""
    syn = mod(PORT, "examples.synthetic")
    ds = syn.synthetic_passengers_labelled(30_000, seed=5, with_text=True)
    base = syn.synthetic_passengers(30_000, seed=5, with_text=True)
    for name in base:
        np.testing.assert_array_equal(ds[name].values, base[name].values)
    tier = ds["tier"].values
    np.testing.assert_allclose(np.bincount(tier.astype(int)) / len(tier),
                               1 / 3, atol=0.01)
    c = syn.planted_label_ceilings(grid=2001)
    np.testing.assert_allclose(c["terciles"], syn.LATENT_TERCILES, atol=1e-9)
    assert abs(c["bayes_f1"] - syn.BAYES_F1_OBSERVED) < 1e-4
    assert abs(c["best_rmse"] - syn.BEST_RMSE_OBSERVED) < 1e-6
    assert abs(c["best_r2"] - syn.BEST_R2_OBSERVED) < 1e-6
    # E[response | observed]: f where age is seen, f at age 45 where not
    age, seen = ds["age"].values, ds["age"].mask
    rest = (-0.02 * (ds["height"].values - 170)
            + np.where(ds["gender"].values == "female", 1.2, -0.4))
    best = rest + np.where(seen, 0.03 * (age - 45), 0.0)
    rmse = np.sqrt(np.mean((ds["response"].values - best) ** 2))
    assert abs(rmse - syn.BEST_RMSE_OBSERVED) < 0.01


def test_validator_lowest_rmse_wins_and_mode_stays_exact(monkeypatch):
    """RMSE is smaller-better: the validator picks the lowest mean, as
    the reference's does; even with the device rank metrics forced on
    (``TX_CV_RANK_METRICS=approx``) F1 and RMSE grids stay exact."""
    monkeypatch.setenv("TX_CV_RANK_METRICS", "approx")
    rng = np.random.RandomState(12)
    X = rng.randn(600, 4)
    y = X @ np.array([1.0, -0.5, 0.0, 2.0]) + 0.3 * rng.randn(600)
    out = []
    for pkg in (REF, PORT):
        kw = {"device": "cpu"} if pkg == PORT else {}
        cv = mod(pkg, "selector.validator").OpCrossValidation(
            num_folds=3, seed=1, evaluator=mod(
                pkg, "evaluators.regression").OpRegressionEvaluator(), **kw)
        est = mod(pkg, "models.linear_regression").OpLinearRegression(**kw)
        out.append(cv.validate(
            [(est, mod(pkg, "selector.factories").linreg_grid())], X, y))
    want, got = out
    means = [r["metric"] for r in got.all_results]
    assert got.best_metric == min(means) and got.larger_better is False
    assert got.best_params == want.best_params
    assert {r["rank_metric_mode"] for r in got.all_results} == {"exact"}
    np.testing.assert_allclose(means, [r["metric"] for r in want.all_results],
                               rtol=1e-5, atol=0)
    Xc, yc = _three_class(rng)
    ev = mod(PORT, "evaluators.multiclass").OpMultiClassificationEvaluator()
    res = mod(PORT, "selector.validator").OpCrossValidation(
        num_folds=3, stratify=True, evaluator=ev, device="cpu").validate(
        [(mod(PORT, "models.naive_bayes").OpNaiveBayes(device="cpu"), [{}])],
        np.abs(Xc), yc)
    assert {r["rank_metric_mode"] for r in res.all_results} == {"exact"}


def _three_class(rng, n=450):
    y = np.repeat(np.arange(3.0), n // 3)
    X = np.array([[2.0, 0.0], [-2.0, 1.5], [0.0, -2.5]])[y.astype(int)]
    return X + rng.randn(n, 2), y


@pytest.mark.parametrize("K", [3, 4, 7])
def test_stratified_folds_over_k_labels_equal_reference(K):
    """Stratified folds over K classes consume the RNG class by class in
    ascending order: the masks are bit-equal to the reference's."""
    y = np.random.RandomState(K).randint(0, K, 1001).astype(np.float64)
    got = mod(PORT, "selector.validator").stratified_kfold_masks(y, 3, 42,
                                                                 True)
    want = mod(REF, "selector.validator").stratified_kfold_masks(y, 3, 42,
                                                                 True)
    np.testing.assert_array_equal(got, want)
    for c in range(K):
        per_fold = (~got[:, y == c]).sum(axis=1)
        assert per_fold.max() - per_fold.min() <= 1
