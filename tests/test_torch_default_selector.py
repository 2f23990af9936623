"""The parameterless binary selector's families in both packages on the
passenger data: transmogrify(label=...) -> SanityChecker ->
BinaryClassificationModelSelector (3-fold CV over logistic regression, the
random forest with per-node feature subsets, the GBT and the linear SVM;
the tree grids trimmed to test size through ``models_and_parameters``) ->
holdout evaluation -> score(), and the reference's fitted workflow carried
over by ``interop.load_reference_state``.

Both run the exact host metrics (the CPU): the SVM's CV metric then ranks
its 0/1 prediction, as the reference's evaluator does for a family
without probabilities.  Tolerances: the same kept columns, the same winner
and params, every candidate's mean CV metric within 1e-5, holdout AuROC
within 1e-4, scored probabilities (or the SVM's margins) within 1e-5 on
rows no tree tie touches (``compare_trees``, ROADMAP.md queue 3), and the
carried-over model's scores within 1e-6 of the reference's own.  The
reference runs its single-device route (``TX_PRODUCT_MESH=0``).
"""
import numpy as np
import pytest

from torch_parity import (
    PORT,
    REF,
    compare_trees,
    default_selector_models,
    mod,
    passenger_selector_slice,
    passengers,
    reference_states,
    reset_uids,
    stage_of,
    workflow,
)

N = 1500
CASES = {
    "default_four": None,
    "forest_wins": ["OpRandomForestClassifier", "OpLinearSVC"],
    "svc_alone": ["OpLinearSVC"],
}


def _scores(scored, name) -> np.ndarray:
    col = scored[name]
    out = col.probability if col.probability is not None else col.raw_prediction
    return np.asarray(out, np.float64)


def _slice(pkg, families):
    reset_uids(pkg)
    return passenger_selector_slice(
        pkg, models=default_selector_models(pkg, families))


def _train(pkg, families):
    survived, checked, pred = _slice(pkg, families)
    data = passengers(pkg, N)
    model = workflow(pkg, pred, data).train()
    return model, model.score(data), pred


@pytest.mark.parametrize("case", list(CASES))
def test_default_families_match_reference(monkeypatch, case):
    monkeypatch.setenv("TX_PRODUCT_MESH", "0")
    monkeypatch.setenv("TX_CV_RANK_METRICS", "exact")
    families = CASES[case]
    m_ref, s_ref, p_ref = _train(REF, families)
    m_port, s_port, p_port = _train(PORT, families)
    assert (stage_of(m_port, "SanityCheckerModel").indices_to_keep
            == stage_of(m_ref, "SanityCheckerModel").indices_to_keep)
    summary = [stage_of(m, "SelectedModel").metadata["model_selector_summary"]
               for m in (m_port, m_ref)]
    got, want = summary
    assert got["best_model_type"] == want["best_model_type"]
    assert got["best_params"] == want["best_params"]
    if case == "forest_wins":
        assert got["best_model_type"] == "OpRandomForestClassifier"
    assert len(got["validation_results"]) == len(want["validation_results"])
    for g, r in zip(got["validation_results"], want["validation_results"]):
        assert (g["model_type"], g["params"]) == (r["model_type"], r["params"])
        assert g["rank_metric_mode"] == r["rank_metric_mode"] == "exact"
        np.testing.assert_allclose(g["metric"], r["metric"], rtol=0, atol=1e-5)
    hold = [s["holdout_metrics"]["OpBinaryClassificationEvaluator"]["AuROC"]
            for s in summary]
    assert abs(hold[0] - hold[1]) <= 1e-4
    fitted = stage_of(m_port, "SelectedModel")
    tie_rows = np.zeros(N, bool)
    if got["best_model_type"] == "OpRandomForestClassifier":
        params = fitted.model_params
        bins = mod(PORT, "models.tree_kernel").bin_data(
            np.asarray(s_port[fitted.input_features[1].name].values, np.float32),
            params["edges"])
        want_heaps = stage_of(m_ref, "SelectedModel").model_params["heaps"]
        for t in range(params["heaps"][0].shape[0]):
            tie_rows |= compare_trees(
                [h[t] for h in params["heaps"]], [h[t] for h in want_heaps],
                bins, params["max_depth"])[1]
    assert tie_rows.mean() < 0.05
    np.testing.assert_allclose(_scores(s_port, p_port.name)[~tie_rows],
                               _scores(s_ref, p_ref.name)[~tie_rows],
                               rtol=0, atol=1e-5)
    if got["best_model_type"] == "OpLinearSVC":
        assert s_port[p_port.name].probability is None

    # the reference's fitted workflow, carried over and scored by the port
    data = passengers(PORT, N, seed=7)
    want_scores = _scores(m_ref.score(passengers(REF, N, seed=7)), p_ref.name)
    _, _, pred = _slice(PORT, families)
    carried = mod(PORT, "interop").load_reference_state(
        workflow(PORT, pred, data), reference_states(m_ref))
    selected = stage_of(carried, "SelectedModel")
    assert selected.estimator_ref.model_type == want["best_model_type"]
    assert selected.estimator_ref.device == "cpu"
    assert selected.metadata["model_selector_summary"]["best_params"] == \
        want["best_params"]
    np.testing.assert_allclose(_scores(carried.score(data), pred.name),
                               want_scores, rtol=0, atol=1e-6)


def test_carry_over_needs_the_winning_family():
    reset_uids(REF)
    m_ref, _, _ = _train(REF, ["OpRandomForestClassifier", "OpLinearSVC"])
    _, _, pred = _slice(PORT, ["OpLinearSVC"])
    load = mod(PORT, "interop").load_reference_state
    with pytest.raises(ValueError, match="no OpRandomForestClassifier"):
        load(workflow(PORT, pred, passengers(PORT, 10)), reference_states(m_ref))
