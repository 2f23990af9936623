"""The selector workflow in both packages on the passenger data:
transmogrify(label=...) -> SanityChecker -> BinaryClassificationModelSelector
(3-fold CV over the default LR grid and a small GBT grid) -> holdout
evaluation -> score(), plain and under ``with_workflow_cv()``.

Tolerances: the same kept columns, the same winner and params, every
candidate's mean CV metric within 1e-5, holdout AuROC within 1e-4 and
scored probabilities within 1e-5 (rows routed through a kind-2 split tie,
ROADMAP.md queue 3, excluded as ``compare_trees`` does).  The reference
runs its single-device route (``TX_PRODUCT_MESH=0``).
"""
import numpy as np
import pytest
import torch

from torch_parity import (
    PORT,
    REF,
    compare_trees,
    mod,
    passenger_selector_slice,
    passengers,
    probabilities,
    reset_uids,
    small_gbt_grid,
    stage_of,
    workflow,
)

N = 1500


def _summary(model):
    return stage_of(model, "SelectedModel").metadata["model_selector_summary"]


def _train(pkg, workflow_cv: bool, gbt_only: bool = False):
    reset_uids(pkg)
    survived, checked, pred = passenger_selector_slice(pkg)
    if gbt_only:  # the GBT family alone, so that it wins
        sel = pred.origin_stage
        sel.models = sel.models[1:]
    data = passengers(pkg, N)
    wf = workflow(pkg, pred, data)
    if workflow_cv:
        wf.with_workflow_cv()
    model = wf.train()
    return model, model.score(data), pred


@pytest.mark.parametrize("workflow_cv,gbt_only", [
    (False, False), (True, False), (False, True), (True, True)],
    ids=["plain", "workflow_cv", "gbt_plain", "gbt_workflow_cv"])
def test_selector_workflow_matches_reference(monkeypatch, workflow_cv, gbt_only):
    monkeypatch.setenv("TX_PRODUCT_MESH", "0")
    m_ref, s_ref, p_ref = _train(REF, workflow_cv, gbt_only)
    m_port, s_port, p_port = _train(PORT, workflow_cv, gbt_only)
    assert (stage_of(m_port, "SanityCheckerModel").indices_to_keep
            == stage_of(m_ref, "SanityCheckerModel").indices_to_keep)
    got, want = _summary(m_port), _summary(m_ref)
    # the reference's fused-training trail ("train_fused": which families
    # fell back to the kernel-at-a-time path) has no counterpart: the fused
    # programs are not ported, and the key is absent when they are off
    assert sorted(got) == sorted(set(want) - {"train_fused", "autotune"})
    assert got["best_model_type"] == want["best_model_type"]
    assert got["best_params"] == want["best_params"]
    assert got["splitter_summary"] == want["splitter_summary"]
    assert got["n_rows"] == want["n_rows"] and got["n_features"] == want["n_features"]
    assert len(got["validation_results"]) == len(want["validation_results"])
    for g, r in zip(got["validation_results"], want["validation_results"]):
        assert sorted(g) == sorted(r)
        assert (g["model_type"], g["params"]) == (r["model_type"], r["params"])
        np.testing.assert_allclose(g["metric"], r["metric"], rtol=0, atol=1e-5)
    hold = [s["holdout_metrics"]["OpBinaryClassificationEvaluator"]["AuROC"]
            for s in (got, want)]
    assert abs(hold[0] - hold[1]) <= 1e-4
    tie_rows = np.zeros(N, bool)
    fitted = stage_of(m_port, "SelectedModel")
    if got["best_model_type"] == "OpGBTClassifier":
        params = fitted.model_params
        bins = mod(PORT, "models.tree_kernel").bin_data(
            np.asarray(s_port[fitted.input_features[1].name].values, np.float32),
            params["edges"])
        want_heaps = stage_of(m_ref, "SelectedModel").model_params["heaps"]
        for t in range(params["heaps"][0].shape[0]):
            tie_rows |= compare_trees(
                [h[t] for h in params["heaps"]], [h[t] for h in want_heaps],
                bins, params["max_depth"], rtol=1e-4, atol=1e-5)[1]
    assert tie_rows.mean() < 0.05
    np.testing.assert_allclose(
        probabilities(s_port, p_port.name)[~tie_rows],
        probabilities(s_ref, p_ref.name)[~tie_rows], rtol=0, atol=1e-5)
    assert fitted.estimator_ref.device == "cpu"


def test_cut_dag_matches_reference():
    def cut(pkg):
        reset_uids(pkg)
        _, _, pred = passenger_selector_slice(pkg)
        dag_mod = mod(pkg, "workflow.dag")
        dag = dag_mod.compute_dag([pred])
        sel = pred.origin_stage
        during = dag_mod.cut_dag_during(dag, [sel])
        parts = dag_mod.cut_dag(dag, [sel])
        return ({k: [s.uid for s in v] for k, v in during.items()},
                [[[s.uid for s in layer] for layer in part]
                 if part and isinstance(part[0], list) else [s.uid for s in part]
                 for part in parts])

    got, want = cut(PORT), cut(REF)
    assert got == want
    during = next(iter(got[0].values()))
    # the label-aware bucketizers are the first label-touching layer: they,
    # everything below them and the selector refit in every fold
    assert during[0].startswith("DecisionTreeNumericBucketizer")
    assert during[-1].startswith("ModelSelector")
    assert any(u.startswith("SanityChecker") for u in during)


def test_workflow_device_reaches_selector_and_candidates():
    reset_uids(PORT)
    _, _, pred = passenger_selector_slice(PORT, gbt_grid=small_gbt_grid(2, (2,)))
    sel = pred.origin_stage
    # what a default-built selector holds; the workflow's device overrides it
    sel.device = sel.validator.device = "cuda"
    for est, _ in sel.models:
        est.device = "cuda"
    model = workflow(PORT, pred, passengers(PORT, 400)).with_workflow_cv().train()
    assert sel.device == sel.validator.device == "cpu"
    assert {est.device for est, _ in sel.models} == {"cpu"}
    assert sel.best_override.best_estimator.device == "cpu"
    assert stage_of(model, "SelectedModel").estimator_ref.device == "cpu"


def test_selector_defaults_to_cuda():
    fac = mod(PORT, "selector.factories")
    sel = fac.BinaryClassificationModelSelector.with_cross_validation(
        model_types_to_use=["OpLogisticRegression", "OpGBTClassifier"])
    assert sel.device == sel.validator.device == "cuda"
    assert {est.device for est, _ in sel.models} == {"cuda"}
    if not torch.cuda.is_available():
        # a fit resolves the device first, so a missing card fails loudly
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            sel._to_device()
