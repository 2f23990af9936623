"""The port's spans inside the training path (``obs/trace.py``): the tree
learner's ``tree.*``, the bucketizers' ``bucketize.prep``, the validator's
``cv.score``, the selector's ``selector.*`` and the hand kernels'
``kernel.*`` spans, recorded by one small GBT selector train on the CPU.

Each span name is a case: its count against the calls it wraps, and its
attributes.  Turning the tracer off must leave the train's heaps, fold
metrics and winner bit for bit as they were.
"""
from __future__ import annotations

import numpy as np
import pytest

from transmogrifai_tpu_torch import Dataset, FeatureBuilder, OpWorkflow
from transmogrifai_tpu_torch.models import tree_kernel
from transmogrifai_tpu_torch.models.trees import OpGBTClassifier
from transmogrifai_tpu_torch.obs import trace as obs_trace
from transmogrifai_tpu_torch.ops import bucketizers
from transmogrifai_tpu_torch.ops.transmogrifier import transmogrify
from transmogrifai_tpu_torch.parallel import kernels
from transmogrifai_tpu_torch.preparators.sanity_checker import SanityChecker
from transmogrifai_tpu_torch.selector import factories
from transmogrifai_tpu_torch.types import feature_types as ft
from transmogrifai_tpu_torch.types.columns import NumericColumn

N_ROWS, N_COLS, FOLDS, TREES = 300, 3, 2, 3
DEPTHS = (2, 3)


def _dataset() -> Dataset:
    r = np.random.default_rng(7)
    X = r.normal(size=(N_ROWS, N_COLS))
    y = (X[:, 0] + 0.5 * X[:, 1] + 0.3 * r.normal(size=N_ROWS) > 0)
    cols = {f"x{j}": NumericColumn(X[:, j], np.ones(N_ROWS, bool), ft.Real)
            for j in range(N_COLS)}
    cols["label"] = NumericColumn(y.astype(float), np.ones(N_ROWS, bool),
                                  ft.RealNN)
    return Dataset(cols)


def _train():
    label = FeatureBuilder.RealNN("label").as_response()
    preds = [FeatureBuilder.Real(f"x{j}").as_predictor()
             for j in range(N_COLS)]
    vec = transmogrify(preds, label=label)
    checked = SanityChecker().set_input(label, vec).get_output()
    gbt = OpGBTClassifier(num_trees=TREES, device="cpu")
    selector = factories.BinaryClassificationModelSelector.with_cross_validation(
        num_folds=FOLDS, seed=42, device="cpu",
        models_and_parameters=[(gbt, [{"max_depth": m} for m in DEPTHS])])
    pred = selector.set_input(label, checked).get_output()
    wf = OpWorkflow(device="cpu").set_result_features(pred)
    wf.set_input_dataset(_dataset())
    return wf.train()


def _selected(model):
    return next(s for s in model.stages
                if type(s).__name__ == "SelectedModel")


def _outcome(model) -> dict:
    selected = _selected(model)
    summary = selected.metadata["model_selector_summary"]
    return {
        "winner": (summary["best_model_type"], summary["best_params"]),
        "folds": [r["fold_metrics"] for r in summary["validation_results"]],
        "heaps": [np.asarray(h) for h in selected.model_params["heaps"]],
    }


def _train_rows(model) -> int:
    """The selector's training rows (the splitter's holdout left out)."""
    return _selected(model).metadata["model_selector_summary"]["n_rows"]


@pytest.fixture(scope="module")
def traced():
    """One train under a fresh default-sized ring, with the calls that the
    spans wrap counted beside them: ``fit_tree``'s depths and the plain
    kernels' calls."""
    calls = {"fit_tree": [], "bin_matrix": 0, "fused_moments": 0}
    fit_tree, bin_plain = tree_kernel.fit_tree, kernels.bin_matrix_plain
    moments_plain = kernels.fused_moments_plain

    def counted_fit_tree(*args, **kw):
        calls["fit_tree"].append(
            args[4] if len(args) > 4 else kw["max_depth"])
        return fit_tree(*args, **kw)

    def counted_bins(*args, **kw):
        calls["bin_matrix"] += 1
        return bin_plain(*args, **kw)

    def counted_moments(*args, **kw):
        calls["fused_moments"] += 1
        return moments_plain(*args, **kw)

    mp = pytest.MonkeyPatch()
    mp.setattr(tree_kernel, "fit_tree", counted_fit_tree)
    mp.setattr(bucketizers, "fit_tree", counted_fit_tree)
    mp.setattr(kernels, "bin_matrix_plain", counted_bins)
    mp.setattr(kernels, "fused_moments_plain", counted_moments)
    tracer = obs_trace.reset_tracer()
    try:
        model = _train()
    finally:
        mp.undo()
    spans = tracer.spans()
    snap = tracer.snapshot()
    obs_trace.reset_tracer()
    return {"model": model, "spans": spans, "snapshot": snap,
            "calls": calls}


def _named(traced, name):
    return [r for r in traced["spans"] if r["name"] == name]


def _check_tree_fit(traced, spans):
    depths = traced["calls"]["fit_tree"]
    assert len(spans) == len(depths) > 0
    # one span per fit_tree call, in call order, at the depth it grew
    assert [r["attrs"]["depth"] for r in spans] == depths
    for r in spans:
        a = r["attrs"]
        assert set(a) == {"n", "d", "bins", "stats", "depth", "bin_bytes"}
        assert a["bins"] == 32 and a["bin_bytes"] == 1
    gbt = [r["attrs"] for r in spans if r["attrs"]["stats"] == 4]
    # the CV trees of each depth, and the winner's refit
    winner_depth = _outcome(traced["model"])["winner"][1]["max_depth"]
    for depth in DEPTHS:
        want = FOLDS * TREES + (TREES if depth == winner_depth else 0)
        assert sum(a["depth"] == depth for a in gbt) == want
    # the bucketizers' one-column trees
    assert sum(r["attrs"]["d"] == 1 for r in spans) == N_COLS


def _check_cv_score(traced, spans):
    assert len(spans) == len(DEPTHS) * FOLDS
    n_train = _train_rows(traced["model"])
    for r in spans:
        a = r["attrs"]
        assert a["family"] == "OpGBTClassifier" and a["mode"] == "exact"
        assert a["fold"] in range(FOLDS)
        assert 0 < a["n_rows"] < n_train
    # each fold's validation rows, the same for every candidate
    by_fold = {}
    for r in spans:
        by_fold.setdefault(r["attrs"]["fold"], set()).add(r["attrs"]["n_rows"])
    assert all(len(v) == 1 for v in by_fold.values())
    assert sum(next(iter(v)) for v in by_fold.values()) == n_train


def _check_refit(traced, spans):
    assert len(spans) == 1
    a = spans[0]["attrs"]
    assert a["family"] == _outcome(traced["model"])["winner"][0]
    assert a["n_rows"] == _train_rows(traced["model"])
    # the winner's trees grow inside it
    inside = [r for r in _named(traced, "tree.fit")
              if r["parent"] == spans[0]["span"]]
    assert len(inside) == TREES


def _check_train_eval(traced, spans):
    assert len(spans) == 1
    assert spans[0]["attrs"]["n_rows"] == _train_rows(traced["model"])


def _check_bin_matrix(traced, spans):
    assert len(spans) == traced["calls"]["bin_matrix"] > 0
    for r in spans:
        a = r["attrs"]
        assert a["route"] == "plain" and a["out_bytes"] == 1
        assert a["n_edges"] == 31 and a["n"] > 0 and a["d"] >= 1


def _check_fused_moments(traced, spans):
    assert len(spans) == traced["calls"]["fused_moments"] == 1
    assert spans[0]["attrs"]["route"] == "plain"


def _tree_stage(count: int):
    def check(traced, spans):
        assert len(spans) == count
        for r in spans:
            assert set(r["attrs"]) == {"depth", "n", "d"}
            assert r["attrs"]["depth"] in DEPTHS
            assert r["attrs"]["n"] == _train_rows(traced["model"])
    return check


def _check_bucketize_prep(traced, spans):
    assert len(spans) == N_COLS
    one_column = [r for r in _named(traced, "tree.fit")
                  if r["attrs"]["d"] == 1]
    assert [r["attrs"]["n"] for r in spans] == \
        [r["attrs"]["n"] for r in one_column]


CHECKS = {
    "tree.fit": _check_tree_fit,
    # the CV fit's edges once (one bin count and seed), its bins and heaps
    # once a depth group; the refit's once each
    "tree.edges": _tree_stage(2),
    "tree.bin": _tree_stage(len(DEPTHS) + 1),
    "tree.fetch": _tree_stage(len(DEPTHS) + 1),
    "bucketize.prep": _check_bucketize_prep,
    "cv.score": _check_cv_score,
    "selector.refit": _check_refit,
    "selector.train_eval": _check_train_eval,
    "kernel.bin_matrix": _check_bin_matrix,
    "kernel.fused_moments": _check_fused_moments,
}


@pytest.mark.parametrize("name", sorted(CHECKS))
def test_train_records_span(traced, name):
    CHECKS[name](traced, _named(traced, name))


def test_one_train_fits_the_default_ring(traced):
    snap = traced["snapshot"]
    assert snap["capacity"] == obs_trace.DEFAULT_CAPACITY
    assert snap["spans_evicted"] == 0
    assert snap["spans_recorded"] == len(traced["spans"])


def test_tracer_off_leaves_the_train_bit_identical(traced):
    obs_trace.reset_tracer()
    obs_trace.set_enabled(False)
    try:
        off = _outcome(_train())
        assert obs_trace.tracer().spans() == []
    finally:
        obs_trace.reset_tracer()
    on = _outcome(traced["model"])
    assert off["winner"] == on["winner"]
    assert off["folds"] == on["folds"]
    assert len(off["heaps"]) == len(on["heaps"])
    for a, b in zip(off["heaps"], on["heaps"]):
        np.testing.assert_array_equal(a, b)
