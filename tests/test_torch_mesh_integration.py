"""Product-path mesh integration of the torch package, against the JAX
package's ``tests/test_mesh_integration.py``.

One spawned gloo world of 4 ranks (``torch_mesh_world.py``, ~10 s) runs
the sharded SanityChecker, the LR grid's CV on the CV mesh, the forest
and GBT fold and grid fits on the data mesh and the passenger selector
workflow, each also on the rank alone (the port's world 1,
``TX_PRODUCT_MESH=0``).  Each is held:

* against world 1: the same selection, CV means rtol 1e-5, fold metrics
  rtol 1e-5 / atol 1e-7, moments rtol 3e-5; forest heaps bit-equal (unit
  fold weights and integer bootstrap counts make every histogram sum an
  integer), GBT predictions within 1e-5;
* against the reference's own sharded run on the 8-device virtual CPU
  mesh (``TX_PRODUCT_MESH=1``), within the reference test's own
  tolerances, trees node by node off exact split ties
  (``torch_parity.tree_fits_agree``);
* across the ranks: every rank holds the same answer.
"""
import numpy as np
import pytest

from torch_mesh_world import (
    check_result, cv_data, heaps_equal, run_world, sanity_data, tree_data)
from torch_parity import REF, mod, tree_fits_agree


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return run_world("integration", 4, tmp_path_factory.mktemp("mesh"))


def _same_on_every_rank(per_rank, compare):
    for other in per_rank[1:]:
        compare(per_rank[0], other)


def test_mesh_helpers_shape(world):
    for got in check_result(world, "mesh_helpers_shape"):
        assert got["data"] == {"data": 4}
        assert got["cv24"] == {"replica": 2, "data": 2}  # 3 folds x 8 grid
        assert got["cv3"] == {"replica": 1, "data": 4}  # replica divides B
        assert got["disabled"] == [True, True]  # TX_PRODUCT_MESH=0


def _reference_cv(X, y):
    ev = mod(REF, "evaluators.binary").OpBinaryClassificationEvaluator()
    cv = mod(REF, "selector.validator").OpCrossValidation(
        num_folds=3, evaluator=ev, stratify=True)
    lr = mod(REF, "models.logistic_regression").OpLogisticRegression()
    return cv.validate([(lr, mod(REF, "selector.factories").lr_grid())], X, y)


@pytest.mark.parametrize("against", ["world_one", "reference_sharded"])
def test_cv_sharded_matches(world, against, monkeypatch):
    per_rank = check_result(world, "cv_sharded")
    shard = per_rank[0]["sharded"]
    if against == "world_one":
        want = per_rank[0]["single"]
        want_params, want_best = want["best_params"], want["best_metric"]
        want_folds = want["fold_metrics"]
    else:
        monkeypatch.setenv("TX_PRODUCT_MESH", "1")
        res = _reference_cv(*cv_data())
        want_params, want_best = res.best_params, res.best_metric
        want_folds = np.array([r["fold_metrics"] for r in res.all_results])
    assert shard["best_params"] == want_params
    np.testing.assert_allclose(shard["best_metric"], want_best, rtol=1e-5)
    np.testing.assert_allclose(shard["fold_metrics"], want_folds,
                               rtol=1e-5, atol=1e-7)
    _same_on_every_rank([r["sharded"] for r in per_rank], lambda a, b: (
        np.testing.assert_array_equal(a["fold_metrics"], b["fold_metrics"])))


def _reference_sanity(X, y):
    cols = mod(REF, "types.columns")
    vm = mod(REF, "types.vector_metadata")
    n, d = X.shape
    meta = vm.VectorMetadata(
        "features", tuple(vm.VectorColumnMeta(f"f{j}", "Real") for j in range(d))
    ).reindexed()
    label = cols.NumericColumn(y, np.ones(n, bool),
                               mod(REF, "types.feature_types").RealNN)
    vec = cols.VectorColumn(X, meta)
    ds = mod(REF, "types.dataset").Dataset({"label": label, "features": vec})
    sc = mod(REF, "preparators.sanity_checker").SanityChecker(
        remove_bad_features=False)
    sc.fit_model([label, vec], ds)
    stats = sc.metadata["sanity_checker_summary"]["column_stats"]
    return {k: np.array([c[k] for c in stats], dtype=np.float64)
            for k in ("mean", "variance", "corr_label")}


@pytest.mark.parametrize("against", ["world_one", "reference_sharded"])
def test_sanity_checker_sharded_matches(world, against, monkeypatch):
    per_rank = check_result(world, "sanity_checker_sharded")
    got = per_rank[0]["sharded"]
    if against == "world_one":
        want = per_rank[0]["single"]
    else:
        monkeypatch.setenv("TX_PRODUCT_MESH", "1")
        want = _reference_sanity(*sanity_data())
    for k in ("mean", "variance", "corr_label"):
        np.testing.assert_allclose(got[k], want[k], rtol=3e-5, atol=1e-7)
    _same_on_every_rank([r["sharded"] for r in per_rank], lambda a, b: [
        np.testing.assert_array_equal(a[k], b[k]) for k in a])


TREE_FITS = ["rf", "gbt", "rf_grid", "gbt_grid"]


@pytest.mark.parametrize("name", TREE_FITS)
def test_tree_fold_fits_sharded_match_world_one(world, name):
    per_rank = check_result(world, "tree_fold_fits_sharded")
    got, want = per_rank[0]["sharded"][name], per_rank[0]["single"][name]
    for gs, ws in zip(got["params"], want["params"]):
        for g, w in zip(gs, ws):
            if name.startswith("rf"):
                assert heaps_equal(g, w)
            else:
                np.testing.assert_array_equal(g["edges"], w["edges"])
                assert abs(g["f0"] - w["f0"]) <= 1e-6
    np.testing.assert_allclose(np.asarray(got["prob"]),
                               np.asarray(want["prob"]), atol=1e-5)
    for other in per_rank[1:]:
        for gs, os_ in zip(got["params"], other["sharded"][name]["params"]):
            assert all(heaps_equal(g, o) for g, o in zip(gs, os_))


def _reference_tree_fits(name, X, y):
    trees = mod(REF, "models.trees")
    W = mod(REF, "selector.validator").stratified_kfold_masks(
        y, 3, seed=0, stratify=True).astype(float)
    if name == "rf":
        return [trees.OpRandomForestClassifier(
            num_trees=5, max_depth=3, backend="jax").fit_arrays_folds(X, y, W)]
    if name == "gbt":
        return [trees.OpGBTClassifier(
            num_trees=4, max_depth=3, backend="jax").fit_arrays_folds(X, y, W)]
    if name == "rf_grid":
        return trees.OpRandomForestClassifier(
            num_trees=4, max_depth=3, backend="jax").fit_arrays_folds_grid(
                X, y, W, [{"min_info_gain": 0.0}, {"min_info_gain": 0.1}])
    return trees.OpGBTClassifier(
        num_trees=3, max_depth=2, backend="jax").fit_arrays_folds_grid(
            X, y, W, [{"step_size": 0.1}, {"step_size": 0.3}])


@pytest.mark.parametrize("name", TREE_FITS)
def test_tree_fold_fits_sharded_match_reference_sharded(world, name,
                                                        monkeypatch):
    got = check_result(world, "tree_fold_fits_sharded")[0]["sharded"][name]
    monkeypatch.setenv("TX_PRODUCT_MESH", "1")
    X, y = tree_data()
    want = _reference_tree_fits(name, X, y)
    for gs, ws in zip(got["params"], want):
        for g, w in zip(gs, ws):
            tree_fits_agree(w, g, X, classification=True,
                            gbt=name.startswith("gbt"))


def test_tree_fits_with_an_empty_block(world):
    """Three rows on four ranks: the rank with no rows still joins every
    level's histogram, and the heaps are world 1's."""
    for got in check_result(world, "tree_fits_on_an_empty_block"):
        for g, w in zip(got["sharded"], got["single"]):
            np.testing.assert_array_equal(g["edges"], w["edges"])
            for hg, hw in zip(g["heaps"], w["heaps"]):
                np.testing.assert_allclose(hg, hw, rtol=0, atol=1e-6)


def test_selector_workflow_sharded_matches_world_one(world):
    """``OpWorkflow.train()`` of the passenger selector (SanityChecker,
    the LR grid and a GBT grid under CV) at world 4: the same drops, the
    same selection summary and the same scored probabilities as world 1,
    on every rank."""
    per_rank = check_result(world, "workflow_sharded")
    for got in per_rank:
        assert got["sharded"]["dropped"] == got["single"]["dropped"]
        assert got["sharded"]["selected"] == got["single"]["selected"]
        np.testing.assert_allclose(got["sharded"]["metric"],
                                   got["single"]["metric"], rtol=1e-5)
        np.testing.assert_allclose(got["sharded"]["prob"],
                                   got["single"]["prob"], rtol=1e-5,
                                   atol=1e-6)
        assert not got["sharded"]["mesh_resilience"]  # a healthy run
    _same_on_every_rank([r["sharded"] for r in per_rank], lambda a, b: (
        np.testing.assert_array_equal(a["prob"], b["prob"])))
