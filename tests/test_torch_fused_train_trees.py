"""The fused training programs of the tree families against the
kernel-at-a-time path and against the JAX package's fused path.

``trees.fused_tree_plan`` and ``local/fused_train.run_tree`` at the
reference tests' 3 000 rows: port fused against port existing - the
plan's heaps bit-equal to ``fit_arrays_folds_grid``'s, fold metrics
within 1e-9, the same winner - for the random forest, the GBT and the
forest regressor; port fused against the reference's fused path (run
through ``torch_parity.reference_fused_x64``; its trees on
``TX_TREE_BACKEND=jax``) - the same trail, fold metrics within 1e-5 where
no exact split tie touches a fold's validation rows (``compare_trees``
through ``tree_fits_agree``), else the predictions off the tie rows within
1e-5 (and rtol 1e-6: the regressor's float32 means), as the existing tree
selector tests hold them.  The plans' fallback
reasons and ``fits_per_dispatch`` against the reference's.
"""
import numpy as np
import pytest
import torch

from torch_parity import (
    PORT,
    REF,
    fold_metric_diffs,
    fused_cv_data,
    fused_validate,
    mod,
    reference_fused_x64,
    tree_fits_agree,
)

N = 3_000


@pytest.fixture(autouse=True)
def _single_device(monkeypatch):
    monkeypatch.setenv("TX_PRODUCT_MESH", "0")
    monkeypatch.setenv("TX_TREE_BACKEND", "jax")
    reference_fused_x64(monkeypatch)


def _family(pkg: str, name: str, **extra):
    kw = {"device": "cpu"} if pkg == PORT else {"backend": "jax"}
    kw.update(extra)
    trees = mod(pkg, "models.trees")
    if name == "gbt":
        return (trees.OpGBTClassifier(num_trees=6, max_depth=3, **kw),
                [{"step_size": s} for s in (0.1, 0.3)])
    cls = (trees.OpRandomForestRegressor if name == "rf_reg"
           else trees.OpRandomForestClassifier)
    return (cls(num_trees=8, max_depth=4, **kw),
            [{"max_depth": 4, "min_info_gain": m} for m in (0.0, 0.01)])


@pytest.mark.parametrize("family", ["rf", "gbt", "rf_reg"])
def test_tree_fused_matches_existing_and_reference(family):
    regression = family == "rf_reg"
    X, y = fused_cv_data(N, regression)
    ev = "OpRegressionEvaluator" if regression else \
        "OpBinaryClassificationEvaluator"
    est, grid = _family(PORT, family)
    existing = fused_validate(PORT, est, grid, X, y, ev, False,
                              stratify=not regression)
    fused = fused_validate(PORT, est, grid, X, y, ev, True,
                           stratify=not regression)
    fam = fused.train_fused["families"][est.model_type]
    assert (fam["backend"], fam["mode"]) == ("fused", "exact")
    assert fam["bucket"] == f"n={N},d=39,k=3,g=2"
    assert fused.best_params == existing.best_params
    assert fold_metric_diffs(existing, fused).max() <= 1e-9
    # the plan's fit: the heaps of the kernel-at-a-time grid fit, bit for bit
    masks = mod(PORT, "selector.validator").stratified_kfold_masks(
        y, 3, 42, not regression)
    W = masks.astype(np.float64)
    plan = est.fused_tree_plan(X, y, W, grid)
    state = [h.numpy() for h in plan["fit"](plan["arrays"])]
    got = est.fit_arrays_folds_grid(X, y, W, grid)
    heaps = state[1:] if family == "gbt" else state
    for j in range(len(grid)):
        for f in range(3):
            for a, b in zip(got[j][f]["heaps"], heaps):
                np.testing.assert_array_equal(a, b[j, f])
            if family == "gbt":
                assert got[j][f]["f0"] == float(state[0][j, f])
    # the reference's own fused path
    ref_est, ref_grid = _family(REF, family)
    want = fused_validate(REF, ref_est, ref_grid, X, y, ev, True,
                          stratify=not regression)
    want_fam = want.train_fused["families"][est.model_type]
    assert (want_fam["backend"], want_fam["mode"], want_fam["bucket"]) == \
        (fam["backend"], fam["mode"], fam["bucket"])
    assert fused.best_params == want.best_params
    diffs = fold_metric_diffs(want, fused)
    ref_fits = ref_est.fit_arrays_folds_grid(X, y, W, ref_grid)
    for j in range(len(grid)):
        for f in range(3):
            tied = tree_fits_agree(ref_fits[j][f], got[j][f], X,
                                   classification=not regression,
                                   gbt=family == "gbt")
            val = ~masks[f]
            if not tied[val].any():
                assert diffs[j, f] <= 1e-5, (j, f, diffs[j, f])
                continue
            rows = X[val][~tied[val]]
            p_got = est.predict_arrays(got[j][f], rows)
            p_want = ref_est.predict_arrays(ref_fits[j][f], rows)
            k = 0 if regression else 2
            np.testing.assert_allclose(np.asarray(p_got[k]),
                                       np.asarray(p_want[k]), rtol=1e-6,
                                       atol=1e-5)


@pytest.mark.parametrize("family,reason", [
    ("rf", "native_backend"), ("gbt", "native_backend"),
    ("rf", "grid_shape_groups"), ("gbt", "grid_shape_groups"),
    ("rf", "dispatch_chunked"), ("gbt", "dispatch_chunked"),
    ("rf", "single_class")])
def test_tree_plan_reasons_match_reference(monkeypatch, family, reason):
    X, y = fused_cv_data(600)
    W = np.ones((3, 600))
    extra = {"backend": "native"} if reason == "native_backend" else {}
    if extra:  # the reference's TX_TREE_BACKEND outranks the param
        monkeypatch.delenv("TX_TREE_BACKEND")
    if reason == "dispatch_chunked":
        monkeypatch.setenv("TX_TREE_FITS_PER_DISPATCH", "5")
    if reason == "single_class":
        y = np.zeros_like(y)
    for pkg in (REF, PORT):
        est, grid = _family(pkg, family, **extra)
        if reason == "grid_shape_groups":
            grid = [{"max_depth": 2}, {"max_depth": 3}]
        with pytest.raises(ValueError, match=f"^{reason}$"):
            est.fused_tree_plan(X, y, W, grid)
    # the validator records the reason and takes the existing path
    est, grid = _family(PORT, family, **extra)
    if reason == "grid_shape_groups":
        grid = [{"max_depth": 2}, {"max_depth": 3}]
    if reason != "single_class":
        r = fused_validate(PORT, est, grid, X, y,
                           "OpBinaryClassificationEvaluator", True)
        assert r.train_fused["families"][est.model_type] == {
            "backend": "existing", "reason": reason}


@pytest.mark.parametrize("shape", [
    (6, 1_000_000, 39, 32, 3), (3, 1_000_000, 39, 32, 4),
    (12, 3_000, 39, 32, 3), (4, 200_000, 9, 32, 4), (20, 10, 2, 255, 5)])
def test_fits_per_dispatch_matches_reference(monkeypatch, shape):
    ref = mod(REF, "models.tree_kernel")
    port = mod(PORT, "models.tree_kernel")
    cap = mod(PORT, "local.fused_train").tree_fits_cap
    assert port._tree_fit_work(*shape) == ref._tree_fit_work(*shape)
    assert port.fits_per_dispatch(*shape) == ref.fits_per_dispatch(*shape)
    assert cap(*shape) == ref.fits_per_dispatch(*shape)
    monkeypatch.setenv("TX_TREE_DISPATCH_BUDGET_S", "0.5")
    assert cap(*shape) == ref.fits_per_dispatch(*shape) == \
        port.fits_per_dispatch(*shape, budget_s=0.5)
    monkeypatch.setenv("TX_TREE_FITS_PER_DISPATCH", "7")
    assert cap(*shape) == ref.fits_per_dispatch(*shape) == 7


def test_tree_dispatch_drops_its_blocks_and_counts():
    """The plan's per-call blocks (fold weights, bootstrap, stats) are
    dropped once the fit has returned; the bins stay for the scoring; the
    dispatch counter moves by one."""
    X, y = fused_cv_data(900)
    est, grid = _family(PORT, "rf")
    masks = mod(PORT, "selector.validator").stratified_kfold_masks(
        y, 3, 42, True)
    plan = est.fused_tree_plan(X, y, masks.astype(np.float64), grid)
    ref_est, _ = _family(REF, "rf")
    want = ref_est.fused_tree_plan(X, y, masks.astype(np.float64), grid)
    # the per-node subset masks stand in for the reference's threefry keys
    assert sorted(plan["arrays"]) == sorted(
        "node_masks" if k == "keys" else k for k in want["arrays"])
    assert plan["sig"][:2] == want["sig"][:2]
    np.testing.assert_array_equal(plan["arrays"]["bins"].numpy(),
                                  want["arrays"]["bins"])
    assert plan["donate"] == want["donate"]
    assert set(plan["donate"]) == {"stats", "w_rows", "boot"}
    assert plan["arrays"]["bins"].dtype == torch.int8
    ft = mod(PORT, "local.fused_train")
    count = mod(PORT, "obs.metrics").metrics_registry().counter(
        "train_fused.dispatches")
    n0 = count.value
    ev = mod(PORT, "evaluators.binary").OpBinaryClassificationEvaluator()
    res = ft.run_tree(est, X, y, masks, masks.astype(np.float64), grid, ev)
    assert count.value == n0 + 1
    assert res.metrics.shape == (3, 2) and res.betas is None
    assert np.isfinite(res.metrics).all()
