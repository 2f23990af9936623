"""The model selector's host pieces and validator against the JAX package.

Bit-equal: the splitters (weights, keep masks, summaries),
``stratified_kfold_masks`` and the train/validation split masks,
``RandomParamBuilder``'s draws and the factory grids.
``masked_rank_metrics``: within 1e-6 of the reference on bin-centre scores
(lossless binning: both count the same integers), 1e-4 on continuous
scores.  ``OpCrossValidation.validate`` over LR and GBT grids: the same
winner and ``all_results`` keys, fold metrics within 1e-5 in the exact
mode and 1e-3 in the approx mode.  The reference runs its single-device
route (``TX_PRODUCT_MESH=0``): the torch package has no mesh yet.
"""
import numpy as np
import pytest

from torch_parity import PORT, REF, mod, selector_models


def _both(path):
    return mod(REF, path), mod(PORT, path)


# -- splitters ----------------------------------------------------------------

def _labels(kind, rng):
    if kind == "balanced":
        return (rng.rand(500) < 0.45).astype(float)
    if kind == "rare_positive":
        return (rng.rand(2000) < 0.03).astype(float)
    if kind == "rare_negative":
        return (rng.rand(2000) < 0.97).astype(float)
    if kind == "one_class":
        return np.zeros(100)
    return rng.randint(0, 6, size=700).astype(float)  # multiclass


@pytest.mark.parametrize("kind", ["balanced", "rare_positive", "rare_negative",
                                  "one_class", "multiclass"])
@pytest.mark.parametrize("splitter,kw", [
    ("Splitter", {}),
    ("DataSplitter", {"reserve_test_fraction": 0.2}),
    ("DataBalancer", {}),
    ("DataBalancer", {"sample_fraction": 0.2, "max_training_sample": 300}),
    ("DataCutter", {"min_label_fraction": 0.15, "max_label_categories": 3}),
    ("DataCutter", {}),
])
def test_splitters_bit_equal(kind, splitter, kw):
    y = _labels(kind, np.random.RandomState(3))
    ref, port = _both("selector.splitters")
    want = getattr(ref, splitter)(**kw).prepare(y)
    got = getattr(port, splitter)(**kw).prepare(y)
    np.testing.assert_array_equal(got.weights, want.weights)
    assert got.weights.dtype == want.weights.dtype
    if want.keep_mask is None:
        assert got.keep_mask is None
    else:
        np.testing.assert_array_equal(got.keep_mask, want.keep_mask)
    assert got.summary == want.summary


# -- fold masks ---------------------------------------------------------------

@pytest.mark.parametrize("k", [2, 3, 5])
@pytest.mark.parametrize("stratify", [True, False])
@pytest.mark.parametrize("seed", [0, 42])
def test_kfold_masks_bit_equal(k, stratify, seed):
    y = _labels("multiclass", np.random.RandomState(seed + k))
    ref, port = _both("selector.validator")
    np.testing.assert_array_equal(
        port.stratified_kfold_masks(y, k, seed, stratify),
        ref.stratified_kfold_masks(y, k, seed, stratify),
    )


@pytest.mark.parametrize("stratify", [True, False])
def test_train_validation_split_masks_bit_equal(stratify):
    y = _labels("rare_positive", np.random.RandomState(5))
    ref, port = _both("selector.validator")
    kw = {"train_ratio": 0.7, "seed": 11, "stratify": stratify}
    np.testing.assert_array_equal(
        port.OpTrainValidationSplit(device="cpu", **kw).train_masks(y),
        ref.OpTrainValidationSplit(**kw).train_masks(y),
    )


# -- random grids and the factory grids -----------------------------------------

def test_random_param_builder_same_draws():
    def build(pkg):
        b = mod(pkg, "selector.random_param_builder").RandomParamBuilder(seed=7)
        b.uniform("step_size", 0.01, 0.3).log_uniform("reg_param", 1e-4, 1.0)
        b.int_uniform("max_depth", 2, 9).choice("elastic_net_param", [0.1, 0.5])
        return [b.build(4), b.build(2), b.build(4)]

    assert build(PORT) == build(REF)


@pytest.mark.parametrize("grid", ["lr_grid", "gbt_grid", "rf_grid", "linreg_grid"])
def test_factory_grids_equal(grid):
    ref, port = _both("selector.factories")
    assert getattr(port, grid)() == getattr(ref, grid)()
    for const in ("REGULARIZATION", "ELASTIC_NET", "MAX_DEPTH", "MAX_TREES",
                  "MIN_INFO_GAIN", "MIN_INSTANCES_PER_NODE"):
        assert getattr(port, const) == getattr(ref, const)


# -- device rank metrics --------------------------------------------------------

def _bin_centre_scores(rng, B, n):
    scores = rng.randint(0, 1024, size=(B, n)).astype(np.float64) / 1023.0
    scores[:, 0] = 0.0  # pin min/max so the affine bin map hits centres
    scores[:, 1] = 1.0
    return scores


@pytest.mark.parametrize("case", ["bin_centres", "masks_exclude_min_max",
                                  "continuous"])
def test_masked_rank_metrics_match_reference(case):
    rng = np.random.RandomState({"bin_centres": 0, "continuous": 1,
                                 "masks_exclude_min_max": 2}[case])
    B, n = 6, 2000
    y = (rng.rand(n) < 0.4).astype(np.float64)
    vmask = rng.rand(B, n) < 0.5
    if case == "continuous":
        scores = rng.randn(B, n) + 1.2 * y[None, :]
        atol = 1e-4
    else:
        scores = _bin_centre_scores(rng, B, n)
        # the global min and max lie in masked-out rows: the bins still
        # span all n rows of each candidate
        vmask[:, :2] = case == "bin_centres"
        atol = 1e-6
    ref, port = _both("evaluators.binary")
    want = ref.masked_rank_metrics(scores, y, vmask)
    got = port.masked_rank_metrics(scores, y, vmask, device="cpu")
    for g, w in zip(got, want):
        assert g.shape == (B,) and g.dtype == np.float64
        np.testing.assert_allclose(g, w, rtol=0, atol=atol)


def test_masked_rank_metrics_default_to_cuda():
    """Host inputs go to the card unless the CPU is asked for; tensors stay
    on their own device."""
    import torch

    ev = mod(PORT, "evaluators.binary")
    y = np.array([0.0, 1.0, 1.0, 0.0])
    s = np.array([[0.1, 0.9, 0.4, 0.3]])
    m = np.ones((1, 4))
    auroc, _ = ev.masked_rank_metrics(torch.tensor(s), torch.tensor(y),
                                      torch.tensor(m))
    assert auroc[0] == 1.0
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            ev.masked_rank_metrics(s, y, m)


def test_masked_rank_metrics_equal_exact_on_bin_centres():
    """Lossless binning: the device metrics are the host evaluator's."""
    rng = np.random.RandomState(4)
    B, n = 5, 600
    y = (rng.rand(n) < 0.3).astype(np.float64)
    scores = _bin_centre_scores(rng, B, n)
    vmask = rng.rand(B, n) < 0.6
    vmask[:, :2] = True
    port = mod(PORT, "evaluators.binary")
    auroc, aupr = port.masked_rank_metrics(scores, y, vmask, device="cpu")
    for b in range(B):
        m = vmask[b]
        want_roc, want_pr = port._roc_pr_areas(y[m], scores[b][m])
        np.testing.assert_allclose(auroc[b], want_roc, atol=1e-9)
        np.testing.assert_allclose(aupr[b], want_pr, atol=1e-9)


# -- the validator ------------------------------------------------------------

def _cv_data(n=450, d=6, seed=9):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, d) * np.linspace(0.5, 3.0, d) + np.linspace(-1.0, 2.0, d)
    z = X @ np.linspace(1.0, -0.6, d) + 0.8 * rng.randn(n)
    return X, (z > np.median(z)).astype(np.float64)


def _validate(pkg, cls, X, y, w, **kw):
    val = mod(pkg, "selector.validator")
    ev = mod(pkg, "evaluators.binary").OpBinaryClassificationEvaluator()
    if pkg == PORT:
        kw["device"] = "cpu"
    return getattr(val, cls)(evaluator=ev, seed=42, stratify=True, **kw) \
        .validate(selector_models(pkg), X, y, w)


@pytest.mark.parametrize("mode,atol", [("exact", 1e-5), ("approx", 1e-3)])
@pytest.mark.parametrize("cls,kw", [("OpCrossValidation", {"num_folds": 3}),
                                    ("OpTrainValidationSplit", {})])
def test_validate_matches_reference(monkeypatch, mode, atol, cls, kw):
    monkeypatch.setenv("TX_PRODUCT_MESH", "0")
    monkeypatch.setenv("TX_CV_RANK_METRICS", mode)
    X, y = _cv_data()
    w = np.where(y == 1, 1.5, 1.0)
    want = _validate(REF, cls, X, y, w, **kw)
    got = _validate(PORT, cls, X, y, w, **kw)
    assert got.best_params == want.best_params
    assert got.best_estimator.model_type == want.best_estimator.model_type
    assert got.best_estimator.device == "cpu"
    assert got.metric_name == want.metric_name == "AuROC"
    np.testing.assert_allclose(got.best_metric, want.best_metric, atol=atol)
    assert len(got.all_results) == len(want.all_results) == 8 + 4
    for g, r in zip(got.all_results, want.all_results):
        assert sorted(g) == sorted(r)
        assert (g["model_type"], g["params"]) == (r["model_type"], r["params"])
        assert g["rank_metric_mode"] == r["rank_metric_mode"]
        np.testing.assert_allclose(g["fold_metrics"], r["fold_metrics"],
                                   rtol=0, atol=atol)
    modes = {r["model_type"]: r["rank_metric_mode"] for r in got.all_results}
    assert modes == {"OpLogisticRegression": mode, "OpGBTClassifier": "exact"}


def _validate_default(pkg, X, y, w, families):
    from torch_parity import default_selector_models

    val = mod(pkg, "selector.validator")
    ev = mod(pkg, "evaluators.binary").OpBinaryClassificationEvaluator()
    kw = {"device": "cpu"} if pkg == PORT else {}
    return val.OpCrossValidation(evaluator=ev, seed=42, stratify=True,
                                 num_folds=3, **kw).validate(
        default_selector_models(pkg, families), X, y, w)


def test_svc_metric_follows_the_rank_mode(monkeypatch):
    """The linear SVM has no probability: under approx the device rank
    metrics rank its margins, under exact the host evaluator ranks its 0/1
    prediction (the reference's rule, ROADMAP.md queue 3).  Each mode's
    fold metrics match the reference's (1e-3 approx, 1e-5 exact); the
    forest is exact in both.  Unit weights: with the 1.5 class weight of
    ``test_validate_matches_reference`` one forest tree meets an exact
    split tie (queue 3, kind 2) and its fold metric moves by 1e-3."""
    monkeypatch.setenv("TX_PRODUCT_MESH", "0")
    X, y = _cv_data(n=600)
    w = None
    families = ["OpLinearSVC", "OpRandomForestClassifier"]
    by_mode = {}
    for mode, atol in (("approx", 1e-3), ("exact", 1e-5)):
        monkeypatch.setenv("TX_CV_RANK_METRICS", mode)
        want = _validate_default(REF, X, y, w, families)
        got = _validate_default(PORT, X, y, w, families)
        assert len(got.all_results) == len(want.all_results) == 8 + 4
        for g, r in zip(got.all_results, want.all_results):
            assert (g["model_type"], g["params"]) == (r["model_type"], r["params"])
            assert g["rank_metric_mode"] == r["rank_metric_mode"] == (
                mode if g["model_type"] == "OpLinearSVC" else "exact")
            np.testing.assert_allclose(g["fold_metrics"], r["fold_metrics"],
                                       rtol=0, atol=atol)
        assert got.best_params == want.best_params
        by_mode[mode] = [r["metric"] for r in got.all_results[:8]]
    # ranking the 0/1 prediction loses most of the margins' ordering
    assert min(by_mode["approx"]) > max(by_mode["exact"]) + 0.02


def test_approx_rank_gate(monkeypatch):
    """The validator's device is CUDA and n >= 100 000, or the override."""
    import torch

    monkeypatch.delenv("TX_CV_RANK_METRICS", raising=False)
    val = mod(PORT, "selector.validator").OpCrossValidation(device="cpu")
    cpu, cuda = torch.device("cpu"), torch.device("cuda")
    assert not val._approx_rank(10**6, cpu)
    assert val._approx_rank(100_000, cuda) and not val._approx_rank(99_999, cuda)
    monkeypatch.setenv("TX_CV_RANK_METRICS", "approx")
    assert val._approx_rank(10, cpu)
    monkeypatch.setenv("TX_CV_RANK_METRICS", "exact")
    assert not val._approx_rank(10**6, cuda)


# -- what is not ported raises, naming its item -------------------------------

def test_unported_families_and_selectors_raise():
    """Every binary family of the JAX package's registry builds, the
    default list included; the multiclass and regression selectors no
    longer raise: they build their default families, and, as in the
    reference, have no train-validation-split entry point."""
    fac = mod(PORT, "selector.factories")
    binary = fac.BinaryClassificationModelSelector
    for types, want in ((None, ["OpLogisticRegression",
                                "OpRandomForestClassifier", "OpGBTClassifier",
                                "OpLinearSVC"]),
                        (["OpRandomForestClassifier"], None),
                        (["OpLinearSVC"], None), (["OpNaiveBayes"], None)):
        sel = binary.with_cross_validation(model_types_to_use=types,
                                           device="cpu")
        assert [e.model_type for e, _ in sel.models] == (want or types)
    multi = fac.MultiClassificationModelSelector(device="cpu")
    assert [e.model_type for e, _ in multi.models] == [
        "OpLogisticRegression", "OpRandomForestClassifier",
        "OpDecisionTreeClassifier", "OpNaiveBayes"]
    regression = fac.RegressionModelSelector(device="cpu")
    assert [e.model_type for e, _ in regression.models] == [
        "OpLinearRegression", "OpRandomForestRegressor", "OpGBTRegressor"]
    with pytest.raises(AttributeError):
        fac.RegressionModelSelector.with_train_validation_split()


@pytest.mark.parametrize("make", ["with_cross_validation",
                                  "with_train_validation_split", "__new__"])
def test_default_families_and_grids_equal_reference(make):
    """The parameterless factory: the reference's four default families in
    its order, each at its default params and grid."""
    def build(pkg):
        binary = mod(pkg, "selector.factories").BinaryClassificationModelSelector
        kw = {"device": "cpu"} if pkg == PORT else {}
        return binary(**kw) if make == "__new__" else getattr(binary, make)(**kw)

    got, want = build(PORT), build(REF)
    assert [e.model_type for e, _ in got.models] == \
        [e.model_type for e, _ in want.models] == [
            "OpLogisticRegression", "OpRandomForestClassifier",
            "OpGBTClassifier", "OpLinearSVC"]
    for (ge, gg), (we, wg) in zip(got.models, want.models):
        assert list(gg) == list(wg)
        assert ge.params == {**we.params, **({"backend": "auto"}
                                             if "backend" in we.params else {})}
        assert ge.device == "cpu"
    assert [len(g) for _, g in got.models] == [8, 18, 9, 8]
    assert type(got.validator).__name__ == type(want.validator).__name__
    assert type(got.splitter).__name__ == type(want.splitter).__name__


def test_factory_builds_ported_families_on_its_device():
    fac = mod(PORT, "selector.factories")
    types = ["OpLogisticRegression", "OpGBTClassifier"]
    for make in (fac.BinaryClassificationModelSelector.with_cross_validation,
                 fac.BinaryClassificationModelSelector.with_train_validation_split):
        sel = make(model_types_to_use=types, device="cpu")
        assert [e.model_type for e, _ in sel.models] == types
        assert [g for _, g in sel.models] == [fac.lr_grid(), fac.gbt_grid()]
        assert {e.device for e, _ in sel.models} == {sel.device} == {"cpu"}
        assert sel.validator.device == "cpu"
    sel = fac.BinaryClassificationModelSelector(model_types_to_use=types)
    assert sel.device == sel.validator.device == "cuda"
    assert type(sel.validator).__name__ == "OpCrossValidation"
    assert type(sel.splitter).__name__ == "DataBalancer"


def test_unported_validator_options_raise(monkeypatch):
    val = mod(PORT, "selector.validator")
    with pytest.raises(NotImplementedError, match=r"item 1\)"):
        val.OpCrossValidation(checkpoint_path="cv.json")
    with pytest.raises(NotImplementedError, match=r"item 12\)"):
        val.OpCrossValidation(autotune=object())
    cv = val.OpCrossValidation(device="cpu")
    with pytest.raises(NotImplementedError, match=r"item 12\)"):
        cv.validate_stream([], iter(()))
    X, y = _cv_data(n=60)
    cv.train_fused = True
    with pytest.raises(NotImplementedError, match=r"item 9\)"):
        cv.validate(selector_models(PORT), X, y)
    cv.train_fused = None
    monkeypatch.setenv("TX_TRAIN_FUSED", "1")
    with pytest.raises(NotImplementedError, match=r"item 9\)"):
        cv.validate(selector_models(PORT), X, y)
