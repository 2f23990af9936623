"""Helpers shared by the tests/test_torch_*.py parity tests.

The torch package mirrors the JAX package's module paths, so one builder
drives either package by name: ``pkg`` is ``"transmogrifai_tpu"`` or
``"transmogrifai_tpu_torch"``.
"""
import importlib

import numpy as np
import torch

REF, PORT = "transmogrifai_tpu", "transmogrifai_tpu_torch"

# parity tests compare float32 arithmetic: no TF32 anywhere
torch.set_float32_matmul_precision("highest")


def mod(pkg: str, path: str):
    return importlib.import_module(f"{pkg}.{path}")


def reset_uids(pkg: str) -> None:
    mod(pkg, "utils.uid").reset_uids()


def workflow(pkg: str, result, data, **params):
    """OpWorkflow of ``pkg`` over ``data``; the torch package's runs on
    the CPU."""
    kw = {"device": "cpu"} if pkg == PORT else {}
    wf = mod(pkg, "workflow.workflow").OpWorkflow(**kw)
    wf = wf.set_result_features(result).set_input_dataset(data)
    if params:
        wf.set_parameters(**params)
    return wf


def passenger_features(pkg: str):
    """(label, predictors) of the passenger slice: age, height, weight
    (Real) and gender (PickList) against survived (RealNN)."""
    fb = mod(pkg, "features.feature_builder").FeatureBuilder
    survived = fb.RealNN("survived").as_response()
    preds = [fb.Real(c).as_predictor() for c in ("age", "height", "weight")]
    preds.append(fb.PickList("gender").as_predictor())
    return survived, preds


def passenger_slice(pkg: str, sanity_kw=None, lr_kw=None):
    """transmogrify -> SanityChecker -> OpLogisticRegression of ``pkg``;
    returns (label, checked vector, prediction) features."""
    survived, preds = passenger_features(pkg)
    vec = mod(pkg, "ops.transmogrifier").transmogrify(preds)
    kw = {"device": "cpu"} if pkg == PORT else {}
    checker = mod(pkg, "preparators.sanity_checker").SanityChecker(
        **(sanity_kw or {}), **kw
    )
    checked = checker.set_input(survived, vec).get_output()
    lr = mod(pkg, "models.logistic_regression").OpLogisticRegression(
        **(lr_kw or {}), **kw
    )
    pred = lr.set_input(survived, checked).get_output()
    return survived, checked, pred


def passenger_tree_slice(pkg: str, gbt_kw=None):
    """transmogrify(label=survived) -> SanityChecker -> OpGBTClassifier of
    ``pkg`` (the reference's tree learner on its JAX backend); returns
    (label, vector, checked vector, prediction) features."""
    survived, preds = passenger_features(pkg)
    vec = mod(pkg, "ops.transmogrifier").transmogrify(preds, label=survived)
    kw = {"device": "cpu"} if pkg == PORT else {}
    checked = mod(pkg, "preparators.sanity_checker").SanityChecker(
        **kw).set_input(survived, vec).get_output()
    gbt_kw = dict(gbt_kw or {}, **(kw or {"backend": "jax"}))
    gbt = mod(pkg, "models.trees").OpGBTClassifier(**gbt_kw)
    pred = gbt.set_input(survived, checked).get_output()
    return survived, vec, checked, pred


def small_gbt_grid(num_trees: int = 3, depths=(2, 3)) -> list:
    """A GBT grid of the default grid's form at test size."""
    return [{"max_depth": d, "num_trees": num_trees, "min_info_gain": g}
            for d in depths for g in (0.001, 0.1)]


def selector_models(pkg: str, gbt_grid=None):
    """(estimator, grid) pairs of the binary selector: OpLogisticRegression
    over the default LR grid and OpGBTClassifier (the reference's on its
    JAX backend) over ``gbt_grid``; the torch package's on the CPU."""
    kw = {"device": "cpu"} if pkg == PORT else {}
    lr = mod(pkg, "models.logistic_regression").OpLogisticRegression(**kw)
    gbt = mod(pkg, "models.trees").OpGBTClassifier(**(kw or {"backend": "jax"}))
    return [(lr, mod(pkg, "selector.factories").lr_grid()),
            (gbt, gbt_grid or small_gbt_grid())]


def small_rf_grid(num_trees: int = 4, depths=(2, 4)) -> list:
    """A forest grid of the default grid's form at test size."""
    return [{"max_depth": d, "num_trees": num_trees, "min_info_gain": g,
             "min_instances_per_node": m}
            for d in depths for g in (0.001, 0.1) for m in (10,)]


def default_selector_models(pkg: str, families=None, rf_grid=None,
                            gbt_grid=None):
    """(estimator, grid) pairs of the parameterless binary selector's
    families (or ``families`` of them), the default LR and SVM grids and
    test-sized forest and GBT grids; the reference's trees on their JAX
    backend, the torch package's estimators on the CPU."""
    kw = {"device": "cpu"} if pkg == PORT else {}
    tree_kw = kw or {"backend": "jax"}
    fac, trees = mod(pkg, "selector.factories"), mod(pkg, "models.trees")
    every = {
        "OpLogisticRegression": lambda: (mod(
            pkg, "models.logistic_regression").OpLogisticRegression(**kw),
            fac.lr_grid()),
        "OpRandomForestClassifier": lambda: (
            trees.OpRandomForestClassifier(**tree_kw),
            rf_grid or small_rf_grid()),
        "OpGBTClassifier": lambda: (trees.OpGBTClassifier(**tree_kw),
                                    gbt_grid or small_gbt_grid()),
        "OpLinearSVC": lambda: (
            mod(pkg, "models.linear_svc").OpLinearSVC(**kw), fac.lr_grid()),
    }
    return [every[f]() for f in (families or every)]


def passenger_selector_slice(pkg: str, gbt_grid=None, models=None,
                             **selector_kw):
    """transmogrify(label=survived) -> SanityChecker ->
    BinaryClassificationModelSelector.with_cross_validation over ``models``
    (by default ``selector_models`` of ``pkg``); returns (label, checked
    vector, prediction) features."""
    survived, preds = passenger_features(pkg)
    vec = mod(pkg, "ops.transmogrifier").transmogrify(preds, label=survived)
    kw = {"device": "cpu"} if pkg == PORT else {}
    checked = mod(pkg, "preparators.sanity_checker").SanityChecker(
        **kw).set_input(survived, vec).get_output()
    factory = mod(pkg, "selector.factories").BinaryClassificationModelSelector
    sel = factory.with_cross_validation(
        models_and_parameters=models or selector_models(pkg, gbt_grid),
        **selector_kw, **kw)
    pred = sel.set_input(survived, checked).get_output()
    return survived, checked, pred


def passengers(pkg: str, n: int, seed: int = 42):
    return mod(pkg, "examples.synthetic").synthetic_passengers(
        n, seed=seed, with_text=False
    )


def labelled_passengers(pkg: str, n: int, seed: int = 42):
    """The torch package's ``synthetic_passengers_labelled`` (the passenger
    columns with the planted ``tier`` and ``response`` labels); for the
    JAX package, the same numpy columns in its own ``Dataset``."""
    ds = mod(PORT, "examples.synthetic").synthetic_passengers_labelled(
        n, seed=seed, with_text=False)
    if pkg == PORT:
        return ds
    cols, ft = mod(REF, "types.columns"), mod(REF, "types.feature_types")
    out = {}
    for name in ds:
        c = ds[name]
        ftype = getattr(ft, c.feature_type.__name__)
        if isinstance(c, mod(PORT, "types.columns").NumericColumn):
            out[name] = cols.NumericColumn(c.values, c.mask, ftype)
        else:
            out[name] = cols.TextColumn(c.values, ftype)
    return mod(REF, "types.dataset").Dataset(out)


def problem_selector_slice(pkg: str, problem: str, models=None,
                           **selector_kw):
    """transmogrify(label=...) -> SanityChecker -> the parameterless
    ``MultiClassificationModelSelector`` (``problem="multiclass"``, label
    ``tier``) or ``RegressionModelSelector`` (``"regression"``, label
    ``response``) of ``pkg`` over ``models`` (None: the defaults); returns
    (label, checked vector, prediction) features."""
    fb = mod(pkg, "features.feature_builder").FeatureBuilder
    label = fb.RealNN("tier" if problem == "multiclass"
                      else "response").as_response()
    _, preds = passenger_features(pkg)
    vec = mod(pkg, "ops.transmogrifier").transmogrify(preds, label=label)
    kw = {"device": "cpu"} if pkg == PORT else {}
    checked = mod(pkg, "preparators.sanity_checker").SanityChecker(
        **kw).set_input(label, vec).get_output()
    fac = mod(pkg, "selector.factories")
    factory = (fac.MultiClassificationModelSelector if problem == "multiclass"
               else fac.RegressionModelSelector)
    sel = factory.with_cross_validation(models_and_parameters=models,
                                        **selector_kw, **kw)
    pred = sel.set_input(label, checked).get_output()
    return label, checked, pred


def problem_models(pkg: str, problem: str, rf_grid=None, gbt_grid=None):
    """(estimator, grid) pairs of a problem selector's default families:
    the linear family and the decision tree at their default grids, naive
    Bayes, and test-sized forest and GBT grids (the reference's trees on
    their JAX backend, the torch package's estimators on the CPU)."""
    kw = {"device": "cpu"} if pkg == PORT else {}
    tree_kw = kw or {"backend": "jax"}
    fac, trees = mod(pkg, "selector.factories"), mod(pkg, "models.trees")
    rf = rf_grid or small_rf_grid()
    if problem == "multiclass":
        return [
            (mod(pkg, "models.logistic_regression").OpLogisticRegression(**kw),
             fac.lr_grid()),
            (trees.OpRandomForestClassifier(**tree_kw), rf),
            (trees.OpDecisionTreeClassifier(**tree_kw),
             [{"max_depth": d, "min_info_gain": g}
              for d in fac.MAX_DEPTH for g in fac.MIN_INFO_GAIN]),
            (mod(pkg, "models.naive_bayes").OpNaiveBayes(**kw), [{}]),
        ]
    return [
        (mod(pkg, "models.linear_regression").OpLinearRegression(**kw),
         fac.linreg_grid()),
        (trees.OpRandomForestRegressor(**tree_kw), rf),
        (trees.OpGBTRegressor(**tree_kw), gbt_grid or small_gbt_grid()),
    ]


def reference_states(model) -> list:
    """(class name, state) of each fitted stage of a JAX-package model, as
    ``interop.load_reference_state`` reads them: ``stage_state``, and for a
    selected model also its selection summary."""
    from transmogrifai_tpu.serialization.model_io import stage_state

    out = []
    for s in model.stages:
        state = stage_state(s)
        if type(s).__name__ == "SelectedModel":
            state["model_selector_summary"] = \
                s.metadata["model_selector_summary"]
        out.append((type(s).__name__, state))
    return out


def stage_of(model, cls_name: str):
    (st,) = [s for s in model.stages if type(s).__name__ == cls_name]
    return st


def probabilities(scored, pred_name: str) -> np.ndarray:
    return np.asarray(scored[pred_name].probability, dtype=np.float64)


def identified(model, scored, checked_name: str):
    """The fitted LR's (beta, intercept) with each one-hot group whose kept
    columns sum to 1 on every row centred to mean 0 (the shift moves into
    the intercept).  Such a group is collinear with the intercept, so an
    unregularized fit pins its common level only by float32 rounding."""
    params = model.stages[-1].model_params
    beta = np.asarray(params["beta"], np.float64).copy()
    b0 = float(params["intercept"])
    col = scored[checked_name]
    x = np.asarray(col.values)
    for idx in col.metadata.grouping_indices().values():
        idx = list(idx)
        if len(idx) > 1 and np.all(x[:, idx].sum(axis=1) == 1.0):
            shift = beta[idx].mean()
            beta[idx] -= shift
            b0 += shift
    return beta, b0



def leaf_index(bins: np.ndarray, heap, depth: int, stop=()) -> np.ndarray:
    """Heap slot each row of ``bins`` lands in (the flat-heap walk); a row
    stops early at a slot in ``stop``."""
    hf, ht, hl = (np.asarray(h) for h in heap[:3])
    idx = np.zeros(bins.shape[0], dtype=np.int64)
    rows = np.arange(bins.shape[0])
    halt = np.zeros(len(hf), bool)
    halt[list(stop)] = True
    for _ in range(depth):
        nxt = idx * 2 + 1 + (bins[rows, hf[idx]] > ht[idx])
        idx = np.where(hl[idx] | halt[idx], idx, nxt)
    return idx


def compare_trees(got, want, bins, depth, rtol=0.0, atol=0.0):
    """One tree grown by each package on the same bins.  Walking down from
    the root, every node reached must have the same leaf flag, split and
    stats (within rtol, atol) - except at an exact tie: both packages
    split the node, on different (feature, bin) pairs whose two children
    hold the same stats (as a pair, in either order), so the gains are
    equal and float32 rounding picked the winner.  Below a tie the
    subtrees grow on different rows and are not compared.  Heaps that
    differ only by ties between splits that route every row alike (two
    complementary one-hot columns) put the rows into the same leaves:
    then the leaves' stats are compared row by row instead.

    Returns (tie nodes, mask of the rows whose path in either tree passes
    a tie node); ties are logged in ROADMAP.md queue 3."""
    got = [np.asarray(h) for h in got]
    want = [np.asarray(h) for h in want]
    if not all(np.array_equal(g, v) for g, v in zip(got[:3], want[:3])):
        # a tie between splits that send every row the same way (e.g. two
        # complementary one-hot columns) leaves the same leaves
        lg, lw = leaf_index(bins, got, depth), leaf_index(bins, want, depth)
        pairs = set(zip(lw.tolist(), lg.tolist()))
        if len(pairs) == len(set(lw.tolist())) == len(set(lg.tolist())):
            np.testing.assert_allclose(got[3][lg], want[3][lw],
                                       rtol=rtol, atol=atol)
            return [], np.zeros(bins.shape[0], bool)
    ties, todo = [], [0]
    while todo:
        i = todo.pop()
        np.testing.assert_allclose(got[3][i], want[3][i], rtol=rtol, atol=atol)
        assert got[2][i] == want[2][i], f"node {i}: leaf flags differ"
        if want[2][i] or 2 * i + 2 >= len(want[0]):
            continue
        kids = [2 * i + 1, 2 * i + 2]
        if (got[0][i], got[1][i]) == (want[0][i], want[1][i]):
            todo.extend(kids)
            continue
        g, w = got[3][kids], want[3][kids]
        same = np.allclose(g, w, rtol=rtol, atol=atol)
        mirrored = np.allclose(g, w[::-1], rtol=rtol, atol=atol)
        assert same or mirrored, f"node {i}: different splits, not a tie"
        ties.append(i)
    lg = leaf_index(bins, got, depth, stop=ties)
    lw = leaf_index(bins, want, depth, stop=ties)
    return ties, np.isin(lg, ties) | np.isin(lw, ties)


def tree_fits_agree(want, got, X, classification: bool, gbt: bool = False):
    """A tree family's params fitted by each package on the same X: the
    same edges, depth and heap dtypes; every tree equal node by node but
    at exact ties (``compare_trees``) - gini counts exactly, variance and
    gradient channels (a GBT's as its Newton leaf values) within rtol
    1e-4, atol 1e-5.  Returns the mask of the rows a tie touches."""
    np.testing.assert_array_equal(got["edges"], want["edges"])
    assert got["max_depth"] == want["max_depth"]
    assert [h.dtype for h in got["heaps"]] == \
        [np.asarray(h).dtype for h in want["heaps"]]

    def stats(hv):
        if not gbt:
            return hv
        leaf = hv[..., 1] / np.maximum(hv[..., 3], 1e-12)
        return np.concatenate([hv[..., [0, 3]], leaf[..., None]], axis=-1)

    depth = want["max_depth"]
    bins = mod(REF, "models.tree_kernel").bin_data(
        np.asarray(X, np.float32), want["edges"])
    exact = classification and not gbt
    tol = dict(rtol=0.0, atol=0.0) if exact else dict(rtol=1e-4, atol=1e-5)
    tied = np.zeros(bins.shape[0], bool)
    for t in range(len(want["heaps"][0])):
        g = [h[t] for h in got["heaps"][:3]] + [stats(got["heaps"][3][t])]
        w = [np.asarray(h[t]) for h in want["heaps"][:3]] + [
            stats(np.asarray(want["heaps"][3][t]))]
        tied |= compare_trees(g, w, bins, depth, **tol)[1]
    return tied


# -- the fused-serving slice ------------------------------------------------
#: per-family float tolerance of torch-fused against numpy-fused rows,
#: (ulps, atol), copied from the JAX package's tests/test_fused_xla.py
#: ULP_BUDGETS (its XLA backend against its numpy-fused one): gathers and
#: elementwise heads are bit-exact to an ULP, matmul heads a few ULP
ULP_BUDGETS = {
    "rf": (1, 0.0), "rf_reg": (1, 0.0), "svc": (1, 0.0),
    "linreg": (1, 0.0),
    "lr": (4, 0.0), "nb": (4, 0.0),
    "gbt": (64, 0.0), "gbt_reg": (64, 0.0),
}

#: the families of the JAX package's tests/test_fused_pipeline.py that the
#: torch package has: name -> (estimator maker(pkg), classification)
SERVE_FAMILIES = {
    "lr": (lambda p: mod(p, "models.logistic_regression")
           .OpLogisticRegression(reg_param=0.01), True),
    "rf": (lambda p: mod(p, "models.trees")
           .OpRandomForestClassifier(num_trees=8, max_depth=4), True),
    "gbt": (lambda p: mod(p, "models.trees")
            .OpGBTClassifier(num_trees=6, max_depth=3), True),
    "nb": (lambda p: mod(p, "models.naive_bayes").OpNaiveBayes(), True),
    "svc": (lambda p: mod(p, "models.linear_svc").OpLinearSVC(), True),
    "linreg": (lambda p: mod(p, "models.linear_regression")
               .OpLinearRegression(), False),
    "rf_reg": (lambda p: mod(p, "models.trees")
               .OpRandomForestRegressor(num_trees=8, max_depth=4), False),
    "gbt_reg": (lambda p: mod(p, "models.trees")
                .OpGBTRegressor(num_trees=6, max_depth=3), False),
}


def mixed_pipeline(pkg: str, family: str, n: int = 160, seed: int = 3):
    """The JAX package's ``_mixed_pipeline`` (tests/test_fused_pipeline.py)
    in ``pkg``: fill-mean -> z-normalize, real and integral vectorizers, a
    one-hot picklist, the combiner, the SanityChecker and the ``family``
    head.  Returns (workflow, records, prediction name); the torch
    package's workflow runs on the CPU."""
    mod(pkg, "dsl")
    make, classification = SERVE_FAMILIES[family]
    rng = np.random.RandomState(seed)
    y = ((rng.rand(n) > 0.5).astype(float) if classification
         else rng.randn(n) * 2.0)
    data = {
        "y": y.tolist(),
        "a": [float(v) if rng.rand() > 0.2 else None
              for v in rng.randn(n)],
        "b": rng.uniform(0, 10, n).round(3).tolist(),
        "k": rng.randint(0, 5, n).astype(float).tolist(),
        "c": [("u", "v", "w", None)[rng.randint(4)] for _ in range(n)],
    }
    fb = mod(pkg, "features.feature_builder").FeatureBuilder
    ft = mod(pkg, "types.feature_types")
    yf = fb(ft.RealNN, "y").as_response()
    a = fb(ft.Real, "a").as_predictor()
    b = fb(ft.Real, "b").as_predictor()
    k = fb(ft.Integral, "k").as_predictor()
    c = fb(ft.PickList, "c").as_predictor()
    vec = mod(pkg, "ops.transmogrifier").transmogrify(
        [a.fill_missing_with_mean().z_normalize(), b, k, c])
    checked = yf.sanity_check(vec, remove_bad_features=True)
    pred = make(pkg).set_input(yf, checked).get_output()
    records = [
        {nm: data[nm][i] for nm in ("a", "b", "k", "c")} for i in range(n)
    ]
    return workflow(pkg, pred, data), records, pred.name


def assert_rows_close(got_rows, want_rows, ulps: int, atol: float = 0.0,
                      unit=np.float64):
    """Result dicts equal key for key, floats within ``ulps`` of the
    wanted value's spacing as a ``unit`` (or ``atol``), everything else
    exactly."""
    assert len(got_rows) == len(want_rows)
    for rg, rw in zip(got_rows, want_rows):
        assert rg.keys() == rw.keys()
        for name in rg:
            dg, dw = rg[name], rw[name]
            if not isinstance(dg, dict):
                assert dg == dw, name
                continue
            assert dg.keys() == dw.keys(), name
            for kk, vg in dg.items():
                vw = dw[kk]
                if isinstance(vg, float) and isinstance(vw, float):
                    if vg == vw:
                        continue
                    assert np.isfinite(vg) and np.isfinite(vw), (
                        name, kk, vg, vw)
                    tol = max(ulps * float(np.spacing(unit(abs(vw)))),
                              atol)
                    assert abs(vg - vw) <= tol, (name, kk, vg, vw)
                else:
                    assert vg == vw, (name, kk)

