"""Helpers shared by the tests/test_torch_*.py parity tests.

The torch package mirrors the JAX package's module paths, so one builder
drives either package by name: ``pkg`` is ``"transmogrifai_tpu"`` or
``"transmogrifai_tpu_torch"``.
"""
import importlib
import os

import numpy as np
import torch

REF, PORT = "transmogrifai_tpu", "transmogrifai_tpu_torch"

# parity tests compare float32 arithmetic: no TF32 anywhere
torch.set_float32_matmul_precision("highest")

# one intra-op thread count in every test process, on every host: left
# alone, every xdist worker runs torch's pool at the machine's full core
# count and the workers oversubscribe the CPU many times over.  Both
# sides of every bit-equality comparison run in one process, under the
# same count.  The count is fixed rather than a share of the cores
# because MKL's float32 GEMM sums in an order that depends on it, and a
# port-against-reference tolerance test sits at the edge at some counts
# (ROADMAP.md queue 3): its verdict must not depend on the host.
TORCH_TEST_THREADS = 4
torch.set_num_threads(TORCH_TEST_THREADS)


def _device_fault_params():
    """pytest params of the two device faults (``parallel.kernels.
    is_device_fault``) that every catch-all of the port re-raises."""
    import pytest

    kernel_error = mod(PORT, "parallel.kernels").KernelError
    return [
        pytest.param(lambda: kernel_error(
            "bin_matrix kernel launch failed: CUDA error 700"),
            id="KernelError"),
        pytest.param(lambda: torch.AcceleratorError(
            "CUDA error: an illegal memory access was encountered"),
            id="AcceleratorError"),
    ]


def mod(pkg: str, path: str):
    return importlib.import_module(f"{pkg}.{path}")


DEVICE_FAULTS = _device_fault_params()


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
    "linreg": (1, 0.0), "glm": (1, 0.0),
    "lr": (4, 0.0), "nb": (4, 0.0),
    "gbt": (64, 0.0), "gbt_reg": (64, 0.0),
    "mlp": (64, 1e-9),
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
    "mlp": (lambda p: mod(p, "models.mlp").OpMultilayerPerceptronClassifier(
        hidden_layers=(4,), max_iter=15), True),
    "glm": (lambda p: mod(p, "models.glm")
            .OpGeneralizedLinearRegression(), False),
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



# -- serving and the model registry ---------------------------------------------

def tiny_pipeline(pkg: str, n: int = 120, seed: int = 0):
    """The JAX package's ``testkit.drills.tiny_drill_pipeline`` in
    ``pkg`` (y response, a numeric, c a three-value picklist,
    transmogrify, a logistic regression at reg 0.01): (workflow, data,
    records, prediction name); the torch package's workflow runs on the
    CPU."""
    mod(pkg, "dsl")
    fb = mod(pkg, "features.feature_builder").FeatureBuilder
    ft = mod(pkg, "types.feature_types")
    rng = np.random.RandomState(seed)
    data = {
        "y": (rng.rand(n) > 0.5).astype(float).tolist(),
        "a": rng.randn(n).tolist(),
        "c": [("u", "v", "w")[i % 3] for i in range(n)],
    }
    y = fb(ft.RealNN, "y").as_response()
    a = fb(ft.Real, "a").as_predictor()
    c = fb(ft.PickList, "c").as_predictor()
    vec = mod(pkg, "ops.transmogrifier").transmogrify([a, c])
    pred = mod(pkg, "models.logistic_regression").OpLogisticRegression(
        reg_param=0.01).set_input(y, vec).get_output()
    records = [{"a": data["a"][i], "c": data["c"][i]} for i in range(n)]
    return workflow(pkg, pred, data), data, records, pred.name


def reference_pair(pkg_builder, path: str):
    """Train ``pkg_builder(REF)``'s workflow in the JAX package, save it at
    ``path`` and load the artifact into ``pkg_builder(PORT)``'s workflow:
    (reference model, torch model with the same weights).  Each side's uid
    counters are reset before its build, so feature names agree."""
    from transmogrifai_tpu_torch.interop import load_reference_artifact

    reset_uids(REF)
    ref_model = pkg_builder(REF).train()
    ref_model.save(path)
    reset_uids(PORT)
    return ref_model, load_reference_artifact(path, pkg_builder(PORT))


def strip_volatile(doc, keys):
    """``doc`` without the entries named in ``keys``, at any depth (the
    timestamps, content hashes and paths two packages' registry documents
    may differ in)."""
    if isinstance(doc, dict):
        return {k: strip_volatile(v, keys) for k, v in doc.items()
                if k not in keys}
    if isinstance(doc, list):
        return [strip_volatile(v, keys) for v in doc]
    return doc


# -- the vectorizer slice: every transmogrify group ----------------------------

#: a pinned "now" for the date vectorizers (``reference_date_ms=None``
#: captures the time of the fit, which two runs never share)
REFERENCE_DATE_MS = 1_500_000_000_000.0

#: one feature of each of these types makes the type lattice: every
#: transmogrify group, every map value route
LATTICE_TYPES = (
    "Real", "Integral", "Binary", "PickList", "MultiPickList", "Text",
    "TextArea", "Email", "URL", "Phone", "ID", "Date", "DateTime", "DateList",
    "TextList", "Geolocation", "RealMap", "IntegralMap", "BinaryMap",
    "TextMap", "PickListMap", "DateMap", "GeolocationMap", "MultiPickListMap",
)


def assert_same(got, want, where: str = "") -> None:
    """``got`` equals ``want`` exactly, through tuples, lists and dicts;
    arrays by value and dtype, NaN equal to NaN."""
    if isinstance(want, np.ndarray) or isinstance(got, np.ndarray):
        got, want = np.asarray(got), np.asarray(want)
        assert got.dtype == want.dtype, (where, got.dtype, want.dtype)
        np.testing.assert_array_equal(got, want, err_msg=where)
    elif isinstance(want, dict):
        assert isinstance(got, dict) and list(got) == list(want), (
            where, list(got)[:8], list(want)[:8])
        for k in want:
            assert_same(got[k], want[k], f"{where}[{k!r}]")
    elif isinstance(want, (tuple, list)) and not isinstance(want, str):
        assert isinstance(got, (tuple, list)) and len(got) == len(want), (
            where, got, want)
        for i, (g, w) in enumerate(zip(got, want)):
            assert_same(g, w, f"{where}[{i}]")
    elif isinstance(want, float) and want != want:
        assert isinstance(got, float) and got != got, (where, got)
    else:
        assert type(got).__name__ == type(want).__name__ and got == want, (
            where, got, want)


def column_state(col) -> tuple:
    """A column in a form both packages share: its class and type names,
    its values (and mask), and for a vector every field of every column's
    metadata."""
    import dataclasses

    kind = (type(col).__name__, col.feature_type.__name__
            if getattr(col, "feature_type", None) is not None else None)
    meta = getattr(col, "metadata", None)
    if meta is not None and hasattr(meta, "columns"):
        return kind + (np.asarray(col.values), meta.name,
                       tuple(dataclasses.astuple(m) for m in meta.columns))
    if hasattr(col, "mask"):
        return kind + (np.asarray(col.values), np.asarray(col.mask))
    return kind + (col.to_list(),)


def run_features(pkg: str, build, n: int, seed: int = 7, data=None) -> list:
    """Train and score, on ``pkg``'s workflow, the features that
    ``build(pkg)`` returns over ``data(pkg)`` (by default
    ``lattice_dataset(pkg, n, seed)``); returns the ``column_state`` of
    each."""
    reset_uids(pkg)
    data = data(pkg) if data is not None else lattice_dataset(pkg, n, seed)
    feats = build(pkg)
    scored = workflow(pkg, feats[0], data).set_result_features(
        *feats).train().score()
    return [column_state(scored[f.name]) for f in feats]


def assert_features_match(build, n: int = 300, seed: int = 7,
                          data=None) -> list:
    """``run_features`` in both packages gives the same columns; returns
    the port's."""
    want = run_features(REF, build, n, seed, data)
    got = run_features(PORT, build, n, seed, data)
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert_same(g, w, f"feature {i}")
    return got


def lattice_dataset(pkg: str, n: int, seed: int = 100,
                    probability_of_empty: float = 0.1):
    """``pkg``'s testkit ``random_dataset`` over one column ``f_<type>`` of
    each LATTICE_TYPES type, drawn by ``default_generator`` (type i from
    seed ``seed + i``), and a binary ``label`` (RealNN) planted on the
    real, integral and pick-list columns."""
    ftm = mod(pkg, "types.feature_types")
    rd = mod(pkg, "testkit.random_data")
    gens = {f"f_{t.lower()}": (rd.default_generator(
        getattr(ftm, t), seed=seed + i,
        probability_of_empty=probability_of_empty), getattr(ftm, t))
        for i, t in enumerate(LATTICE_TYPES)}
    ds = rd.random_dataset(gens, n)
    cols = {c: ds[c] for c in ds.column_names()}
    cols["label"] = mod(pkg, "types.columns").NumericColumn(
        lattice_label(cols), np.ones(n, bool), ftm.RealNN)
    return mod(pkg, "types.dataset").Dataset(cols)


def lattice_label(cols: dict) -> np.ndarray:
    """0/1 label of a lattice dataset: a logistic draw on its real value,
    its integral value and whether its pick list says ``red`` (a null
    counts as the mean)."""
    real, integral = cols["f_real"], cols["f_integral"]
    r = np.where(real.mask, real.values, 0.0)
    i = np.where(integral.mask, integral.values, 50.0)
    red = np.array([v == "red" for v in cols["f_picklist"].values], float)
    noise = np.random.RandomState(7).logistic(size=len(r))
    return (1.0 * r + 0.03 * (i - 50.0) + 1.5 * red - 0.5 + noise
            > 0).astype(np.float64)


def lattice_features(pkg: str) -> tuple:
    """(label, one predictor per LATTICE_TYPES type) of a lattice dataset."""
    fb = mod(pkg, "features.feature_builder").FeatureBuilder
    label = fb.RealNN("label").as_response()
    return label, [getattr(fb, t)(f"f_{t.lower()}").as_predictor()
                   for t in LATTICE_TYPES]


def full_schema_features(pkg: str) -> tuple:
    """(label, predictors) of the passenger workflow at its full schema:
    age, height, weight (Real), gender (PickList), boarded (Date) and
    description (Text) against survived (RealNN)."""
    survived, preds = passenger_features(pkg)
    fb = mod(pkg, "features.feature_builder").FeatureBuilder
    preds += [fb.Date("boarded").as_predictor(),
              fb.Text("description").as_predictor()]
    return survived, preds


#: the lattice's LR ridge: its ~4 200 columns (five 512-wide hash spaces
#: of random words) separate the rows, and a ridge keeps the Newton fit
#: identified
LATTICE_REG_PARAM = 0.1


def vector_slice(pkg: str, label, preds, **lr_kw):
    """transmogrify(label=...) with the pinned reference date ->
    SanityChecker -> OpLogisticRegression(**lr_kw) of ``pkg``; returns
    (vector, checked vector, prediction) features."""
    tm = mod(pkg, "ops.transmogrifier")
    vec = tm.transmogrify(preds, label=label, defaults=tm.TransmogrifierDefaults(
        reference_date_ms=REFERENCE_DATE_MS))
    kw = {"device": "cpu"} if pkg == PORT else {}
    checked = mod(pkg, "preparators.sanity_checker").SanityChecker(
        **kw).set_input(label, vec).get_output()
    pred = mod(pkg, "models.logistic_regression").OpLogisticRegression(
        **lr_kw, **kw).set_input(label, checked).get_output()
    return vec, checked, pred


def rff_datasets(pkg: str, n: int = 2000, n_score: int = 1000,
                 seed: int = 42):
    """(train, scoring) datasets of the RawFeatureFilter drills in ``pkg``:
    the passenger columns plus ``sparse`` (a Real filled on one row, below
    the default min fill rate) and ``extras`` (a RealMap whose key ``k1``
    is always present and ``k2`` on one row); the scoring set, drawn from
    another seed, holds every height at the training maximum, so its
    distribution moves past the default JS-divergence limit."""
    cols_mod, ft = mod(pkg, "types.columns"), mod(pkg, "types.feature_types")
    ds_cls = mod(pkg, "types.dataset").Dataset
    out = []
    for rows, s, drift in ((n, seed, False), (n_score, seed + 1000, True)):
        base = passengers(PORT, rows, s)
        rng = np.random.RandomState(s + 7)
        cols = {}
        for name in base:
            c = base[name]
            vals = np.asarray(c.values)
            if name == "height" and drift:
                vals = np.full_like(vals, train_height_max)
            ftype = getattr(ft, c.feature_type.__name__)
            if isinstance(c, mod(PORT, "types.columns").NumericColumn):
                cols[name] = cols_mod.NumericColumn(vals, np.asarray(c.mask),
                                                    ftype)
            else:
                cols[name] = cols_mod.TextColumn(list(c.values), ftype)
        if not drift:
            train_height_max = float(np.max(base["height"].values))
        sparse_mask = np.zeros(rows, bool)
        sparse_mask[0] = True
        cols["sparse"] = cols_mod.NumericColumn(
            np.where(sparse_mask, 1.5, 0.0), sparse_mask, ft.Real)
        cols["extras"] = cols_mod.MapColumn(
            [{"k1": float(v), **({"k2": 2.0} if i == 1 else {})}
             for i, v in enumerate(rng.randn(rows))], ft.RealMap)
        out.append(ds_cls(cols))
    return tuple(out)


def rff_features(pkg: str):
    """(label, predictors) of the RawFeatureFilter drills: the passenger
    features plus ``sparse`` and ``extras``."""
    fb = mod(pkg, "features.feature_builder").FeatureBuilder
    survived, preds = passenger_features(pkg)
    preds = preds + [fb.Real("sparse").as_predictor(),
                     fb.RealMap("extras").as_predictor()]
    return survived, preds


def carry_and_reload(build, data, tmp_path, rtol=0.0, atol=0.0):
    """Train ``build(pkg)``'s result feature (the last of the features it
    returns) in both packages over ``data(pkg)``; the reference's fitted
    state carried across with ``interop.load_reference_state`` scores as
    the reference does, and the port's own model, saved and loaded into a
    freshly built workflow, scores as it did (bit for bit).  Returns the
    port's scored result column."""
    import os

    out = {}
    for pkg in (REF, PORT):
        reset_uids(pkg)
        feats = build(pkg)
        wf = workflow(pkg, feats[-1], data(pkg))
        model = wf.train()
        out[pkg] = (model, feats[-1], model.score()[feats[-1].name])
    reset_uids(PORT)
    feats = build(PORT)
    carried = mod(PORT, "interop").load_reference_state(
        workflow(PORT, feats[-1], data(PORT)), reference_states(out[REF][0]))
    got = carried.score(data(PORT))[feats[-1].name]
    want = out[REF][2]
    for a, b in ((got, want),):
        av = getattr(a, "prediction", getattr(a, "values", None))
        bv = getattr(b, "prediction", getattr(b, "values", None))
        np.testing.assert_allclose(np.asarray(av, np.float64),
                                   np.asarray(bv, np.float64),
                                   rtol=rtol, atol=atol)
    model, feat, scored = out[PORT]
    path = os.path.join(str(tmp_path), "port_model")
    model.save(path)
    reset_uids(PORT)
    feats = build(PORT)
    loaded = mod(PORT, "workflow.workflow").OpWorkflowModel.load(
        path, workflow(PORT, feats[-1], data(PORT)))
    again = loaded.score(data(PORT))[feats[-1].name]
    for name in ("prediction", "probability", "values"):
        if getattr(scored, name, None) is not None:
            np.testing.assert_array_equal(np.asarray(getattr(again, name)),
                                          np.asarray(getattr(scored, name)))
    return scored


# -- the fused training programs ------------------------------------------
def reference_fused_x64(monkeypatch) -> None:
    """Let the reference's fused training programs run on this jax: they
    open their 64-bit window through ``local.fused_train._x64``, which
    calls ``jax.experimental.enable_x64`` (gone from jax 0.9); the test
    swaps in ``jax.enable_x64(True)`` for its own duration.  The JAX
    package is not edited."""
    import jax

    monkeypatch.setattr(mod(REF, "local.fused_train"), "_x64",
                        lambda: jax.enable_x64(True))


def fused_cv_data(n: int, regression: bool = False, seed: int = 0):
    """The reference fused tests' data: ``synthetic_design_matrix`` (39
    columns) as float64, its planted binary label, or a linear target with
    noise for the regression families."""
    X, y, _ = mod(PORT, "examples.synthetic").synthetic_design_matrix(
        n, text_dims=32, seed=seed)
    X = np.asarray(X, np.float64)
    if regression:
        rng = np.random.RandomState(seed)
        return X, X[:, 3] * 2.0 - X[:, 7] + 0.1 * rng.randn(n)
    return X, np.asarray(y)


def fused_validate(pkg: str, est, grid, X, y, evaluator: str,
                   fused, stratify: bool = True):
    """``OpCrossValidation(num_folds=3)`` of ``pkg`` over one family with
    ``train_fused`` set (the port's on the CPU); ``evaluator`` names an
    evaluator class of ``evaluators.binary`` or ``evaluators.regression``."""
    where = ("regression" if evaluator == "OpRegressionEvaluator"
             else "binary")
    ev = getattr(mod(pkg, f"evaluators.{where}"), evaluator)()
    kw = {"device": "cpu"} if pkg == PORT else {}
    cv = mod(pkg, "selector.validator").OpCrossValidation(
        num_folds=3, evaluator=ev, stratify=stratify, **kw)
    cv.train_fused = fused
    return cv.validate([(est, grid)], X, y)


def fold_metric_diffs(want, got, key: str = "fold_metrics") -> np.ndarray:
    """|got - want| of every (candidate, fold) metric, candidates matched by
    params: [candidates, folds]; ``key="metric"``: of the CV means,
    [candidates]."""
    import json

    by = {json.dumps(r["params"], sort_keys=True): r[key]
          for r in want.all_results}
    return np.array([
        np.abs(np.asarray(r[key])
               - by[json.dumps(r["params"], sort_keys=True)])
        for r in got.all_results])
