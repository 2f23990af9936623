"""The README example (``README.md``'s first code block) on both packages.

A CSV written by ``examples.synthetic.write_readme_csv`` is read through
``OpWorkflow.set_reader(CSVReader(path))``; ``age.fill_missing_with_mean()
.z_normalize()`` (``dsl``), ``transmogrify``, ``survived.sanity_check(...,
remove_bad_features=True)`` and ``BinaryClassificationModelSelector.
with_cross_validation(num_folds=3)`` over the default four families (the
tree grids trimmed to test size through ``models_and_parameters``) train,
score and report ``summary_pretty()``.  Gates: the same kept columns and a
bit-equal design matrix; the same winner and params; every candidate's
mean CV metric within 1e-5, but for a forest candidate whose fold trees
differ from the reference's only at exact ties (``normed_age`` is an
affine copy of ``age``); holdout AuROC within 1e-4; scores within 1e-5 on
rows no tree tie touches (``compare_trees``); ``model_insights()`` and
``summary_pretty()`` with the same fields and values (statistics within
rtol 1e-5 and atol 1e-6, metrics as above) apart from train times.  The
reference runs its single-device route (``TX_PRODUCT_MESH=0``) with its
trees on the JAX backend.  A last case runs the README word for word on
the port (only ``OpWorkflow(device="cpu")`` added) at the parameterless
grids."""
import math
import re

import numpy as np
import pytest

from torch_parity import (
    PORT,
    REF,
    compare_trees,
    default_selector_models,
    mod,
    reset_uids,
    stage_of,
)

N = 1500
#: the word-for-word run: the parameterless grids (2 700 forest trees)
#: cost about the same on the CPU at any small size
N_WORD_FOR_WORD = 300
#: the SanityChecker's statistics, as test_torch_sanity_checker.py holds them
STAT_RTOL, STAT_ATOL = 1e-5, 1e-6
CV_ATOL = 1e-5        # mean CV metrics
HOLDOUT_ATOL = 1e-4   # holdout metrics
SCORE_ATOL = 1e-5


def readme(pkg: str, path: str, models=None, device=None):
    """README.md's example in ``pkg`` over the CSV at ``path``, with the
    selector's ``models_and_parameters`` and the stages' ``device``
    when given; returns (model, checked, prediction)."""
    reset_uids(pkg)
    mod(pkg, "dsl")                                       # feature operators
    FeatureBuilder = mod(pkg, "features.feature_builder").FeatureBuilder
    OpWorkflow = mod(pkg, "workflow.workflow").OpWorkflow
    transmogrify = mod(pkg, "ops.transmogrifier").transmogrify
    CSVReader = mod(pkg, "readers.csv_reader").CSVReader
    BinaryClassificationModelSelector = mod(
        pkg, "selector.factories").BinaryClassificationModelSelector
    ft = mod(pkg, "types.feature_types")
    dev = {"device": device} if device else {}

    # Typed raw features
    survived = FeatureBuilder(ft.RealNN, "survived").as_response()
    sex = FeatureBuilder(ft.PickList, "sex").as_predictor()
    age = FeatureBuilder(ft.Real, "age").as_predictor()
    fare = FeatureBuilder(ft.Real, "fare").as_predictor()

    # Derived features (feature math DSL)
    normed_age = age.fill_missing_with_mean().z_normalize()

    # Automated feature engineering
    features = transmogrify([sex, age, fare, normed_age])

    # Automated feature validation
    checked = survived.sanity_check(features, remove_bad_features=True, **dev)

    # Automated model selection
    sel = {"models_and_parameters": models} if models else {}
    prediction = (
        BinaryClassificationModelSelector.with_cross_validation(
            num_folds=3, **sel, **dev)
        .set_input(survived, checked)
        .get_output()
    )

    model = (
        OpWorkflow(**dev)
        .set_result_features(prediction)
        .set_reader(CSVReader(path))
        .train()
    )
    return model, checked, prediction


@pytest.fixture(scope="module")
def csv_path(tmp_path_factory):
    path = tmp_path_factory.mktemp("readme") / "titanic.csv"
    return mod(PORT, "examples.synthetic").write_readme_csv(str(path), N)


@pytest.fixture(scope="module")
def trained(csv_path):
    """Both packages' README models on the same CSV (trimmed tree grids),
    with what each forest grid fit of the validation returned: {pkg:
    (model, checked, prediction, [(X, grid, fold params by grid
    point)])}."""
    mp = pytest.MonkeyPatch()
    mp.setenv("TX_PRODUCT_MESH", "0")
    mp.setenv("TX_CV_RANK_METRICS", "exact")
    out = {}
    try:
        for pkg in (REF, PORT):
            forest = mod(pkg, "models.trees")._RandomForest
            fits, fit = [], forest.fit_arrays_folds_grid

            def keep(self, X, y, W, grid, _fit=fit, _fits=fits):
                res = _fit(self, X, y, W, grid)
                _fits.append((np.asarray(X, np.float32), grid, res))
                return res

            mp.setattr(forest, "fit_arrays_folds_grid", keep)
            out[pkg] = readme(pkg, csv_path, default_selector_models(pkg),
                              device="cpu" if pkg == PORT else None) + (fits,)
    finally:
        mp.undo()
    return out


def _summary(model) -> dict:
    return stage_of(model, "SelectedModel").metadata["model_selector_summary"]


def test_kept_columns_and_design_matrix_bit_equal(trained):
    (m_ref, c_ref, _, _), (m_port, c_port, _, _) = trained[REF], trained[PORT]
    keep = [stage_of(m, "SanityCheckerModel").indices_to_keep
            for m in (m_port, m_ref)]
    assert keep[0] == keep[1]
    x = [m.score()[c.name] for m, c in ((m_port, c_port), (m_ref, c_ref))]
    assert x[0].metadata.column_names() == x[1].metadata.column_names()
    np.testing.assert_array_equal(np.asarray(x[0].values),
                                  np.asarray(x[1].values))
    assert np.asarray(x[0].values).shape[1] == len(keep[0]) > 0


def _forest_fold_trees(fits, params: dict):
    """(X, [fold params]) of the forest grid point ``params`` from the
    kept grid fits."""
    (hit,) = [(X, res[grid.index(params)]) for X, grid, res in fits
              if params in grid]
    return hit


def test_selection_and_scores_match_reference(trained):
    """The same winner and params; every candidate's mean CV metric within
    CV_ATOL, but for a forest candidate whose fold trees differ from the
    reference's only at exact ties (``compare_trees``: both packages split
    the node on different columns whose children hold the same counts).
    The README's ``normed_age`` is an affine copy of ``age``, so their
    splits tie exactly, and float32 rounding picks the split (ROADMAP.md
    queue 3); at least one tie must then be found."""
    (m_ref, _, p_ref, f_ref), (m_port, _, p_port, f_port) = \
        trained[REF], trained[PORT]
    got, want = _summary(m_port), _summary(m_ref)
    assert got["best_model_type"] == want["best_model_type"]
    assert got["best_params"] == want["best_params"]
    assert len(got["validation_results"]) == len(want["validation_results"]) \
        == 8 + 4 + 4 + 8
    tie_explained = 0
    for g, r in zip(got["validation_results"], want["validation_results"]):
        assert (g["model_type"], g["params"]) == (r["model_type"], r["params"])
        if abs(g["metric"] - r["metric"]) <= CV_ATOL:
            continue
        assert g["model_type"] == "OpRandomForestClassifier", (g, r)
        (x_port, folds_port) = _forest_fold_trees(f_port, g["params"])
        (x_ref, folds_ref) = _forest_fold_trees(f_ref, r["params"])
        np.testing.assert_array_equal(x_port, x_ref)
        n_ties = 0
        for fp, fr in zip(folds_port, folds_ref):
            np.testing.assert_array_equal(fp["edges"], fr["edges"])
            bins = mod(PORT, "models.tree_kernel").bin_data(x_port,
                                                            fp["edges"])
            for t in range(fp["heaps"][0].shape[0]):
                ties, _ = compare_trees([h[t] for h in fp["heaps"]],
                                        [h[t] for h in fr["heaps"]],
                                        bins, fp["max_depth"])
                n_ties += len(ties)
        assert n_ties > 0, (g, r)
        tie_explained += 1
    assert tie_explained <= 2, tie_explained
    hold = [s["holdout_metrics"]["OpBinaryClassificationEvaluator"]["AuROC"]
            for s in (got, want)]
    assert abs(hold[0] - hold[1]) <= HOLDOUT_ATOL

    s_port, s_ref = m_port.score(), m_ref.score()
    fitted = stage_of(m_port, "SelectedModel")
    n = len(s_port)
    tie_rows = np.zeros(n, bool)
    if "heaps" in fitted.model_params:
        params = fitted.model_params
        bins = mod(PORT, "models.tree_kernel").bin_data(
            np.asarray(s_port[fitted.input_features[1].name].values,
                       np.float32), params["edges"])
        want_heaps = stage_of(m_ref, "SelectedModel").model_params["heaps"]
        for t in range(params["heaps"][0].shape[0]):
            tie_rows |= compare_trees(
                [h[t] for h in params["heaps"]], [h[t] for h in want_heaps],
                bins, params["max_depth"])[1]
    assert tie_rows.mean() < 0.05

    def scores(scored, name):
        col = scored[name]
        out = (col.probability if col.probability is not None
               else col.raw_prediction)
        return np.asarray(out, np.float64)

    np.testing.assert_allclose(scores(s_port, p_port.name)[~tie_rows],
                               scores(s_ref, p_ref.name)[~tie_rows],
                               rtol=0, atol=SCORE_ATOL)


def _close(got, want, path: str, rtol: float, atol: float) -> None:
    """``got`` and ``want`` carry the same fields and the same values:
    strings, bools and integers equal, floats within the tolerances,
    fields named for train time skipped."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), (
            path, sorted(set(got) ^ set(want)))
        for k in want:
            if "time" in k.lower():
                continue
            tol = (0.0, HOLDOUT_ATOL) if k in ("holdout_metrics",
                                               "train_metrics") \
                else (0.0, CV_ATOL) if k in ("validation_results",
                                             "validation_metric") \
                else (rtol, atol)
            _close(got[k], want[k], f"{path}.{k}", *tol)
    elif isinstance(want, (list, tuple)):
        assert isinstance(got, (list, tuple)) and len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _close(g, w, f"{path}[{i}]", rtol, atol)
    elif isinstance(want, float) and not isinstance(want, bool):
        assert isinstance(got, (float, int)), (path, got)
        if math.isnan(want):
            assert math.isnan(got), (path, got)
        else:
            assert math.isclose(got, want, rel_tol=rtol, abs_tol=atol), (
                path, got, want)
    else:
        assert got == want, (path, got, want)


def test_model_insights_match_reference(trained):
    """The same fields and values: statistics within STAT_RTOL, metrics
    as above; the mean CV metrics of the validation results are held by
    the selection test, ties included."""
    got = trained[PORT][0].model_insights().to_json()
    want = trained[REF][0].model_insights().to_json()
    for ins, model in ((got, trained[PORT][0]), (want, trained[REF][0])):
        assert ins.pop("validation_results") == \
            _summary(model)["validation_results"]
    _close(got, want, "insights", STAT_RTOL, STAT_ATOL)
    assert got["selected_model_type"] == _summary(
        trained[PORT][0])["best_model_type"]
    # sex's pivot with OTHER and null, and age, fare and normed_age
    # with their null indicators, the dropped ones with their reasons
    assert len(got["feature_insights"]) >= 10
    assert got["label_summary"]["label_name"] == "survived"


_NUMBER = re.compile(r"-?\d+(?:\.\d+)?(?:e[-+]?\d+)?")


def _pretty_rows(text: str) -> list:
    """Each line of ``summary_pretty()`` as (its words, its numbers); the
    correlation tables' rows sorted by name (equal correlations may
    print in either order)."""
    out, table = [], []
    for line in text.splitlines():
        nums = [float(x) for x in _NUMBER.findall(line)]
        words = _NUMBER.sub("#", line)
        words = re.sub(r"[ |-]+", " ", words).strip()
        row = (words, nums)
        if line.startswith("| ") and table is not None:
            table.append(row)
        else:
            out.extend(sorted(table))
            table = []
            out.append(row)
    return out + sorted(table)


def test_summary_pretty_matches_reference(trained):
    """The same lines; numbers to their printed 6 digits, metrics as in
    the selection test (a family's CV range within its largest candidate
    difference there, exact ties included)."""
    got = trained[PORT][0].summary_pretty()
    want = trained[REF][0].summary_pretty()
    family_atol: dict = {}
    for g, r in zip(_summary(trained[PORT][0])["validation_results"],
                    _summary(trained[REF][0])["validation_results"]):
        family_atol[g["model_type"]] = max(
            family_atol.get(g["model_type"], CV_ATOL),
            abs(g["metric"] - r["metric"]))
    rows_got, rows_want = _pretty_rows(got), _pretty_rows(want)
    assert [w for w, _ in rows_got] == [w for w, _ in rows_want]
    for (words, g), (_, w) in zip(rows_got, rows_want):
        assert len(g) == len(w), words
        family = re.match(r"Evaluated # (\w+) models with AuROC between",
                          words)
        atol = family_atol[family.group(1)] if family else HOLDOUT_ATOL
        # printed to 6 significant digits: the last digit may differ
        np.testing.assert_allclose(g, w, rtol=2e-5, atol=atol, err_msg=words)
    best = _summary(trained[PORT][0])["best_model_type"]
    assert f"Selected model {best}" in got
    assert "Evaluated 8 OpLogisticRegression, 4 OpRandomForestClassifier, " \
        "4 OpGBTClassifier, 8 OpLinearSVC models with AuROC metric." in got


def test_readme_word_for_word_on_the_port(tmp_path):
    """README.md's code with the port's imports, ``OpWorkflow(device=
    "cpu")`` the one change: the parameterless selector's four families at
    their default grids; the reader takes the native route."""
    path = mod(PORT, "examples.synthetic").write_readme_csv(
        str(tmp_path / "titanic.csv"), N_WORD_FOR_WORD)
    tr = mod(PORT, "obs.trace").reset_tracer()
    code = f'''
import transmogrifai_tpu_torch.dsl                  # feature operators
from transmogrifai_tpu_torch import FeatureBuilder, OpWorkflow
from transmogrifai_tpu_torch.ops.transmogrifier import transmogrify
from transmogrifai_tpu_torch.readers.csv_reader import CSVReader
from transmogrifai_tpu_torch.selector.factories import BinaryClassificationModelSelector
from transmogrifai_tpu_torch.types import feature_types as ft

# Typed raw features
survived = FeatureBuilder(ft.RealNN, "survived").as_response()
sex      = FeatureBuilder(ft.PickList, "sex").as_predictor()
age      = FeatureBuilder(ft.Real, "age").as_predictor()
fare     = FeatureBuilder(ft.Real, "fare").as_predictor()

# Derived features (feature math DSL)
normed_age = age.fill_missing_with_mean().z_normalize()

# Automated feature engineering
features = transmogrify([sex, age, fare, normed_age])

# Automated feature validation
checked = survived.sanity_check(features, remove_bad_features=True)

# Automated model selection
prediction = (
    BinaryClassificationModelSelector.with_cross_validation(num_folds=3)
    .set_input(survived, checked)
    .get_output()
)

model = (
    OpWorkflow(device="cpu")
    .set_result_features(prediction)
    .set_reader(CSVReader({path!r}))
    .train()
)
summary = model.summary_pretty()
'''
    scope: dict = {}
    exec(compile(code, "README.md", "exec"), scope)
    model, summary = scope["model"], scope["summary"]
    s = _summary(model)
    assert len(s["validation_results"]) == 8 + 18 + 9 + 8
    assert f"Selected model {s['best_model_type']}" in summary
    assert "Evaluated 8 OpLogisticRegression, 18 OpRandomForestClassifier, " \
        "9 OpGBTClassifier, 8 OpLinearSVC models with AuROC metric." in summary
    assert "Hold Out Set Value" in summary
    routes = [sp["attrs"].get("route") for sp in tr.spans()
              if sp["name"] == "ingest.read" and sp["attrs"]["format"] == "csv"]
    assert routes == ["native"]
    scored = model.score()
    pred = scope["prediction"]
    prob = np.asarray(scored[pred.name].probability
                      if scored[pred.name].probability is not None
                      else scored[pred.name].raw_prediction)
    assert prob.shape[0] == len(scored) and np.isfinite(prob).all()
