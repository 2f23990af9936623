"""The example apps of the torch package on the CPU, against the JAX
package's.

* The two data-prep apps (``joins_and_aggregates``,
  ``conditional_aggregation``), whose event tables are built in code: the
  hand-derived values of the JAX package's ``tests/test_dataprep_examples.
  py``, and every scored column equal to the reference's.
* ``titanic``, ``boston`` and ``iris`` on files with their datasets'
  columns that the tests write (the real files are not in the
  repository): the same workflows in both packages, the Titanic LR's
  probabilities within 1e-5 of the reference's (two float32 fits),
  Boston's linear-regression predictions within rtol 1e-4 of the
  reference's, Iris's naive-Bayes predictions, de-indexed labels
  included, equal; each app's quality floor of the reference's
  ``tests/test_examples.py``/``test_e2e_titanic.py`` on its planted
  data.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from torch_parity import PORT, REF, mod, probabilities, reset_uids


def _scored(pkg: str, app: str, build: str):
    reset_uids(pkg)
    kw = {"device": "cpu"} if pkg == PORT else {}
    wf, feats = getattr(mod(pkg, f"examples.{app}"), build)(**kw)
    model = wf.train()
    cols = model.score().columns()
    return wf, model, {f.name: cols[f.name].to_list()
                       for f in feats if f.name in cols}


def test_joins_and_aggregates_end_to_end():
    pytest.importorskip("pandas")
    _, _, ref = _scored(REF, "joins_and_aggregates",
                        "joins_and_aggregates_workflow")
    wf, _, by = _scored(PORT, "joins_and_aggregates",
                        "joins_and_aggregates_workflow")
    assert wf._reader.left.row_keys() == ["u1", "u2", "u3"]
    # u1: 2 clicks yesterday, 1 tomorrow, 2 sends, ctr 2/(2+1); u2: no
    # click in the yday window, 1 tomorrow, 1 send; u3: no click rows
    assert by["numClicksYday"] == [2.0, None, None]
    assert by["numClicksTomorrow"] == [1.0, 1.0, None]
    assert by["numSendsLastWeek"] == [2.0, 1.0, 1.0]
    assert [round(v, 4) for v in by["ctr"]] == [0.6667, 0.0, 0.0]
    assert by == ref


def test_conditional_aggregation_end_to_end():
    _, _, ref = _scored(REF, "conditional_aggregation",
                        "conditional_aggregation_workflow")
    wf, _, by = _scored(PORT, "conditional_aggregation",
                        "conditional_aggregation_workflow")
    assert wf._reader.row_keys() == ["ann", "bob", "cat"]  # dan dropped
    assert by["numVisitsWeekPrior"] == [3.0, None, 1.0]
    assert by["numPurchasesNextDay"] == [1.0, 1.0, None]
    assert by == ref


def test_conditional_scoring_reuses_fitted_model():
    _, model, _ = _scored(PORT, "conditional_aggregation",
                          "conditional_aggregation_workflow")
    first, second = model.score().columns(), model.score().columns()
    for name in first:
        assert first[name].to_list() == second[name].to_list()


def test_apps_default_to_the_card(tmp_path):
    """Every app builds its workflow on ``device``, the card by default,
    which raises at ``train()`` where CUDA is missing."""
    ex = mod(PORT, "examples")
    built = [
        ex.conditional_aggregation_workflow()[0],
        ex.joins_and_aggregates_workflow()[0],
        ex.titanic_workflow(str(tmp_path / "unread.csv"))[0],
        ex.boston_workflow(write_boston_data(str(tmp_path / "b"), n=20))[0],
        ex.iris_workflow(write_iris_data(str(tmp_path / "i"), 3))[0],
    ]
    assert [str(wf.device) for wf in built] == ["cuda"] * 5
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            built[0].train()


# -- the apps over files they are held on -------------------------------------

def write_titanic_csv(path: str, n: int = 400, seed: int = 0) -> str:
    """A headerless CSV with the Titanic columns (``TITANIC_COLUMNS``):
    survival planted on sex, class and age, missing ages and cabins."""
    rng = np.random.RandomState(seed)
    names = ["Smith, Mr. John", "Brown, Mrs. Ann", "Lee, Miss. Kim",
             "Khan, Master. Ali", "Rossi, Mr. Marco"]
    rows = []
    for i in range(n):
        sex = "female" if rng.rand() < 0.35 else "male"
        p_class = int(rng.randint(1, 4))
        age = "" if rng.rand() < 0.2 else f"{rng.randint(1, 80)}"
        sib, par = int(rng.randint(0, 3)), int(rng.randint(0, 3))
        z = (2.2 * (sex == "female") - 0.8 * (p_class - 2)
             - 0.02 * (float(age or 30) - 30) - 0.6)
        survived = int(rng.rand() < 1 / (1 + np.exp(-z)))
        fare = f"{rng.gamma(2.0, 15.0 / p_class):.4f}"
        cabin = "" if rng.rand() < 0.7 else f"C{rng.randint(1, 40)}"
        rows.append(",".join([
            str(i + 1), str(survived), str(p_class),
            '"' + names[rng.randint(len(names))] + '"', sex, age, str(sib),
            str(par), f"T{rng.randint(1, 30)}", fare, cabin,
            "SCQ"[rng.randint(3)]]))
    with open(path, "w") as f:
        f.write("\n".join(rows) + "\n")
    return path


def test_titanic_on_a_written_csv(tmp_path):
    path = write_titanic_csv(str(tmp_path / "titanic.csv"))
    out = {}
    for pkg in (REF, PORT):
        reset_uids(pkg)
        kw = {"device": "cpu"} if pkg == PORT else {}
        titanic = mod(pkg, "examples.titanic")
        wf, survived, prediction = titanic.titanic_workflow(
            path, reserve_test_fraction=0.15, **kw)
        model = wf.train()
        ev = mod(pkg, "evaluators.binary").OpBinaryClassificationEvaluator()
        out[pkg] = (probabilities(model.score(), prediction.name),
                    model.evaluate(ev).AuROC,
                    model.evaluate_holdout(ev).AuROC)
    (p_ref, auc_ref, hold_ref), (p_port, auc_port, hold_port) = \
        out[REF], out[PORT]
    assert p_port.shape == p_ref.shape
    np.testing.assert_allclose(p_port, p_ref, rtol=0, atol=1e-5)
    assert auc_port == pytest.approx(auc_ref, abs=1e-4)
    assert hold_port == pytest.approx(hold_ref, abs=1e-4)
    assert auc_port > 0.75


def write_boston_data(path: str, n: int = 300, seed: int = 1) -> str:
    """Whitespace-delimited rows of the 14 housing columns, ``medv``
    planted linear in rm, lstat and crim."""
    rng = np.random.RandomState(seed)
    cols = mod(PORT, "examples.boston").COLUMNS
    lines = []
    for _ in range(n):
        v = {c: rng.rand() * 10 for c in cols}
        v["chas"] = float(rng.randint(0, 2))
        v["rad"] = float(rng.randint(1, 9))
        v["rm"] = 4 + 4 * rng.rand()
        v["medv"] = (9.0 * v["rm"] - 0.9 * v["lstat"] - 0.4 * v["crim"]
                     - 10.0 + rng.randn())
        lines.append("  ".join(f"{v[c]:.5f}" for c in cols))
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
    return path


def test_boston_on_a_written_file(tmp_path):
    path = write_boston_data(str(tmp_path / "housing.data"))
    out = {}
    for pkg in (REF, PORT):
        reset_uids(pkg)
        kw = {"device": "cpu"} if pkg == PORT else {}
        fac = mod(pkg, "selector.factories")
        selector = fac.RegressionModelSelector.with_cross_validation(
            num_folds=3, models_and_parameters=[(
                mod(pkg, "models.linear_regression").OpLinearRegression(
                    **kw), fac.linreg_grid()[:4])], **kw)
        wf, medv, prediction = mod(pkg, "examples.boston").boston_workflow(
            path, selector=selector, **kw)
        model = wf.train()
        ev = mod(pkg, "evaluators.regression").OpRegressionEvaluator()
        scored = model.score()
        out[pkg] = (np.asarray(scored[prediction.name].prediction,
                               np.float64), model.evaluate(ev).R2)
    (y_ref, r2_ref), (y_port, r2_port) = out[REF], out[PORT]
    np.testing.assert_allclose(y_port, y_ref, rtol=1e-4, atol=1e-4)
    assert r2_port == pytest.approx(r2_ref, abs=1e-4)
    assert r2_port > 0.6


def write_iris_data(path: str, n_per_class: int = 50, seed: int = 2) -> str:
    """iris.data rows (four measurements and the class string), three
    planted classes whose measurements differ in proportion, so that the
    multinomial naive Bayes separates them."""
    rng = np.random.RandomState(seed)
    centres = {"Iris-setosa": (5.0, 3.4, 1.5, 0.2),
               "Iris-versicolor": (5.9, 2.8, 4.3, 1.3),
               "Iris-virginica": (4.0, 1.5, 7.5, 4.0)}
    rows = []
    for _ in range(n_per_class):
        for name, c in centres.items():
            vals = np.asarray(c) + 0.15 * rng.randn(4)
            rows.append(",".join(f"{x:.2f}" for x in vals) + "," + name)
    with open(path, "w") as f:
        f.write("\n".join(rows) + "\n")
    return path


def test_iris_on_a_written_file(tmp_path):
    path = write_iris_data(str(tmp_path / "iris.data"))
    out = {}
    for pkg in (REF, PORT):
        reset_uids(pkg)
        kw = {"device": "cpu"} if pkg == PORT else {}
        selector = mod(pkg, "selector.factories") \
            .MultiClassificationModelSelector.with_cross_validation(
                num_folds=3, models_and_parameters=[
                    (mod(pkg, "models.naive_bayes").OpNaiveBayes(**kw),
                     [{}])], **kw)
        wf, label, prediction, deindexed, labels = mod(
            pkg, "examples.iris").iris_workflow(path, selector=selector,
                                                **kw)
        assert labels == ["Iris-setosa", "Iris-versicolor", "Iris-virginica"]
        model = wf.train()
        ev = mod(pkg, "evaluators.multiclass").OpMultiClassificationEvaluator()
        scored = model.score(wf.generate_raw_data())
        out[pkg] = (scored[prediction.name].prediction.tolist(),
                    list(scored[deindexed.name].values),
                    list(scored["irisClass"].values),
                    model.evaluate(ev).F1)
    (pred_ref, de_ref, _, f1_ref), (pred, de, raw, f1) = out[REF], out[PORT]
    assert pred == pred_ref and de == de_ref
    assert f1 == pytest.approx(f1_ref, abs=1e-12) and f1 > 0.9
    assert sum(a == b for a, b in zip(de, raw)) / len(de) > 0.9
