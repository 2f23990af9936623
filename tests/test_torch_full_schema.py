"""The passenger workflow at its full schema, and the type lattice, in the
torch package against the JAX package.

* The passenger data of ``synthetic_passengers`` with its free-text
  ``description`` and its ``boarded`` date (2 000 rows): transmogrify
  (label-aware, the reference date pinned) -> SanityChecker ->
  OpLogisticRegression.  The design matrix (539 columns: 512 of them the
  description's hash space) and its metadata bit-equal, the same kept
  columns, the SanityChecker's statistics within rtol 1e-5 of float64
  moments and 3e-5 of the JAX package's (ROADMAP queue 3), the LR betas
  within rtol 1e-4 with the gender group centred, AuROC within 1e-6.
* The type lattice (``torch_parity.LATTICE_TYPES``, one feature of each
  of 24 types from the testkit, 1 000 rows, 512 hash columns a text
  feature; the LR with a ridge, ``LATTICE_REG_PARAM``): the design matrix
  and metadata bit-equal, the same kept columns, Cramer's V and the rule
  confidences within 1e-6, the probabilities within 1e-4.
* ``score_function()`` of the full-schema model: the text and date
  models have no lowering, so it serves interpreted, as the JAX package's
  does, and its rows equal ``score()``'s (the head within 1e-6).
"""
import numpy as np
import pytest

from torch_parity import (
    LATTICE_REG_PARAM, PORT, REF, assert_same, column_state, full_schema_features, identified,
    lattice_dataset, lattice_features, mod, probabilities, reset_uids,
    vector_slice, workflow,
)

FULL_ROWS, LATTICE_ROWS = 2000, 1000
_cache: dict = {}


def _full_schema_data(pkg: str):
    return mod(pkg, "examples.synthetic").synthetic_passengers(
        FULL_ROWS, seed=42)


def _train(pkg: str, case: str):
    """(model, scored, label, vector, checked, prediction, data) of the
    full-schema workflow or the type lattice in ``pkg``, trained once."""
    key = (pkg, case)
    if key not in _cache:
        reset_uids(pkg)
        lr_kw = {}
        if case == "full_schema":
            label, preds = full_schema_features(pkg)
            data = _full_schema_data(pkg)
        else:
            label, preds = lattice_features(pkg)
            data = lattice_dataset(pkg, LATTICE_ROWS)
            lr_kw = {"reg_param": LATTICE_REG_PARAM}
        vec, checked, pred = vector_slice(pkg, label, preds, **lr_kw)
        model = workflow(pkg, pred, data).set_result_features(
            vec, checked, pred).train()
        _cache[key] = (model, model.score(), label, vec, checked, pred, data)
    return _cache[key]


def _summary(model) -> dict:
    (checker,) = [s for s in model.stages
                  if type(s).__name__ == "SanityCheckerModel"]
    return checker.metadata["sanity_checker_summary"]


@pytest.mark.parametrize("case", ["full_schema", "lattice"])
def test_design_matrix_and_metadata_bit_equal(case):
    want = _train(REF, case)
    got = _train(PORT, case)
    x_ref = column_state(want[1][want[3].name])
    x_port = column_state(got[1][got[3].name])
    assert_same(x_port, x_ref)
    width = x_port[2].shape[1]
    if case == "full_schema":
        assert width == 539
        hashed = [m for m in x_port[4] if m[0] == "description"]
        assert len(hashed) == 512 + 1
    else:
        assert 4000 < width < 4400
        parents = {m[0] for m in x_port[4]}
        assert parents == {f.name for f in lattice_features(PORT)[1]}


@pytest.mark.parametrize("case", ["full_schema", "lattice"])
def test_same_kept_columns(case):
    want, got = _summary(_train(REF, case)[0]), _summary(_train(PORT, case)[0])
    assert got["dropped"] == want["dropped"]
    assert got["n_kept"] == want["n_kept"]
    assert_same(column_state(_train(PORT, case)[1][_train(PORT, case)[4].name]),
                column_state(_train(REF, case)[1][_train(REF, case)[4].name]))
    if case == "full_schema":
        assert got["n_kept"] == 38


def _float64_stats(x: np.ndarray, y: np.ndarray) -> dict:
    x, y = x.astype(np.float64), y.astype(np.float64)
    mean = x.mean(axis=0)
    var = x.var(axis=0, ddof=1)
    xc, yc = x - mean, y - y.mean()
    with np.errstate(invalid="ignore", divide="ignore"):
        corr = (xc * yc[:, None]).sum(0) / np.sqrt(
            (xc ** 2).sum(0) * (yc ** 2).sum())
    return {"mean": mean, "variance": var, "corr_label": corr,
            "min": x.min(axis=0), "max": x.max(axis=0)}


@pytest.mark.parametrize("case", ["full_schema", "lattice"])
def test_sanity_checker_statistics(case):
    """Against float64 moments of the design matrix (rtol 1e-5) and the
    JAX package's (rtol 3e-5; its float32 sums, ROADMAP queue 3); min and
    max exact; the contingency statistics within 1e-6."""
    _, scored, label, vec, *_ = _train(PORT, case)
    x = np.asarray(scored[vec.name].values)
    exact = _float64_stats(x, np.asarray(scored[label.name].values))
    got, want = _summary(_train(PORT, case)[0]), _summary(_train(REF, case)[0])
    assert len(got["column_stats"]) == len(want["column_stats"]) == x.shape[1]
    for i, (a, b) in enumerate(zip(got["column_stats"], want["column_stats"])):
        assert a["name"] == b["name"] and a["dropped_reasons"] == b["dropped_reasons"]
        assert a["min"] == b["min"] == exact["min"][i]
        assert a["max"] == b["max"] == exact["max"][i]
        for k in ("mean", "variance", "corr_label"):
            if b[k] is None:
                assert a[k] is None and not np.isfinite(exact[k][i])
                continue
            np.testing.assert_allclose(a[k], exact[k][i], rtol=1e-5,
                                       atol=1e-6, err_msg=f"{k} {a['name']}")
            np.testing.assert_allclose(a[k], b[k], rtol=3e-5, atol=1e-6,
                                       err_msg=f"{k} {a['name']}")
        for k in ("cramers_v", "max_rule_confidence", "support"):
            if b[k] is None:
                assert a[k] is None
            else:
                np.testing.assert_allclose(a[k], b[k], rtol=0, atol=1e-6)
    assert set(got["cramers_v_by_group"]) == set(want["cramers_v_by_group"])
    for g, v in want["cramers_v_by_group"].items():
        np.testing.assert_allclose(got["cramers_v_by_group"][g], v, atol=1e-6)


def test_full_schema_betas_and_auroc():
    outs = {}
    for pkg in (REF, PORT):
        model, scored, label, _, checked, pred, _ = _train(pkg, "full_schema")
        beta, b0 = identified(model, scored, checked.name)
        ev = mod(pkg, "evaluators.binary").OpBinaryClassificationEvaluator()
        auroc = float(ev.evaluate(scored, label_col=label.name,
                                  pred_col=pred.name).AuROC)
        outs[pkg] = (beta, b0, auroc, probabilities(scored, pred.name))
    (b_ref, i_ref, a_ref, p_ref), (b_port, i_port, a_port, p_port) = \
        outs[REF], outs[PORT]
    np.testing.assert_allclose(b_port, b_ref, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(i_port, i_ref, rtol=1e-4, atol=1e-5)
    assert abs(a_port - a_ref) <= 1e-6
    np.testing.assert_allclose(p_port, p_ref, rtol=0, atol=1e-4)
    assert 0.70 <= a_port <= 0.78


def test_lattice_probabilities():
    p_ref = probabilities(_train(REF, "lattice")[1], _train(REF, "lattice")[5].name)
    p_port = probabilities(_train(PORT, "lattice")[1],
                           _train(PORT, "lattice")[5].name)
    np.testing.assert_allclose(p_port, p_ref, rtol=0, atol=1e-4)


def _records(pkg: str, case: str, k: int = 300) -> list:
    model, *_, data = _train(pkg, case)
    names = [f.name for f in model.raw_features]
    cols = {n: data[n].to_list() for n in names}
    return [{n: cols[n][r] for n in names} for r in range(k)]


@pytest.mark.parametrize("case", ["full_schema", "lattice"])
def test_score_function_serves_interpreted(case):
    """The text, date, geolocation and map models have no lowering: both
    packages' scorers record "pipeline not fusable" and serve
    interpreted; the port's rows equal its score() of the same records
    (the design matrix to the bit, the head within 1e-6)."""
    scorers = {}
    for pkg in (REF, PORT):
        scorer_mod = mod(pkg, "local.scorer")
        scorers[pkg] = scorer_mod.LocalScorer(_train(pkg, case)[0],
                                              drift_policy=None)
    ref, port = scorers[REF], scorers[PORT]
    assert port.fused is None and ref.fused is None
    assert port.fused_backend is None and ref.fused_backend is None
    assert port.fused_reason == ref.fused_reason
    assert "does not lower" in port.fused_reason
    records = _records(PORT, case)
    rows = port.score_batch(records)
    model, *_, data = _train(PORT, case)
    scored = model.score(data.take(np.arange(len(records))))
    vec, pred = _train(PORT, case)[3].name, _train(PORT, case)[5].name
    assert_same([r[vec] for r in rows], scored[vec].to_list(), vec)
    # the scorer's head predicts on numpy in float64 (the engine-free
    # path), score() on torch in float32: the same predictions, the
    # margins within float32 rounding, the probabilities within 1e-6
    want = scored[pred].to_list()
    assert [r[pred]["prediction"] for r in rows] == \
        [w["prediction"] for w in want]
    for k, rtol in (("rawPrediction_0", 1e-6), ("rawPrediction_1", 1e-6),
                    ("probability_0", 0.0), ("probability_1", 0.0)):
        np.testing.assert_allclose([r[pred][k] for r in rows],
                                   [w[k] for w in want], rtol=rtol, atol=1e-6)
    ref_rows = ref.score_batch(_records(REF, case))
    pred = _train(PORT, case)[5].name
    np.testing.assert_allclose(
        [r[pred]["probability_1"] for r in rows],
        [r[_train(REF, case)[5].name]["probability_1"] for r in ref_rows],
        atol=1e-4)
