"""The whole ported slices in both packages on the passenger data:
transmogrify -> SanityChecker -> OpLogisticRegression, and the tree slice
transmogrify(label=...) -> SanityChecker -> OpGBTClassifier, each through
train() -> score() -> AuROC; and the reference-fitted state of each scored
by the torch package.

Tolerances: kept columns identical; identified coefficients within rtol
1e-4, atol 1e-5; probabilities within 1e-5 abs and
AuROC within 1e-4 after two float32 fits that sum in different orders;
the same fitted state scored by both packages within 1e-6 abs (one
float32 dot or tree walk, no fit in between).  The tree slice: kept
columns identical, probabilities within 1e-5 abs, AuROC within 1e-4.
"""
import numpy as np
import pytest

from torch_parity import (
    PORT,
    REF,
    identified,
    mod,
    passenger_slice,
    passenger_tree_slice,
    passengers,
    probabilities,
    reset_uids,
    stage_of,
    workflow,
)

N = 2000


def _train(pkg: str, lr_kw=None):
    reset_uids(pkg)
    survived, checked, pred = passenger_slice(pkg, lr_kw=lr_kw)
    data = passengers(pkg, N)
    model = workflow(pkg, pred, data).train()
    scored = model.score(data)
    ev = mod(pkg, "evaluators.binary").OpBinaryClassificationEvaluator()
    auroc = ev.evaluate(scored, label_col=survived.name,
                        pred_col=pred.name).AuROC
    model.coefficients = identified(model, scored, checked.name)
    return model, scored, pred, auroc


@pytest.mark.parametrize(
    "lr_kw", [None, {"reg_param": 0.001, "elastic_net_param": 0.1}],
    ids=["unregularized", "grid-0.001-0.1"],
)
def test_slice_matches_reference(lr_kw):
    m_ref, s_ref, p_ref, auc_ref = _train(REF, lr_kw)
    m_port, s_port, p_port, auc_port = _train(PORT, lr_kw)
    assert (stage_of(m_port, "SanityCheckerModel").indices_to_keep
            == stage_of(m_ref, "SanityCheckerModel").indices_to_keep)
    # coefficients as the data determine them (see torch_parity.identified)
    (b_port, c_port), (b_ref, c_ref) = m_port.coefficients, m_ref.coefficients
    np.testing.assert_allclose(b_port, b_ref, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(c_port, c_ref, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(
        probabilities(s_port, p_port.name), probabilities(s_ref, p_ref.name),
        rtol=0, atol=1e-5,
    )
    assert abs(auc_port - auc_ref) <= 1e-4
    # the planted signal is learned: AuROC near the observable ceiling
    bayes = mod(PORT, "examples.synthetic").BAYES_AUROC_OBSERVED
    assert 0.70 < auc_port < bayes + 0.02


def test_reference_state_scored_by_port():
    """load_reference_state carries the JAX-fitted state over; the port's
    score() of it matches the reference's score() within 1e-6."""
    from transmogrifai_tpu.serialization.model_io import stage_state

    m_ref, _, p_ref, _ = _train(REF)
    states = [(type(s).__name__, stage_state(s)) for s in m_ref.stages]
    data_ref = passengers(REF, N, seed=7)
    want = probabilities(m_ref.score(data_ref), p_ref.name)

    reset_uids(PORT)
    _, _, pred = passenger_slice(PORT)
    data = passengers(PORT, N, seed=7)
    wf = workflow(PORT, pred, data)
    model = mod(PORT, "interop").load_reference_state(wf, states)
    got = probabilities(model.score(data), pred.name)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    assert (stage_of(model, "SanityCheckerModel").indices_to_keep
            == stage_of(m_ref, "SanityCheckerModel").indices_to_keep)


def test_reference_state_must_pair_with_the_workflow():
    from transmogrifai_tpu.serialization.model_io import stage_state

    m_ref, _, _, _ = _train(REF)
    states = [(type(s).__name__, stage_state(s)) for s in m_ref.stages]
    reset_uids(PORT)
    _, _, pred = passenger_slice(PORT)
    wf = workflow(PORT, pred, passengers(PORT, 10))
    load = mod(PORT, "interop").load_reference_state
    with pytest.raises(ValueError, match="stages"):
        load(wf, states[:-1])
    with pytest.raises(ValueError, match="pairs with"):
        load(wf, list(reversed(states)))


def _train_trees(pkg: str, data_seed: int = 42):
    reset_uids(pkg)
    survived, _, _, pred = passenger_tree_slice(pkg, {"num_trees": 8})
    data = passengers(pkg, N, seed=data_seed)
    model = workflow(pkg, pred, data).train()
    scored = model.score(data)
    ev = mod(pkg, "evaluators.binary").OpBinaryClassificationEvaluator()
    auroc = ev.evaluate(scored, label_col=survived.name,
                        pred_col=pred.name).AuROC
    return model, scored, pred, auroc


def test_tree_slice_matches_reference():
    m_ref, s_ref, p_ref, auc_ref = _train_trees(REF)
    m_port, s_port, p_port, auc_port = _train_trees(PORT)
    assert (stage_of(m_port, "SanityCheckerModel").indices_to_keep
            == stage_of(m_ref, "SanityCheckerModel").indices_to_keep)
    splits = [[s.splits for s in m.stages
               if type(s).__name__ == "NumericBucketizerModel"]
              for m in (m_port, m_ref)]
    assert splits[0] == splits[1] and any(splits[0])
    np.testing.assert_allclose(
        probabilities(s_port, p_port.name), probabilities(s_ref, p_ref.name),
        rtol=0, atol=1e-5,
    )
    assert abs(auc_port - auc_ref) <= 1e-4
    # scored on its own 2000 training rows, the boosted trees fit past the
    # planted observable ceiling (0.7493); at 1M rows chip_smoke.py holds
    # the card's AuROC under it
    assert auc_port > 0.70


def test_reference_tree_state_scored_by_port():
    """load_reference_state carries the JAX-fitted bucketizer splits and
    GBT heaps over; the port's score() of them matches the reference's
    score() within 1e-6."""
    from transmogrifai_tpu.serialization.model_io import stage_state

    m_ref, _, p_ref, _ = _train_trees(REF)
    states = [(type(s).__name__, stage_state(s)) for s in m_ref.stages]
    want = probabilities(m_ref.score(passengers(REF, N, seed=7)), p_ref.name)

    reset_uids(PORT)
    _, _, _, pred = passenger_tree_slice(PORT, {"num_trees": 8})
    data = passengers(PORT, N, seed=7)
    model = mod(PORT, "interop").load_reference_state(
        workflow(PORT, pred, data), states)
    got = probabilities(model.score(data), pred.name)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def _kept(ds, checked_name):
    """(the checked vector's values, its column names) of a dataset."""
    col = ds[checked_name]
    return (np.asarray(col.values),
            [c.column_name() for c in col.metadata.columns])


def _upto(pkg: str, data_seed: int = 42):
    reset_uids(pkg)
    survived, checked, pred = passenger_slice(pkg)
    wf = workflow(pkg, pred, passengers(pkg, N, seed=data_seed))
    return wf, checked, pred


def test_compute_data_up_to_matches_reference():
    """OpWorkflow.compute_data_up_to(pred) fits and applies the stages
    strictly upstream of the prediction: the vectorizers and the
    SanityChecker, not the LR.  The same kept columns and the same
    design matrix, bit-equal, in both packages."""
    out = []
    for pkg in (REF, PORT):
        wf, checked, pred = _upto(pkg)
        data = wf.compute_data_up_to(pred)
        assert pred.name not in data and checked.name in data
        out.append(_kept(data, checked.name))
    (x_ref, cols_ref), (x_port, cols_port) = out
    assert cols_port == cols_ref
    np.testing.assert_array_equal(x_port, x_ref)


def test_model_compute_data_up_to_matches_reference(tmp_path):
    """OpWorkflowModel.compute_data_up_to(feature, data=) applies the
    fitted upstream stages to new data: bit-equal to the reference's and
    to the checked column that score() computes on the same rows.  With
    ``path=`` both the workflow's and the model's datasets are saved as
    Avro, and each package's file reads back equal in either package."""
    out, avro = [], {}
    for pkg in (REF, PORT):
        wf, checked, pred = _upto(pkg)
        model = wf.train()
        new = passengers(pkg, 500, seed=9)
        data = model.compute_data_up_to(checked, data=new)
        assert checked.name not in data
        vec_name = checked.origin_stage.input_features[1].name
        up_to_pred = model.compute_data_up_to(pred, data=new)
        np.testing.assert_array_equal(
            np.asarray(up_to_pred[checked.name].values),
            np.asarray(model.score(new)[checked.name].values))
        out.append(np.asarray(data[vec_name].values))
        if pkg == PORT:
            with pytest.raises(ValueError, match="needs data="):
                model.compute_data_up_to(checked)
        for side, run in (
                ("model", lambda p: model.compute_data_up_to(
                    checked, data=new, path=p)),
                ("workflow", lambda p: wf.compute_data_up_to(checked,
                                                             path=p))):
            path = str(tmp_path / f"{pkg}-{side}.avro")
            avro[pkg, side] = (path, run(path).to_pylists())
    np.testing.assert_array_equal(out[1], out[0])
    for side in ("model", "workflow"):
        records = {}
        for writer in (REF, PORT):
            path, written = avro[writer, side]
            for reader in (REF, PORT):
                schema, recs = mod(reader, "readers.avro_reader") \
                    .read_avro_records(path)
                records[writer, reader] = recs
                assert [f.get("doc", f["name"]) for f in schema["fields"]] \
                    == list(written)
                assert len(recs) == len(next(iter(written.values())))
        first = records[REF, REF]
        assert all(r == first for r in records.values()), side


def test_with_model_stages_warm_start_matches_reference():
    """with_model_stages: the vectorizers and the SanityChecker fitted by
    a first workflow (data seed 42) are swapped in by uid when a second
    workflow over the same features trains on other rows (seed 7); only
    the LR fits.  The same kept columns and design matrix, bit-equal,
    and the LR coefficients within rtol 1e-4, atol 1e-5, in both
    packages."""
    out = []
    for pkg in (REF, PORT):
        reset_uids(pkg)
        _, checked, pred = passenger_slice(pkg)
        first = workflow(pkg, checked, passengers(pkg, N)).train()
        checker = stage_of(first, "SanityCheckerModel")
        wf = workflow(pkg, pred, passengers(pkg, N, seed=7))
        wf.with_model_stages(first)
        warm = wf.train()
        assert stage_of(warm, "SanityCheckerModel") is checker
        data = wf.compute_data_up_to(pred)
        np.testing.assert_array_equal(
            np.asarray(data[checked.name].values),
            np.asarray(warm.score()[checked.name].values))
        scored = warm.score()
        out.append((checker.indices_to_keep,
                    np.asarray(scored[checked.name].values),
                    identified(warm, scored, checked.name)))
    (keep_ref, x_ref, (b_ref, c_ref)), (keep_port, x_port, (b_port, c_port)) \
        = out
    assert keep_port == keep_ref
    np.testing.assert_array_equal(x_port, x_ref)
    np.testing.assert_allclose(b_port, b_ref, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(c_port, c_ref, rtol=1e-4, atol=1e-5)


def test_summary_pretty_raises_with_its_item():
    """``summary_pretty`` is ported (ModelInsights): on the LR slice
    without a selector it reports the SanityChecker's correlations in the
    reference's lines, each value the one ``model_insights()`` holds.
    Every correlation is within rtol 1e-5 of the float64 Pearson of its
    column (the plain moment sums accumulate in float64), and within rtol
    3e-5 of the reference's: on the 8-device test mesh the reference's
    float32 sums put its off-centre weight column 1.88e-5 from the port's
    value at these 2000 rows (ROADMAP.md queue 3).  Local scoring
    no longer raises: a CPU model scores through the numpy-fused
    program."""
    out = []
    for pkg in (REF, PORT):
        wf, _, _ = _upto(pkg)
        model = wf.train()
        corr = {f.pretty_name: f.corr_label
                for f in model.model_insights().feature_insights}
        out.append((model.summary_pretty(), corr))
    (ref, corr_ref), (port, corr_port) = out
    checker = stage_of(model, "SanityCheckerModel")
    label_f, vec_f = checker.input_features
    train = model.score()
    X = np.asarray(train[vec_f.name].values, np.float64)
    y = np.asarray(train[label_f.name].values, np.float64)
    stats = checker.metadata["sanity_checker_summary"]["column_stats"]
    for j, st in enumerate(stats):
        if st["corr_label"] is not None:
            exact = np.corrcoef(X[:, j], y)[0, 1]
            assert st["corr_label"] == pytest.approx(
                exact, rel=1e-5, abs=1e-7), st["name"]
    assert port.startswith("Top model insights computed using correlation:")
    rows = []
    for text in (port, ref):
        rows.append([[c.strip() for c in line.split("|")]
                     for line in text.splitlines()])
    assert [[c for c in r if not c.startswith("-0.") and not
             c.startswith("0.")] for r in rows[0]] == \
        [[c for c in r if not c.startswith("-0.") and not
          c.startswith("0.")] for r in rows[1]]
    for row in rows[0]:
        if len(row) == 4 and row[1] in corr_port and \
                corr_port[row[1]] is not None:
            assert row[2] == f"{corr_port[row[1]]:.6g}", row
    for name, want in corr_ref.items():
        if want is None:
            assert corr_port[name] is None
        else:
            assert corr_port[name] == pytest.approx(want, rel=3e-5), name
    scorer = model.score_function()
    assert scorer.fused_backend == "numpy" and scorer.fused_reason is None



def _csv_slice_workflow(pkg: str, reader):
    """The README CSV's columns (survived, sex, age, fare) through
    transmogrify -> SanityChecker -> OpLogisticRegression, read by
    ``reader``, with ``streaming_ingest=True``; returns (workflow,
    prediction)."""
    reset_uids(pkg)
    fb = mod(pkg, "features.feature_builder").FeatureBuilder
    ft = mod(pkg, "types.feature_types")
    kw = {"device": "cpu"} if pkg == PORT else {}
    survived = fb(ft.RealNN, "survived").as_response()
    preds = [fb(ft.PickList, "sex").as_predictor(),
             fb(ft.Real, "age").as_predictor(),
             fb(ft.Real, "fare").as_predictor()]
    vec = mod(pkg, "ops.transmogrifier").transmogrify(preds)
    checked = mod(pkg, "preparators.sanity_checker").SanityChecker(
        **kw).set_input(survived, vec).get_output()
    pred = mod(pkg, "models.logistic_regression").OpLogisticRegression(
        **kw).set_input(survived, checked).get_output()
    wf = (mod(pkg, "workflow.workflow").OpWorkflow(**kw)
          .set_result_features(pred).set_reader(reader)
          .set_parameters(streaming_ingest=True))
    assert wf.parameters["streaming_ingest"] is True
    return wf, pred


def test_streaming_ingest_flag_trains_from_a_csv_reader(tmp_path):
    """``set_parameters(streaming_ingest=True)`` is stored, and a reader
    without a chunk stream (``CSVReader``) trains on the batch path, as in
    the reference (its ``_streaming_eligible``); the port used to raise
    in ``set_parameters``.  The scores agree with the reference's within
    1e-5.  A reader that has ``stream_dataset`` streams at ``train()``
    (the pipelined reader over the same file: the same scores as the
    batch path), and ``streaming_ingest=False`` opts out of it."""
    path = mod(PORT, "examples.synthetic").write_readme_csv(
        str(tmp_path / "passengers.csv"), N)
    probs = []
    for pkg in (REF, PORT):
        wf, pred = _csv_slice_workflow(
            pkg, mod(pkg, "readers.csv_reader").CSVReader(path))
        probs.append(probabilities(wf.train().score(), pred.name))
    p_ref, p_port = probs
    assert p_port.shape == p_ref.shape == (N, 2)
    np.testing.assert_allclose(p_port, p_ref, rtol=0, atol=1e-5)

    wf, pred = _csv_slice_workflow(
        PORT, mod(PORT, "readers.pipeline").PipelinedCSVReader(
            [path], workers=1))
    assert wf._streaming_eligible()
    streamed = probabilities(wf.train().score(), pred.name)
    np.testing.assert_array_equal(streamed, p_port)
    assert not wf.set_parameters(streaming_ingest=False)._streaming_eligible()
