"""filters/raw_feature_filter.py and the workflow's blacklist surgery of the
torch package against the JAX package's.

The drill data (``torch_parity.rff_datasets``) plants three faults: a raw
feature filled on one row (``sparse``, under the minimum fill rate), a
map key filled on one row (``extras[k2]``) and a scoring set whose
``height`` sits at the training maximum (past the JS-divergence limit).
Both packages train transmogrify -> SanityChecker -> logistic regression
behind ``with_raw_feature_filter`` on the same columns: the same
blacklist, map keys and results document; the same stages after the
surgery with the same inputs; the design matrix and the kept columns
bit-equal, the betas within rtol 1e-4.  A reference artifact with
``blacklisted_raw`` loads through ``interop.load_reference_artifact``, the
port's own artifact through ``load_model``; cutting a response or a result
feature raises as in the reference.
"""
import json

import numpy as np
import pytest

from torch_parity import (
    PORT, REF, identified, mod, reset_uids, rff_datasets, rff_features,
)

N, N_SCORE = 2000, 1000


def _build(pkg):
    survived, preds = rff_features(pkg)
    vec = mod(pkg, "ops.transmogrifier").transmogrify(preds)
    kw = {"device": "cpu"} if pkg == PORT else {}
    checked = mod(pkg, "preparators.sanity_checker").SanityChecker(
        **kw).set_input(survived, vec).get_output()
    pred = mod(pkg, "models.logistic_regression").OpLogisticRegression(
        **kw).set_input(survived, checked).get_output()
    return survived, vec, checked, pred


def _workflow(pkg, train, score, **rff_kw):
    reset_uids(pkg)
    survived, vec, checked, pred = _build(pkg)
    kw = {"device": "cpu"} if pkg == PORT else {}
    rff = mod(pkg, "filters.raw_feature_filter").RawFeatureFilter(
        scoring_data=score, **rff_kw)
    wf = (mod(pkg, "workflow.workflow").OpWorkflow(**kw)
          .set_result_features(pred, checked)
          .set_input_dataset(train).with_raw_feature_filter(rff))
    return wf, (survived, vec, checked, pred)


@pytest.fixture(scope="module")
def trained():
    out = {}
    for pkg in (REF, PORT):
        train, score = rff_datasets(pkg, N, N_SCORE)
        wf, feats = _workflow(pkg, train, score)
        out[pkg] = (wf, feats, wf.train())
    return out


def _stage_view(model):
    return [(type(s).__name__, [f.name for f in s.input_features])
            for s in model.stages]


def test_blacklist_and_results_match_reference(trained):
    (rwf, _, rmodel), (pwf, _, pmodel) = trained[REF], trained[PORT]
    names = sorted(f.name for f in pwf.blacklisted_features if f.is_raw())
    assert names == sorted(f.name for f in rwf.blacklisted_features
                           if f.is_raw())
    assert {"height", "sparse"} <= set(names)
    assert pwf.blacklisted_map_keys == rwf.blacklisted_map_keys == \
        {"extras": ["k2"]}
    assert json.dumps(pwf.rff_results, sort_keys=True) == \
        json.dumps(rwf.rff_results, sort_keys=True)
    assert [f.name for f in pmodel.blacklisted_features] == \
        [f.name for f in rmodel.blacklisted_features]
    assert [f.name for f in pwf.raw_features] == \
        [f.name for f in rwf.raw_features]


def test_surgery_and_design_matrix_match_reference(trained):
    (_, rfeats, rmodel), (_, pfeats, pmodel) = trained[REF], trained[PORT]
    assert _stage_view(pmodel) == _stage_view(rmodel)
    rs, ps = rmodel.score(), pmodel.score()
    for f_ref, f_port in zip(rfeats[1:3], pfeats[1:3]):
        np.testing.assert_array_equal(ps[f_port.name].values,
                                      rs[f_ref.name].values)
        assert ps[f_port.name].metadata.column_names() == \
            rs[f_ref.name].metadata.column_names()
    names = ps[pfeats[1].name].metadata.column_names()
    assert not any(n.startswith(("height", "sparse")) for n in names)
    assert not any("k2" in n for n in names)
    # the gender group is collinear with the intercept: betas compared
    # with it centred (ROADMAP queue 3, unidentified LR coefficients)
    assert type(pmodel.stages[-1]).__name__ == "PredictorModel"
    (pb, pb0), (rb, rb0) = (identified(m, sc, f[2].name) for m, sc, f in
                            ((pmodel, ps, pfeats), (rmodel, rs, rfeats)))
    np.testing.assert_allclose(pb, rb, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(pb0, rb0, rtol=1e-4, atol=1e-5)


def test_contract_is_captured_after_the_filter(trained):
    (_, _, rmodel), (_, _, pmodel) = trained[REF], trained[PORT]
    pc, rc = pmodel.schema_contract.to_json(), rmodel.schema_contract.to_json()
    names = [f["name"] for f in pc["features"]]
    assert names == [f["name"] for f in rc["features"]]
    assert "height" not in names and "sparse" not in names
    pc.pop("captured_at"), rc.pop("captured_at")
    assert json.dumps(pc, sort_keys=True) == json.dumps(rc, sort_keys=True)


def test_saved_blacklist_rederives_the_surgery(trained, tmp_path):
    """The port's artifact records ``blacklisted_raw`` and ``load_model``
    re-derives the surgery on a fresh workflow; a reference artifact with a
    blacklist loads through ``load_reference_artifact``."""
    (_, rfeats, rmodel), (_, pfeats, pmodel) = trained[REF], trained[PORT]
    train, score = rff_datasets(PORT, N, N_SCORE)
    path = str(tmp_path / "port")
    pmodel.save(path)
    with open(f"{path}/model.json") as f:
        assert sorted(json.load(f)["blacklisted_raw"]) == \
            sorted(f.name for f in pmodel.blacklisted_features if f.is_raw())
    fresh, feats = _workflow(PORT, train, score)
    loaded = mod(PORT, "workflow.workflow").OpWorkflowModel.load(path, fresh)
    assert _stage_view(loaded) == _stage_view(pmodel)
    np.testing.assert_array_equal(
        loaded.score(train)[feats[2].name].values,
        pmodel.score(train)[pfeats[2].name].values)
    # the reference's artifact
    rpath = str(tmp_path / "ref")
    rmodel.save(rpath)
    fresh, feats = _workflow(PORT, train, score)
    carried = mod(PORT, "interop").load_reference_artifact(rpath, fresh)
    assert _stage_view(carried) == _stage_view(rmodel)
    assert sorted(f.name for f in carried.blacklisted_features) == \
        sorted(f.name for f in rmodel.blacklisted_features if f.is_raw())
    rtrain, _ = rff_datasets(REF, N, N_SCORE)
    np.testing.assert_array_equal(
        carried.score(train)[feats[2].name].values,
        rmodel.score(rtrain)[rfeats[2].name].values)


def test_blacklist_errors_match_reference():
    """A blacklisted response raises; so does a cut that kills a result
    feature (the filter's ``protected_features`` keeps one alive)."""
    for pkg in (REF, PORT):
        train, score = rff_datasets(pkg, 2000, 200)
        reset_uids(pkg)
        survived, preds = rff_features(pkg)
        kw = {"device": "cpu"} if pkg == PORT else {}
        wf = mod(pkg, "workflow.workflow").OpWorkflow(**kw)
        wf.set_result_features(*preds)
        wf.blacklisted_features = [survived]
        with pytest.raises(ValueError, match="response"):
            wf._apply_blacklist()
        sparse = [p for p in preds if p.name == "sparse"][0]
        vec = mod(pkg, "ops.transmogrifier").transmogrify([sparse])
        wf = mod(pkg, "workflow.workflow").OpWorkflow(**kw)
        wf.set_result_features(vec).set_input_dataset(train)
        wf.with_raw_feature_filter(mod(
            pkg, "filters.raw_feature_filter").RawFeatureFilter())
        with pytest.raises(ValueError, match="critical to result feature"):
            wf.train()
        wf = mod(pkg, "workflow.workflow").OpWorkflow(**kw)
        wf.set_result_features(vec).set_input_dataset(train)
        wf.with_raw_feature_filter(mod(
            pkg, "filters.raw_feature_filter").RawFeatureFilter(
                protected_features=["sparse"]))
        assert wf.train().blacklisted_features == []
