"""Cost-model-driven autotuning, port against reference.

Ports the contracts of ``tests/test_autotune.py`` (less its CLI case,
which comes with ``cli.py``) onto ``transmogrifai_tpu_torch.autotune``,
the validator's successive-halving ladder and the runner's ``autotune``
and ``serving_autotune`` knobs.

Walls drive the decisions and walls differ by device, so the parity
cases inject the same observations into both packages - a cost model
trained from one fixed list, fixed probe results - and compare what is
decided, not what was timed:

* ``params_hash``, ``_rung_train_mask`` and the ``RandomState(seed)``
  rung subsample: bit-equal;
* the cost-model artifact: equal after the same observations; each
  package loads the other's ``autotune.json`` and predicts the same;
* plans, survivors, reports (less the walls) and winners: equal, CV
  means within 1e-5, rung interim metrics within 1e-5;
* knob decisions, candidates, bucket edges and pipeline proposals:
  equal;
* a device fault in a rung fit, a fused dispatch or a knob probe
  propagates; an ordinary error ranks the rung last or loses the probe.
"""
import json
import os

import numpy as np
import pytest

from torch_parity import DEVICE_FAULTS, PORT, REF, mod, reset_uids

#: the report keys that carry measured walls (device-dependent)
WALL_KEYS = ("rung_wall_ms", "actual_full_ms_by_family")


def _at(pkg):
    return mod(pkg, "autotune")


def _kw(pkg):
    return {"device": "cpu"} if pkg == PORT else {}


def _binary_arrays(n=20_000, d=8, seed=0):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, d)
    beta = np.linspace(1.5, -1.5, d)
    y = (rng.rand(n) < 1 / (1 + np.exp(-(X @ beta)))).astype(float)
    return X, y


def _models(pkg, with_forest=True):
    lr_grid = [{"reg_param": r, "elastic_net_param": e}
               for r in (0.001, 0.1) for e in (0.1, 0.5)]
    models = [(mod(pkg, "models.logistic_regression").OpLogisticRegression(
        **_kw(pkg)), lr_grid)]
    if with_forest:
        rf_grid = [{"min_info_gain": g} for g in (0.001, 0.01, 0.1)]
        tree_kw = dict(_kw(pkg)) if pkg == PORT else {"backend": "jax"}
        models.append((mod(pkg, "models.trees").OpRandomForestClassifier(
            num_trees=4, max_depth=3, **tree_kw), rf_grid))
    return models


#: one fixed observation list, injected into both packages: walls that
#: scale with rows, what a deployment accumulates across runs
OBSERVATIONS = [
    (fam, rows, base_ms * rows / 40_000)
    for fam, base_ms in (("OpLogisticRegression", 60.0),
                         ("OpRandomForestClassifier", 400.0))
    for rows in (4_000, 8_000, 20_000, 40_000)
]


def _warm(pkg, cm, families=None, d=8):
    at = _at(pkg)
    for fam, rows, ms in OBSERVATIONS:
        if families is None or fam in families:
            cm.observe(at.key_for_fit(fam),
                       at.candidate_features(rows, d, {}, 0.5, folds=1.0),
                       ms)
    return cm


def _warmed_config(pkg, families=None, **kw):
    at = _at(pkg)
    kw.setdefault("rung_rows", 6_000)
    kw.setdefault("min_rows", 10_000)
    return at.AutotuneConfig(cost_model=_warm(pkg, at.CostModel(), families),
                             **kw)


def _cv(pkg, folds=3, **kw):
    return mod(pkg, "selector.validator").OpCrossValidation(
        num_folds=folds,
        evaluator=mod(pkg, "evaluators.binary")
        .OpBinaryClassificationEvaluator(),
        seed=7, stratify=True, **_kw(pkg), **kw)


def _strip_walls(doc):
    if isinstance(doc, dict):
        return {k: _strip_walls(v) for k, v in doc.items()
                if k not in WALL_KEYS}
    if isinstance(doc, list):
        return [_strip_walls(v) for v in doc]
    return doc


def _split_metrics(report):
    """(report without the rung interim metrics, [interim metrics])."""
    metrics = [r.pop("interim_metric") for r in report.get("rungs", [])]
    return report, metrics


# ---------------------------------------------------------------------------
# cost model
# ---------------------------------------------------------------------------
def test_cost_model_learns_row_scaling_and_roundtrips(tmp_path):
    at = _at(PORT)
    cm = at.CostModel()
    key = at.key_for_fit("OpLogisticRegression")
    assert cm.predict_wall_ms(key, at.candidate_features(1000, 8)) is None
    for rows in (1_000, 4_000, 16_000, 64_000, 256_000):
        cm.observe(key, at.candidate_features(rows, 8), 0.01 * rows)
    lo = cm.predict_wall_ms(key, at.candidate_features(2_000, 8))
    hi = cm.predict_wall_ms(key, at.candidate_features(128_000, 8))
    assert lo is not None and hi is not None and hi > lo > 0
    p = str(tmp_path / "autotune.json")
    cm.save(p)
    cm2 = at.CostModel.load(p)
    assert cm2.load_error is None
    assert cm2.n_observations(key) == cm.n_observations(key)
    assert cm2.predict_wall_ms(
        key, at.candidate_features(128_000, 8)) == pytest.approx(hi)


def test_cost_model_artifacts_cross_load_and_predict_the_same(tmp_path):
    """The same observations give the same artifact in both packages,
    and each package loads the other's ``autotune.json`` and predicts the
    same values."""
    docs, paths = {}, {}
    for pkg in (REF, PORT):
        cm = _warm(pkg, _at(pkg).CostModel())
        paths[pkg] = str(tmp_path / f"{pkg}.json")
        cm.save(paths[pkg])
        with open(paths[pkg]) as f:
            docs[pkg] = json.load(f)
    assert docs[PORT] == docs[REF]
    probes = [(fam, rows) for fam in ("OpLogisticRegression",
                                      "OpRandomForestClassifier")
              for rows in (1_000, 30_000, 2_000_000)]
    for loader, written in ((PORT, REF), (REF, PORT), (PORT, PORT)):
        at = _at(loader)
        cm = at.CostModel.load(paths[written])
        assert cm.load_error is None
        ref_cm = _at(REF).CostModel.load(paths[REF])
        for fam, rows in probes:
            got = cm.predict_wall_ms(at.key_for_fit(fam),
                                     at.candidate_features(rows, 8))
            want = ref_cm.predict_wall_ms(
                _at(REF).key_for_fit(fam),
                _at(REF).candidate_features(rows, 8))
            assert got == want
    assert _at(PORT).COST_MODEL_FILENAME == _at(REF).COST_MODEL_FILENAME


def test_cost_model_load_tolerates_missing_and_torn(tmp_path):
    CostModel = _at(PORT).CostModel
    cold = CostModel.load(str(tmp_path / "missing.json"))
    assert cold.n_observations() == 0 and cold.load_error is None
    torn = tmp_path / "torn.json"
    torn.write_text('{"version": 1, "keys": {"fit:')
    cm = CostModel.load(str(torn))
    assert cm.n_observations() == 0
    assert cm.load_error and "Error" in cm.load_error
    stale = tmp_path / "stale.json"
    stale.write_text(json.dumps({"version": 999, "keys": {}}))
    cm3 = CostModel.load(str(stale))
    assert cm3.load_error == "version_mismatch"
    assert cm3.n_observations() == 0


def _fit_span_shapes(pkg, X, y):
    obs_trace = mod(pkg, "obs.trace")
    obs_trace.reset_tracer()
    reset_uids(pkg)
    _cv(pkg, folds=2).validate(_models(pkg), X, y)
    records = obs_trace.tracer().spans()
    shapes = sorted(
        (r["name"], r["attrs"]["family"],
         tuple(sorted(k for k in r["attrs"])),
         r["attrs"]["n_rows"], r["attrs"]["n_features"],
         r["attrs"].get("params_hash"))
        for r in records if r["name"].startswith("cv.fit"))
    return shapes, records


def test_cost_model_trains_from_the_port_validator_spans():
    """The port's validator emits the reference's ``cv.fit*`` span names
    with its attributes (family, params_hash, n_rows, n_features, the
    numeric params), so the cost model trains from either; re-ingesting
    the same ring dedupes."""
    X, y = _binary_arrays(n=6_000)
    shapes = {pkg: _fit_span_shapes(pkg, X, y) for pkg in (REF, PORT)}
    assert shapes[PORT][0] == shapes[REF][0]
    records = shapes[PORT][1]
    at = _at(PORT)
    cm = at.CostModel(min_obs=2)
    added = cm.ingest_spans(records)
    assert added == len([
        r for r in records
        if r["name"] in ("cv.fit", "cv.fit_folds", "cv.fit_batch",
                         "serve.batch")
    ]) > 0
    assert cm.ingest_spans(records) == 0  # dedupe on re-ingest
    assert cm.n_observations(at.key_for_fit("OpRandomForestClassifier")) > 0
    mod(PORT, "obs.trace").reset_tracer()


def test_params_hash_rung_mask_and_subsample_bit_equal():
    maps = [{"x": 1, "y": 2.0}, {"y": 2.0, "x": 1},
            {"reg_param": 0.001, "elastic_net_param": 0.1},
            {"min_info_gain": 0.01, "max_depth": 3}, {}]
    for m in maps:
        assert (_at(PORT).params_hash(m) == _at(REF).params_hash(m))
    assert _at(PORT).params_hash(maps[0]) == _at(PORT).params_hash(maps[1])
    assert len(_at(PORT).params_hash(maps[0])) == 12
    r = np.random.RandomState(1)
    for ys in ((r.rand(5_000) > 0.7).astype(float),
               r.randint(0, 5, 3_000).astype(float),
               r.randn(2_000)):  # > 32 classes: the plain split
        for frac, seed in ((0.75, 7), (0.5, 42)):
            got = mod(PORT, "selector.validator")._rung_train_mask(
                ys, frac, seed)
            want = mod(REF, "selector.validator")._rung_train_mask(
                ys, frac, seed)
            assert np.array_equal(got, want)


# ---------------------------------------------------------------------------
# successive-halving selection
# ---------------------------------------------------------------------------
def _selection(pkg, X, y, cfg=None, models=None, folds=3):
    reset_uids(pkg)
    cv = _cv(pkg, folds=folds, autotune=cfg)
    res = cv.validate(models or _models(pkg), X, y)
    return res, cv.last_autotune_report


def test_cold_start_degrades_to_exhaustive_like_reference():
    """First run (no observations): the exhaustive path with the reason
    recorded, the same result as autotune off, and the reference's
    report."""
    X, y = _binary_arrays()
    res_ex, _ = _selection(PORT, X, y)
    out = {}
    for pkg in (REF, PORT):
        at = _at(pkg)
        cfg = at.AutotuneConfig(cost_model=at.CostModel(), rung_rows=6_000,
                                min_rows=10_000)
        out[pkg] = _selection(pkg, X, y, cfg)
    res, rep = out[PORT]
    assert rep["mode"] == "exhaustive"
    assert rep["reason"].startswith("cost_model_cold:")
    assert "OpLogisticRegression" in rep["reason"]
    assert rep["fits"]["total"] == rep["fits"]["exhaustive"]
    assert res.best_params == res_ex.best_params
    assert res.best_metric == res_ex.best_metric
    assert res.autotune is rep
    assert _strip_walls(rep) == _strip_walls(out[REF][1])


def test_pruned_selection_parity_floor_and_reference():
    """Pruning returns the exhaustive sweep's winner (AuROC within 1e-9),
    never spends more candidate-fold fits than it (the floor), and - fed
    the same injected observations - plans, keeps and reports what the
    reference does (rung interim metrics and CV means within 1e-5)."""
    X, y = _binary_arrays()
    res_ex, _ = _selection(PORT, X, y)
    out = {pkg: _selection(pkg, X, y, _warmed_config(pkg))
           for pkg in (REF, PORT)}
    res, rep = out[PORT]
    assert rep["mode"] == "pruned" and rep["candidates_pruned"] > 0
    assert rep["fits"]["total"] <= rep["fits"]["exhaustive"]
    assert rep["fits"]["total"] == rep["fits"]["rung"] + rep["fits"]["full"]
    assert (res.best_estimator.model_type
            == res_ex.best_estimator.model_type)
    assert res.best_params == res_ex.best_params
    assert abs(res.best_metric - res_ex.best_metric) <= 1e-9
    assert rep["predicted_speedup"] is not None
    assert rep["actual_full_ms_by_family"]
    for c in rep["rungs"]:
        assert c["rung_wall_ms"] is not None
        assert c["predicted_fit_ms"] is not None and c["params_hash"]
    pruned = [r for r in res.all_results if r.get("pruned")]
    assert len(pruned) == rep["candidates_pruned"]
    assert all(r["metric_kind"] == "rung" for r in pruned)
    # against the reference, under the same injected observations
    res_ref, rep_ref = out[REF]
    got, got_m = _split_metrics(_strip_walls(rep))
    want, want_m = _split_metrics(_strip_walls(rep_ref))
    assert got == want
    np.testing.assert_allclose(got_m, want_m, rtol=0, atol=1e-5)
    assert res.best_params == res_ref.best_params
    assert (res.best_estimator.model_type
            == res_ref.best_estimator.model_type)
    kept = [(r["model_type"], r["params"]) for r in res.all_results
            if not r.get("pruned")]
    assert kept == [(r["model_type"], r["params"])
                    for r in res_ref.all_results if not r.get("pruned")]
    for a, b in zip(res.all_results, res_ref.all_results):
        assert abs(a["metric"] - b["metric"]) <= 1e-5


def test_rung_rows_are_gathered_from_the_validator_buffer():
    """A tensor X (the card-resident matrix's stand-in on this host) is
    gathered for the rung by a device index, never converted whole: the
    ladder gives the same report as the host array."""
    import torch

    X, y = _binary_arrays()
    host = _selection(PORT, X, y, _warmed_config(PORT))
    dev = _selection(PORT, torch.as_tensor(X, dtype=torch.float32), y,
                     _warmed_config(PORT))
    assert _split_metrics(_strip_walls(dev[1]))[0] == _split_metrics(
        _strip_walls(host[1]))[0]
    assert dev[0].best_params == host[0].best_params


def test_pruned_selection_visible_in_obs_plane():
    obs_trace = mod(PORT, "obs.trace")
    metrics = mod(PORT, "obs.metrics")
    obs_trace.reset_tracer()
    X, y = _binary_arrays()
    _selection(PORT, X, y, _warmed_config(PORT))
    doc = metrics.metrics_registry().to_json()
    assert doc["series"]["autotune.selections"]["value"] >= 1
    assert doc["series"]["autotune.candidates_pruned"]["value"] > 0
    text = metrics.prometheus_text_from_json(doc)
    assert "tx_autotune_selections" in text
    assert "tx_autotune_candidates_pruned" in text
    names = {s["name"] for s in obs_trace.tracer().spans()}
    assert {"autotune.decision", "autotune.rung_fit",
            "autotune.rung"} <= names
    obs_trace.reset_tracer()


def test_winner_ties_break_identically_with_autotune_on_and_off():
    """Duplicated grid points produce exact metric ties; the FIRST
    candidate wins in both modes (survivors keep grid order, rank ties
    break by index)."""
    X, y = _binary_arrays()
    p = {"reg_param": 0.01, "elastic_net_param": 0.1}
    grid = [dict(p), dict(p), {"reg_param": 0.2, "elastic_net_param": 0.5}]
    lr = mod(PORT, "models.logistic_regression").OpLogisticRegression(
        device="cpu")
    res_off, _ = _selection(PORT, X, y, models=[(lr, grid)], folds=2)
    cfg = _warmed_config(PORT, families={"OpLogisticRegression"},
                         min_keep=2)
    res_on, _ = _selection(PORT, X, y, cfg, models=[(lr, grid)], folds=2)
    assert res_off.best_params == res_on.best_params == p


@pytest.mark.parametrize("folds,reason", [(3, "no_fit_budget"),
                                          (1, "too_few_folds")])
def test_tiny_grids_and_single_folds_degrade_like_reference(folds, reason):
    """g=2, k=3: the fits-floor clamp allows one survivor, below
    min_keep=2, so the plan degrades; k=1 (a train/validation split) has
    no fit budget for a rung at all.  Both keep the floor, as in the
    reference."""
    X, y = _binary_arrays()
    reps = {}
    for pkg in (REF, PORT):
        cfg = _warmed_config(pkg)
        if folds == 1:
            tv = mod(pkg, "selector.validator").OpTrainValidationSplit(
                evaluator=mod(pkg, "evaluators.binary")
                .OpBinaryClassificationEvaluator(),
                seed=7, stratify=True, autotune=cfg, **_kw(pkg))
            tv.validate(_models(pkg, with_forest=False), X, y)
            reps[pkg] = tv.last_autotune_report
        else:
            grid = [{"reg_param": r, "elastic_net_param": 0.1}
                    for r in (0.001, 0.1)]
            lr = mod(pkg, "models.logistic_regression") \
                .OpLogisticRegression(**_kw(pkg))
            reps[pkg] = _selection(pkg, X, y, cfg, models=[(lr, grid)])[1]
    rep = reps[PORT]
    assert rep["mode"] == "exhaustive" and rep["reason"] == reason
    assert rep["fits"]["total"] == rep["fits"]["exhaustive"]
    assert _strip_walls(rep) == _strip_walls(reps[REF])


def test_a_failed_rung_fit_ranks_last_and_never_wins(monkeypatch):
    """An ordinary error in one candidate's rung fit is recorded and
    ranks it last; the selection goes on."""
    X, y = _binary_arrays()
    cls = mod(PORT, "models.logistic_regression").OpLogisticRegression
    real = cls.fit_arrays

    def flaky(self, X, y, w=None):
        if self.params.get("reg_param") == 0.001 and \
                self.params.get("elastic_net_param") == 0.1:
            raise FloatingPointError("diverged")
        return real(self, X, y, w)

    monkeypatch.setattr(cls, "fit_arrays", flaky)
    res, rep = _selection(PORT, X, y, _warmed_config(PORT))
    bad = [c for c in rep["rungs"] if c["rung_error"]]
    assert len(bad) == 1 and "FloatingPointError" in bad[0]["rung_error"]
    assert not bad[0]["kept"]


@pytest.mark.parametrize("make_fault", DEVICE_FAULTS)
def test_device_fault_in_a_rung_fit_propagates(monkeypatch, make_fault):
    """A device fault is not a failed rung: it escapes the rung loop."""
    X, y = _binary_arrays()
    cls = mod(PORT, "models.logistic_regression").OpLogisticRegression
    fault = make_fault()

    def broken(self, X, y, w=None):
        raise fault

    monkeypatch.setattr(cls, "fit_arrays", broken)
    with pytest.raises(type(fault)) as exc:
        _selection(PORT, X, y, _warmed_config(PORT))
    assert exc.value is fault


@pytest.mark.parametrize("make_fault", DEVICE_FAULTS)
def test_device_fault_in_a_fused_dispatch_propagates(monkeypatch,
                                                     make_fault):
    """The fused training dispatch's catch-all degrades an ordinary error
    to the kernel-at-a-time path, but re-raises a device fault."""
    ft = mod(PORT, "local.fused_train")
    fault = make_fault()

    def broken(*a, **k):
        raise fault

    X, y = _binary_arrays(n=3_000)
    lr = mod(PORT, "models.logistic_regression").OpLogisticRegression(
        device="cpu")
    grid = [{"reg_param": 0.01}, {"reg_param": 0.1}]
    monkeypatch.setattr(ft, "run_linear", broken)
    cv = _cv(PORT)
    cv.train_fused = True
    with pytest.raises(type(fault)):
        cv.validate([(lr, grid)], X, y)
    monkeypatch.setattr(ft, "run_linear",
                        lambda *a, **k: (_ for _ in ()).throw(
                            ValueError("fused bug")))
    cv.validate([(lr, grid)], X, y)
    fam = cv.last_train_fused["families"]["OpLogisticRegression"]
    assert fam == {"backend": "existing", "reason": "error:ValueError"}


# ---------------------------------------------------------------------------
# knob tuning
# ---------------------------------------------------------------------------
BASE = {"max_batch_size": 128, "max_wait_us": 2000}
BETTER = {"max_batch_size": 256, "max_wait_us": 1000}
WORSE = {"max_batch_size": 64, "max_wait_us": 4000}


def _probe_cases():
    """(name, candidates, repeats, measure factory): the fixed probe
    results both packages' tuners decide over."""
    def tied():
        return lambda k: 1000.0

    def clear():
        return lambda k: 2000.0 if k == BETTER else 1000.0

    def erroring():
        def m(k):
            if k == WORSE:
                raise RuntimeError("bad knobs")
            return 1000.0
        return m

    def flaky():
        calls = {"n": 0}

        def m(k):
            if k == BETTER:
                calls["n"] += 1
                if calls["n"] > 1:
                    raise RuntimeError("intermittent")
                return 9999.0
            return 1000.0
        return m

    def within_margin():
        return lambda k: 1020.0 if k == BETTER else 1000.0

    return [("tied", [BETTER, WORSE], 1, tied),
            ("clear", [BETTER, WORSE], 1, clear),
            ("erroring", [BETTER, WORSE], 1, erroring),
            ("flaky", [BETTER], 2, flaky),
            ("within_margin", [BETTER], 2, within_margin)]


@pytest.mark.parametrize("case", _probe_cases(), ids=lambda c: c[0])
def test_ab_probe_decisions_equal_the_reference(case):
    name, cands, repeats, factory = case
    decisions = {}
    for pkg in (REF, PORT):
        tuner = _at(pkg).KnobTuner(margin=0.05, repeats=repeats)
        decisions[pkg] = tuner.ab_probe("s", BASE, cands, factory()) \
            .to_json()
    got = decisions[PORT]
    assert got == decisions[REF]
    expect_tuned = name == "clear"
    assert got["tuned"] is expect_tuned
    assert got["winner"] == (BETTER if expect_tuned else BASE)


@pytest.mark.parametrize("make_fault", DEVICE_FAULTS)
def test_a_device_fault_is_not_a_losing_probe(make_fault):
    fault = make_fault()

    def measure(k):
        if k == BETTER:
            raise fault
        return 1000.0

    with pytest.raises(type(fault)):
        _at(PORT).KnobTuner(repeats=1).ab_probe("s", BASE, [BETTER], measure)


def test_ab_probe_records_obs_gauges():
    tuner = _at(PORT).KnobTuner(margin=0.01, repeats=1)
    d = tuner.ab_probe("unit.scope", {"max_wait_us": 2000},
                       [{"max_wait_us": 500}],
                       lambda k: 1.0 / (1 + k["max_wait_us"]))
    assert d.tuned
    doc = mod(PORT, "obs.metrics").metrics_registry().to_json()
    assert doc["series"]["autotune.knob.unit.scope.max_wait_us"][
        "value"] == 500.0
    assert doc["series"]["autotune.knob.unit.scope.tuned"]["value"] == 1.0


def test_knob_proposals_equal_the_reference():
    """Micro-batch candidates (cold and cost-model ranked), bucket edges
    and pipeline knob proposals are pure functions: equal in both."""
    bases = [BASE, {"max_batch_size": 1, "max_wait_us": 0},
             {"max_batch_size": 32, "max_wait_us": 500}]
    spreads = [[3, 7, 20, 90, 110], [], range(1, 3000),
               [2, 5, 17, 65, 257, 1000], [5000], [1, 1, 1]]
    stalls = [{"producer_busy_s": 10.0, "producer_stall_s": 0.1,
               "consumer_stall_s": 5.0},
              {"producer_busy_s": 10.0, "producer_stall_s": 6.0,
               "consumer_stall_s": 0.1},
              {"producer_busy_s": 10.0, "producer_stall_s": 0.2,
               "consumer_stall_s": 0.2}, {}]
    out = {}
    for pkg in (REF, PORT):
        at = _at(pkg)
        cm = at.CostModel(min_obs=2)
        for k in at.microbatch_candidates(BASE, max_candidates=8):
            cm.observe("knob:serving.microbatch",
                       at.candidate_features(0, 0, k),
                       1.0 + k["max_batch_size"] / k["max_wait_us"])
        out[pkg] = (
            [at.microbatch_candidates(b) for b in bases],
            at.microbatch_candidates(BASE, cost_model=cm),
            [at.propose_bucket_edges(s) for s in spreads]
            + [at.propose_bucket_edges(s, max_buckets=5) for s in spreads],
            [at.propose_pipeline_knobs(s, {"workers": 4,
                                           "buffer_chunks": 8})
             for s in stalls],
        )
    assert out[PORT] == out[REF]
    cands = out[PORT][0][0]
    assert BASE not in cands and cands
    assert {c["max_batch_size"] for c in cands} <= {64, 128, 256}
    assert out[PORT][3][0] == {"workers": 8, "buffer_chunks": 16}
    assert out[PORT][3][1]["workers"] == 2


def test_scheduler_retune_applies_live_and_lands_in_telemetry():
    serving = mod(PORT, "serving")

    class _Endpoint:
        batch_buckets = (1, 8, 32, 128)

        def __init__(self):
            self.telemetry = serving.ServingTelemetry()

        def score_batch(self, records):
            return [dict(r) for r in records]

    ep = _Endpoint()
    sched = serving.MicroBatchScheduler(ep, max_wait_us=2000, start=False)
    assert sched.knobs() == {"max_batch_size": 128, "max_wait_us": 2000}
    applied = sched.retune(max_batch_size=256, max_wait_us=500)
    assert applied == {"max_batch_size": 256, "max_wait_us": 500}
    assert sched.max_batch_size == 256
    snap = ep.telemetry.snapshot()
    assert snap["tuned_knobs"]["max_batch_size"] == 256.0
    assert snap["knob_source"] == "autotune"
    with pytest.raises(ValueError):
        sched.retune(max_batch_size=0)
    sched.close()


def test_profiler_observations_export():
    prof = mod(PORT, "obs.profiler").SpanProfiler()
    for ms in (1.0, 2.0, 3.0):
        prof.observe("stage.fit", ms)
    row = next(r for r in prof.observations() if r["name"] == "stage.fit")
    assert row["count"] == 3 and row["ewma_ms"] is not None
    cm = _at(PORT).CostModel(min_obs=1)
    assert cm.ingest_profiler(prof.snapshot()) >= 1
    assert cm.n_observations("span:stage.fit") == 1


# ---------------------------------------------------------------------------
# runner wiring
# ---------------------------------------------------------------------------
def _selector_workflow(pkg, n=1200, seed=0):
    reset_uids(pkg)
    rng = np.random.RandomState(seed)
    ft = mod(pkg, "types.feature_types")
    fb = mod(pkg, "features.feature_builder").FeatureBuilder
    a_v, b_v = rng.randn(n), rng.randn(n)
    data = {
        "y": ((a_v - b_v + 0.3 * rng.randn(n)) > 0).astype(float).tolist(),
        "a": a_v.tolist(),
        "b": b_v.tolist(),
    }
    y = fb(ft.RealNN, "y").as_response()
    vec = mod(pkg, "ops.transmogrifier").transmogrify(
        [fb(ft.Real, "a").as_predictor(), fb(ft.Real, "b").as_predictor()])
    lr = mod(pkg, "models.logistic_regression").OpLogisticRegression(
        **_kw(pkg))
    selector = mod(pkg, "selector.factories") \
        .BinaryClassificationModelSelector.with_cross_validation(
            num_folds=2,
            models_and_parameters=[
                (lr, [{"reg_param": r, "elastic_net_param": 0.1}
                      for r in (0.001, 0.01, 0.1, 0.2)]),
            ],
            splitter=None, **_kw(pkg))
    pred = selector.set_input(y, vec).get_output()
    return mod(pkg, "workflow.workflow").OpWorkflow(**_kw(pkg)) \
        .set_result_features(pred).set_input_dataset(data)


def _selector_summary(summary):
    return next(
        s["metadata"]["model_selector_summary"] for s in summary["stages"]
        if "model_selector_summary" in s.get("metadata", {}))


def test_runner_train_autotune_cold_then_warm_like_reference(tmp_path):
    """Cold: the exhaustive path with the reason in the run summary, the
    cost model trained from the run's spans and saved next to the model
    as ``autotune.json``.  Warm (a second run over the saved artifact):
    the plan prunes.  Each run's decision equals the reference's on the
    same data; the report over the model dir reads the trail."""
    params_of = {}
    for pkg in (REF, PORT):
        mod(pkg, "obs.trace").reset_tracer()
        loc = str(tmp_path / pkg)
        cp = {"autotune": True, "autotune_rung_rows": 400,
              "autotune_min_rows": 200}
        runner = mod(pkg, "workflow.runner").OpWorkflowRunner(
            _selector_workflow(pkg))
        r = runner.run("train", mod(pkg, "workflow.params").OpParams(
            model_location=loc, custom_params=cp))
        md = _selector_summary(r.summary)
        assert md["autotune"]["mode"] == "exhaustive"
        assert md["autotune"]["reason"].startswith("cost_model_cold")
        assert r.summary["autotune"]["cost_model"]["observations"] > 0
        at_path = os.path.join(loc, "autotune.json")
        assert _at(pkg).CostModel.load(at_path).n_observations() > 0
        with open(os.path.join(loc, "summary.json")) as f:
            assert json.load(f)["autotune"]["cost_model"]["path"] == at_path
        report = _at(pkg).report_from_path(loc)
        assert report["selection"][0]["autotune"]["mode"] == "exhaustive"
        params_of[pkg] = (md["autotune"], md["best_params"])
    assert _strip_walls(params_of[PORT][0]) == _strip_walls(
        params_of[REF][0])
    assert params_of[PORT][1] == params_of[REF][1]
    # warm: both packages over the SAME reference-written artifact, made
    # from the fixed observation list (the walls of the cold runs differ
    # by device and by what else ran in the process)
    ref_at = _at(REF)
    cm = ref_at.CostModel()
    for fam, rows, ms in OBSERVATIONS:
        if fam == "OpLogisticRegression":
            cm.observe(ref_at.key_for_fit(fam),
                       ref_at.candidate_features(rows, 2, {}, 0.5), ms)
    warm = {}
    for pkg in (REF, PORT):
        loc = str(tmp_path / f"warm-{pkg}")
        os.makedirs(loc)
        cm.save(os.path.join(loc, "autotune.json"))
        runner = mod(pkg, "workflow.runner").OpWorkflowRunner(
            _selector_workflow(pkg))
        r = runner.run("train", mod(pkg, "workflow.params").OpParams(
            model_location=loc,
            custom_params={"autotune": True, "autotune_rung_rows": 400,
                           "autotune_min_rows": 200}))
        md = _selector_summary(r.summary)
        warm[pkg] = (_split_metrics(_strip_walls(md["autotune"])),
                     md["best_params"])
    (got, got_m), got_best = warm[PORT]
    (want, want_m), want_best = warm[REF]
    assert got["mode"] == "pruned", got["reason"]
    assert got == want and got_best == want_best
    np.testing.assert_allclose(got_m, want_m, rtol=0, atol=1e-5)


def test_runner_serve_autotune_probes_and_records_decision(tmp_path):
    runner_mod = mod(PORT, "workflow.runner")
    OpParams = mod(PORT, "workflow.params").OpParams
    loc = str(tmp_path / "model")
    runner_mod.OpWorkflowRunner(_selector_workflow(PORT, n=400)).run(
        "train", OpParams(model_location=loc))
    r = runner_mod.OpWorkflowRunner(_selector_workflow(PORT, n=400)).run(
        "serve", OpParams(model_location=loc, custom_params={
            "serving_autotune": True,
            "autotune_probe_rows": 64,
            "autotune_probe_repeats": 1,
        }))
    dec = r.metrics["autotune"]
    assert dec["scope"] == "serving.microbatch"
    assert dec["baseline"] == {"max_batch_size": 128, "max_wait_us": 2000}
    assert dec["winner"]["max_batch_size"] >= 1
    assert sum(p["is_winner"] for p in dec["probes"]) == 1
    assert len(dec["probes"]) == 1 + len(
        _at(PORT).microbatch_candidates(dec["baseline"]))
    assert "max_batch_size" in r.metrics["tuned_knobs"]
    assert r.metrics["knob_source"] == (
        "autotune" if dec["tuned"] else "hand_set")
    assert r.metrics["rows_submitted"] == 400
