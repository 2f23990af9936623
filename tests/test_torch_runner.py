"""The torch package's ``OpWorkflowRunner`` against the JAX package's.

``workflow/runner.py`` and ``workflow/params.py`` on the CPU
(``OpWorkflow(device="cpu")``):

* the JAX package's runner contracts (its tests/test_runner.py: train,
  score, evaluate, features with param injection, streaming score, Avro
  scores; the ``serve`` run type of its tests/test_serving.py; the
  ``deploy`` run type of its tests/test_registry.py; the ``metrics_path``
  and ``slo_path`` knobs of its tests/test_obs*.py);
* against the JAX package: the same fitted models served by both
  packages' ``serve`` and ``deploy`` runs export documents with the same
  keys and score the same rows (exact);
* the unported pieces - the ``fleet`` and ``bulk`` run types - raise
  ``NotImplementedError`` naming ROADMAP item 12; the ``continuous`` run
  type, ``autotune``, ``serving_autotune``, ``ingest_shards`` and the
  obs-fleet shipping (``fleet_dir`` / ``TX_OBS_FLEET_DIR``) no longer
  raise and are held against the reference in
  ``tests/test_torch_{autotune,input_pipeline,continuous,obs_fleet}.py``.
"""
import json
import os

import numpy as np
import pytest

from torch_parity import PORT, REF, mod, reset_uids, tiny_pipeline

from transmogrifai_tpu_torch.interop import load_reference_artifact
from transmogrifai_tpu_torch.workflow.params import OpParams
from transmogrifai_tpu_torch.workflow.runner import (
    OpWorkflowRunner,
    train_fused_summary,
)


class ListReader:
    """Minimal reader over in-memory rows (either package's columns)."""

    def __init__(self, data: dict, pkg: str = PORT):
        self.data, self.pkg = data, pkg

    def generate_dataset(self, raw_features, params):
        column_from_list = mod(self.pkg, "types.columns").column_from_list
        return mod(self.pkg, "types.dataset").Dataset({
            f.name: column_from_list(self.data[f.name], f.ftype)
            for f in raw_features})


def _build(seed=0, n=200, pkg=PORT):
    """The JAX package's tests/test_runner.py workflow in ``pkg``."""
    reset_uids(pkg)
    rng = np.random.RandomState(seed)
    data = {"y": (rng.rand(n) > 0.5).astype(float).tolist(),
            "a": rng.randn(n).tolist(), "b": rng.randn(n).tolist()}
    mod(pkg, "dsl")
    fb = mod(pkg, "features.feature_builder").FeatureBuilder
    ft = mod(pkg, "types.feature_types")
    y = fb(ft.RealNN, "y").as_response()
    a = fb(ft.Real, "a").as_predictor()
    b = fb(ft.Real, "b").as_predictor()
    vec = mod(pkg, "ops.transmogrifier").transmogrify([a, b])
    pred = mod(pkg, "models.logistic_regression").OpLogisticRegression(
        reg_param=0.1).set_input(y, vec).get_output()
    kw = {"device": "cpu"} if pkg == PORT else {}
    wf = mod(pkg, "workflow.workflow").OpWorkflow(**kw) \
        .set_result_features(pred).set_reader(ListReader(data, pkg))
    return wf, data, pred


def _evaluator():
    from transmogrifai_tpu_torch.evaluators.binary import (
        OpBinaryClassificationEvaluator,
    )

    return OpBinaryClassificationEvaluator()


# -- the JAX package's runner contracts ------------------------------------------

def test_runner_train_score_evaluate(tmp_path):
    wf, _data, _pred = _build()
    params = OpParams(model_location=str(tmp_path / "model"),
                      write_location=str(tmp_path / "scores"),
                      metrics_location=str(tmp_path / "metrics"))
    r1 = OpWorkflowRunner(wf, evaluator=_evaluator()).run("train", params)
    assert r1.model is not None and r1.wall_s > 0
    assert os.path.exists(tmp_path / "model" / "model.json")
    assert os.path.exists(tmp_path / "model" / "summary.json")
    wf2, _, pred2 = _build()
    r2 = OpWorkflowRunner(wf2, evaluator=_evaluator()).run("score", params)
    assert pred2.name in r2.scores
    with open(tmp_path / "scores" / "scores.json") as f:
        written = json.load(f)
    assert pred2.name in written and "y" in written
    wf3, _, _ = _build()
    r3 = OpWorkflowRunner(wf3, evaluator=_evaluator()).run("evaluate", params)
    assert r3.metrics["AuROC"] > 0.4
    assert os.path.exists(tmp_path / "metrics" / "metrics.json")


def test_runner_features_and_param_injection(tmp_path):
    wf, _data, pred = _build()
    params = OpParams(write_location=str(tmp_path / "feat"),
                      stage_params={"OpLogisticRegression":
                                    {"reg_param": 0.5}})
    r = OpWorkflowRunner(wf).run("features", params)
    assert set(r.scores.column_names()) == {"y", "a", "b"}
    assert pred.origin_stage.params["reg_param"] == 0.5


def test_streaming_score(tmp_path):
    wf, _data, _pred = _build()
    params = OpParams(model_location=str(tmp_path / "m"))
    OpWorkflowRunner(wf).run("train", params)
    wf2, data2, _ = _build()
    batches = [{k: v[i:i + 50] for k, v in data2.items()}
               for i in range(0, 200, 50)]
    outs = list(OpWorkflowRunner(wf2).streaming_score(batches, params))
    assert len(outs) == 4 and all(len(o) == 50 for o in outs)


def test_runner_avro_score_output(tmp_path):
    from transmogrifai_tpu_torch.readers.avro_reader import read_avro_records

    wf, data, pred = _build()
    runner = OpWorkflowRunner(wf, evaluator=_evaluator())
    params = OpParams(model_location=str(tmp_path / "model"),
                      write_location=str(tmp_path / "scores"),
                      write_format="avro")
    runner.run("train", params)
    result = runner.run("score", params)
    schema, records = read_avro_records(str(tmp_path / "scores" /
                                            "scores.avro"))
    assert len(records) == len(data["y"])
    field = next(f for f in schema["fields"]
                 if f.get("doc") == pred.name or f["name"] == pred.name)
    scored = result.scores[pred.name]
    for i in (0, 7, len(records) - 1):
        assert records[i][field["name"]]["prediction"] == pytest.approx(
            float(scored.prediction[i]))


def test_train_fused_summary_rolls_up_the_trails():
    class V:
        def __init__(self, trail):
            self.last_train_fused = trail

    assert train_fused_summary([V(None)]) is None
    got = train_fused_summary([
        V({"backend": "fused", "families": {"lr": {"mode": "exact"}}}),
        V({"backend": "existing", "families": {"lr": {"reason": "rows"}},
           "cache": {"hits": 1}}),
    ])
    assert got == {"backend": "mixed",
                   "families": {"lr": {"mode": "exact"},
                                "lr#2": {"reason": "rows"}},
                   "cache": {"hits": 1, "misses": 0, "stale": 0}}


def _serve_workflow(pkg: str, data: dict):
    """The JAX package's serve-run workflow (tests/test_serving.py): a
    forest on a numeric and a picklist, reading ``data``."""
    mod(pkg, "dsl")
    fb = mod(pkg, "features.feature_builder").FeatureBuilder
    ft = mod(pkg, "types.feature_types")
    y = fb(ft.RealNN, "y").as_response()
    a = fb(ft.Real, "a").as_predictor()
    c = fb(ft.PickList, "c").as_predictor()
    vec = mod(pkg, "ops.transmogrifier").transmogrify([a, c])
    pred = mod(pkg, "models.trees").OpRandomForestClassifier(
        num_trees=8, max_depth=3).set_input(y, vec).get_output()
    kw = {"device": "cpu"} if pkg == PORT else {}
    return mod(pkg, "workflow.workflow").OpWorkflow(**kw) \
        .set_result_features(pred).set_input_dataset(data)


def _serve_data(n=120):
    rng = np.random.RandomState(3)
    return {"y": (rng.rand(n) > 0.5).astype(float).tolist(),
            "a": rng.randn(n).tolist(),
            "c": [("u", "v")[i % 2] for i in range(n)]}


def test_serve_run_type_exports_telemetry(tmp_path):
    data = _serve_data()
    reset_uids(PORT)
    wf = _serve_workflow(PORT, data)
    wf.train().save(str(tmp_path / "model"))
    params = OpParams(
        model_location=str(tmp_path / "model"),
        metrics_location=str(tmp_path / "metrics"),
        write_location=str(tmp_path / "scores"),
        custom_params={"serving_max_wait_us": 500, "serving_window": 32})
    result = OpWorkflowRunner(wf).run("serve", params)
    assert result.run_type == "serve"
    assert result.metrics["rows_scored"] == 120
    assert result.metrics["rows_failed"] == 0
    for k in ("p50", "p95", "p99"):
        assert result.metrics["latency_ms"][k] >= 0.0
    with open(tmp_path / "metrics" / "serving_metrics.json") as f:
        assert json.load(f)["rows_submitted"] == 120
    with open(tmp_path / "scores" / "scores.json") as f:
        rows = json.load(f)
    assert len(rows) == 120 and all("error" not in r for r in rows)


def _fresh_tiny():
    reset_uids(PORT)
    return tiny_pipeline(PORT)[0]


def test_runner_deploy_run_publishes_and_serves(tmp_path):
    reset_uids(PORT)
    wf, _data, _records, _name = tiny_pipeline(PORT)
    wf.train().save(str(tmp_path / "model"))
    root = str(tmp_path / "reg")
    params = OpParams(model_location=str(tmp_path / "model"),
                      metrics_location=str(tmp_path / "metrics"),
                      custom_params={"registry_root": root,
                                     "deploy_batch_rows": 32})
    m = OpWorkflowRunner(_fresh_tiny()).run("deploy", params).metrics
    assert m["rows_submitted"] == 120 and m["rows_failed"] == 0
    assert m["published_version"] == "v1"
    assert m["deployed_version"] == "v1"
    assert m["stable"]["telemetry"]["model_version"] == "v1"
    with open(tmp_path / "metrics" / "deploy_metrics.json") as f:
        assert json.load(f)["deployed_version"] == "v1"
    from transmogrifai_tpu_torch.registry import ModelRegistry

    assert ModelRegistry(root, create=False).stable == "v1"


def test_runner_deploy_releases_an_undecided_canary(tmp_path):
    from transmogrifai_tpu_torch.registry import ModelRegistry

    reset_uids(PORT)
    model = tiny_pipeline(PORT)[0].train()
    reset_uids(PORT)
    variant = tiny_pipeline(PORT, seed=1)[0].train()
    root = str(tmp_path / "reg")
    reg = ModelRegistry(root)
    reg.publish(model, stage="stable")
    reg.publish(variant)
    runner = OpWorkflowRunner(_fresh_tiny(), workflow_factory=_fresh_tiny)
    m = runner.run("deploy", OpParams(custom_params={
        "registry_root": root, "canary_version": "v2",
        "canary_fraction": 0.3, "deploy_batch_rows": 32})).metrics
    assert m["rows_failed"] == 0
    assert m["canary_released"] is not None
    reg2 = ModelRegistry(root, create=False)
    assert reg2.canary is None
    assert reg2.get("v2").stage == "candidate"
    assert reg2.lineage()[-1]["event"] == "canary_release"


def _small_csv(tmp_path, n=120) -> str:
    rng = np.random.RandomState(0)
    path = os.path.join(str(tmp_path), "data.csv")
    with open(path, "w") as f:
        f.write("label,a,b,kind\n")
        for _ in range(n):
            a, b = rng.rand(), rng.rand()
            kind = ("x", "y", "z")[int(rng.randint(3))]
            f.write(f"{int(a + b > 1.0)},{a:.4f},{b:.4f},{kind}\n")
    return path


def _small_workflow(csv_path):
    """The JAX package's tests/test_obs.py workflow, read from a CSV."""
    import transmogrifai_tpu_torch.dsl  # noqa: F401
    from transmogrifai_tpu_torch import FeatureBuilder, OpWorkflow
    from transmogrifai_tpu_torch.models.logistic_regression import (
        OpLogisticRegression,
    )
    from transmogrifai_tpu_torch.ops.transmogrifier import transmogrify
    from transmogrifai_tpu_torch.readers.csv_reader import CSVReader
    from transmogrifai_tpu_torch.types import feature_types as ft

    label = FeatureBuilder(ft.RealNN, "label").as_response()
    a = FeatureBuilder(ft.Real, "a").as_predictor()
    b = FeatureBuilder(ft.Real, "b").as_predictor()
    kind = FeatureBuilder(ft.PickList, "kind").as_predictor()
    checked = label.sanity_check(transmogrify([a, b, kind]),
                                 remove_bad_features=True)
    pred = OpLogisticRegression().set_input(label, checked).get_output()
    return OpWorkflow(device="cpu").set_result_features(pred) \
        .set_reader(CSVReader(csv_path))


def test_runner_metrics_path_knob_exports_plane(tmp_path):
    out_dir = str(tmp_path / "obs_out")
    result = OpWorkflowRunner(_small_workflow(_small_csv(tmp_path))).run(
        "train", OpParams(model_location=str(tmp_path / "model"),
                          custom_params={"metrics_path": out_dir}))
    assert result.model is not None
    for name in ("metrics.json", "metrics.prom", "spans.jsonl"):
        assert os.path.exists(os.path.join(out_dir, name)), name
    with open(os.path.join(out_dir, "metrics.json")) as f:
        doc = json.load(f)
    assert doc["run_type"] == "train" and "views" in doc
    with open(os.path.join(out_dir, "spans.jsonl")) as f:
        names = {json.loads(line)["name"] for line in f if line.strip()}
    assert {"run.train", "workflow.train", "ingest.read"} <= names


def test_runner_slo_path_knob_exports_report(tmp_path):
    cfg = tmp_path / "slo.json"
    cfg.write_text(json.dumps({"slos": [
        {"name": "spans-flowing", "kind": "threshold",
         "metric": "obs_tracer.spans_recorded", "objective": 1e9}]}))
    out_dir = str(tmp_path / "obs_out")
    OpWorkflowRunner(_small_workflow(_small_csv(tmp_path))).run(
        "train", OpParams(model_location=str(tmp_path / "model"),
                          custom_params={"metrics_path": out_dir,
                                         "slo_path": str(cfg)}))
    with open(os.path.join(out_dir, "slo_report.json")) as f:
        report = json.load(f)
    assert report["firing"] == []
    obj = report["objectives"]["spans-flowing"]
    assert obj["state"] == "ok" and obj["value"] > 0
    with open(os.path.join(out_dir, "metrics.prom")) as f:
        assert "tx_slo_alerts_firing" in f.read()


def test_slo_path_wires_the_deploy_rollback_policy(tmp_path):
    """A firing SLO of the ``slo_path`` config is a hard rollback signal of
    the deploy run's policy, and its report rides deploy_metrics.json."""
    from transmogrifai_tpu_torch.registry import ModelRegistry

    reset_uids(PORT)
    reg = ModelRegistry(str(tmp_path / "reg"))
    reg.publish(tiny_pipeline(PORT)[0].train(), stage="stable")
    reset_uids(PORT)
    reg.publish(tiny_pipeline(PORT, seed=1)[0].train())
    cfg = tmp_path / "slo.json"
    cfg.write_text(json.dumps({"slos": [
        {"name": "always", "kind": "threshold",
         "metric": "obs_tracer.spans_recorded", "objective": 1e-9,
         "windows_s": [60.0, 30.0]}]}))
    m = OpWorkflowRunner(_fresh_tiny(), workflow_factory=_fresh_tiny).run(
        "deploy", OpParams(
            metrics_location=str(tmp_path / "metrics"),
            custom_params={"registry_root": reg.root, "canary_version": "v2",
                           "canary_fraction": 0.5, "deploy_batch_rows": 32,
                           "canary_check_every_batches": 1,
                           "slo_path": str(cfg)})).metrics
    rollbacks = [e for e in m["events"] if e["event"] == "rollback"]
    assert rollbacks and "slo:always" in {
        r["signal"] for r in rollbacks[0]["reasons"]}
    assert m["slo"]["firing"] == ["always"]
    assert os.path.exists(tmp_path / "metrics" / "slo_report.json")


# -- the once-unported pieces: each run type asks for what it needs ----------------

@pytest.mark.parametrize("run_type", ["fleet", "continuous", "bulk"])
def test_unported_run_types_raise_naming_item_12(run_type, tmp_path,
                                                 monkeypatch):
    """Every run type is ported, and as in the reference each asks for
    what it needs with the reference's message: the fleet run for its
    registry root and worker factory, the continuous run for its watch
    dir, the bulk run for its job dir.  The fleet run's
    ``fleet_autoscale`` knob attaches an autoscaler whose columns land in
    the fleet status document."""
    wf, _data, _pred = _build()
    ref_wf = tiny_pipeline(REF)[0]
    ref_runner = mod(REF, "workflow.runner").OpWorkflowRunner(ref_wf)
    ref_params = mod(REF, "workflow.params").OpParams
    if run_type == "continuous":
        with pytest.raises(ValueError, match="watch_dir"):
            OpWorkflowRunner(wf).run(run_type, OpParams())
        return
    if run_type == "bulk":
        with pytest.raises(ValueError) as got:
            OpWorkflowRunner(wf).run(run_type, OpParams())
        with pytest.raises(ValueError) as want:
            ref_runner.run(run_type, ref_params())
        assert str(got.value) == str(want.value)
        assert "bulk_job_dir" in str(got.value)
        return
    for cp in ({}, {"registry_root": str(tmp_path / "r")},
               {"fleet_workflow": "m:f"}):
        with pytest.raises(ValueError) as got:
            OpWorkflowRunner(wf).run(run_type, OpParams(
                custom_params=dict(cp)))
        with pytest.raises(ValueError) as want:
            ref_runner.run(run_type, ref_params(custom_params=dict(cp)))
        assert str(got.value) == str(want.value)
        assert "registry_root" in str(got.value)
    with pytest.raises(ValueError, match="serving_fused_backend"):
        OpWorkflowRunner(wf).run(run_type, OpParams(custom_params={
            "registry_root": str(tmp_path / "r"),
            "fleet_workflow": "m:f", "serving_fused_backend": "xla"}))
    from torch_fleet import PORT_TINY_SPEC, WORKER_ENV

    for k, v in WORKER_ENV.items():
        monkeypatch.setenv(k, v)
    reset_uids(PORT)
    tiny_wf = tiny_pipeline(PORT)[0]
    tiny_wf.train().save(str(tmp_path / "model"))
    res = OpWorkflowRunner(tiny_wf).run(run_type, OpParams(
        model_location=str(tmp_path / "model"),
        custom_params={
            "registry_root": str(tmp_path / "r"),
            "fleet_workflow": PORT_TINY_SPEC,
            "fleet_replicas": 2, "fleet_work_dir": str(tmp_path / "fleet"),
            "fleet_batch_rows": 16, "fleet_concurrency": 2,
            "fleet_autoscale": True, "fleet_min_replicas": 2,
            "fleet_max_replicas": 3,
            "fleet_autoscale_interval_s": 0.1,
            "fleet_target_utilization": 0.6}))
    m = res.metrics
    assert m["rows_ok"] == m["rows_submitted"] and m["errors"] == []
    scaler = m["status"]["autoscaler"]
    assert scaler["min_replicas"] == 2 and scaler["max_replicas"] == 3
    assert scaler["alive"] is False and scaler["crashed"] is False
    assert scaler["decisions_total"] >= 1  # the adoption at least
    assert scaler["errors"] == 0


@pytest.mark.parametrize("run_type,knob", [
    ("train", "autotune"), ("train", "ingest_shards"),
    ("serve", "serving_autotune"),
])
def test_unported_knobs_raise_naming_item_12(run_type, knob, tmp_path):
    """The three knobs are ported and no longer raise: ``autotune``
    records its decision trail and saves ``autotune.json``,
    ``ingest_shards`` reads the shards through the pipelined reader, and
    ``serving_autotune`` records its knob decision."""
    wf, data, _pred = _build()
    if run_type == "serve":
        OpWorkflowRunner(wf).run("train", OpParams(
            model_location=str(tmp_path / "m")))
        wf = _build()[0]
    value = True
    if knob == "ingest_shards":
        shard = tmp_path / "a.csv"
        shard.write_text("y,a,b\n" + "".join(
            f"{y},{a},{b}\n"
            for y, a, b in zip(data["y"], data["a"], data["b"])))
        value = [str(shard)]
    res = OpWorkflowRunner(wf).run(run_type, OpParams(
        model_location=str(tmp_path / "m"),
        custom_params={knob: value, "autotune_probe_repeats": 1}))
    if knob == "autotune":
        assert res.summary["autotune"]["cost_model"]["path"] == str(
            tmp_path / "m" / "autotune.json")
        assert os.path.exists(tmp_path / "m" / "autotune.json")
    elif knob == "ingest_shards":
        assert len(res.model._train_data_cache) == len(data["y"])
    else:
        assert res.metrics["autotune"]["scope"] == "serving.microbatch"


def test_obs_fleet_shipping_raises_naming_item_12(tmp_path, monkeypatch):
    """The obs-fleet shipping is ported: ``fleet_dir`` and the
    ``TX_OBS_FLEET_DIR`` env seam each ship this process's plane as one
    shard that the aggregator reads back."""
    from transmogrifai_tpu_torch.obs import FleetAggregator

    wf, _data, _pred = _build()
    OpWorkflowRunner(wf).run("features", OpParams(
        custom_params={"fleet_dir": str(tmp_path / "agg")}))
    agg = FleetAggregator(str(tmp_path / "agg"), stale_after_s=300.0)
    assert agg.last_report == {} and len(agg.shards()) == 1
    monkeypatch.setenv("TX_OBS_FLEET_DIR", str(tmp_path / "agg2"))
    OpWorkflowRunner(wf).run("features", OpParams())
    shards = FleetAggregator(str(tmp_path / "agg2"),
                             stale_after_s=300.0).shards()
    assert len(shards) == 1 and any(
        s["name"] == "run.features" for s in shards[0]["spans"])


# -- against the JAX package --------------------------------------------------------

def _keys(doc, prefix=""):
    out = set()
    for k, v in doc.items():
        out.add(prefix + k)
        if isinstance(v, dict) and k not in (
                "compile_ms_by_bucket", "bucket_timings", "drift_js",
                "violations_by_kind", "batches_by_action", "tuned_knobs",
                "evidence"):
            out |= _keys(v, prefix + k + ".")
    return out


def _both_artifacts(build, tmp_path, name):
    """The JAX package trains ``build(REF)`` and saves it; the torch
    package loads that artifact into ``build(PORT)`` and saves its own:
    (reference artifact path, torch artifact path)."""
    ref_path = str(tmp_path / f"ref_{name}")
    port_path = str(tmp_path / f"port_{name}")
    reset_uids(REF)
    build(REF).train().save(ref_path)
    reset_uids(PORT)
    load_reference_artifact(ref_path, build(PORT)).save(port_path)
    return ref_path, port_path


def _run(pkg, wf, run_type, params_kw, factory=None):
    params = mod(pkg, "workflow.params").OpParams(**params_kw)
    runner = mod(pkg, "workflow.runner").OpWorkflowRunner(
        wf, workflow_factory=factory)
    return runner.run(run_type, params)


def test_serve_run_exports_equal_the_reference(tmp_path):
    """The same forest served by both packages' ``serve`` runs: the
    exported serving_metrics.json has the same keys and counts, and
    scores.json the same rows (exact)."""
    data = _serve_data()
    ref_path, port_path = _both_artifacts(
        lambda pkg: _serve_workflow(pkg, data), tmp_path, "forest")
    out = {}
    for pkg, path in ((REF, ref_path), (PORT, port_path)):
        reset_uids(pkg)
        d = tmp_path / pkg
        _run(pkg, _serve_workflow(pkg, data), "serve", dict(
            model_location=path, metrics_location=str(d / "metrics"),
            write_location=str(d / "scores"),
            custom_params={"serving_max_wait_us": 500,
                           "serving_window": 32,
                           "serving_fused_backend": "numpy"}))
        with open(d / "metrics" / "serving_metrics.json") as f:
            metrics = json.load(f)
        with open(d / "scores" / "scores.json") as f:
            out[pkg] = (metrics, json.load(f))
    (gm, grows), (wm, wrows) = out[PORT], out[REF]
    assert _keys(gm) == _keys(wm)
    for k in ("rows_scored", "rows_failed", "rows_submitted", "run_type",
              "rows_fallback"):
        assert gm[k] == wm[k], k
    assert gm["fused"]["backend"] == wm["fused"]["backend"] == "numpy"
    assert grows == wrows


def test_deploy_run_exports_equal_the_reference(tmp_path):
    """The same two models deployed by both packages' ``deploy`` runs, v1
    stable and v2 a 30% canary: deploy_metrics.json has the same keys,
    each arm the same row counts, the registry the same end state, and
    scores.json the same rows (exact)."""
    ref_v1, port_v1 = _both_artifacts(
        lambda pkg: tiny_pipeline(pkg)[0], tmp_path, "v1")
    ref_v2, port_v2 = _both_artifacts(
        lambda pkg: tiny_pipeline(pkg, seed=1)[0], tmp_path, "v2")
    out = {}
    for pkg, v1, v2 in ((REF, ref_v1, ref_v2), (PORT, port_v1, port_v2)):
        def fresh(pkg=pkg):
            reset_uids(pkg)
            return tiny_pipeline(pkg)[0]

        reg = mod(pkg, "registry").ModelRegistry(str(tmp_path / pkg / "reg"))
        loaded = mod(pkg, "workflow.workflow").OpWorkflowModel
        reg.publish(loaded.load(v1, fresh()), stage="stable")
        reg.publish(loaded.load(v2, fresh()))
        d = tmp_path / pkg
        res = _run(pkg, fresh(), "deploy", dict(
            metrics_location=str(d / "metrics"),
            write_location=str(d / "scores"),
            custom_params={"registry_root": reg.root, "canary_version": "v2",
                           "canary_fraction": 0.3, "deploy_batch_rows": 32,
                           "serving_fused_backend": "numpy"}), factory=fresh)
        with open(d / "metrics" / "deploy_metrics.json") as f:
            metrics = json.load(f)
        with open(d / "scores" / "scores.json") as f:
            rows = json.load(f)
        out[pkg] = (metrics, rows, reg.describe(), res.metrics)
    (gm, grows, gdesc, _), (wm, wrows, wdesc, _) = out[PORT], out[REF]
    assert _keys(gm) == _keys(wm)
    for k in ("rows_submitted", "rows_failed", "deployed_version",
              "canary_version", "published_version", "canary_fraction",
              "shadow", "shadow_stats"):
        assert gm[k] == wm[k], k
    for arm in ("stable", "canary"):
        for k in ("rows_scored", "rows_failed", "model_version",
                  "generation"):
            assert gm[arm]["telemetry"][k] == wm[arm]["telemetry"][k], (
                arm, k)
    assert gm["canary"]["telemetry"]["rows_scored"] > 0
    assert [e["event"] for e in gm["events"]] == [
        e["event"] for e in wm["events"]]
    assert [(v["version"], v["stage"]) for v in gdesc["versions"]] == [
        (v["version"], v["stage"]) for v in wdesc["versions"]]
    assert grows == wrows
