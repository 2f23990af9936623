"""The torch package's SLO engine and metrics exposition against the JAX
package's.

``obs/slo.py`` (declarative objectives with multi-window burn-rate
alerts, the rollback policy's SLO signal), ``obs/metrics.py``'s
Prometheus renderer and process identity, and ``obs.export_obs``:

* the JAX package's contracts (its tests/test_obs_fleet.py SLO tests and
  tests/test_obs.py exposition tests), run on the torch package - the
  nan-scores drill against a ``device="cpu"`` endpoint;
* against the JAX package: ``SLOEngine.report()`` over the same sequence
  of registry documents under the same clock, and
  ``prometheus_text_from_json`` of the same documents, equal (exact).

Left out: the fleet shipping and aggregation tests (``obs/fleet.py``
waits for ROADMAP item 12) and the ``tx obs`` CLI tests.
"""
import json
import os
import re
import time

import pytest

from torch_parity import PORT, REF, mod, reset_uids, tiny_pipeline

from transmogrifai_tpu_torch.faults import injection as faults
from transmogrifai_tpu_torch.obs import (
    SLOEngine,
    SLObjective,
    default_objectives,
    export_obs,
    load_slo_config,
    metrics_registry,
    process_instance,
    prometheus_text_from_json,
    set_process_instance,
)
from transmogrifai_tpu_torch.obs.metrics import _numeric_leaves
from transmogrifai_tpu_torch.serving import ServingTelemetry

_PROM_SAMPLE = re.compile(r"^([a-zA-Z_:][a-zA-Z0-9_:]*)(\{[^}]*\})?\s+(\S+)$")
_PROM_LABEL = re.compile(r'([a-zA-Z_][a-zA-Z0-9_]*)="([^"]*)"')


def _parse_prometheus(text: str) -> dict:
    """Strict parse of the text exposition: {(name, labels): value}."""
    out = {}
    for line in text.splitlines():
        if not line or line.startswith("#"):
            continue
        m = _PROM_SAMPLE.match(line)
        assert m is not None, f"unparseable exposition line: {line!r}"
        labels = tuple(sorted(_PROM_LABEL.findall(m.group(2) or "")))
        out[(m.group(1), labels)] = float(m.group(3))
    return out


@pytest.fixture(autouse=True)
def _disarm():
    faults.reset()
    yield
    faults.reset()


# -- the JAX package's SLO contracts ---------------------------------------------

def test_slo_ratio_burn_fires_and_clears_synthetic():
    reg = metrics_registry()
    bad = reg.counter("drill.bad")
    total = reg.counter("drill.total")
    obj = SLObjective(name="bad-ratio", kind="ratio", numerator="drill.bad",
                      denominator="drill.total", objective=0.01,
                      windows_s=(0.8, 0.15), burn_threshold=1.0)
    eng = SLOEngine([obj], register=False)
    eng.observe()
    deadline = time.monotonic() + 3.0
    fired = False
    while time.monotonic() < deadline and not fired:
        bad.inc(10)
        total.inc(10)
        fired = eng.observe()["objectives"]["bad-ratio"]["state"] == "firing"
        time.sleep(0.02)
    assert fired, "alert never fired under sustained burn"
    assert [a["name"] for a in eng.firing()] == ["bad-ratio"]
    deadline = time.monotonic() + 3.0
    cleared = False
    while time.monotonic() < deadline and not cleared:
        total.inc(50)
        cleared = eng.observe()["objectives"]["bad-ratio"]["state"] == "ok"
        time.sleep(0.05)
    assert cleared, "alert never cleared after recovery"
    assert [e["transition"] for e in eng.report()["events"]] == [
        "fired", "cleared"]
    for _ in range(3):
        rep = eng.observe()
    assert rep["objectives"]["bad-ratio"]["state"] == "ok"


def test_slo_alert_fires_on_nan_scores_and_clears_after_recovery():
    from transmogrifai_tpu_torch.serving import compile_endpoint

    reset_uids(PORT)
    wf, _data, records, _name = tiny_pipeline(PORT)
    endpoint = compile_endpoint(wf.train(), batch_buckets=(32,),
                                breaker_threshold=10_000)
    endpoint.score_batch(records[:32])
    obj = SLObjective(
        name="serving-nonfinite", kind="ratio",
        numerator="serving.breaker.rows_nonfinite",
        denominator=("serving.rows_batched",
                     "serving.breaker.rows_nonfinite"),
        objective=0.05, windows_s=(0.8, 0.15), burn_threshold=1.0)
    eng = SLOEngine([obj], register=False)
    eng.observe()
    faults.configure("serving.nan_scores:every=1")
    try:
        deadline = time.monotonic() + 5.0
        fired = False
        while time.monotonic() < deadline and not fired:
            endpoint.score_batch(records[:32])
            fired = bool(eng.observe()["firing"])
            time.sleep(0.02)
        assert fired, "SLO alert never fired while nan_scores armed"
    finally:
        faults.reset()
    deadline = time.monotonic() + 5.0
    cleared = False
    while time.monotonic() < deadline and not cleared:
        assert len(endpoint.score_batch(records[:32])) == 32
        cleared = not eng.observe()["firing"]
        time.sleep(0.05)
    assert cleared, "SLO alert never cleared after recovery"
    assert [e["transition"] for e in eng.report()["events"]] == [
        "fired", "cleared"]


def test_firing_slo_is_a_hard_rollback_signal():
    from transmogrifai_tpu_torch.registry.rollback import RollbackPolicy

    reg = metrics_registry()
    bad = reg.counter("fleet.bad")
    total = reg.counter("fleet.total")
    obj = SLObjective(name="fleet-errors", kind="ratio",
                      numerator="fleet.bad", denominator="fleet.total",
                      objective=0.01, windows_s=(0.5, 0.05),
                      burn_threshold=1.0)
    eng = SLOEngine([obj], register=False)
    eng.observe()
    policy = RollbackPolicy(slo_engine=eng)
    time.sleep(0.06)
    bad.inc(100)
    total.inc(100)
    eng.observe()
    time.sleep(0.06)
    bad.inc(100)
    total.inc(100)
    decision = policy.evaluate({"rows_scored": 0}, {"rows_scored": 0})
    assert "slo:fleet-errors" in [r["signal"] for r in decision.reasons]
    assert decision.rollback
    assert decision.evidence["slo"]["firing"] == ["fleet-errors"]
    assert not RollbackPolicy().evaluate({"rows_scored": 0},
                                         {"rows_scored": 0}).rollback


def test_slo_config_load_validates(tmp_path):
    cfg = tmp_path / "slo.json"
    cfg.write_text(json.dumps({"slos": [
        {"name": "p99", "kind": "threshold",
         "metric": "serving.latency_ms.p99", "objective": 100.0},
        {"name": "errs", "kind": "ratio", "numerator": "serving.rows_failed",
         "denominator": ["serving.rows_scored", "serving.rows_failed"],
         "objective": 0.05},
    ]}))
    assert [o.name for o in load_slo_config(str(cfg))] == ["p99", "errs"]
    cfg.write_text(json.dumps({"slos": [
        {"name": "x", "kind": "ratio", "numerator": "a",
         "denominator": "b", "objectve": 0.1}]}))
    with pytest.raises(ValueError, match="objectve"):
        load_slo_config(str(cfg))
    with pytest.raises(ValueError):
        SLObjective(name="w", kind="nope")
    with pytest.raises(ValueError):
        SLObjective(name="w", kind="rate", numerator="a",
                    windows_s=(1.0, 2.0))


def test_threshold_spike_outside_windows_does_not_hold_alert():
    g = metrics_registry().gauge("probe.p99")
    obj = SLObjective(name="p99", kind="threshold", metric="probe.p99",
                      objective=10.0, windows_s=(0.3, 0.1),
                      burn_threshold=1.0)
    eng = SLOEngine([obj], register=False)
    g.set(1000.0)
    assert eng.observe()["objectives"]["p99"]["state"] == "firing"
    g.set(1.0)
    time.sleep(0.35)
    rep = eng.observe()
    assert rep["objectives"]["p99"]["state"] == "ok", rep
    time.sleep(0.35)
    st = eng._alerts["p99"]
    burn, _info = eng._burn(obj, st.samples, time.perf_counter(), 0.1)
    assert burn == 0.0


# -- the JAX package's exposition contracts ------------------------------------------

def test_prometheus_round_trips_the_registered_snapshots():
    """Every finite numeric series of the registered telemetry snapshots
    (serving, mesh, data) appears in the Prometheus text with its value."""
    from transmogrifai_tpu_torch.obs import sanitize_metric_name
    from transmogrifai_tpu_torch.parallel.resilience import MeshTelemetry
    from transmogrifai_tpu_torch.schema.quarantine import DataTelemetry

    serving = ServingTelemetry()
    serving.record_request(0.002, "ok")
    serving.record_request(0.004, "failed")
    serving.record_batch(32, 32, 0.01, fused=True)
    serving.record_breaker_transition("open")
    serving.set_model_version("v001", generation=3)
    mesh = MeshTelemetry()
    mesh.record_step("fit", 0.5)
    mesh.record_detection("fit", 1.0, "straggler", 1.2, [])
    data = DataTelemetry()
    data.record_read("a.csv", 100, 97)
    doc = metrics_registry().to_json()
    assert {"serving", "mesh", "data"} <= {k.split("/")[0]
                                            for k in doc["views"]}
    inst = process_instance()
    samples = _parse_prometheus(prometheus_text_from_json(doc))
    missing, wrong = [], []
    for key, snap in doc["views"].items():
        kind, _, idx = key.partition("/")
        labels = [("instance", inst), ("view", idx)]
        if isinstance(snap.get("model_id"), str) and snap["model_id"]:
            labels.append(("model_id", snap["model_id"]))
        for path, value in _numeric_leaves(snap):
            name = sanitize_metric_name(kind + "_" + "_".join(path))
            got = samples.get((name, tuple(sorted(labels))))
            if got is None:
                missing.append(name)
            elif abs(got - float(value)) > 1e-9:
                wrong.append((name, got, value))
    assert not missing, missing[:10]
    assert not wrong, wrong[:10]
    (key,) = [k for k, v in doc["views"].items()
              if k.startswith("serving/") and v["model_version"] == "v001"]
    lbl = (("instance", inst), ("view", key.partition("/")[2]))
    assert samples[("tx_serving_rows_scored", lbl)] == 1.0
    assert samples[("tx_serving_generation", lbl)] == 3.0


def test_export_obs_writes_the_plane(tmp_path):
    """``export_obs``: metrics.json (the registry document stamped with
    this process's instance), metrics.prom rendered from that same
    document, spans.jsonl."""
    reg = metrics_registry()
    reg.counter("obs.events_dropped", help="drops").inc(4)
    ServingTelemetry().record_request(0.001, "ok")
    out = export_obs(str(tmp_path / "obs"), extra={"run_type": "serve"})
    assert out["series"]["obs.events_dropped"]["value"] >= 4
    assert out["instance"] == process_instance()
    with open(tmp_path / "obs" / "metrics.json") as f:
        saved = json.load(f)
    assert saved["run_type"] == "serve"
    with open(tmp_path / "obs" / "metrics.prom") as f:
        assert f.read() == prometheus_text_from_json(saved)
    assert os.path.exists(tmp_path / "obs" / "spans.jsonl")


def test_instance_label_stable_and_overridable(monkeypatch):
    inst = process_instance()
    assert inst == process_instance()
    assert inst.split("-")[0] == str(os.getpid())
    try:
        set_process_instance("replica-7")
        reg = metrics_registry()
        reg.counter("x.c").inc()
        assert 'tx_x_c{instance="replica-7"}' in reg.prometheus_text()
        doc = dict(reg.to_json(), instance="replica-7")
        t2 = prometheus_text_from_json(doc, instance="other")
        assert 'instance="other"' in t2 and "replica-7" not in t2
        # a hostile name cannot inject label syntax
        set_process_instance('evil"name/../x')
        assert process_instance() == "evil_name_.._x"
        monkeypatch.setenv("TX_OBS_INSTANCE", "replica 3")
        set_process_instance(None)
        assert process_instance() == "replica_3"
    finally:
        set_process_instance(None)


# -- against the JAX package -------------------------------------------------------

def _doc(step: int) -> dict:
    """A registry document (native series + two serving views and a mesh
    view) at ``step``: counters that grow, a failure burst at steps 3-5,
    a p99 spike at step 4 and a histogram."""
    burst = 1 if 3 <= step <= 5 else 0
    failed = 2 * step + 40 * max(0, min(step, 5) - 2)
    view = {
        "rows_scored": 100 * step, "rows_failed": failed,
        "rows_batched": 90 * step,
        "latency_ms": {"p50": 2.0, "p95": 3.5,
                       "p99": 80.0 if step == 4 else 4.0 + 0.25 * step},
        "breaker": {"opens": burst + (step > 5), "rows_nonfinite": 3 * burst,
                    "rows_shed": 0},
        "data_contract": {"drift_js_max": 0.01 * step,
                          "drift_js": {"age": {"last": 0.02, "max": 0.3}}},
        "generation": 2, "model_version": "v2", "flag": True,
        "note": "text", "samples": [1, 2, 3], "nan": float("nan"),
        "wall_s": 12.5,
    }
    return {
        "series": {
            "obs.events_dropped": {"type": "counter", "value": step,
                                   "help": "drops"},
            "queue.depth": {"type": "gauge", "value": 0.5 * step},
            "ingest.rows": {"type": "histogram", "sum": 10.0 * step,
                            "count": step,
                            "buckets": {"1": step, "10": 2, "+Inf": 1}},
        },
        "views": {
            "serving/0": view,
            "serving/1": dict(view, rows_scored=50 * step,
                              model_id="model-a"),
            "mesh/0": {"detections": step, "model_version": None},
        },
    }


class _Clock:
    """A module clock for the SLO engine: ``perf_counter`` reads the time
    the test set, plus a microsecond for each read since, so two engines
    making the same reads see the same times."""

    def __init__(self) -> None:
        self.t, self.k = 0.0, 0

    def set(self, t: float) -> None:
        self.t, self.k = t, 0

    def perf_counter(self) -> float:
        self.k += 1
        return self.t + 1e-6 * self.k


def _objectives(pkg: str):
    slo = mod(pkg, "obs.slo")
    return [
        *slo.default_objectives(),
        slo.SLObjective(name="errs", kind="ratio",
                        numerator="serving.rows_failed",
                        denominator=("serving.rows_scored",
                                     "serving.rows_failed"),
                        objective=0.05, windows_s=(3.0, 1.0)),
        slo.SLObjective(name="opens", kind="rate",
                        numerator="serving.breaker.opens",
                        objective=0.2, windows_s=(2.0, 1.0)),
        slo.SLObjective(name="p99", kind="threshold",
                        metric="serving.latency_ms.p99", objective=20.0,
                        windows_s=(2.0, 0.5)),
        slo.SLObjective(name="floor", kind="threshold", op=">=",
                        metric="queue.depth", objective=1.0,
                        windows_s=(2.0, 1.0)),
        slo.SLObjective(name="dropped", kind="rate",
                        numerator="tx_obs_events_dropped", objective=0.5,
                        windows_s=(3.0, 1.0)),
        slo.SLObjective(name="hist", kind="ratio", numerator="ingest.rows",
                        denominator="serving.rows_batched", objective=0.05,
                        windows_s=(3.0, 1.0)),
    ]


def test_slo_engine_reports_equal_the_reference(monkeypatch):
    """Both packages' engines observe the same ten documents under the
    same clock: every report, the final ``report()``, ``firing()`` and
    ``snapshot()`` are equal (exact)."""
    engines, clocks = {}, {}
    for pkg in (PORT, REF):
        clocks[pkg] = _Clock()
        monkeypatch.setattr(mod(pkg, "obs.slo"), "time", clocks[pkg])
        engines[pkg] = mod(pkg, "obs.slo").SLOEngine(_objectives(pkg),
                                                     register=False)
    for step in range(10):
        for c in clocks.values():
            c.set(0.5 * (step + 1))
        got = engines[PORT].observe(_doc(step))
        want = engines[REF].observe(_doc(step))
        assert got == want, step
    assert engines[PORT].report() == engines[REF].report()
    # the sequence drives alerts through both transitions
    assert {e["transition"] for e in engines[PORT].report()["events"]} == {
        "fired", "cleared"}
    assert engines[PORT].firing() == engines[REF].firing()
    assert engines[PORT].snapshot() == engines[REF].snapshot()
    assert [o.to_json() for o in default_objectives()] == [
        o.to_json() for o in mod(REF, "obs.slo").default_objectives()]


@pytest.mark.parametrize("step", [0, 4, 7])
@pytest.mark.parametrize("instance", [None, "replica-1", 'bad"name'])
def test_prometheus_text_equals_the_reference(step, instance):
    """``prometheus_text_from_json`` of the same document renders the same
    text in both packages (exact), with and without an instance."""
    ref = mod(REF, "obs.metrics")
    doc = dict(_doc(step), instance="writer-9")
    got = prometheus_text_from_json(doc, instance=instance)
    want = ref.prometheus_text_from_json(doc, instance=instance)
    assert got == want
    _parse_prometheus(got)
