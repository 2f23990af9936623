"""Multi-model serving, port against reference.

``transmogrifai_tpu_torch.fleet.multimodel`` is a host copy of the JAX
package's: the per-replica ``ModelTable`` (a weighted LRU over the
resident models - evict cold, rehydrate by re-deploying from the
registry), the ``--models`` grammar and the ``PlacementPlanner``.  Held
three ways on the CPU:

* against the reference: for the same specs the placement plans'
  ``to_json()`` are equal, ``parse_models_arg``/``format_models_arg``
  round-trip alike, and both packages' tables evict and rehydrate in
  the same order under the same host and score sequence with injected
  weights;
* the contracts of the JAX package's tests/test_multimodel.py that need
  no autoscaler and no bulk job (those come with the autoscaler and
  ``bulk/``): the table's counters, pins and storm bound, the router's
  per-model dispatch and quotas, and model-multiplexed fleets of port
  workers (``device="cpu"``, one thread each);
* the port writes no compiled-program cache, so an artifact weighs its
  whole directory (the reference's own fallback).
"""
from __future__ import annotations

import json
import os
import socket
import time

import pytest

from torch_fleet import PORT_TINY_SPEC, controller, publish_tiny
from torch_parity import PORT, REF, mod, reference_pair, tiny_pipeline

from transmogrifai_tpu_torch.faults import injection as faults
from transmogrifai_tpu_torch.fleet import (
    FleetRouter,
    ModelQuotaError,
    ModelTable,
    MultiModelError,
    PlacementPlanner,
    UnhostedModelError,
    UnknownModelError,
    format_models_arg,
    parse_models_arg,
)
from transmogrifai_tpu_torch.fleet.multimodel import artifact_cache_bytes
from transmogrifai_tpu_torch.registry import ModelRegistry


@pytest.fixture(autouse=True)
def _disarm_faults():
    faults.reset()
    yield
    faults.reset()


@pytest.fixture(scope="module")
def mm_registry(tmp_path_factory):
    return publish_tiny(str(tmp_path_factory.mktemp("mm-registry")))


def _fresh_workflow():
    from transmogrifai_tpu_torch.testkit.drills import tiny_drill_pipeline

    return tiny_drill_pipeline(device="cpu")[0]


def _table(mm_registry, **kw):
    kw.setdefault("batch_buckets", (1, 8, 32))
    reg = ModelRegistry(mm_registry["root"], create=False)
    return ModelTable(reg, _fresh_workflow, **kw)


def _wait_status(fc, cond, timeout_s=45.0):
    """Poll the controller's status doc until ``cond(doc)`` holds (the
    per-model rows fold from obs shards shipped on an interval)."""
    deadline = time.monotonic() + timeout_s
    while True:
        doc = fc.status()
        if cond(doc):
            return doc
        if time.monotonic() >= deadline:
            return doc
        time.sleep(0.2)


def _controller(mm_registry, tmp_path, n_replicas, **kw):
    return controller(mm_registry["root"], PORT_TINY_SPEC, n_replicas,
                      str(tmp_path / "fleet"), **kw)


# -- against the reference ---------------------------------------------------

@pytest.mark.parametrize("spec", [
    "alpha=v1,beta=v2", " alpha = v1 , beta=v2 ,", "m=v7", "a=1,b=2,c=3"])
def test_models_arg_roundtrips_equal_to_reference(spec):
    ref = mod(REF, "fleet.multimodel")
    got = parse_models_arg(spec)
    assert got == ref.parse_models_arg(spec)
    assert format_models_arg(got) == ref.format_models_arg(got)
    assert parse_models_arg(format_models_arg(got)) == got


PLAN_CASES = {
    "replicated": (dict(replication=2), [
        {"model_id": "a", "weight_bytes": 300, "rows_per_s": 1000.0},
        {"model_id": "b", "weight_bytes": 200, "rows_per_s": 4000.0},
        {"model_id": "c", "weight_bytes": 100, "rows_per_s": 2000.0},
    ], ["replica-0", "replica-1", "replica-2"]),
    "harmonic": (dict(replication=1), [
        {"model_id": "fast", "rows_per_s": 4000.0},
        {"model_id": "slow", "rows_per_s": 1000.0},
    ], ["only"]),
    "budget": (dict(replication=1, cache_budget_bytes=250), [
        {"model_id": "big", "weight_bytes": 200, "rows_per_s": 100.0},
        {"model_id": "mid", "weight_bytes": 150, "rows_per_s": 100.0},
        {"model_id": "sml", "weight_bytes": 40, "rows_per_s": 100.0},
    ], ["replica-0", "replica-1"]),
    "defaults": (dict(), [
        {"model_id": m} for m in ("x", "y", "z", "w")
    ], ["r0", "r1", "r2"]),
}


@pytest.mark.parametrize("case", sorted(PLAN_CASES))
def test_placement_plans_equal_to_reference(case):
    kw, models, insts = PLAN_CASES[case]
    got = PlacementPlanner(**kw)
    want = mod(REF, "fleet.multimodel").PlacementPlanner(**kw)
    for _ in range(2):  # the revision counts alike too
        assert got.plan(models, insts).to_json() == \
            want.plan(models, insts).to_json()


@pytest.fixture(scope="module")
def both_registries(tmp_path_factory):
    """One reference-trained model published as v1..v3 into a registry of
    each package."""
    ws = tmp_path_factory.mktemp("mm-parity")
    ref, port = reference_pair(lambda pkg: tiny_pipeline(pkg)[0],
                               str(ws / "model"))
    roots = {}
    for pkg, model in ((REF, ref), (PORT, port)):
        roots[pkg] = str(ws / f"{pkg}_registry")
        reg = mod(pkg, "registry").ModelRegistry(roots[pkg])
        reg.publish(model, stage="stable")
        reg.publish(model)
        reg.publish(model)
    _wf, _data, records, _name = tiny_pipeline(PORT)
    return roots, records


#: injected per-version weights: the eviction order is a function of
#: these, the capacity and the touch sequence alone
WEIGHTS = {"v1": 300, "v2": 200, "v3": 100}
SEQUENCE = [("host", "a", "v1"), ("host", "b", "v2"), ("host", "c", "v3"),
            ("score", "a"), ("score", "b"), ("host", "d", "v3"),
            ("score", "c"), ("score", "a"), ("score", "d")]


def _drive_table(pkg, root, records, monkeypatch):
    mm = mod(pkg, "fleet.multimodel")
    monkeypatch.setattr(mm, "artifact_cache_bytes",
                        lambda _reg, version: WEIGHTS[version])
    reset = mod(pkg, "utils.uid").reset_uids

    def factory():
        reset()
        return tiny_pipeline(pkg)[0]

    table = mm.ModelTable(
        mod(pkg, "registry").ModelRegistry(root, create=False), factory,
        capacity_bytes=450, evict_min_interval_s=0.0,
        batch_buckets=(8,), fused_backend="numpy")
    trail = []
    for step in SEQUENCE:
        if step[0] == "host":
            table.host(step[1], step[2])
            rows = None
        else:
            rows, info = table.score(step[1], records[:8])
            rows = (rows, bool(info.get("cold_hit")))
        resident = sorted(r["model_id"] for r in table.rows()
                          if r["resident"])
        trail.append((step, resident, table.evictions, table.rehydrations,
                      table.cold_hits, rows))
    return trail


def test_table_evicts_and_rehydrates_like_reference(both_registries,
                                                    monkeypatch):
    roots, records = both_registries
    want = _drive_table(REF, roots[REF], records, monkeypatch)
    got = _drive_table(PORT, roots[PORT], records, monkeypatch)
    assert [t[:5] for t in got] == [t[:5] for t in want]
    # the rows each hit scored are the reference's, to the bit
    assert [t[5] for t in got] == [t[5] for t in want]
    assert got[-1][2] >= 3 and got[-1][3] >= 2


# -- the --models grammar and the artifact weight ----------------------------

def test_models_arg_roundtrip_and_rejects_blanks():
    models = {"alpha": "v1", "beta": "v2"}
    assert parse_models_arg(format_models_arg(models)) == models
    assert parse_models_arg(" alpha = v1 , beta=v2 ,") == models
    for bad in ("alpha", "=v1", ",,"):
        with pytest.raises(ValueError):
            parse_models_arg(bad)


def test_artifact_cache_bytes_weighs_the_whole_artifact(mm_registry):
    reg = ModelRegistry(mm_registry["root"], create=False)
    w = artifact_cache_bytes(reg, mm_registry["v1"])
    root = reg.artifact_path(mm_registry["v1"])
    assert w == sum(os.path.getsize(os.path.join(d, f))
                    for d, _s, fs in os.walk(root) for f in fs) > 0
    assert artifact_cache_bytes(reg, "v999") == 0


# -- PlacementPlanner ---------------------------------------------------------

def test_placement_replicates_and_is_deterministic():
    planner = PlacementPlanner(replication=2)
    _kw, models, insts = PLAN_CASES["replicated"]
    plan = planner.plan(models, insts)
    for m in ("a", "b", "c"):
        assert len(plan.hosts(m)) == 2, plan.assignments
    again = PlacementPlanner(replication=2).plan(models, insts)
    assert again.assignments == plan.assignments
    assert plan.rev == 1 and planner.plan(models, insts).rev == 2


def test_placement_capacity_is_the_harmonic_blend():
    _kw, models, insts = PLAN_CASES["harmonic"]
    plan = PlacementPlanner(replication=1).plan(models, insts)
    assert plan.replica_capacity("only") == pytest.approx(1600.0)
    assert plan.mean_capacity() == pytest.approx(1600.0)
    doc = plan.to_json()
    assert doc["assignments"]["only"] == ["fast", "slow"]
    assert doc["model_rows_s"]["slow"] == 1000.0


def test_placement_respects_cache_budget_headroom():
    kw, models, insts = PLAN_CASES["budget"]
    plan = PlacementPlanner(**kw).plan(models, insts)
    assert max(plan.pressure_bytes.values()) <= 250
    assert sorted(plan.hosts("big") + plan.hosts("mid")) == [
        "replica-0", "replica-1"]


def test_placement_refuses_an_empty_fleet():
    with pytest.raises(ValueError):
        PlacementPlanner().plan([{"model_id": "a"}], [])


# -- ModelTable ------------------------------------------------------------------

def test_table_eviction_and_rehydration_counters_exact(mm_registry):
    table = _table(mm_registry, max_resident=1, evict_min_interval_s=0.0)
    records = mm_registry["records"][:8]
    table.host("alpha", mm_registry["v1"])
    table.host("beta", mm_registry["v2"])
    rows = {r["model_id"]: r for r in table.rows()}
    assert rows["beta"]["resident"] and not rows["alpha"]["resident"]
    assert table.evictions == 1 and table.rehydrations == 0
    results, info = table.score("alpha", records)
    assert len(results) == 8 and info["model_id"] == "alpha"
    assert info["cold_hit"] is True and info["rehydrate_ms"] > 0
    assert table.rehydrations == 1 and table.cold_hits == 1
    snap = table.snapshot()
    assert snap["rehydrate_ms"]["p99"] is not None
    assert snap["cold_hit_ms"]["p99"] is not None
    rows = {r["model_id"]: r for r in table.rows()}
    assert rows["alpha"]["resident"] and not rows["beta"]["resident"]
    _results, info = table.score("alpha", records)
    assert "cold_hit" not in info
    assert table.cold_hits == 1


def test_table_unknown_model_is_loud(mm_registry):
    table = _table(mm_registry)
    table.host("alpha", mm_registry["v1"])
    with pytest.raises(UnknownModelError):
        table.score("ghost", mm_registry["records"][:4])
    assert table.unknown_model_errors == 1


def test_table_canary_pins_model_against_eviction(mm_registry):
    table = _table(mm_registry, max_resident=1, evict_min_interval_s=0.0)
    table.host("alpha", mm_registry["v1"])
    table.start_canary("alpha", mm_registry["v3"], fraction=0.5)
    table.host("beta", mm_registry["v2"])
    rows = {r["model_id"]: r for r in table.rows()}
    assert rows["alpha"]["resident"]
    assert rows["alpha"]["canary_version"] == mm_registry["v3"]
    assert table.evictions == 0
    with pytest.raises(MultiModelError):
        table.unhost("alpha")
    gen = table.promote_canary("alpha")
    assert gen.version == mm_registry["v3"]
    rows = {r["model_id"]: r for r in table.rows()}
    assert rows["alpha"]["version"] == mm_registry["v3"]
    table.host("beta", mm_registry["v2"])
    assert table.evictions >= 1


def test_evict_storm_fault_is_rate_bounded(mm_registry):
    """``fleet.model_evict_storm`` demands an eviction on every cache
    decision; the rate bound absorbs the storm into denied-eviction
    counters instead of thrashing the resident models."""
    table = _table(mm_registry, evict_min_interval_s=60.0)
    records = mm_registry["records"][:4]
    table.host("alpha", mm_registry["v1"])
    table.host("beta", mm_registry["v2"])
    evictions_before = table.evictions
    faults.configure("fleet.model_evict_storm:every=1")
    try:
        for _ in range(4):
            r1, _ = table.score("alpha", records)
            r2, _ = table.score("beta", records)
            assert len(r1) == 4 and len(r2) == 4
    finally:
        faults.reset()
    assert table.evictions - evictions_before <= 1
    assert table.evictions_denied >= 3


# -- the router: per-model dispatch, hosting fold, quotas --------------------

def _fake_router(model_quotas=None):
    from transmogrifai_tpu_torch.fleet.channel import FleetChannel
    from transmogrifai_tpu_torch.fleet.router import ReplicaHandle

    router = FleetRouter(start=False, model_quotas=model_quotas)
    socks = []
    for i in range(2):
        a, b = socket.socketpair(socket.AF_UNIX, socket.SOCK_STREAM)
        socks.append(b)
        router._handles[f"replica-{i}"] = ReplicaHandle(
            f"replica-{i}", FleetChannel(a))
    return router, socks


def test_router_dispatch_filters_on_hosting():
    router, _socks = _fake_router()
    try:
        router.set_hosting({"replica-0": ["alpha"],
                            "replica-1": ["beta"]})
        assert router.hosting_map() == {"replica-0": ["alpha"],
                                        "replica-1": ["beta"]}
        h = router._pick(8, model_id="beta")
        assert h is not None and h.instance == "replica-1"
        assert router._pick(8, model_id="alpha").instance == "replica-0"
        assert router._pick(8) is not None
    finally:
        router.close()


def test_router_unhosted_model_sheds_loudly():
    router, _socks = _fake_router()
    try:
        router.set_hosting({"replica-0": ["alpha"], "replica-1": []})
        with pytest.raises(UnhostedModelError):
            router.submit(records=[{"a": 1.0}], model_id="ghost")
        assert router.snapshot()["unhosted_model_errors"] == 1
    finally:
        router.close()


def test_router_per_model_quota_bounds_in_flight_rows():
    router, _socks = _fake_router(model_quotas={"alpha": 8})
    try:
        router.set_hosting({"replica-0": ["alpha", "beta"],
                            "replica-1": ["alpha", "beta"]})
        records = [{"a": float(i)} for i in range(6)]
        router.submit(records=records, model_id="alpha")
        with pytest.raises(ModelQuotaError):
            router.submit(records=records, model_id="alpha")
        router.submit(records=records, model_id="beta")
        assert router.snapshot()["shed_model_quota"] == 1
    finally:
        router.close()


def test_refresh_from_shards_folds_hosting_from_replica_view():
    router, _socks = _fake_router()
    try:
        docs = [
            {"instance": "replica-0",
             "views": {
                 "serving/0": {"batch_rows_per_s": 1000.0,
                               "latency_ms": {"p99": 4.0},
                               "queue_depth": {}, "rows_scored": 10},
                 "fleet_replica/0": {
                     "models": [{"model_id": "alpha"},
                                {"model_id": "gamma"}]},
             }},
        ]
        router.refresh_from_shards(docs)
        h = router._handles["replica-0"]
        assert h.hosted_models == {"alpha", "gamma"}
    finally:
        router.close()


def test_prometheus_exposition_carries_model_id_label():
    from transmogrifai_tpu_torch.obs import prometheus_text_from_json
    from transmogrifai_tpu_torch.serving import ServingTelemetry

    tel = ServingTelemetry()
    tel.set_model_id("alpha")
    tel.record_batch(8, 8, 0.002)
    doc = {"views": {"serving/0": tel.snapshot()}, "series": {}}
    text = prometheus_text_from_json(doc)
    lines = [ln for ln in text.splitlines()
             if "rows_scored" in ln and not ln.startswith("#")]
    assert lines and all('model_id="alpha"' in ln for ln in lines)


# -- model-multiplexed fleets of port workers --------------------------------

def test_multimodel_fleet_dispatch_quota_and_status(mm_registry,
                                                    tmp_path):
    records = mm_registry["records"]
    models = {"alpha": mm_registry["v1"], "beta": mm_registry["v2"]}
    with _controller(
            mm_registry, tmp_path, 2, models=models,
            router_kw={"model_quotas": {"beta": 4096}}) as fc:
        assert fc.placement is not None and fc.placement.rev >= 1
        assert sorted(fc.model_hosts("alpha")) == sorted(
            fc.model_hosts("beta"))
        out_a = fc.router.score_batch(records[:24], model_id="alpha")
        out_b = fc.router.score_batch(records[:16], model_id="beta")
        assert len(out_a) == 24 and len(out_b) == 16
        assert all(isinstance(r, dict) for r in out_a + out_b)
        with pytest.raises(UnhostedModelError):
            fc.router.score_batch(records[:4], model_id="ghost")
        status = _wait_status(fc, lambda d: (
            d.get("models", {}).get("alpha", {}).get("rows_scored") == 24
            and len(d["models"]["alpha"].get("hosts", [])) == 2))
        rows = status["models"]
        assert set(rows) == {"alpha", "beta"}
        assert rows["alpha"]["version"] == mm_registry["v1"]
        assert rows["alpha"]["rows_delivered"] == 24
        assert rows["beta"]["rows_delivered"] == 16
        assert len(rows["alpha"]["hosts"]) == 2
        assert status["placement"]["rev"] == fc.placement.rev
        assert status["router"]["rows_by_model"] == {
            "alpha": 24, "beta": 16}
        assert rows["alpha"]["rows_scored"] == 24
        fc._write_status()
        doc = json.load(open(os.path.join(
            fc.control_dir, "fleet_status.json")))
        assert set(doc["models"]) == {"alpha", "beta"}


def test_concurrent_canaries_one_promotes_one_rolls_back(mm_registry,
                                                         tmp_path):
    """Two hosted models run independent canary lifecycles at once:
    alpha's canary promotes while beta's rolls back, with zero dropped
    rows on either model throughout."""
    records = mm_registry["records"]
    models = {"alpha": mm_registry["v1"], "beta": mm_registry["v2"]}
    with _controller(mm_registry, tmp_path, 2, models=models) as fc:
        fc.start_model_canary("alpha", mm_registry["v3"], fraction=0.5)
        fc.start_model_canary("beta", mm_registry["v3"], fraction=0.5)
        assert fc.model_canaries == {"alpha": mm_registry["v3"],
                                     "beta": mm_registry["v3"]}
        for _ in range(3):
            assert len(fc.router.score_batch(
                records[:16], model_id="alpha")) == 16
            assert len(fc.router.score_batch(
                records[:16], model_id="beta")) == 16
        fc.promote_model_canary("alpha")
        fc.rollback_model_canary("beta", reason="drill")
        assert fc.models["alpha"] == mm_registry["v3"]
        assert fc.models["beta"] == mm_registry["v2"]
        assert fc.model_canaries == {}
        out_a = fc.router.score_batch(records[:8], model_id="alpha")
        out_b = fc.router.score_batch(records[:8], model_id="beta")
        assert len(out_a) == 8 and len(out_b) == 8
        rows = _wait_status(fc, lambda d: (
            d.get("models", {}).get("alpha", {}).get("version")
            == mm_registry["v3"]))["models"]
        assert rows["alpha"]["version"] == mm_registry["v3"]
        assert rows["beta"]["version"] == mm_registry["v2"]
        assert rows["alpha"]["canary_version"] is None
        assert rows["beta"]["canary_version"] is None


def test_scale_up_replans_placement_and_hosts_on_new_replica(
        mm_registry, tmp_path):
    records = mm_registry["records"]
    models = {"alpha": mm_registry["v1"], "beta": mm_registry["v2"]}
    with _controller(mm_registry, tmp_path, 1, models=models) as fc:
        rev0 = fc.placement.rev
        assert fc.model_hosts("alpha") == ["replica-0"]
        inst = fc.add_replica()
        assert fc.placement.rev > rev0
        assert inst in fc.placement.assignments
        doc = fc.router.control(inst, "models", timeout_s=60.0)
        hosted = {r["model_id"] for r in doc["table"]["models"]}
        assert hosted == set(fc.placement.models_for(inst))
        assert len(fc.router.score_batch(records[:16],
                                         model_id="alpha")) == 16
