"""The model registry and deployment control of the torch package.

``registry/`` (the versioned ``ModelRegistry``, the
``DeploymentController``'s hot swap, canary split, shadow and rollback,
the ``RollbackPolicy``) is held on the CPU:

* the JAX package's registry contracts (its tests/test_registry.py),
  run on the torch package with ``device="cpu"`` models: publish and the
  checksummed index with its ``.last-good`` recovery, the stage machine,
  the ``registry.publish_crash`` kill drill in a child process (with
  ``sys.modules["jax"] = None``), hot swaps under concurrent scoring
  threads, the canary split, shadow scoring, the ``canary.regression``
  and ``canary.latency`` rollbacks, lineage;
* against the JAX package: ``route_key`` and the canary assignment equal
  record for record; ``RollbackPolicy`` decisions equal on the same
  evidence; the same publish / promote / canary / rollback sequence gives
  equal ``describe()`` and lineage documents apart from timestamps,
  content hashes and the root path;
* device faults: a ``KernelError`` or ``torch.AcceleratorError`` raised
  by the canary arm or the shadow escapes, with no re-score on stable;
* the path-valued fleet view reads the published status torn-safe.

Left out: the JAX package's registry CLI tests (``cli.py`` waits for
ROADMAP item 12).
"""
import gc
import json
import os
import subprocess
import sys
import threading
import time

import pytest
import torch

from torch_parity import (
    PORT,
    REF,
    mod,
    reset_uids,
    strip_volatile,
    tiny_pipeline,
)

from transmogrifai_tpu_torch.faults import injection as faults
from transmogrifai_tpu_torch.faults.injection import InjectedFault
from transmogrifai_tpu_torch.parallel.kernels import KernelError
from transmogrifai_tpu_torch.testkit.drills import (
    REGISTRY_CRASH_PUBLISHER_TEMPLATE,
)
from transmogrifai_tpu_torch.registry import (
    DeploymentController,
    ModelRegistry,
    RegistryError,
    RegistryIntegrityError,
    RollbackPolicy,
    route_key,
)
from transmogrifai_tpu_torch.serving import RowScoringError, ServingTelemetry

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

DEVICE_FAULTS = [
    pytest.param(lambda: KernelError("bin_matrix kernel launch failed: "
                                     "CUDA error 700"), id="KernelError"),
    pytest.param(lambda: torch.AcceleratorError(
        "CUDA error: an illegal memory access was encountered"),
        id="AcceleratorError"),
]


@pytest.fixture(autouse=True)
def _disarm():
    faults.reset()
    yield
    faults.reset()


def _trained():
    reset_uids(PORT)
    wf, _data, records, name = tiny_pipeline(PORT)
    return wf.train(), records, name


def _trained_variant(seed: int = 1):
    """A second model whose feature names match the first pipeline's (uids
    reset: the registry serves versions of one workflow definition)."""
    reset_uids(PORT)
    return tiny_pipeline(PORT, seed=seed)[0].train()


def _fresh_workflow():
    reset_uids(PORT)
    return tiny_pipeline(PORT)[0]


# -- ModelRegistry: publish, index, verify ------------------------------------------

def test_publish_records_content_address_and_lineage(tmp_path):
    model, _records, _name = _trained()
    reg = ModelRegistry(str(tmp_path / "reg"))
    v1 = reg.publish(model, metrics={"auroc": 0.91})
    assert v1.version == "v1" and v1.stage == "candidate"
    assert len(v1.manifest_sha256) == 64
    assert v1.schema_sha256 is not None
    assert v1.metrics == {"auroc": 0.91}
    assert v1.parent is None
    reg.promote("v1", to="stable")
    v2 = reg.publish(model)
    assert v2.version == "v2" and v2.parent == "v1"
    assert [e["event"] for e in reg.lineage()] == ["publish", "promote",
                                                   "publish"]
    assert [v.version for v in reg.versions()] == ["v1", "v2"]
    with pytest.raises(RegistryError, match="v9"):
        reg.get("v9")


def test_registry_index_recovers_from_last_good(tmp_path):
    model, _records, _name = _trained()
    root = str(tmp_path / "reg")
    reg = ModelRegistry(root)
    reg.publish(model)
    reg.promote("v1", to="stable")
    with open(os.path.join(root, "registry.json"), "r+b") as f:
        f.seek(10)
        f.write(b"XXXX")
    reg2 = ModelRegistry(root, create=False)
    report = reg2.verify()
    assert report["recovered_from_last_good"]
    assert not report["index_ok"] and not report["ok"]
    assert "v1" in {v.version for v in reg2.versions()}
    reg2.publish(model)
    report = reg2.verify()
    assert report["index_ok"] and report["ok"]
    assert "v2" in {v.version for v in reg2.versions()}


def test_registry_index_both_damaged_is_loud(tmp_path):
    model, _records, _name = _trained()
    root = str(tmp_path / "reg")
    reg = ModelRegistry(root)
    reg.publish(model)
    reg.promote("v1", to="stable")
    for name in ("registry.json", "registry.json.last-good"):
        with open(os.path.join(root, name), "w") as f:
            f.write("{not json")
    with pytest.raises(RegistryIntegrityError, match="last-good"):
        ModelRegistry(root, create=False).versions()


def test_verify_reports_tamper_and_orphans(tmp_path):
    model, _records, _name = _trained()
    root = str(tmp_path / "reg")
    reg = ModelRegistry(root)
    reg.publish(model)
    os.makedirs(os.path.join(root, "versions", "v99", "junk"))
    with open(os.path.join(root, "versions", "v1", "arrays.npz"), "r+b") as f:
        f.seek(30)
        f.write(b"\x00\x00\x00\x00")
    report = reg.verify()
    assert not report["ok"]
    assert "checksum" in report["versions"]["v1"]
    assert os.path.join("versions", "v99") in report["orphans"]
    # the port's artifacts carry no compiled executables to go stale
    assert report["stale_executables"] == {}


def test_load_verifies_the_registered_content_address(tmp_path):
    model, records, _name = _trained()
    root = str(tmp_path / "reg")
    reg = ModelRegistry(root)
    reg.publish(model)
    loaded = reg.load("v1", _fresh_workflow())
    assert loaded.schema_contract is not None
    scored = loaded.score_function()(dict(records[0]))
    assert loaded.result_features[0].name in scored
    from transmogrifai_tpu_torch.serialization.model_io import save_model

    save_model(_trained_variant(), os.path.join(root, "versions", "v1"))
    with pytest.raises(RegistryIntegrityError, match="manifest"):
        reg.load("v1", _fresh_workflow())


# -- the stage machine ----------------------------------------------------------------

def test_stage_machine_and_invalid_transitions(tmp_path):
    model, _records, _name = _trained()
    reg = ModelRegistry(str(tmp_path / "reg"))
    reg.publish(model)
    reg.publish(model)
    reg.promote("v1", to="stable")
    reg.promote("v2", to="canary")
    assert reg.stable == "v1" and reg.canary == "v2"
    reg.publish(model)
    with pytest.raises(RegistryError, match="canary slot"):
        reg.promote("v3", to="canary")
    reg.promote("v2", to="stable")
    assert reg.stable == "v2" and reg.canary is None
    assert reg.get("v1").stage == "retired"
    with pytest.raises(RegistryError, match="retired"):
        reg.promote("v1", to="stable")


def test_rollback_stable_reverts_to_parent(tmp_path):
    model, _records, _name = _trained()
    reg = ModelRegistry(str(tmp_path / "reg"))
    reg.publish(model)
    reg.promote("v1", to="stable")
    reg.publish(model)
    reg.promote("v2", to="stable")
    event = reg.rollback(reason="bad release")
    assert event["version"] == "v2"
    assert event["stable_reverted_to"] == "v1"
    assert reg.stable == "v1"
    assert reg.get("v2").stage == "rolled_back"
    assert reg.get("v1").stage == "stable"
    with pytest.raises(RegistryError, match="no parent"):
        reg.rollback()


def test_publish_directly_into_a_stage(tmp_path):
    model, _records, _name = _trained()
    reg = ModelRegistry(str(tmp_path / "reg"))
    v1 = reg.publish(model, stage="stable")
    assert v1.stage == "stable" and reg.stable == "v1"
    v2 = reg.publish(model, stage="canary")
    assert v2.stage == "canary" and reg.canary == "v2"
    with pytest.raises(RegistryError, match="retired"):
        reg.publish(model, stage="retired")


def test_orphaned_version_ids_are_never_reissued(tmp_path):
    model, _records, _name = _trained()
    root = str(tmp_path / "reg")
    reg = ModelRegistry(root)
    reg.publish(model)
    os.makedirs(os.path.join(root, "versions", "v2"))
    assert reg.publish(model).version == "v3"
    assert os.path.join("versions", "v2") in reg.verify()["orphans"]


def test_rollback_never_reinstates_a_rolled_back_parent(tmp_path):
    model, _records, _name = _trained()
    reg = ModelRegistry(str(tmp_path / "reg"))
    reg.publish(model)
    reg.promote("v1", to="stable")
    reg.publish(model)
    reg.promote("v2", to="stable")
    reg.rollback(version="v1", reason="v1 is bad too")
    with pytest.raises(RegistryError, match="rolled_back"):
        reg.rollback(reason="v2 regressed")
    assert reg.stable == "v2"


def test_versions_listing_tolerates_non_canonical_ids(tmp_path):
    model, _records, _name = _trained()
    reg = ModelRegistry(str(tmp_path / "reg"))
    reg.publish(model)
    with reg._exclusive():
        doc = reg._read()
        doc["versions"]["legacy-2024"] = dict(doc["versions"]["v1"],
                                              version="legacy-2024")
        reg._commit(doc)
    assert [v.version for v in reg.versions()] == ["v1", "legacy-2024"]
    assert reg.publish(model).version == "v2"


def test_publish_attributes_process_telemetry(tmp_path):
    from transmogrifai_tpu_torch.parallel.resilience import mesh_telemetry
    from transmogrifai_tpu_torch.schema.quarantine import data_telemetry

    model, _records, _name = _trained()
    v1 = ModelRegistry(str(tmp_path / "reg")).publish(model)
    assert data_telemetry().snapshot()["model_version"] == v1.version
    assert mesh_telemetry().snapshot()["model_version"] == v1.version


def test_rollback_empty_registry_is_loud(tmp_path):
    with pytest.raises(RegistryError, match="nothing to roll back"):
        ModelRegistry(str(tmp_path / "reg")).rollback()


def test_release_canary_frees_the_slot_without_judgement(tmp_path):
    model, _records, _name = _trained()
    reg = ModelRegistry(str(tmp_path / "reg"))
    reg.publish(model, stage="stable")
    reg.publish(model, stage="canary")
    event = reg.release_canary(reason="run ended")
    assert event["version"] == "v2"
    assert reg.canary is None
    assert reg.get("v2").stage == "candidate"
    assert reg.lineage()[-1]["event"] == "canary_release"
    reg.promote("v2", to="canary")
    assert reg.canary == "v2"
    reg.release_canary()
    assert reg.release_canary() is None


def test_describe_is_one_consistent_view(tmp_path):
    model, _records, _name = _trained()
    reg = ModelRegistry(str(tmp_path / "reg"))
    reg.publish(model, stage="stable")
    doc = reg.describe(lineage=True)
    assert doc["stable"] == "v1" and doc["canary"] is None
    assert [v["version"] for v in doc["versions"]] == ["v1"]
    assert [e["event"] for e in doc["lineage"]] == ["publish", "promote"]


# -- the publish crash window (registry.publish_crash) -------------------------------

#: the publish-crash child: the port's testkit template
PUBLISH_CRASHER = REGISTRY_CRASH_PUBLISHER_TEMPLATE

def test_publish_crash_leaves_registry_at_prior_version(tmp_path):
    root = str(tmp_path / "reg")
    script = tmp_path / "publisher.py"
    script.write_text(PUBLISH_CRASHER.format(
        repo=REPO, tests=os.path.join(REPO, "tests"), root=root,
        fault="registry.publish_crash:on=1"))
    env = dict(os.environ)
    env.pop("TX_FAULTS", None)
    proc = subprocess.run([sys.executable, str(script)], env=env,
                          timeout=300)
    assert proc.returncode == faults.DEFAULT_KILL_EXIT  # really crashed
    reg = ModelRegistry(root, create=False)
    assert [v.version for v in reg.versions()] == ["v1"]
    assert reg.stable == "v1"
    report = reg.verify()
    assert report["versions"]["v1"] is None
    assert any("v2" in o for o in report["orphans"])
    assert reg.load_stable(_fresh_workflow()).schema_contract is not None


# -- DeploymentController: hot swap ----------------------------------------------------

def test_hot_swap_serves_without_interruption():
    model, records, name = _trained()
    ctl = DeploymentController(batch_buckets=(1, 8))
    ctl.deploy(model, version="v1")
    out1 = ctl.score_batch(records[:8])
    assert len(out1) == 8 and all(name in r for r in out1)
    gen2 = ctl.deploy(_trained_variant(), version="v2")
    assert gen2.generation == 2
    out2 = ctl.score_batch(records[:8])
    assert len(out2) == 8 and all(name in r for r in out2)
    swaps = [e for e in ctl.events() if e["event"] == "swap"]
    assert len(swaps) == 2
    assert swaps[1]["from_version"] == "v1"
    assert swaps[1]["flip_us"] < 1e6
    snap = gen2.endpoint.telemetry.snapshot()
    assert snap["model_version"] == "v2" and snap["generation"] == 2


def test_swap_crash_leaves_old_generation_serving():
    model, records, name = _trained()
    ctl = DeploymentController(batch_buckets=(1, 8))
    ctl.deploy(model, version="v1")
    model2 = _trained_variant()
    faults.configure("registry.swap_crash:on=1")
    with pytest.raises(InjectedFault):
        ctl.deploy(model2, version="v2")
    faults.reset()
    gen = ctl.stable_generation
    assert gen.version == "v1" and gen.generation == 1
    assert all(name in r for r in ctl.score_batch(records[:4]))
    assert ctl.deploy(model2, version="v2").generation == 2


def test_concurrent_scoring_through_hot_swaps_drops_nothing():
    """Threads score continuously while the main thread hot-swaps twice:
    every batch returns exactly its own results, each call observes one
    stable generation, and every row lands in exactly one generation's
    request accounting."""
    model, records, name = _trained()
    variants = [_trained_variant(seed=s) for s in (1, 2)]
    ctl = DeploymentController(batch_buckets=(1, 8))
    generations = [ctl.deploy(model, version="v1")]
    stop = threading.Event()
    failures: list = []
    counts = {"batches": 0, "rows": 0}
    lock = threading.Lock()

    def pump(tid: int):
        i = 0
        while not stop.is_set():
            batch = [dict(records[(i + j + tid) % len(records)])
                     for j in range(4)]
            try:
                out, info = ctl.score_batch_with_info(batch)
            except Exception as e:  # noqa: BLE001 - the invariant under test
                failures.append(f"t{tid}: {type(e).__name__}: {e}")
                return
            if len(out) != len(batch) or any(
                    isinstance(r, RowScoringError) or name not in r
                    for r in out):
                failures.append(f"t{tid}: bad batch {out[:2]}")
                return
            if info["stable_generation"] not in (1, 2, 3):
                failures.append(f"t{tid}: unknown generation {info}")
                return
            with lock:
                counts["batches"] += 1
                counts["rows"] += len(out)
            i += 4

    threads = [threading.Thread(target=pump, args=(t,)) for t in range(3)]
    for t in threads:
        t.start()
    try:
        for m, version in zip(variants, ("v2", "v3")):
            time.sleep(0.15)
            generations.append(ctl.deploy(m, version=version))
    finally:
        time.sleep(0.15)
        stop.set()
        for t in threads:
            t.join(30)
    assert not failures, failures[:3]
    assert counts["batches"] > 0
    assert len([e for e in ctl.events() if e["event"] == "swap"]) == 3
    assert sum(g.endpoint.telemetry.snapshot()["rows_scored"]
               for g in generations) == counts["rows"]


def test_canary_arm_failure_never_fails_stable_rows():
    model, records, _name = _trained()
    ctl = DeploymentController(batch_buckets=(1, 8), canary_fraction=0.5,
                               check_every_batches=1000)
    ctl.deploy(model, version="v1")
    canary_gen = ctl.start_canary(_trained_variant(), version="v2")

    def boom(records):
        raise RuntimeError("canary endpoint defect")

    canary_gen.endpoint.score_batch = boom
    out, info = ctl.score_batch_with_info(records[:16])
    assert len(out) == 16
    assert not any(isinstance(r, RowScoringError) for r in out)
    assert info["canary_rows"] > 0
    snap = canary_gen.endpoint.telemetry.snapshot()
    assert snap["rows_failed"] == info["canary_rows"]


def test_deploy_version_rejects_ineligible_stage_without_swapping(tmp_path):
    model, _records, _name = _trained()
    reg = ModelRegistry(str(tmp_path / "reg"))
    reg.publish(model)
    reg.promote("v1", to="stable")
    reg.publish(model)
    reg.promote("v2", to="stable")
    ctl = DeploymentController(registry=reg, batch_buckets=(1, 8))
    ctl.deploy_version("v2", _fresh_workflow())
    with pytest.raises(RegistryError, match="retired"):
        ctl.deploy_version("v1", _fresh_workflow())
    assert ctl.stable_generation.version == "v2"
    assert reg.stable == "v2"


def test_start_canary_validates_before_building():
    model, _records, _name = _trained()
    ctl = DeploymentController(batch_buckets=(1, 8))
    ctl.deploy(model, version="v1")
    with pytest.raises(ValueError, match="fraction"):
        ctl.start_canary(model, version="v2", fraction=1.5)
    assert ctl.canary_generation is None
    assert ctl.start_canary(model, version="v2", fraction=0.5).generation == 2


# -- canary routing, shadow, rollback ----------------------------------------------------

def test_canary_split_is_deterministic_and_proportional():
    model, records, _name = _trained()
    ctl = DeploymentController(batch_buckets=(1, 8), canary_fraction=0.3)
    ctl.deploy(model, version="v1")
    routes = [ctl.routes_to_canary(r) for r in records]
    assert routes == [ctl.routes_to_canary(r) for r in records]
    assert 0.05 < sum(routes) / len(routes) < 0.6
    assert not any(ctl.routes_to_canary(r, fraction=0.0) for r in records)
    assert all(ctl.routes_to_canary(r, fraction=1.0) for r in records)


def test_canary_scores_its_share_and_promotes():
    model, records, name = _trained()
    ctl = DeploymentController(batch_buckets=(1, 8), canary_fraction=0.5,
                               check_every_batches=1000)
    ctl.deploy(model, version="v1")
    ctl.start_canary(_trained_variant(), version="v2")
    out, info = ctl.score_batch_with_info(records[:32])
    assert len(out) == 32 and all(name in r for r in out)
    assert 0 < info["canary_rows"] < 32
    c_snap = ctl.canary_generation.endpoint.telemetry.snapshot()
    assert c_snap["rows_scored"] == info["canary_rows"]
    assert c_snap["model_version"] == "v2"
    promoted = ctl.promote_canary()
    assert ctl.stable_generation is promoted
    assert ctl.canary_generation is None


def test_shadow_scoring_never_touches_responses():
    model, records, _name = _trained()
    ctl = DeploymentController(batch_buckets=(1, 8), check_every_batches=1000)
    ctl.deploy(model, version="v1")
    baseline = ctl.score_batch(records[:16])
    ctl.start_canary(_trained_variant(), version="v2", shadow=True)
    shadowed, info = ctl.score_batch_with_info(records[:16])
    assert shadowed == baseline
    assert info["shadow_rows"] == 16
    stats = ctl.shadow_stats()
    assert stats["rows"] == 16
    assert stats["rows_differed"] > 0
    assert stats["max_abs_delta"] > 0


def test_canary_regression_fault_triggers_auto_rollback():
    model, records, _name = _trained()
    ctl = DeploymentController(batch_buckets=(1, 8), canary_fraction=0.5,
                               policy=RollbackPolicy(min_canary_rows=8),
                               check_every_batches=1)
    ctl.deploy(model, version="v1")
    canary_gen = ctl.start_canary(_trained_variant(), version="v2")
    faults.configure("canary.regression:every=1")
    try:
        for _ in range(8):
            ctl.score_batch(records[:16])
            if ctl.canary_generation is None:
                break
    finally:
        faults.reset()
    assert ctl.canary_generation is None
    rollbacks = [e for e in ctl.events() if e["event"] == "rollback"]
    assert len(rollbacks) == 1
    assert "nonfinite_rows" in {r["signal"] for r in rollbacks[0]["reasons"]}
    assert rollbacks[0]["evidence"]["canary"]["breaker"]["rows_nonfinite"] > 0
    snap = canary_gen.endpoint.telemetry.snapshot()
    assert any(e["event"] == "rollback" for e in snap["lifecycle"])
    out = ctl.score_batch(records[:8])
    assert not any(isinstance(r, RowScoringError) for r in out)


def test_canary_latency_fault_trips_the_latency_slo():
    model, records, _name = _trained()
    ctl = DeploymentController(
        batch_buckets=(1, 8), canary_fraction=0.5,
        policy=RollbackPolicy(min_canary_rows=8, max_latency_ratio=3.0,
                              max_breaker_opens=None,
                              max_nonfinite_rows=None,
                              max_failed_ratio=None),
        check_every_batches=1)
    ctl.deploy(model, version="v1")
    ctl.start_canary(_trained_variant(), version="v2")
    # the earlier tests' retired generations are collected here, not in
    # the middle of one arm's timed window (a ~1 ms batch wall)
    gc.collect()
    for _ in range(4):
        ctl.score_batch(records[:16])
    assert ctl.canary_generation is not None
    faults.configure("canary.latency:every=1:delay=0.25")
    try:
        for _ in range(10):
            ctl.score_batch(records[:16])
            if ctl.canary_generation is None:
                break
    finally:
        faults.reset()
    assert ctl.canary_generation is None
    rollbacks = [e for e in ctl.events() if e["event"] == "rollback"]
    assert {r["signal"] for r in rollbacks[0]["reasons"]} == {
        "p99_latency_ratio"}
    assert rollbacks[0]["reasons"][0]["value"] > 3.0


def test_manual_rollback_and_registry_lineage(tmp_path):
    model, records, _name = _trained()
    reg = ModelRegistry(str(tmp_path / "reg"))
    reg.publish(model)
    reg.promote("v1", to="stable")
    reg.publish(_trained_variant())
    ctl = DeploymentController(registry=reg, batch_buckets=(1, 8))
    wf_a, wf_b = _fresh_workflow(), _fresh_workflow()
    ctl.deploy_version("v1", wf_a)
    ctl.start_canary_version("v2", wf_b, fraction=0.5)
    assert reg.get("v2").stage == "canary"
    ctl.score_batch(records[:16])
    event = ctl.rollback_canary(reason="operator said so")
    assert event["reason"] == "operator said so"
    assert reg.get("v2").stage == "rolled_back"
    assert reg.canary is None
    tail = reg.lineage()[-1]
    assert tail["event"] == "rollback" and tail["version"] == "v2"


def test_all_three_telemetry_tiers_carry_model_version():
    from transmogrifai_tpu_torch.parallel.resilience import MeshTelemetry
    from transmogrifai_tpu_torch.schema.quarantine import DataTelemetry

    for cls in (ServingTelemetry, DataTelemetry, MeshTelemetry):
        t = cls()
        snap = t.snapshot()
        assert snap["model_version"] is None and snap["generation"] is None
        t.set_model_version("v7", generation=3)
        snap = t.snapshot()
        assert snap["model_version"] == "v7", cls.__name__
        assert snap["generation"] == 3, cls.__name__


# -- device faults in the canary arm and the shadow -------------------------------------

@pytest.mark.parametrize("err", DEVICE_FAULTS)
def test_device_fault_escapes_the_canary_arm(err):
    """A device fault in the canary arm is not isolated: it escapes, and
    the canary's rows are not re-scored on stable."""
    model, records, _name = _trained()
    ctl = DeploymentController(batch_buckets=(1, 8), canary_fraction=0.5,
                               check_every_batches=1000)
    stable = ctl.deploy(model, version="v1")
    canary = ctl.start_canary(_trained_variant(), version="v2")

    def boom(batch):
        raise err()

    canary.endpoint.score_batch = boom
    before = stable.endpoint.telemetry.snapshot()["rows_scored"]
    with pytest.raises(type(err())):
        ctl.score_batch(records[:16])
    n_stable = sum(not ctl.routes_to_canary(r) for r in records[:16])
    # only the stable arm's own rows scored on stable: no re-score
    assert stable.endpoint.telemetry.snapshot()["rows_scored"] == (
        before + n_stable)
    assert canary.endpoint.telemetry.snapshot()["rows_failed"] == 0


@pytest.mark.parametrize("err", DEVICE_FAULTS)
def test_device_fault_escapes_the_shadow(err):
    model, records, _name = _trained()
    ctl = DeploymentController(batch_buckets=(1, 8), check_every_batches=1000)
    ctl.deploy(model, version="v1")
    canary = ctl.start_canary(_trained_variant(), version="v2", shadow=True)

    def boom(batch):
        raise err()

    canary.endpoint.score_batch = boom
    with pytest.raises(type(err())):
        ctl.score_batch(records[:8])
    # an ordinary shadow failure is still only logged
    canary.endpoint.score_batch = lambda batch: (_ for _ in ()).throw(
        ValueError("shadow defect"))
    assert len(ctl.score_batch(records[:8])) == 8


def test_ordinary_canary_failure_still_rescores_on_stable():
    """The JAX package's canary isolation is kept for any other error."""
    model, records, _name = _trained()
    ctl = DeploymentController(batch_buckets=(1, 8), canary_fraction=0.5,
                               check_every_batches=1000)
    stable = ctl.deploy(model, version="v1")
    canary = ctl.start_canary(_trained_variant(), version="v2")
    canary.endpoint.score_batch = lambda batch: (_ for _ in ()).throw(
        ValueError("stricter contract"))
    out = ctl.score_batch(records[:16])
    assert not any(isinstance(r, RowScoringError) for r in out)
    assert stable.endpoint.telemetry.snapshot()["rows_scored"] == 16


# -- unported pieces raise ---------------------------------------------------------------

def test_path_valued_fleet_view_raises_naming_item_12(tmp_path):
    """The path-valued fleet view is ported with ``obs/fleet.py``: the
    summary reads the published status document torn-safe (a torn or
    missing one reads as None, never raising), as the reference's."""
    model, _records, _name = _trained()
    ctl = DeploymentController(batch_buckets=(1, 8))
    ctl.deploy(model, version="v1")
    path = tmp_path / "fleet_status.json"
    ctl.fleet_status_source = str(path)
    assert ctl.summary_json()["fleet"] is None
    path.write_text(json.dumps({"replicas": {"r0": {"generation": 2}}}))
    assert ctl.summary_json()["fleet"] == {
        "replicas": {"r0": {"generation": 2}}}
    path.write_text('{"replicas": {"r0": {"gen')
    assert ctl.summary_json()["fleet"] is None
    ctl.fleet_status_source = lambda: {"replicas": {"r0": {"generation": 1}}}
    assert ctl.summary_json()["fleet"] == {
        "replicas": {"r0": {"generation": 1}}}


# -- against the JAX package ----------------------------------------------------------

def _ref_registry():
    return mod(REF, "registry")


def test_route_key_and_canary_assignment_equal_the_reference():
    """``route_key`` and the split decision equal the JAX package's record
    for record (exact), at several fractions and seeds, on records with
    None, strings, ints and floats."""
    ref = _ref_registry()
    _, _, records, _ = tiny_pipeline(PORT, n=400)
    records = records + [{"a": None, "c": None}, {"a": 3, "c": "w"},
                         {"c": "u", "a": -0.0}, {"b": [1, 2], "a": 1e300}]
    assert [route_key(r) for r in records] == [ref.route_key(r)
                                               for r in records]
    for fraction, seed in ((0.05, 42), (0.2, 42), (0.5, 7), (0.999, 1)):
        got = DeploymentController(canary_fraction=fraction, split_seed=seed)
        want = ref.DeploymentController(canary_fraction=fraction,
                                        split_seed=seed)
        assert [got.routes_to_canary(r) for r in records] == [
            want.routes_to_canary(r) for r in records], (fraction, seed)


def _snap(rows_scored, rows_failed=0, p99=5.0, opens=0, nonfinite=0,
          drift=0.0):
    return {"rows_scored": rows_scored, "rows_failed": rows_failed,
            "latency_ms": {"p50": p99 / 2, "p95": p99 * 0.9, "p99": p99},
            "breaker": {"opens": opens, "closes": 0, "probes": 0,
                        "rows_shed": 0, "rows_nonfinite": nonfinite},
            "data_contract": {"drift_js_max": drift},
            "model_version": "v", "generation": 1}


EVIDENCE = [
    (_snap(1000), _snap(10)),
    (_snap(1000), _snap(200, rows_failed=60)),
    (_snap(1000, p99=4.0), _snap(100, p99=20.0)),
    (_snap(1000, p99=4.0), _snap(30, p99=20.0)),
    (_snap(1000), _snap(100, opens=1)),
    (_snap(1000), _snap(5, nonfinite=3)),
    (_snap(1000), _snap(500, drift=0.4)),
    (_snap(1000), _snap(500, drift=0.1, p99=5.5)),
]


@pytest.mark.parametrize("policy_kw", [
    {}, {"min_canary_rows": 8, "max_latency_ratio": 2.0},
    {"max_breaker_opens": None, "max_nonfinite_rows": None,
     "max_failed_ratio": None, "max_drift_js": None},
], ids=["defaults", "tight", "soft_off"])
def test_rollback_decisions_equal_the_reference(policy_kw):
    """``RollbackPolicy.evaluate`` on the same stable/canary evidence
    decides as the JAX package's: the same verdict, reasons and evidence
    (exact)."""
    ref = _ref_registry()
    for stable, canary in EVIDENCE:
        got = RollbackPolicy(**policy_kw).evaluate(stable, canary)
        want = ref.RollbackPolicy(**policy_kw).evaluate(stable, canary)
        assert got.rollback == want.rollback
        assert got.reasons == want.reasons
        assert got.evidence == want.evidence


def _lifecycle(pkg: str, root: str):
    """One publish / promote / canary / rollback / release sequence in
    ``pkg``: the tiny pipeline and a reseeded variant, a canary scored,
    rolled back by the policy under ``canary.regression``, a third
    version canaried and released, the stable rolled back to its parent.
    Returns (describe with lineage, controller summary's event names)."""
    reg_mod = mod(pkg, "registry")
    fl = mod(pkg, "faults.injection")
    reset_uids(pkg)
    wf, _data, records, _ = tiny_pipeline(pkg)
    m1 = wf.train()
    reset_uids(pkg)
    m2 = tiny_pipeline(pkg, seed=1)[0].train()

    def fresh():
        reset_uids(pkg)
        return tiny_pipeline(pkg)[0]

    reg = reg_mod.ModelRegistry(root)
    reg.publish(m1, metrics={"auroc": 0.9})
    reg.promote("v1", to="stable")
    reg.publish(m2, metrics={"auroc": 0.8})
    reg.publish(m2)
    ctl = reg_mod.DeploymentController(
        registry=reg, canary_fraction=0.5, check_every_batches=1,
        batch_buckets=(1, 8), fused_backend="numpy")
    ctl.deploy_version("v1", fresh())
    ctl.start_canary_version("v2", fresh())
    fl.configure("canary.regression:every=1")
    try:
        ctl.score_batch(records[:16])
    finally:
        fl.reset()
    assert ctl.canary_generation is None
    ctl.start_canary_version("v3", fresh(), fraction=0.2)
    ctl.score_batch(records[:16])
    ctl.release_canary(reason="window expired")
    reg.promote("v3", to="stable")
    reg.rollback(reason="v3 regressed")
    events = [e["event"] for e in ctl.summary_json()["events"]]
    return reg.describe(lineage=True), events


def test_registry_lifecycle_documents_equal_the_reference(tmp_path):
    """The same sequence in both packages: ``describe()`` with the
    lineage, and the controller's event log, equal apart from timestamps,
    content hashes and the root path (exact otherwise, the rollback
    evidence's live latencies aside)."""
    got, got_events = _lifecycle(PORT, str(tmp_path / "port"))
    want, want_events = _lifecycle(REF, str(tmp_path / "ref"))
    assert got_events == want_events
    volatile = ("t", "created_at", "updated_at", "checked_at",
                "manifest_sha256", "schema_sha256", "root", "checksum",
                "latency_ms", "evidence")
    assert strip_volatile(got, volatile) == strip_volatile(want, volatile)
    rb_got = [e for e in got["lineage"] if e.get("evidence")]
    rb_want = [e for e in want["lineage"] if e.get("evidence")]
    assert len(rb_got) == len(rb_want) == 1
    ev_got, ev_want = rb_got[0]["evidence"], rb_want[0]["evidence"]
    assert ev_got["rollback"] == ev_want["rollback"] is True
    assert ev_got["reasons"] == ev_want["reasons"]
    for arm in ("stable", "canary"):
        g, w = ev_got["evidence"][arm], ev_want["evidence"][arm]
        for k in ("rows_scored", "rows_failed", "breaker", "drift_js_max",
                  "model_version", "generation"):
            assert g[k] == w[k], (arm, k)
