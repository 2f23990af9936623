"""The chaos-composition drill on the torch package's children.

The JAX package's tests/test_chaos_composition.py, run end to end on
the port: ONE seeded, randomized schedule arms faults from every
subsystem - ``reader.*`` (data plane), ``serving.batch`` (serving),
``io.save_model.crash`` (serialization), ``supervisor.child_kill``
(supervision), ``registry.publish_crash`` + ``canary.regression`` (model
lifecycle), ``continuous.refit_crash`` + ``drift.false_positive``
(continuous training), ``fleet.partition`` + ``channel.corrupt_frame``
+ ``fleet.reconnect_storm`` (fleet transport over a live loopback-TCP
fleet of port workers), ``bulk.output_crash`` +
``bulk.replica_die_midshard`` (exactly-once bulk scoring) and
``autoscaler.crash`` (the capacity control loop) - across one workflow
run on the CPU (``device="cpu"``; every fleet worker and child at one
thread), asserting the reference's global invariants:

* no corrupt artifact is ever loadable;
* no phase hangs past its deadline;
* every injected event is accounted for in telemetry, the fleet's row
  ledger is exact, and the bulk job's double-entry ledger is exact after
  a kill and a resume, with output bytes equal to an uninterrupted run.

Every child is a template of ``transmogrifai_tpu_torch.testkit.drills``.
The bulk kill child loads the parent's saved model (``model_dir``), so
the resuming parent scores with bit-identical weights whatever the
child's thread count.  The schedule is randomized per TX_CHAOS_SEED but
deterministic for a given seed.
"""
import functools
import os
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

from torch_fleet import WORKER_ENV

import transmogrifai_tpu_torch.dsl  # noqa: F401 - feature operators
from transmogrifai_tpu_torch import FeatureBuilder, OpWorkflow
from transmogrifai_tpu_torch.faults import injection as faults
from transmogrifai_tpu_torch.models.logistic_regression import (
    OpLogisticRegression,
)
from transmogrifai_tpu_torch.ops.transmogrifier import transmogrify
from transmogrifai_tpu_torch.readers.csv_reader import CSVReader
from transmogrifai_tpu_torch.schema import reset_data_telemetry
from transmogrifai_tpu_torch.serialization.model_io import (
    load_model,
    verify_artifact,
)
from transmogrifai_tpu_torch.serving import (
    CircuitBreaker,
    RowScoringError,
    ServingTelemetry,
    compile_endpoint,
)
from transmogrifai_tpu_torch.testkit.drills import (
    CRASH_SAVER_TEMPLATE,
    drill_env,
    tiny_drill_pipeline as _tiny_drill_pipeline,
)
from transmogrifai_tpu_torch.testkit.random_data import write_corrupted_csv
from transmogrifai_tpu_torch.types import feature_types as ft
from transmogrifai_tpu_torch.workflow.supervisor import supervise

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: the drill workflows on the CPU (the package's default is the card)
tiny_drill_pipeline = functools.partial(_tiny_drill_pipeline, device="cpu")

#: the fleets' worker factory: each worker sets its own ``--device``
TINY_SPEC = "transmogrifai_tpu_torch.testkit.drills:tiny_drill_pipeline"

#: per-phase wall-clock ceilings (generous: these catch HANGS, not
#: slowness - a wedged collective/reader/endpoint blows way past them)
INGEST_TRAIN_DEADLINE_S = 120.0
CRASH_SAVE_DEADLINE_S = 300.0
SERVE_DEADLINE_S = 60.0
SUPERVISE_DEADLINE_S = 60.0
FLEET_DEADLINE_S = 180.0
BULK_DEADLINE_S = 180.0


def _child_env() -> dict:
    """A drill child's env: no inherited fault plan, one thread."""
    return dict(drill_env(), OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")


def _fleet(root, work_dir, **kw):
    """A port FleetController of CPU workers at one thread each."""
    from transmogrifai_tpu_torch.fleet import FleetController

    kw["worker_env"] = dict(WORKER_ENV, **kw.get("worker_env", {}))
    return FleetController(root, TINY_SPEC, n_replicas=2, transport="tcp",
                           max_restarts=0, work_dir=work_dir,
                           ship_interval_s=0.2, device="cpu", **kw)


@pytest.fixture(autouse=True)
def _disarm():
    faults.reset()
    reset_data_telemetry()
    yield
    faults.reset()


def _reader_workflow(path, reader_errors="quarantine", quarantine=None):
    y = FeatureBuilder(ft.RealNN, "y").as_response()
    a = FeatureBuilder(ft.Real, "a").as_predictor()
    c = FeatureBuilder(ft.PickList, "c").as_predictor()
    vec = transmogrify([a, c])
    pred = OpLogisticRegression(reg_param=0.01).set_input(y, vec).get_output()
    reader = CSVReader(path, errors=reader_errors, quarantine=quarantine)
    wf = (OpWorkflow(device="cpu").set_result_features(pred)
          .set_reader(reader))
    return wf, reader, pred.name


def test_chaos_composition_end_to_end(tmp_path):
    seed = int(os.environ.get("TX_CHAOS_SEED", "1234"))
    rng = np.random.RandomState(seed)
    # ---- the seeded, randomized schedule -------------------------------
    n_rows = 400
    n_flips = int(rng.randint(3, 9))
    n_trunc = int(rng.randint(2, 6))
    malformed_on = int(rng.randint(1, 50))      # rows 0..48
    flip_on = int(rng.randint(50, 100))         # rows 49..98, disjoint
    serving_failures = int(rng.randint(2, 5))
    canary_regression_on = int(rng.randint(1, 4))  # Nth canary batch
    events = {"armed_points": [
        "reader.malformed_row", "reader.type_flip", "serving.batch",
        "io.save_model.crash", "supervisor.child_kill",
        "registry.publish_crash", "canary.regression",
        "continuous.refit_crash", "drift.false_positive",
        "fleet.partition", "channel.corrupt_frame",
        "fleet.reconnect_storm",
        "bulk.output_crash", "bulk.replica_die_midshard",
        "autoscaler.crash",
    ]}
    bulk_kill_shard = int(rng.randint(1, 4))    # which shard's window
    autoscaler_crash_on = int(rng.randint(2, 6))  # Nth control tick

    # ---- phase 1: quarantine ingest (real corruption + injected) → train
    csv_path = str(tmp_path / "chaos.csv")
    truth = write_corrupted_csv(csv_path, n_rows=n_rows,
                                n_type_flips=n_flips,
                                n_truncated=n_trunc, seed=seed)
    wf, reader, pred_name = _reader_workflow(csv_path)
    faults.configure(
        f"reader.malformed_row:on={malformed_on} "
        f"reader.type_flip:on={flip_on}"
    )
    t0 = time.monotonic()
    model = wf.train()
    t_train = time.monotonic() - t0
    faults.reset()
    assert t_train < INGEST_TRAIN_DEADLINE_S, "ingest+train hang"
    injected_rows = {malformed_on - 1, flip_on - 1}
    expected_quarantined = len(set(truth["bad_rows"]) | injected_rows)
    # invariant: every injected + real bad row accounted, exactly once
    assert reader.quarantine.total == expected_quarantined
    events["quarantined"] = reader.quarantine.total
    assert model.schema_contract is not None
    # the contract saw only the CLEANED rows
    assert model.schema_contract.n_rows == n_rows - expected_quarantined

    # clean save of the chaos-trained model: artifact verifies
    model_path = str(tmp_path / "chaos_model")
    model.save(model_path)
    assert verify_artifact(model_path) is None

    # ---- phase 2: crash mid-save in a child → artifact invariant -------
    crash_path = str(tmp_path / "crash_model")
    script = tmp_path / "saver.py"
    script.write_text(CRASH_SAVER_TEMPLATE.format(
        repo=REPO, path=crash_path, fault="io.save_model.crash:on=1"))
    t0 = time.monotonic()
    proc = subprocess.run([sys.executable, str(script)], env=_child_env(),
                          timeout=CRASH_SAVE_DEADLINE_S)
    assert proc.returncode == faults.DEFAULT_KILL_EXIT  # really crashed
    events["crash_save_exit"] = proc.returncode
    # invariant: the pre-crash artifact is intact and loadable, with its
    # schema contract
    assert verify_artifact(crash_path) is None
    wf2, _data, records, _name = tiny_drill_pipeline()
    recovered = load_model(crash_path, wf2)
    assert recovered.schema_contract is not None

    # ---- phase 3: serving under injected batch failures ----------------
    telemetry = ServingTelemetry()
    breaker = CircuitBreaker(failure_threshold=serving_failures,
                             cooldown_s=60.0)
    endpoint = compile_endpoint(recovered, batch_buckets=(4,),
                                telemetry=telemetry, breaker=breaker)
    faults.configure(
        f"serving.batch:every=1:times={serving_failures}")
    t0 = time.monotonic()
    for _ in range(serving_failures):
        out = endpoint.score_batch(records[:2])
        # degraded, not dead: rows still score through the fallback
        assert not any(isinstance(r, RowScoringError) for r in out)
    assert breaker.state == "open"
    shed = endpoint.score_batch(records[:3])
    assert all(isinstance(r, RowScoringError) and r.shed for r in shed)
    t_serve = time.monotonic() - t0
    faults.reset()
    assert t_serve < SERVE_DEADLINE_S, "serving hang"
    snap = telemetry.snapshot()
    # invariant: every injected batch failure accounted in telemetry
    assert snap["rows_fallback"] == 2 * serving_failures
    assert snap["breaker"]["opens"] == 1
    assert snap["breaker"]["rows_shed"] == 3
    events["serving_failures"] = serving_failures

    # ---- phase 4: supervised child killed by injection -----------------
    faults.configure("supervisor.child_kill:on=1")
    t0 = time.monotonic()
    res = supervise(
        [sys.executable, "-c", "import time; time.sleep(0.4)"],
        heartbeat_path=str(tmp_path / "hb"),
        stale_after_s=60.0, grace_s=60.0, max_restarts=1, poll_s=0.05,
        env=_child_env(), backoff_base_s=0.05, backoff_jitter=0.0,
    )
    t_sup = time.monotonic() - t0
    faults.reset()
    assert t_sup < SUPERVISE_DEADLINE_S, "supervision hang"
    # invariant: the injected kill is accounted in the restart log
    assert res.returncode == 0 and res.attempts == 2
    assert "injected child kill" in res.restarts[0][1]
    events["supervisor_restarts"] = len(res.restarts)

    # ---- phase 5: model lifecycle under injected faults ----------------
    # a crashed registry publish in a child leaves
    # the registry loadable at the prior version, and a poisoned canary
    # auto-rolls-back with the injection accounted in telemetry
    from transmogrifai_tpu_torch.registry import (
        DeploymentController,
        ModelRegistry,
        RollbackPolicy,
    )
    from transmogrifai_tpu_torch.testkit.drills import (
        REGISTRY_CRASH_PUBLISHER_TEMPLATE,
    )

    reg_root = str(tmp_path / "registry")
    reg_script = tmp_path / "publisher.py"
    reg_script.write_text(REGISTRY_CRASH_PUBLISHER_TEMPLATE.format(
        repo=REPO, root=reg_root, fault="registry.publish_crash:on=1"))
    t0 = time.monotonic()
    proc = subprocess.run([sys.executable, str(reg_script)],
                          env=_child_env(), timeout=CRASH_SAVE_DEADLINE_S)
    assert proc.returncode == faults.DEFAULT_KILL_EXIT  # really crashed
    events["registry_crash_exit"] = proc.returncode
    registry = ModelRegistry(reg_root, create=False)
    # invariant: the index never saw the crashed publish — prior version
    # intact, the half-published artifact reported as an orphan
    report = registry.verify()
    assert report["ok"] and report["versions"]["v1"] is None
    assert report["orphans"], "crashed publish left no orphan to report"
    wf5 = tiny_drill_pipeline()[0]
    stable_model = registry.load_stable(wf5)
    controller = DeploymentController(
        registry=registry, canary_fraction=0.5,
        policy=RollbackPolicy(min_canary_rows=4),
        check_every_batches=1, batch_buckets=(4,),
    )
    controller.deploy(stable_model, version="v1")
    # publish the canary candidate THROUGH the registry (v2, parent v1)
    v2 = registry.publish(stable_model, metrics={"drill": True})
    wf6 = tiny_drill_pipeline()[0]
    canary_gen = controller.start_canary_version(v2.version, wf6)
    assert registry.canary == v2.version
    faults.configure(f"canary.regression:on={canary_regression_on}")
    t0 = time.monotonic()
    rolled_back_after = None
    for i in range(canary_regression_on + 3):
        controller.score_batch([dict(r) for r in records[:8]])
        if controller.canary_generation is None:
            rolled_back_after = i + 1
            break
    t_canary = time.monotonic() - t0
    faults.reset()
    assert t_canary < SERVE_DEADLINE_S, "canary control loop hang"
    # invariant: the injected regression is accounted — NaN-guard hits
    # in the canary's telemetry, a rollback event with evidence on the
    # controller, and the demotion in the registry lineage
    assert rolled_back_after is not None
    c_snap = canary_gen.endpoint.telemetry.snapshot()
    assert c_snap["breaker"]["rows_nonfinite"] > 0
    rollbacks = [e for e in controller.events()
                 if e["event"] == "rollback"]
    assert len(rollbacks) == 1
    assert any(r["signal"] == "nonfinite_rows"
               for r in rollbacks[0]["reasons"])
    assert any(e["event"] == "rollback" for e in registry.lineage())
    events["canary_rolled_back_after_batches"] = rolled_back_after

    # ---- phase 6: continuous loop under injected faults ----------------
    # the drift-triggered refit controller takes
    # over the SAME registry the lifecycle drill just exercised: a refit
    # crashed between train and publish leaves the fleet on the old
    # stable and the next cycle recovers organically; then a forced
    # drift false-positive on a healthy window promotes a healthy refit
    # instead of wedging the loop
    from transmogrifai_tpu_torch.continuous import ContinuousTrainer
    from transmogrifai_tpu_torch.testkit.drills import (
        CONTINUOUS_REFIT_CRASH_TEMPLATE,
        continuous_shard_rows,
        continuous_tiny_factory,
        write_shard_csv,
    )

    tiny_factory = functools.partial(continuous_tiny_factory, device="cpu")
    watch = str(tmp_path / "continuous_watch")
    os.makedirs(watch)
    stable_before = registry.stable
    write_shard_csv(os.path.join(watch, "s0000.csv"),
                    continuous_shard_rows(64, seed=seed, shift=3.0))
    crash_script = tmp_path / "refit_crasher.py"
    crash_script.write_text(CONTINUOUS_REFIT_CRASH_TEMPLATE.format(
        repo=REPO, watch=watch, root=reg_root,
        fault="continuous.refit_crash:on=1"))
    t0 = time.monotonic()
    proc = subprocess.run([sys.executable, str(crash_script)],
                          env=_child_env(), timeout=CRASH_SAVE_DEADLINE_S)
    assert proc.returncode == faults.DEFAULT_KILL_EXIT  # really died
    events["refit_crash_exit"] = proc.returncode
    # invariant: the registry never saw the crashed refit
    registry = ModelRegistry(reg_root, create=False)
    assert registry.stable == stable_before
    assert registry.verify()["ok"]
    # next cycle (fresh daemon, same watch dir) recovers end to end:
    # the follower re-offers the shard, detect → refit → promote
    trainer = ContinuousTrainer(
        watch, reg_root, tiny_factory,
        drift_threshold=0.3, consecutive_windows=1, cooldown_windows=0,
        min_window_rows=8, refit_rows=256, train_fused=False)
    cyc = trainer.run_cycle()
    t_cont = time.monotonic() - t0
    assert t_cont < INGEST_TRAIN_DEADLINE_S, "continuous recovery hang"
    assert cyc["verdict"] == "trigger" and cyc["outcome"] == "promote"
    assert registry.stable == cyc["published"] != stable_before
    events["continuous_recovered_version"] = cyc["published"]
    # forced false positive: hysteresis tuned so an organic trigger is
    # impossible (threshold 0.9, three consecutive windows) — only the
    # injected flag fires, and the healthy refit is judged on merit
    forced_trainer = ContinuousTrainer(
        watch, reg_root, tiny_factory,
        drift_threshold=0.9, consecutive_windows=3, cooldown_windows=1,
        min_window_rows=8, refit_rows=256, train_fused=False)
    write_shard_csv(os.path.join(watch, "s0001.csv"),
                    continuous_shard_rows(64, seed=seed + 1, shift=3.0))
    faults.configure("drift.false_positive:on=1")
    cyc2 = forced_trainer.run_cycle()
    faults.reset()
    # invariant: the window itself was healthy — only the forced flag
    # triggered, and it is accounted on the trainer
    assert cyc2["forced"] is True and cyc2["max_js"] < 0.9
    assert cyc2["verdict"] == "trigger" and cyc2["outcome"] == "promote"
    assert forced_trainer.forced_triggers == 1
    assert registry.stable == cyc2["published"] != cyc["published"]
    events["forced_trigger_promoted"] = cyc2["published"]

    # ---- phase 7: fleet transport under network faults -----------------
    # a live loopback-TCP fleet rides out a partition on one
    # replica (silence-detection ejection → failover → probe
    # readmission), then a router-side corrupt frame kills the other
    # replica's channel and the readmission probe rides out a reconnect
    # storm — traffic pumped throughout, the row ledger EXACT
    from transmogrifai_tpu_torch.registry import ModelRegistry as _Reg

    fleet_reg_root = str(tmp_path / "fleet_registry")
    _Reg(fleet_reg_root).publish(recovered, stage="stable")
    t0 = time.monotonic()
    batch = records[:16]
    with _fleet(
        fleet_reg_root, str(tmp_path / "fleet"),
        worker_env_overrides={"replica-1": {
            "TX_FAULTS": "fleet.partition:every=4:times=1:delay=2.5"}},
        router_kw={"max_in_flight_per_replica": 2, "max_queue": 64,
                   "response_timeout_s": 1.5, "eject_after": 1,
                   "probe_interval_s": 0.4, "probe_timeout_s": 0.8},
    ) as fc:
        def _fleet_wait(pred, timeout_s, what):
            deadline = time.monotonic() + timeout_s
            while time.monotonic() <= deadline:
                if pred():
                    return
                time.sleep(0.05)
            raise AssertionError(f"fleet phase hang: {what}")

        fc.router.score_batch(batch, timeout_s=60.0)  # warm
        delivered, fleet_errors, submitted = [], [], [0]
        stop_pump = threading.Event()

        def _pump():
            while not stop_pump.is_set():
                submitted[0] += 1
                try:
                    res = fc.router.submit(records=batch).wait(60.0)
                    delivered.append(res.n_rows)
                except Exception as e:  # noqa: BLE001 - the ledger counts
                    fleet_errors.append(repr(e))

        pumps = [threading.Thread(target=_pump) for _ in range(3)]
        for t in pumps:
            t.start()
        try:
            # replica-1's 4th data send opens the partition window: the
            # router must eject it on response silence while replica-0
            # absorbs the failovers
            _fleet_wait(lambda: fc.router.snapshot()["ejections"] >= 1,
                        30.0, "partition ejection")
        finally:
            stop_pump.set()
            for t in pumps:
                t.join(timeout=120.0)
        _fleet_wait(
            lambda: fc.router.snapshot()["readmissions"] >= 1
            and fc.router.handle("replica-1").health.state == "healthy",
            30.0, "partition readmission")

        # router-side: the NEXT outbound frame goes out corrupt (the
        # worker's CRC check kills the channel), and the readmission
        # probe's first reconnect is storm-dropped
        faults.configure("channel.corrupt_frame:on=1 "
                         "fleet.reconnect_storm:every=1:times=1")
        res = fc.router.submit(records=batch).wait(60.0)
        assert res.n_rows == len(batch)  # failed over, delivered ONCE
        _fleet_wait(lambda: fc.router.snapshot()["readmissions"] >= 2,
                    30.0, "post-storm readmission")
        faults.reset()

        post = fc.router.score_batch(batch, timeout_s=60.0)
        assert len(post) == len(batch)
        snap = fc.router.snapshot()

        # row ledger EXACT: every accepted request answered exactly once
        assert fleet_errors == []
        assert len(delivered) == submitted[0]
        assert sum(delivered) == submitted[0] * len(batch)
        assert snap["rows_ok"] == (submitted[0] + 3) * len(batch)
        assert snap["requests_failed"] == 0

        # every injection accounted in the wire/health ledgers
        corrupted = [h for h in fc.router.replicas()
                     if h.wire_stats()["corrupt_injected"] >= 1]
        assert len(corrupted) == 1  # exactly one frame went out corrupt
        victim = corrupted[0]
        assert victim.health.state == "healthy"  # readmitted post-storm
        vdoc = fc.router.control(victim.instance, "status",
                                 timeout_s=30.0)
        assert vdoc["wire"]["protocol_errors"] >= 1  # worker CAUGHT it
        w1 = fc.router.control("replica-1", "status", timeout_s=30.0)
        assert w1["wire"]["partitions"] >= 1
        assert w1["wire"]["frames_dropped"] >= 1
        assert snap["response_timeouts"] >= 1  # partition detection
        assert snap["ejections"] >= 2 and snap["readmissions"] >= 2
        assert snap["replica_deaths"] >= 1     # corrupt-frame channel kill
        assert snap["probes_failed"] >= 1      # the storm's dropped dial
        events["fleet_ejections"] = snap["ejections"]
        events["fleet_readmissions"] = snap["readmissions"]
        events["fleet_rows_ok"] = snap["rows_ok"]
    t_fleet = time.monotonic() - t0
    assert t_fleet < FLEET_DEADLINE_S, "fleet transport hang"

    # ---- phase 8: exactly-once bulk scoring under kills ----------------
    # a checkpointed bulk job over three shards of the tiny
    # drill schema is SIGKILLed in the seeded shard's "output durable,
    # receipt lost" window (between the output-shard write and its
    # ``scored`` journal commit), resumed in THIS process, and must
    # come out byte-identical to an uninterrupted run with the
    # double-entry ledger exact; then the SAME shards run over a fresh
    # fleet whose replica-1 dies mid-shard - at-least-once failover
    # duplicates WORK, the journal keeps the OUTPUT exactly-once
    from transmogrifai_tpu_torch.bulk import (
        BulkJournal,
        BulkScoringJob,
        concatenated_output,
    )
    from transmogrifai_tpu_torch.testkit.drills import (
        BULK_KILL_CHILD_TEMPLATE,
    )
    from transmogrifai_tpu_torch.utils.uid import reset_uids

    # byte-identity with the killed CHILD requires matching stage uids
    # (the scored rows' column names embed them): rewind the counters
    # to where a fresh process starts before building the oracle
    reset_uids()
    wf8, data8, _rec8, _name8 = tiny_drill_pipeline()
    bulk_rows = [{"y": data8["y"][i], "a": data8["a"][i],
                  "c": data8["c"][i]} for i in range(len(data8["y"]))]
    bulk_shards = []
    for k in range(3):
        p = str(tmp_path / f"bulk-in-{k}.csv")
        write_shard_csv(p, bulk_rows[k * 40:(k + 1) * 40])
        bulk_shards.append(p)
    t0 = time.monotonic()
    # the oracle model is saved and the killed child loads it: the
    # parent and the child score with bit-identical weights
    bulk_model_dir = str(tmp_path / "bulk_model")
    wf8.train().save(bulk_model_dir)
    reset_uids()
    bulk_model = load_model(bulk_model_dir, tiny_drill_pipeline()[0])
    bulk_ref_dir = str(tmp_path / "bulk_ref")
    BulkScoringJob(bulk_model, bulk_ref_dir, bulk_shards,
                   chunk_rows=16).run()
    bulk_ref = concatenated_output(bulk_ref_dir)
    # kill between write and commit on the seeded shard's window
    bulk_dir = str(tmp_path / "bulk_job")
    bulk_script = tmp_path / "bulk_killer.py"
    bulk_script.write_text(BULK_KILL_CHILD_TEMPLATE.format(
        repo=REPO, fault=f"bulk.output_crash:on={bulk_kill_shard}",
        n=120, job_dir=bulk_dir, shards=bulk_shards, chunk=16,
        model_dir=bulk_model_dir))
    proc = subprocess.run([sys.executable, str(bulk_script)],
                          env=_child_env(), timeout=CRASH_SAVE_DEADLINE_S)
    assert proc.returncode == faults.DEFAULT_KILL_EXIT  # really killed
    events["bulk_kill_exit"] = proc.returncode
    assert BulkJournal.load(bulk_dir).states()["committed"] < 3
    bulk_summary = BulkScoringJob(bulk_model, bulk_dir).run()
    # invariant: zero duplicated, zero lost rows - bytes identical,
    # ledger balanced, the killed shard's re-score accounted
    assert bulk_summary["resumed"] is True
    assert concatenated_output(bulk_dir) == bulk_ref
    bulk_led = bulk_summary["ledger"]
    assert bulk_led["balanced"] and bulk_led["rows_in"] == 120
    assert bulk_led["rows_in"] == (bulk_led["rows_out"]
                                   + bulk_led["rows_quarantined"])
    (bulk_resume,) = bulk_summary["resumes"]
    assert bulk_kill_shard - 1 in bulk_resume["rescored_shards"]
    events["bulk_rescored_shards"] = bulk_resume["rescored_shards"]
    # replica death mid-shard: a fresh 2-replica fleet over the same
    # registry; replica-1 dies on its first bulk chunk
    with _fleet(
        fleet_reg_root, str(tmp_path / "bulk_fleet"),
        worker_env_overrides={"replica-1": {
            "TX_FAULTS": "bulk.replica_die_midshard:on=1"}},
        router_kw={"max_in_flight_per_replica": 2, "max_queue": 64},
    ) as bfc:
        fleet_bulk_dir = str(tmp_path / "bulk_fleet_job")
        fleet_summary = BulkScoringJob(
            bulk_model, fleet_bulk_dir, bulk_shards, router=bfc.router,
            chunk_rows=16, max_in_flight=4).run()
        fleet_led = fleet_summary["ledger"]
        assert fleet_led["balanced"] and fleet_led["rows_in"] == 120
        bsnap = bfc.router.snapshot()
        assert bsnap["replica_deaths"] == 1
        assert bsnap["retries"] >= 1  # the victim died holding a chunk
        assert len(concatenated_output(fleet_bulk_dir).splitlines()) \
            == fleet_led["rows_out"]
        events["bulk_fleet_replica_deaths"] = bsnap["replica_deaths"]
    t_bulk = time.monotonic() - t0
    assert t_bulk < BULK_DEADLINE_S, "bulk scoring hang"

    # ---- phase 9: elastic capacity under chaos -------------------------
    # a fresh TCP fleet rides a load surge while the
    # autoscaler's OWN control loop is killed on the seeded tick
    # (``autoscaler.crash``): the data plane keeps serving through the
    # control-plane death, a restarted autoscaler adopts the live
    # fleet and grows it under the still-burning load, then the drain
    # (load stops) shrinks it back - the row ledger EXACT throughout
    from transmogrifai_tpu_torch.fleet import FleetAutoscaler

    t0 = time.monotonic()
    with _fleet(
        fleet_reg_root, str(tmp_path / "autoscale_fleet"),
        worker_env={"TX_FAULTS": "serving.slow_batch:every=1:delay=0.03"},
        router_kw={"max_in_flight_per_replica": 2, "max_queue": 64},
    ) as afc:
        abatch = records[:24]
        afc.router.score_batch(abatch, timeout_s=60.0)  # warm
        adelivered, aerrors = [], []
        stop_surge = threading.Event()

        def _surge():
            while not stop_surge.is_set():
                try:
                    res = afc.router.submit(records=abatch).wait(120.0)
                    adelivered.append(res.n_rows)
                except Exception as e:  # noqa: BLE001 - ledger counts
                    aerrors.append(repr(e))

        surges = [threading.Thread(target=_surge) for _ in range(6)]
        for t in surges:
            t.start()
        try:
            faults.configure(
                f"autoscaler.crash:on={autoscaler_crash_on}")
            doomed = FleetAutoscaler(
                afc, min_replicas=2, max_replicas=3, interval_s=0.15,
                up_consecutive=2, down_consecutive=2,
                cooldown_windows=1, retune_enabled=False,
                probe_timeout_s=120.0, drain_timeout_s=60.0)
            doomed.start()
            _fleet_wait(lambda: not doomed.alive(), 60.0,
                        "autoscaler crash")
            faults.reset()
            assert doomed.crashed  # the fault, not a clean stop
            # the data plane never noticed the control plane die
            assert len(afc.router.score_batch(
                abatch, timeout_s=60.0)) == len(abatch)
            # a restarted autoscaler adopts the live fleet and grows
            # it under the still-burning surge
            scaler = FleetAutoscaler(
                afc, min_replicas=2, max_replicas=3, interval_s=0.15,
                up_consecutive=2, down_consecutive=2,
                cooldown_windows=1, retune_enabled=False,
                probe_timeout_s=120.0, drain_timeout_s=60.0)
            scaler.start()
            _fleet_wait(lambda: len(afc.member_instances()) >= 3,
                        FLEET_DEADLINE_S, "surge scale-up")
        finally:
            stop_surge.set()
            for t in surges:
                t.join(timeout=120.0)
        try:
            # the drain: load gone, the fleet shrinks back to min
            _fleet_wait(lambda: len(afc.member_instances()) <= 2,
                        FLEET_DEADLINE_S, "idle scale-down")
        finally:
            scaler.stop()
        assert scaler.decisions()[0].action == "adopt"
        # the crash tick is randomized, so the surge scale-up may land
        # on either side of the crash: assert it over the COMBINED
        # decision history, and that the adopter never repeated it
        # blindly (at most one scale-up total for one sustained surge)
        actions = [d.action for d in doomed.decisions()] \
            + [d.action for d in scaler.decisions()]
        assert "scale_up" in actions and "scale_down" in actions
        assert actions.count("scale_up") == 1
        # row ledger EXACT across crash + grow + drain: every accepted
        # request answered exactly once
        assert aerrors == []
        asnap = afc.router.snapshot()
        assert asnap["rows_ok"] == (len(adelivered) + 2) * len(abatch)
        assert asnap["requests_failed"] == 0
        events["autoscaler_crash_tick"] = autoscaler_crash_on
        events["autoscale_decisions"] = len(scaler.decisions())
        events["autoscale_rows_ok"] = asnap["rows_ok"]
    t_autoscale = time.monotonic() - t0
    assert t_autoscale < FLEET_DEADLINE_S, "autoscale phase hang"

    # ---- global: nothing leaked, everything accounted ------------------
    assert not faults.active()
    assert events["quarantined"] == expected_quarantined
    assert verify_artifact(model_path) is None
    assert verify_artifact(crash_path) is None
    assert registry.verify()["ok"]
