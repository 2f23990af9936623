"""Scale-out serving fleet drills on port replica workers.

The acceptance drills of the JAX package's tests/test_fleet.py, run on
``transmogrifai_tpu_torch.fleet`` with CPU replicas (``device="cpu"``,
one thread each; ``torch_fleet.py``): the zero-drop rolling deploy
across three replicas, one replica SIGKILLed mid-run with exact row
conservation on the survivors, router backpressure with every replica
full (shed, never hang), and the fleet-wide SLO rollback of a canary.
Every drill is seeded: the drill pipeline's data seed, the fault specs
and the deterministic canary hash split pin the schedule.

Left out: the router-overhead CPU floor (a wall-clock floor; the card
phase of chip_smoke.py measures the fleet there) and the ``tx fleet``
CLI cases, which come with ``cli.py``.
"""
from __future__ import annotations

import json
import os
import signal
import threading
import time

import pytest

from torch_fleet import PORT_TINY_SPEC, controller, publish_tiny

from transmogrifai_tpu_torch.fleet import FleetWorkerError
from transmogrifai_tpu_torch.serving import QueueFullError


@pytest.fixture(scope="module")
def fleet_registry(tmp_path_factory):
    return publish_tiny(str(tmp_path_factory.mktemp("fleet-registry")))


def _controller(fleet_registry, tmp_path, n_replicas, **kw):
    return controller(fleet_registry["root"], PORT_TINY_SPEC, n_replicas,
                      str(tmp_path / "fleet"), **kw)


def test_rolling_deploy_zero_drop_three_replicas(fleet_registry,
                                                 tmp_path):
    records = fleet_registry["records"]
    batch = records[:40]
    direct = fleet_registry["model"].score_function()
    want = [direct(r) for r in batch]
    with _controller(fleet_registry, tmp_path, 3) as fc:
        assert [list(r.values()) for r in fc.router.score_batch(
            batch, timeout_s=60.0)] == [list(r.values()) for r in want]
        results: list = []
        errors: list = []
        stop = threading.Event()

        def pump() -> None:
            while not stop.is_set():
                try:
                    results.append(
                        fc.router.submit(records=batch).wait(60.0))
                except Exception as e:  # noqa: BLE001 - the drill counts
                    errors.append(repr(e))

        threads = [threading.Thread(target=pump) for _ in range(4)]
        for t in threads:
            t.start()
        time.sleep(0.3)
        report = fc.rolling_deploy(fleet_registry["v2"])
        time.sleep(0.3)
        stop.set()
        for t in threads:
            t.join(timeout=60.0)

        assert [s["instance"] for s in report] == [
            "replica-0", "replica-1", "replica-2"]
        assert errors == []
        assert all(res.n_rows == len(batch) for res in results)
        # every routed row is the in-process model's row, to the bit (a
        # later generation's workflow has fresh uids, so its result
        # feature is named apart: compare the rows under the name)
        assert all([list(r.values()) for r in res.results]
                   == [list(r.values()) for r in want] for res in results)
        versions = {res.version for res in results}
        assert all(res.version is not None
                   and res.generation is not None for res in results)
        assert versions <= {fleet_registry["v1"], fleet_registry["v2"]}
        assert fleet_registry["v2"] in versions
        for h in fc.router.live_replicas():
            doc = fc.router.control(h.instance, "status")
            assert doc["version"] == fleet_registry["v2"]
            assert doc["device"] == "cpu"
        assert fc.registry.stable == fleet_registry["v2"]
        snap = fc.router.snapshot()
        assert snap["rows_ok"] == sum(r.n_rows for r in results) \
            + len(batch)
        assert sum(snap["rows_by_generation"].values()) \
            == snap["rows_ok"]

        # one Prometheus scrape of the aggregation dir covers the fleet
        time.sleep(0.4)
        text = fc.aggregator.prometheus_text()
        for i in range(3):
            assert f'instance="replica-{i}"' in text
        assert 'instance="fleet",agg="sum"' in text
        assert "tx_serving_rows_scored" in text

        status_doc = json.load(open(
            os.path.join(fc.control_dir, "fleet_status.json")))
        assert set(status_doc["replicas"]) == {
            "replica-0", "replica-1", "replica-2"}
        for rep in status_doc["replicas"].values():
            assert rep["running"] is True

        # a deployment controller pointed at the published status
        # document carries the same one fleet view in its summary
        from transmogrifai_tpu_torch.registry import DeploymentController

        ctl = DeploymentController()
        ctl.fleet_status_source = os.path.join(fc.control_dir,
                                               "fleet_status.json")
        summary = ctl.summary_json()
        assert set(summary["fleet"]["replicas"]) == {
            "replica-0", "replica-1", "replica-2"}
        for rep in summary["fleet"]["replicas"].values():
            assert "generation" in rep and "heartbeat_age_s" in rep \
                and "in_flight" in rep


def test_replica_sigkill_conserves_every_accepted_request(
        fleet_registry, tmp_path):
    records = fleet_registry["records"]
    batch = records[:30]
    with _controller(
        fleet_registry, tmp_path, 3, max_restarts=0,
        worker_env={"TX_FAULTS": "serving.slow_batch:every=1:delay=0.05"},
    ) as fc:
        fc.router.score_batch(batch, timeout_s=60.0)
        delivered: list = []
        errors: list = []
        submitted = 60

        def pump(k: int) -> None:
            for _ in range(k):
                try:
                    res = fc.router.submit(records=batch).wait(120.0)
                    delivered.append(res.n_rows)
                except Exception as e:  # noqa: BLE001 - the drill counts
                    errors.append(repr(e))

        threads = [threading.Thread(target=pump, args=(submitted // 4,))
                   for _ in range(4)]
        for t in threads:
            t.start()
        time.sleep(0.4)
        victim = fc._replicas["replica-1"]
        os.kill(victim.proc.pid, signal.SIGKILL)
        for t in threads:
            t.join(timeout=180.0)

        assert errors == []
        assert len(delivered) == submitted
        assert sum(delivered) == submitted * len(batch)
        snap = fc.router.snapshot()
        assert snap["replica_deaths"] == 1
        assert snap["retries"] >= 1
        assert snap["rows_ok"] == submitted * len(batch) + len(batch)
        live = {h.instance for h in fc.router.live_replicas()}
        assert live == {"replica-0", "replica-2"}
        post = fc.router.score_batch(batch, timeout_s=60.0)
        assert len(post) == len(batch)


def test_router_backpressure_sheds_never_hangs(fleet_registry,
                                               tmp_path):
    records = fleet_registry["records"]
    batch = records[:20]
    with _controller(
        fleet_registry, tmp_path, 1,
        router_kw={"max_in_flight_per_replica": 1, "max_queue": 3},
        worker_env={"TX_FAULTS": "serving.slow_batch:every=1:delay=0.3"},
    ) as fc:
        fc.router.score_batch(batch, timeout_s=60.0)
        pending = []
        sheds = 0
        t0 = time.perf_counter()
        for _ in range(12):
            try:
                pending.append(fc.router.submit(records=batch))
            except QueueFullError:
                sheds += 1
        submit_wall = time.perf_counter() - t0
        assert sheds >= 6, "a full fleet must shed at the front door"
        assert submit_wall < 2.0, "shedding must be fast, not a hang"
        assert fc.router.snapshot()["shed_queue_full"] == sheds
        for req in pending:
            res = req.wait(60.0)
            assert res.n_rows == len(batch)


def test_fleet_slo_and_signals_roll_canary_back_everywhere(
        fleet_registry, tmp_path):
    from transmogrifai_tpu_torch.obs.slo import SLObjective

    records = fleet_registry["records"]
    batch = records[:40]
    slo = SLObjective(
        name="fleet-nonfinite", kind="threshold",
        metric="serving.breaker.rows_nonfinite", objective=0.5,
        windows_s=(30.0, 5.0),
    )
    with _controller(
        fleet_registry, tmp_path, 2, slo_objectives=[slo],
        worker_env={"TX_FAULTS": "canary.regression:every=1"},
    ) as fc:
        out = fc.start_canary(fleet_registry["v3"], fraction=0.5)
        assert all(doc.get("ok") for doc in out.values())
        assert fc.registry.canary == fleet_registry["v3"]
        for _ in range(6):
            fc.router.score_batch(batch, timeout_s=60.0)
        time.sleep(0.5)
        decision = fc.check_canary()
        assert decision is not None and decision.rollback
        signals = {r["signal"] for r in decision.reasons}
        assert "nonfinite_rows" in signals
        assert any(s.startswith("slo:fleet-nonfinite")
                   for s in signals), signals
        assert fc.canary_version is None
        for h in fc.router.live_replicas():
            doc = fc.router.control(h.instance, "status")
            assert doc["canary_version"] is None
        assert fc.registry.get(
            fleet_registry["v3"]).stage == "rolled_back"
        post = fc.router.score_batch(batch, timeout_s=60.0)
        assert len(post) == len(batch)


def test_unknown_control_verb_is_a_worker_error_not_a_death(
        fleet_registry, tmp_path):
    """An ordinary failure under a control verb is answered as
    ``FleetWorkerError`` and the replica keeps serving (the contrast to
    a device fault, which ends the replica)."""
    batch = fleet_registry["records"][:8]
    with _controller(fleet_registry, tmp_path, 1, max_restarts=0) as fc:
        with pytest.raises(FleetWorkerError, match="unknown fleet control"):
            fc.router.control("replica-0", "no-such-verb", timeout_s=30.0)
        assert len(fc.router.score_batch(batch, timeout_s=60.0)) == 8
        assert fc._replicas["replica-0"].proc.poll() is None
