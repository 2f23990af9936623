"""Network-fault and device-fault drills of the fleet on port workers.

The integration drills of the JAX package's tests/test_fleet_faults.py,
run on ``transmogrifai_tpu_torch.fleet`` with CPU replicas
(``torch_fleet.py``): a loopback-TCP fleet partitioned mid-serve
(ejection -> survivors absorb with an exact double-entry ledger ->
probe readmission, under one trace id), the half-open variant, a
corrupt frame followed by a reconnect storm, and a deadline that rides
the wire to a slow peer.  The fault specs (``on=``/``every=`` triggers,
``delay=`` windows) pin every run to the same schedule.

The port's own device seams:

* a worker whose scoring raises ``KernelError`` answers that request
  with a row-less ``device_fault`` error and exits nonzero: its caller
  gets ``FleetWorkerError``, never a scored or ``RowScoringError`` row;
* no fallback: a ``ReplicaWorker`` or ``FleetController`` left at the
  default ``device="cuda"`` raises on this host without CUDA.
"""
from __future__ import annotations

import threading
import time

import pytest
import torch

from torch_fleet import (
    PORT_TINY_SPEC,
    controller,
    publish_tiny,
    wait_for,
)

from transmogrifai_tpu_torch.faults import injection as _faults
from transmogrifai_tpu_torch.fleet import (
    FleetController,
    FleetWorkerError,
    ReplicaWorker,
)
from transmogrifai_tpu_torch.obs.trace import tracer
from transmogrifai_tpu_torch.serving import RowScoringError
from transmogrifai_tpu_torch.serving.admission import DeadlineExceededError


@pytest.fixture(autouse=True)
def _disarm_faults():
    yield
    _faults.reset()


@pytest.fixture(scope="module")
def fleet_registry(tmp_path_factory):
    return publish_tiny(str(tmp_path_factory.mktemp("faults-registry")),
                        n_versions=1)


def _tcp_controller(fleet_registry, tmp_path, n_replicas, **kw):
    kw.setdefault("transport", "tcp")
    kw.setdefault("max_restarts", 0)
    return controller(fleet_registry["root"], PORT_TINY_SPEC, n_replicas,
                      str(tmp_path / "fleet"), **kw)


def _run_impairment_drill(fleet_registry, tmp_path, fault_spec):
    """A two-replica loopback-TCP fleet, replica-1 impaired mid-serve by
    ``fault_spec``, pumped traffic throughout: ejection -> survivors
    absorb with an exact double-entry ledger -> probe readmission, all
    under ONE trace id.  Returns the final router snapshot, replica-1's
    worker-side status doc and the router's health view."""
    records = fleet_registry["records"]
    batch = records[:24]
    with tracer().span("fleet.fault_drill") as root:
        with _tcp_controller(
            fleet_registry, tmp_path, 2,
            worker_env_overrides={"replica-1": {"TX_FAULTS": fault_spec}},
            router_kw={
                "response_timeout_s": 1.5,
                "eject_after": 1,
                "probe_interval_s": 0.4,
                "probe_timeout_s": 0.8,
            },
        ) as fc:
            assert all(h.transport == "tcp"
                       for h in fc.router.replicas())
            fc.router.score_batch(batch, timeout_s=60.0)
            delivered: list = []
            errors: list = []
            submitted = [0]
            stop_pump = threading.Event()

            def pump() -> None:
                while not stop_pump.is_set():
                    submitted[0] += 1
                    try:
                        res = fc.router.submit(records=batch).wait(60.0)
                        delivered.append(res.n_rows)
                    except Exception as e:  # noqa: BLE001 - the drill counts
                        errors.append(repr(e))

            threads = [threading.Thread(target=pump) for _ in range(4)]
            for t in threads:
                t.start()
            try:
                wait_for(lambda: fc.router.snapshot()["ejections"] >= 1,
                         timeout_s=20.0, what="ejection")
                assert fc.router.handle("replica-1").health.state \
                    != "healthy"
                assert fc.router.score_batch(batch, timeout_s=60.0)
            finally:
                stop_pump.set()
                for t in threads:
                    t.join(timeout=120.0)

            wait_for(
                lambda: fc.router.snapshot()["readmissions"] >= 1
                and fc.router.handle("replica-1").health.state
                == "healthy",
                timeout_s=20.0, what="readmission")

            assert errors == []
            assert len(delivered) == submitted[0]
            assert sum(delivered) == submitted[0] * len(batch)
            snap = fc.router.snapshot()
            assert snap["rows_ok"] == (submitted[0] + 2) * len(batch)
            assert snap["response_timeouts"] >= 1
            assert snap["ejections"] >= 1
            assert snap["readmissions"] >= 1
            assert snap["probes_sent"] >= 1
            assert snap["requests_failed"] == 0
            assert snap["replicas"]["replica-0"]["rows_ok"] > 0
            assert snap["replicas"]["replica-0"]["health"]["state"] \
                == "healthy"
            post = fc.router.score_batch(batch, timeout_s=60.0)
            assert len(post) == len(batch)
            status = fc.status()
            rep1 = status["replicas"]["replica-1"]
            assert rep1["transport"] == "tcp"
            assert rep1["health"] == "healthy"
            assert rep1["ejections"] >= 1 and rep1["readmissions"] >= 1
            worker_doc = fc.router.control("replica-1", "status",
                                           timeout_s=30.0)
            health_snap = fc.router.health_snapshot()
    events = [r for r in tracer().spans(root.trace_id)
              if r["name"] in ("fleet.ejection", "fleet.readmission")]
    assert {r["name"] for r in events} == {"fleet.ejection",
                                          "fleet.readmission"}
    assert all(r["trace"] == root.trace_id for r in events)
    return snap, worker_doc, health_snap


def test_tcp_partition_ejects_heals_and_readmits(fleet_registry,
                                                 tmp_path):
    _snap, worker_doc, health_snap = _run_impairment_drill(
        fleet_registry, tmp_path,
        "fleet.partition:every=6:times=1:delay=4.0")
    wire = worker_doc["wire"]
    assert wire["partitions"] >= 1
    assert wire["frames_dropped"] >= 1
    assert health_snap["replicas"]["replica-1"]["state"] == "healthy"
    assert health_snap["replicas"]["replica-1"]["ejections"] >= 1


def test_tcp_half_open_peer_ejects_heals_and_readmits(fleet_registry,
                                                      tmp_path):
    snap, worker_doc, _health = _run_impairment_drill(
        fleet_registry, tmp_path,
        "fleet.half_open:every=6:times=1:delay=4.0")
    wire = worker_doc["wire"]
    assert wire["half_opens"] >= 1
    assert wire["frames_dropped"] >= 1
    assert snap["probes_failed"] >= 1


def test_corrupt_frame_then_reconnect_storm_recovers(fleet_registry,
                                                     tmp_path):
    records = fleet_registry["records"]
    batch = records[:24]
    with _tcp_controller(
        fleet_registry, tmp_path, 1,
        worker_env_overrides={
            "replica-0": {"TX_FAULTS": "channel.corrupt_frame:on=3"}},
        router_kw={
            "response_timeout_s": 5.0,
            "probe_interval_s": 0.4,
            "probe_timeout_s": 2.0,
        },
    ) as fc:
        for _ in range(2):
            assert len(fc.router.score_batch(batch, timeout_s=60.0)) \
                == len(batch)
        _faults.configure("fleet.reconnect_storm:every=1:times=2")
        t0 = time.monotonic()
        recovered = False
        while time.monotonic() - t0 < 60.0 and not recovered:
            try:
                res = fc.router.submit(records=batch).wait(30.0)
                recovered = len(res.results) == len(batch)
            except Exception:  # noqa: BLE001 - outage window: retry
                time.sleep(0.2)
        assert recovered, ("fleet never recovered from the "
                           "corrupt-frame + storm outage")
        snap = fc.router.snapshot()
        assert snap["protocol_errors"] >= 1
        assert snap["replica_deaths"] >= 1
        assert snap["probes_failed"] >= 2
        assert snap["readmissions"] >= 1
        h = fc.router.handle("replica-0")
        assert h.health.state == "healthy"
        assert time.monotonic() - t0 >= 2 * 0.4
        assert h.wire_stats()["protocol_errors"] >= 1


def test_deadline_rides_wire_and_slow_peer_drops_late_work(
        fleet_registry, tmp_path):
    records = fleet_registry["records"]
    batch = records[:8]
    with _tcp_controller(
        fleet_registry, tmp_path, 1,
        worker_env_overrides={
            "replica-0": {"TX_FAULTS": "fleet.slow_peer:every=1:delay=0.5"}},
    ) as fc:
        fc.router.score_batch(batch, timeout_s=60.0)
        r1 = fc.router.submit(records=batch)
        r2 = fc.router.submit(records=batch, deadline_ms=200.0)
        assert len(r1.wait(60.0).results) == len(batch)
        with pytest.raises(DeadlineExceededError, match="replica-0"):
            r2.wait(60.0)
        snap = fc.router.snapshot()
        assert snap["deadline_dropped_remote"] == 1
        assert snap["shed_deadline"] >= 1
        h = fc.router.handle("replica-0")
        assert h.health.state == "healthy"
        assert h.health.consecutive_failures == 0
        worker_doc = fc.router.control("replica-0", "status",
                                       timeout_s=30.0)
        assert worker_doc["deadline_dropped"] == 1
        post = fc.router.score_batch(batch, timeout_s=60.0)
        assert len(post) == len(batch)


# -- the port's device seams -------------------------------------------------

def test_device_fault_ends_the_worker_and_fails_the_request(
        fleet_registry, tmp_path):
    """Scoring that raises ``KernelError`` inside a replica: the caller
    receives ``FleetWorkerError`` naming the fault (no row, scored or
    ``RowScoringError``), the replica process exits nonzero, and the
    request is not failed over to a survivor."""
    batch = fleet_registry["records"][:8]
    with controller(fleet_registry["root"], "torch_fleet:device_fault_tiny",
                    2, str(tmp_path / "fleet"), max_restarts=0) as fc:
        ok = fc.router.score_batch(batch, timeout_s=60.0)
        assert len(ok) == 8 and not any(
            isinstance(r, RowScoringError) for r in ok)
        poisoned = [dict(r, fault=True) for r in batch]
        with pytest.raises(FleetWorkerError, match="KernelError"):
            fc.router.score_batch(poisoned, timeout_s=60.0)
        procs = {i: r.proc for i, r in fc._replicas.items()}
        wait_for(lambda: any(p.poll() is not None for p in procs.values()),
                 timeout_s=30.0, what="the faulted replica to exit")
        dead = [i for i, p in procs.items() if p.poll() is not None]
        assert len(dead) == 1
        assert procs[dead[0]].returncode not in (0, None)
        snap = fc.router.snapshot()
        assert snap["requests_failed"] == 1 and snap["retries"] == 0
        assert snap["rows_ok"] == 8
        # the survivor serves on
        wait_for(lambda: len(fc.router.live_replicas()) == 1,
                 timeout_s=30.0, what="the router to drop the dead replica")
        assert len(fc.router.score_batch(batch, timeout_s=60.0)) == 8


def test_no_cpu_fallback_without_a_card(fleet_registry, tmp_path,
                                        monkeypatch):
    """Left at ``device="cuda"`` on a host without CUDA, the worker and
    the controller raise before anything loads; ``device="cpu"`` is the
    only way onto the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    kw = dict(registry_root=fleet_registry["root"],
              workflow_spec=PORT_TINY_SPEC,
              socket_path=str(tmp_path / "r.sock"), instance="replica-0")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ReplicaWorker(**kw)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        FleetController(fleet_registry["root"], PORT_TINY_SPEC,
                        n_replicas=1, work_dir=str(tmp_path / "fleet"))
    worker = ReplicaWorker(device="cpu", **kw)
    assert worker.device == "cpu"
    assert worker._fresh_workflow().device == "cpu"
