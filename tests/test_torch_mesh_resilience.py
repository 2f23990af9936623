"""Degraded-mode distributed training drills for the torch package
(``parallel/resilience.py``), the port of the JAX package's
``tests/test_mesh_resilience.py``:

* ``collective.delay``  -> straggler: ONE retry with an extended deadline
* ``mesh.peer_hang``    -> the retry stalls too: escalate to shrink
* ``mesh.peer_die``     -> dead peer: no retry, survivor recompute, the
                           uninterrupted result
* ``mesh.init_no_coordinator`` and a coordinator that never answers ->
  ``initialize()`` raises MeshBootstrapError within
  TX_MESH_INIT_TIMEOUT_S, never hangs (armed in-process and through the
  ``TX_FAULTS`` env of a child)

plus the file-based PeerHealth hang-once / die-once child drills and the
telemetry surfacing.  The watchdog drills run in-process over a
``LocalMesh`` (a mesh of this process alone: the reduction is the
collective's stand-in); the validator's guarded CV fit runs on a spawned
gloo world of 2 ranks (``torch_mesh_world.py``).  The coordinator drills
use localhost only: a port nobody listens on, and a listener that never
answers.
"""
import json
import os
import socket
import subprocess
import sys
import time

import numpy as np
import pytest

from torch_mesh_world import REPO, check_result, run_world
from torch_parity import PORT, mod

from transmogrifai_tpu_torch.testkit.drills import (
    MESH_BOOTSTRAP_CHILD_TEMPLATE,
    MESH_PEER_CHILD_TEMPLATE,
)

faults = mod(PORT, "faults.injection")
dist = mod(PORT, "parallel.distributed")
resilience = mod(PORT, "parallel.resilience")
CollectiveStallError = resilience.CollectiveStallError
CollectiveWatchdog = resilience.CollectiveWatchdog
DeadlinePolicy = resilience.DeadlinePolicy
MeshTelemetry = resilience.MeshTelemetry
PeerHealth = resilience.PeerHealth


@pytest.fixture(autouse=True)
def _disarm(monkeypatch):
    """Every drill arms injection explicitly; none may leak, and the
    process-global telemetry and watchdog must not carry events across
    tests."""
    monkeypatch.delenv("TX_MESH_WATCHDOG", raising=False)
    faults.reset()
    resilience.reset_mesh_telemetry()
    yield
    faults.reset()
    resilience.reset_mesh_telemetry()


def _moments(x):
    return x.sum(axis=0), (x * x).sum(axis=0)


@pytest.fixture
def mesh_setup(rng):
    mesh = resilience.survivor_mesh(("data",))  # this process alone
    X = rng.randn(16, 5).astype(np.float32)
    tel = MeshTelemetry()
    wd = CollectiveWatchdog(
        telemetry=tel,
        policy=DeadlinePolicy(floor_s=0.05, ceiling_s=30.0, factor=4.0),
    )
    step = lambda: dist.all_reduce_stats(_moments, mesh, X)  # noqa: E731
    shrink = lambda: dist.all_reduce_stats(  # noqa: E731
        _moments, resilience.survivor_mesh(("data",)), X)
    baseline = tuple(np.asarray(v) for v in step())
    return wd, tel, step, shrink, baseline


def _parity(result, baseline):
    for got, want in zip(result, baseline):
        np.testing.assert_allclose(np.asarray(got), want, atol=1e-5)


# -- deadline policy ---------------------------------------------------------

def test_deadline_policy_clamps_and_tracks_p99():
    p = DeadlinePolicy(floor_s=1.0, ceiling_s=10.0, factor=4.0)
    assert p.deadline_s() == 10.0  # no observations: never kill a cold start
    for _ in range(50):
        p.observe(0.1)
    assert p.deadline_s() == pytest.approx(1.0)  # 0.4 clamped to floor
    for _ in range(50):
        p.observe(1.0)
    assert 3.9 <= p.deadline_s() <= 4.1  # p99*4
    for _ in range(50):
        p.observe(100.0)
    assert p.deadline_s() == 10.0  # ceiling


# -- the watchdog state machine ----------------------------------------------

def test_healthy_step_is_transparent_and_observed(mesh_setup):
    wd, tel, step, _shrink, baseline = mesh_setup
    out = wd.run("drill.moments", step)
    _parity(out, baseline)
    snap = tel.snapshot()
    assert snap["collectives_ok"] == 1
    assert snap["detections"] == 0 and snap["shrinks"] == 0
    assert snap["step_ms"]["p99"] is not None


def test_straggler_gets_one_extended_retry(mesh_setup):
    wd, tel, step, shrink, baseline = mesh_setup
    wd.run("drill.moments", step)
    faults.configure("collective.delay:on=1:delay=0.5")
    out = wd.run("drill.moments", step, shrink_fn=shrink, deadline_s=0.15)
    _parity(out, baseline)
    snap = tel.snapshot()
    assert snap["detections"] == 1
    assert snap["straggler_retries"] == 1 and snap["retries_ok"] == 1
    assert snap["shrinks"] == 0  # the retry recovered
    detect = [e for e in snap["events"] if e["event"] == "detect"][0]
    assert detect["classification"] == "straggler"
    retry = [e for e in snap["events"] if e["event"] == "retry"][0]
    assert retry["ok"] and retry["deadline_s"] == pytest.approx(0.3)


def test_peer_hang_escalates_past_retry_to_shrink(mesh_setup):
    wd, tel, step, shrink, baseline = mesh_setup
    wd.run("drill.moments", step)
    faults.configure("mesh.peer_hang:every=1:times=2:delay=1.5")
    t0 = time.perf_counter()
    out = wd.run("drill.moments", step, shrink_fn=shrink, deadline_s=0.1)
    wall = time.perf_counter() - t0
    _parity(out, baseline)
    snap = tel.snapshot()
    assert snap["detections"] == 1
    assert snap["straggler_retries"] == 1 and snap["retries_ok"] == 0
    assert snap["shrinks"] == 1
    assert wall < 5.0  # deadline + retry + recompute, not 2 x 1.5 s


def test_peer_die_shrinks_without_retry(mesh_setup):
    wd, tel, step, shrink, baseline = mesh_setup
    faults.configure("mesh.peer_die:on=1:delay=0.05")
    out = wd.run("drill.moments", step, shrink_fn=shrink, deadline_s=30.0)
    _parity(out, baseline)
    snap = tel.snapshot()
    assert snap["detections"] == 1
    assert snap["straggler_retries"] == 0  # dead peer: no pointless retry
    assert snap["shrinks"] == 1
    detect = [e for e in snap["events"] if e["event"] == "detect"][0]
    assert detect["classification"] == "dead_peer"
    assert detect["dead_peers"] == ["injected"]
    assert snap["shrink_recompute_ms"]["p99"] is not None


def test_stall_without_shrink_path_raises_named_error(mesh_setup):
    wd, tel, step, _shrink, _baseline = mesh_setup
    faults.configure("mesh.peer_die:on=1:delay=0.05")
    with pytest.raises(CollectiveStallError, match="dead_peer"):
        wd.run("drill.moments", step, deadline_s=30.0)
    assert tel.snapshot()["shrink_failures"] == 1


def test_wedged_survivor_route_fails_loudly_not_hangs():
    tel = MeshTelemetry()
    wd = CollectiveWatchdog(telemetry=tel, policy=DeadlinePolicy(
        floor_s=0.05, ceiling_s=0.3, factor=4.0))
    faults.configure("mesh.peer_die:on=1:delay=0.05")

    def wedged_shrink():
        time.sleep(5.0)
        return 1

    t0 = time.perf_counter()
    with pytest.raises(CollectiveStallError, match="survivor recompute"):
        wd.run("drill.sum", lambda: 1, shrink_fn=wedged_shrink,
               deadline_s=30.0)
    assert time.perf_counter() - t0 < 3.0  # bounded by the 0.3 s ceiling
    assert tel.snapshot()["shrink_failures"] == 1


def test_nested_guards_run_inline():
    tel = MeshTelemetry()
    wd = CollectiveWatchdog(telemetry=tel, policy=DeadlinePolicy(
        floor_s=0.05, ceiling_s=30.0, factor=4.0))

    def outer():
        return resilience.guarded_collective("inner", lambda: 42, watchdog=wd)

    assert wd.run("outer", outer) == 42
    assert tel.snapshot()["collectives_ok"] == 1  # outer only


# -- peer health: hang-once / die-once child drills --------------------------

#: the peer child: the port's testkit template
PEER_CHILD = MESH_PEER_CHILD_TEMPLATE

def _child_env() -> dict:
    env = dict(os.environ, PYTHONPATH=REPO)
    env.pop("TX_FAULTS", None)
    return env


def _spawn_peer(tmp_path, mode: str, beats: int = 3, interval: float = 0.1,
                exit_code: int = 9):
    hb_dir = str(tmp_path / "hb")
    script = tmp_path / f"peer_{mode}.py"
    script.write_text(PEER_CHILD.format(
        repo=REPO, hb_dir=hb_dir, peer_id=1, beats=beats,
        interval=interval, mode=mode, exit_code=exit_code,
    ))
    proc = subprocess.Popen([sys.executable, str(script)], env=_child_env())
    return hb_dir, proc


def _wait_for_dead(ph, timeout_s: float = 30.0) -> list:
    t0 = time.time()
    while time.time() - t0 < timeout_s:
        dead = ph.dead_peers()
        if dead:
            return dead
        time.sleep(0.05)
    return []


def test_peer_health_detects_die_once_child(tmp_path):
    hb_dir, proc = _spawn_peer(tmp_path, "die")
    try:
        ph = PeerHealth(hb_dir, process_id=0, stale_after_s=0.6)
        ph.beat()
        proc.wait(timeout=60)
        assert proc.returncode == 9  # really died
        assert _wait_for_dead(ph) == [1]
        assert ph.survivors() == [0]
        assert 1 in ph.peers()  # the corpse's last beat is still visible
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)


def test_peer_health_detects_hang_once_child(tmp_path):
    hb_dir, proc = _spawn_peer(tmp_path, "hang", beats=2)
    try:
        ph = PeerHealth(hb_dir, process_id=0, stale_after_s=0.6)
        ph.beat()
        assert _wait_for_dead(ph) == [1]
        assert proc.poll() is None  # hung, not dead: same classification
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)


def test_watchdog_classifies_stale_heartbeat_as_dead_peer(tmp_path):
    hb_dir = str(tmp_path / "hb")
    ph = PeerHealth(hb_dir, process_id=0, stale_after_s=5.0)
    ph.beat()
    stale_path = ph.path_for(1)
    with open(stale_path, "w"):
        pass
    past = time.time() - 100.0
    os.utime(stale_path, (past, past))
    tel = MeshTelemetry()
    wd = CollectiveWatchdog(telemetry=tel, peer_health=ph)
    faults.configure("mesh.peer_hang:on=1:delay=1.0")
    out = wd.run("drill.sum", lambda: 7, shrink_fn=lambda: 7, deadline_s=0.1)
    assert out == 7
    snap = tel.snapshot()
    assert snap["straggler_retries"] == 0
    detect = [e for e in snap["events"] if e["event"] == "detect"][0]
    assert detect["classification"] == "dead_peer"
    assert detect["dead_peers"] == [1]
    shrink = [e for e in snap["events"] if e["event"] == "shrink"][0]
    assert shrink["survivors"] == 1  # only this process still beats


def test_peer_health_clamps_skewed_clocks(tmp_path):
    ph = PeerHealth(str(tmp_path / "hb"), process_id=0)
    ph.beat()
    future = time.time() + 120.0
    os.utime(ph.path_for(0), (future, future))
    assert ph.staleness_by_peer()[0] == 0.0


# -- the validator's guarded CV-fold collective ------------------------------

@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return run_world("resilience", 2, tmp_path_factory.mktemp("res"))


def test_validator_mesh_fit_shrinks_to_survivor_parity(world):
    """The CV fold x grid fit over a 2-rank CV mesh with the peer dying
    mid-collective on every rank: the watchdog (on by default in a
    multi-rank world) shrinks to this rank's host recompute and reaches
    the SAME selection as an undisturbed single-rank run."""
    for got in check_result(world,
                            "validator_mesh_fit_shrinks_to_survivor_parity"):
        assert got["world"] == 2 and got["watchdog"]
        assert got["shrinks"] == 1, got["events"]
        assert [e["event"] for e in got["events"]] == ["detect", "shrink"]
        shrunk, single = got["shrunk"], got["single"]
        assert shrunk["best_params"] == single["best_params"]
        np.testing.assert_allclose(shrunk["best_metric"],
                                   single["best_metric"], rtol=1e-5)
        np.testing.assert_allclose(shrunk["fold_metrics"],
                                   single["fold_metrics"], rtol=1e-5,
                                   atol=1e-7)


def test_undisturbed_mesh_fit_runs_under_the_watchdog(world):
    for got in check_result(world, "undisturbed_mesh_fit_is_guarded"):
        assert got["ok"] == 1 and got["detections"] == 0


# -- bootstrap deadline ------------------------------------------------------

def test_initialize_bootstrap_deadline_with_injected_absent_coordinator(
        monkeypatch):
    monkeypatch.setenv("TX_MESH_INIT_TIMEOUT_S", "0.4")
    faults.configure("mesh.init_no_coordinator:on=1:delay=60")
    t0 = time.time()
    with pytest.raises(dist.MeshBootstrapError, match="coordinator"):
        dist.initialize(coordinator_address="localhost:1",
                        num_processes=2, process_id=1)
    assert time.time() - t0 < 10.0  # bounded, nowhere near the 60 s hang
    assert dist._initialized is False  # failure must not latch
    snap = resilience.mesh_telemetry().snapshot()
    assert snap["bootstrap_timeouts"] == 1


#: the bootstrap child (rank 1 of 2 on gloo): the port's testkit template
BOOTSTRAP_CHILD = MESH_BOOTSTRAP_CHILD_TEMPLATE

def _run_bootstrap_child(tmp_path, addr: str, env_extra: dict,
                         timeout: int = 120):
    script = tmp_path / "bootstrap.py"
    script.write_text(BOOTSTRAP_CHILD.format(repo=REPO, addr=addr,
                                             process_id=1))
    return subprocess.run(
        [sys.executable, str(script)], env=dict(_child_env(), **env_extra),
        timeout=timeout, capture_output=True, text=True,
    )


def test_initialize_bootstrap_deadline_env_armed_child(tmp_path):
    """TX_FAULTS in the child env arms the drill with no code change."""
    proc = _run_bootstrap_child(
        tmp_path, "localhost:1",
        {"TX_FAULTS": "mesh.init_no_coordinator:on=1:delay=600",
         "TX_MESH_INIT_TIMEOUT_S": "2"},
    )
    assert proc.returncode == 42, proc.stdout + proc.stderr
    assert "MESH_BOOTSTRAP_ERROR" in proc.stdout


@pytest.mark.parametrize("coordinator", ["silent", "absent"])
def test_initialize_unreachable_coordinator_never_hangs(tmp_path, coordinator):
    """A coordinator that accepts the connection and never answers (a
    localhost listener that never serves), or a port nobody listens on:
    rank 1 fails loudly within the deadline - the named
    MeshBootstrapError, or the rendezvous' own error - never an
    indefinite hang (the subprocess timeout is the hang detector)."""
    with socket.socket() as listener:
        listener.bind(("localhost", 0))
        port = listener.getsockname()[1]
        if coordinator == "silent":
            listener.listen(8)
        else:
            listener.close()
        t0 = time.time()
        proc = _run_bootstrap_child(
            tmp_path, f"localhost:{port}", {"TX_MESH_INIT_TIMEOUT_S": "3"})
    assert proc.returncode in (42, 43), proc.stdout + proc.stderr
    if coordinator == "silent":
        assert proc.returncode == 42, proc.stdout + proc.stderr
    assert time.time() - t0 < 60.0


# -- telemetry surfacing -----------------------------------------------------

def test_mesh_events_surface_in_stage_metrics_and_export(tmp_path):
    AppMetrics = mod(PORT, "utils.tracing").AppMetrics
    run_metrics = AppMetrics()  # the run the degradation happens in
    tel = resilience.mesh_telemetry()
    wd = CollectiveWatchdog(telemetry=tel)
    faults.configure("mesh.peer_die:on=1:delay=0.05")
    wd.run("drill.sum", lambda: 1, shrink_fn=lambda: 1, deadline_s=30.0)
    mj = run_metrics.to_json()
    assert [e["event"] for e in mj["mesh_resilience_events"]] == [
        "detect", "shrink"]
    time.sleep(0.01)
    assert "mesh_resilience_events" not in AppMetrics().to_json()
    out = tel.export(str(tmp_path / "mesh.json"), extra={"drill": True})
    assert out["shrinks"] == 1 and out["drill"] is True
    on_disk = json.load(open(tmp_path / "mesh.json"))
    assert on_disk["detections"] == 1
    assert set(on_disk["step_ms"]) == {"p50", "p95", "p99"}
    views = mod(PORT, "obs.metrics").metrics_registry().to_json()["views"]
    assert any(k.startswith("mesh/") for k in views)


def test_mesh_events_surface_in_summary_json():
    """A model's ``summary_json()`` carries ``meshResilience`` for the
    events of its own training window, and a healthy run has none."""
    from torch_parity import passenger_slice, passengers, reset_uids, workflow

    reset_uids(PORT)
    _, _, pred = passenger_slice(PORT)
    model = workflow(PORT, pred, passengers(PORT, 200)).train()
    assert "meshResilience" not in model.summary_json()
    wd = CollectiveWatchdog(telemetry=resilience.mesh_telemetry())
    faults.configure("mesh.peer_die:on=1:delay=0.05")
    wd.run("drill.sum", lambda: 1, shrink_fn=lambda: 1, deadline_s=30.0)
    mr = model.summary_json()["meshResilience"]
    assert mr["shrinks"] == 1
    assert [e["event"] for e in mr["events"]] == ["detect", "shrink"]
