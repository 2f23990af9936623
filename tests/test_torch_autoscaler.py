"""The fleet autoscaler, port against reference.

``transmogrifai_tpu_torch.fleet.autoscaler`` is a host copy of the JAX
package's capacity control loop.  Held on the CPU:

* the decision function: the same scripted evidence (a fake controller
  and router exposing only the public seams ``step()`` reads) and the
  same injected ``measure_fn`` drive ``FleetAutoscaler`` of both
  packages, and every decision is equal field for field (action,
  outcome, reason, target, members before and after, the evidence's
  sizing columns); the contracts of the JAX package's
  tests/test_autoscaler.py hold on the port's decisions, and
  ``test_multimodel.py``'s heterogeneous capacity mix sizes alike;
* the live drills on port workers (``device="cpu"``, one thread each):
  the worker ``retune`` verb, a load ramp that grows the fleet from 2
  to 4 and drains it back with no row dropped, the SIGKILL of a
  draining victim, the ``autoscaler.crash`` control-plane death and the
  health knobs on the controller seam;
* a device fault met by the control loop ends the loop (it is never
  counted as a step error) and leaves the data plane serving.
"""
from __future__ import annotations

import os
import signal
import threading
import time

import pytest

from torch_fleet import PORT_TINY_SPEC, controller, publish_tiny
from torch_parity import PORT, REF, mod

from transmogrifai_tpu_torch.faults import injection as faults
from transmogrifai_tpu_torch.fleet import (
    AutoscaleDecision,
    FleetAutoscaler,
    ScaleGovernor,
)
from transmogrifai_tpu_torch.parallel.kernels import KernelError

RAMP_DEADLINE_S = 120.0


@pytest.fixture(autouse=True)
def _disarm_faults():
    faults.reset()
    yield
    faults.reset()


@pytest.fixture(scope="module")
def fleet_registry(tmp_path_factory):
    return publish_tiny(str(tmp_path_factory.mktemp("autoscale-registry")),
                        n_versions=1)


def _controller(fleet_registry, tmp_path, n_replicas, **kw):
    return controller(fleet_registry["root"], PORT_TINY_SPEC, n_replicas,
                      str(tmp_path / "fleet"), **kw)


# -- ScaleGovernor: hysteresis units, both packages ---------------------------

GOVERNOR_SCRIPTS = {
    # (constructor, directions, expected outcomes)
    "streak_then_cooldown": (
        dict(up_consecutive=2, down_consecutive=4, cooldown=2),
        ["up"] * 5, ["over", "trigger", "over", "suppressed", "trigger"]),
    "hold_resets_both": (
        dict(up_consecutive=2, down_consecutive=2, cooldown=0),
        ["up", "hold", "up", "up"], ["over", "clear", "over", "trigger"]),
    "down_needs_its_own_streak": (
        dict(up_consecutive=2, down_consecutive=4, cooldown=0),
        ["down"] * 4, ["over"] * 3 + ["trigger"]),
    "flap_storm": (
        dict(up_consecutive=2, down_consecutive=2, cooldown=2),
        ["up" if i % 2 == 0 else "down" for i in range(60)], ["over"] * 60),
}


@pytest.mark.parametrize("case", sorted(GOVERNOR_SCRIPTS))
def test_governor_outcomes_equal_to_reference(case):
    kw, directions, want = GOVERNOR_SCRIPTS[case]
    ref = mod(REF, "fleet.autoscaler").ScaleGovernor(**kw)
    got = ScaleGovernor(**kw)
    outs = [got.observe_window(d) for d in directions]
    assert outs == want
    assert outs == [ref.observe_window(d) for d in directions]
    assert got.snapshot() == ref.snapshot()


def test_governor_streak_then_cooldown_suppression():
    g = ScaleGovernor(up_consecutive=2, down_consecutive=4, cooldown=2)
    assert g.observe_window("up") == "over"       # streak building
    assert g.observe_window("up") == "trigger"    # streak complete
    assert g.cooldown_left == 2
    assert g.observe_window("up") == "over"       # streaks reset
    assert g.observe_window("up") == "suppressed"  # complete but cooling
    assert g.observe_window("up") == "trigger"    # cooldown expired
    assert g.triggers == 2 and g.suppressed == 1


def test_governor_hold_resets_both_streaks():
    g = ScaleGovernor(up_consecutive=2, down_consecutive=2, cooldown=0)
    assert g.observe_window("up") == "over"
    assert g.observe_window("hold") == "clear"
    assert g.up_streak == 0 and g.down_streak == 0
    assert g.observe_window("up") == "over"       # starts from scratch
    assert g.observe_window("up") == "trigger"


def test_governor_down_needs_its_own_longer_streak():
    g = ScaleGovernor(up_consecutive=2, down_consecutive=4, cooldown=0)
    for _ in range(3):
        assert g.observe_window("down") == "over"
    assert g.observe_window("down") == "trigger"


def test_governor_flap_storm_never_triggers():
    g = ScaleGovernor(up_consecutive=2, down_consecutive=2, cooldown=2)
    for i in range(60):
        out = g.observe_window("up" if i % 2 == 0 else "down")
        assert out == "over"  # every flip resets the other streak
    assert g.triggers == 0 and g.windows == 60


def test_governor_rejects_unknown_direction():
    with pytest.raises(ValueError):
        ScaleGovernor().observe_window("sideways")


# -- step(): the decision function over a fake fleet --------------------------

class _FakeHandle:
    def __init__(self, instance, svc_s=None, obs=None):
        self.instance = instance
        self.svc_s_ewma = svc_s
        self.obs = dict(obs or {})


class _FakeRouter:
    """Just the public seams ``step()`` reads: snapshot, live replicas,
    cost model, the retune broadcast."""

    def __init__(self, members, svc_s=0.01, snapshot=None):
        self.cost_model = None
        self._members = members  # shared list with the controller
        self.svc_s = svc_s
        self.snapshot_doc = dict(snapshot or {})
        self.broadcasts: list = []

    def snapshot(self):
        doc = {"rows_ok": 0, "requests_ok": 0, "queue_depth": 0,
               "healthy_replicas": len(self._members), "replicas": {}}
        doc.update(self.snapshot_doc)
        return doc

    def live_replicas(self):
        return [_FakeHandle(m, svc_s=self.svc_s) for m in self._members]

    def broadcast(self, cmd, args=None, timeout_s=30.0):
        self.broadcasts.append((cmd, dict(args or {})))
        return {m: {"ok": True} for m in self._members}


class _FakeSLO:
    def __init__(self):
        self.firing: list = []

    def observe(self):
        return {"objectives": {}, "firing": [{"name": n}
                                             for n in self.firing]}


class _FakeController:
    def __init__(self, n=2):
        self.members = [f"replica-{i}" for i in range(n)]
        self.router = _FakeRouter(self.members)
        self.slo_engine = _FakeSLO()
        self.gave_up: list = []
        self.autoscaler = None
        self.added: list = []
        self.removed: list = []
        self.add_error = None

    def member_instances(self):
        return list(self.members)

    def gave_up_instances(self):
        return list(self.gave_up)

    def add_replica(self, probe_timeout_s=30.0):
        if self.add_error is not None:
            raise self.add_error
        name = f"replica-{len(self.members)}"
        self.members.append(name)
        self.added.append(name)
        self.router._members = self.members
        return name

    def remove_replica(self, instance, drain_timeout_s=30.0):
        self.members.remove(instance)
        self.removed.append(instance)
        self.router._members = self.members
        return {"instance": instance, "drained": True, "drain_s": 0.0}


def _scaler(pkg, fc, **kw):
    kw.setdefault("min_replicas", 1)
    kw.setdefault("max_replicas", 8)
    kw.setdefault("up_consecutive", 2)
    kw.setdefault("down_consecutive", 2)
    kw.setdefault("cooldown_windows", 2)
    kw.setdefault("ref_batch_rows", 10)
    kw.setdefault("retune_enabled", False)
    return mod(pkg, "fleet.autoscaler").FleetAutoscaler(fc, **kw)


#: the evidence columns a decision is sized from, compared across packages
_EVIDENCE_KEYS = ("slo_firing", "members", "members_n", "gave_up",
                  "healthy_replicas", "serving_n", "queue_depth",
                  "in_flight_rows", "capacity", "capacity_mix",
                  "utilization", "added", "retired", "admission_failures")


def _decision_fields(d):
    if d is None:
        return None
    ev = {k: d.evidence[k] for k in _EVIDENCE_KEYS if k in d.evidence}
    ev["governor"] = d.evidence.get("governor")
    kd = d.evidence.get("knob_decision")
    if kd is not None:
        ev["knob"] = kd
    return (d.action, d.outcome, d.reason, d.target, d.members_before,
            d.members_after, ev)


def _overload(fc):
    fc.router.svc_s = 0.01
    fc.router.snapshot_doc = {
        "queue_depth": 30, "healthy_replicas": 2,
        "replicas": {"replica-0": {"in_flight_rows": 50},
                     "replica-1": {"in_flight_rows": 50}}}


def _at_max(fc):
    fc.router.svc_s = 0.01
    fc.router.snapshot_doc = {
        "queue_depth": 30, "healthy_replicas": 2,
        "replicas": {"replica-0": {"in_flight_rows": 50}}}


def _dead(fc):
    fc.gave_up = ["replica-2", "replica-3"]
    fc.router.svc_s = 0.01
    fc.router.snapshot_doc = {
        "queue_depth": 0, "healthy_replicas": 2,
        "replicas": {"replica-0": {"in_flight_rows": 120},
                     "replica-1": {"in_flight_rows": 120}}}


def _idle(fc):
    fc.router.svc_s = 0.01
    fc.router.snapshot_doc = {"queue_depth": 0,
                              "healthy_replicas": len(fc.members),
                              "replicas": {}}


def _stale_burn(fc):
    _idle(fc)
    fc.slo_engine.firing = ["serving-drift-js"]


def _latency_burn(fc):
    fc.router.svc_s = 0.01
    fc.router.snapshot_doc = {"queue_depth": 1, "healthy_replicas": 2,
                              "replicas": {}}
    fc.slo_engine.firing = ["serving-p99-latency"]


#: name -> (members, arrange, scaler kwargs, windows)
STEP_SCENARIOS = {
    "surge": (2, _overload, dict(interval_s=0.5, target_utilization=0.7),
              2),
    "at_max": (2, _at_max, dict(max_replicas=2), 2),
    "replica_death": (4, _dead, dict(interval_s=0.5,
                                     target_utilization=0.7), 2),
    "idle_down": (4, _idle, dict(min_replicas=1, idle_utilization=0.3), 2),
    "stale_burn": (3, _stale_burn, dict(min_replicas=1,
                                        down_consecutive=2), 2),
    "retune_tuned": (2, _latency_burn, dict(
        retune_enabled=True, ref_batch_rows=16, retune_margin=0.03,
        measure_fn=lambda k: 100.0 + float(k["max_batch_size"])), 3),
    "retune_baseline": (2, _latency_burn, dict(
        retune_enabled=True, ref_batch_rows=16, retune_margin=0.03,
        measure_fn=lambda k: 100.0), 3),
}


def _run_scenario(pkg, name):
    n, arrange, kw, windows = STEP_SCENARIOS[name]
    fc = _FakeController(n=n)
    arrange(fc)
    s = _scaler(pkg, fc, **kw)
    decisions = [s.step() for _ in range(windows)]
    return fc, s, decisions


@pytest.mark.parametrize("name", sorted(STEP_SCENARIOS))
def test_step_decisions_equal_to_reference(name):
    """The same scripted evidence through both packages' decision
    functions: every decision equal field for field, and the fake fleet
    left with the same members and the same broadcasts."""
    fc_p, s_p, got = _run_scenario(PORT, name)
    fc_r, s_r, want = _run_scenario(REF, name)
    assert [_decision_fields(d) for d in got] \
        == [_decision_fields(d) for d in want]
    assert fc_p.members == fc_r.members
    assert fc_p.added == fc_r.added and fc_p.removed == fc_r.removed
    assert fc_p.router.broadcasts == fc_r.router.broadcasts
    for key in ("steps", "scale_ups", "scale_downs", "retunes",
                "replicas_added", "replicas_removed", "errors"):
        assert getattr(s_p, key) == getattr(s_r, key), key


def test_step_sizes_surge_from_demand_not_plus_one():
    fc, _s, (d1, d2) = _run_scenario(PORT, "surge")
    assert d1.action == "hold" and d1.outcome == "over"
    assert d1.reason.startswith("overload:")
    # sized from demand: ceil(400 / (100 * 0.7)) = 6, NOT 2 + 1
    assert d2.action == "scale_up" and d2.target == 6
    assert fc.added == ["replica-2", "replica-3", "replica-4",
                        "replica-5"]
    assert d2.members_after == 6
    assert d2.evidence["capacity"]["source"] == "observed_ewma"
    assert d2.evidence["utilization"] >= 2.0
    assert d2.evidence["governor"]["triggers"] == 1


def test_step_at_max_defers_to_brownout():
    fc, _s, (_d1, d) = _run_scenario(PORT, "at_max")
    assert d.action == "hold" and d.outcome == "at_max"
    assert "brownout" in d.reason
    assert fc.added == []  # the quorum rule stays the last line


def test_step_replica_death_is_replacement_capacity():
    _fc, _s, (_d1, d) = _run_scenario(PORT, "replica_death")
    assert d.action == "scale_up"
    # demand 240 rows/s over 200 effective -> util 1.2; sized
    # ceil(240 / 70) = 4 serving replicas, not a 1:1 restart
    assert d.target == 4
    assert d.evidence["gave_up"] == ["replica-2", "replica-3"]
    assert d.evidence["serving_n"] == 2


def test_step_scales_down_idle_fleet_youngest_first():
    fc, _s, (d1, d2) = _run_scenario(PORT, "idle_down")
    assert d1.action == "hold" and d1.reason.startswith("idle:")
    assert d2.action == "scale_down" and d2.target == 1
    assert fc.removed == ["replica-3", "replica-2", "replica-1"]
    assert fc.members == ["replica-0"]
    assert [r["instance"] for r in d2.evidence["retired"]] == fc.removed


@pytest.mark.parametrize("pkg", [PORT, REF])
def test_step_flap_storm_never_scales(pkg):
    fc = _FakeController(n=2)
    fc.router.svc_s = 0.01
    overload = {"queue_depth": 30, "healthy_replicas": 2,
                "replicas": {"replica-0": {"in_flight_rows": 100}}}
    idle = {"queue_depth": 0, "healthy_replicas": 2, "replicas": {}}
    s = _scaler(pkg, fc, min_replicas=1)
    for i in range(12):
        fc.router.snapshot_doc = overload if i % 2 == 0 else idle
        d = s.step()
        assert d is None or d.action == "hold"
    assert fc.added == [] and fc.removed == []
    assert s.governor.triggers == 0


def test_stale_burn_over_idle_fleet_still_scales_down():
    fc, _s, decisions = _run_scenario(PORT, "stale_burn")
    trigger = decisions[-1]
    assert trigger is not None and trigger.action == "scale_down"
    assert trigger.reason.startswith("idle:")
    assert fc.removed and not fc.added


def test_restarted_autoscaler_adopts_with_fresh_streaks():
    fc = _FakeController(n=3)
    fc.router = None  # no data plane reads: adoption alone
    s = _scaler(PORT, fc, interval_s=0.05)
    s.start()
    try:
        time.sleep(0.2)
    finally:
        s.stop()
    decisions = s.decisions()
    assert decisions[0].action == "adopt"
    assert decisions[0].members_before == 3
    assert decisions[0].evidence["governor"]["up_streak"] == 0
    assert [d.action for d in decisions] == ["adopt"]
    assert s.scale_ups == 0 and s.scale_downs == 0
    assert fc.autoscaler is s
    snap = s.snapshot()
    assert snap["crashed"] is False and snap["members"] == 3
    assert not s.alive()


def test_retune_rides_the_loop_and_never_regresses():
    fc, s, (d, _d2, _d3) = _run_scenario(PORT, "retune_tuned")
    assert d.action == "retune" and d.outcome == "tuned"
    assert d.evidence["knob_decision"]["tuned"] is True
    cmd, args = fc.router.broadcasts[0]
    assert cmd == "retune" and args["source"] == "autotune"
    assert args["max_batch_size"] == 32  # the winning candidate
    assert s.retunes == 1
    # a baseline win restores the hand-set default, and the retune
    # cooldown holds: the next burning windows do not probe again
    fc2, s2, (d2, d3, _d4) = _run_scenario(PORT, "retune_baseline")
    assert d2.action == "retune" and d2.outcome == "baseline_held"
    cmd2, args2 = fc2.router.broadcasts[0]
    assert cmd2 == "retune" and args2["source"] == "hand_set"
    assert args2["max_batch_size"] == 0  # resets the worker cap
    assert s2._retune_cooldown_left > 0
    assert d3.action in ("hold", "scale_up")
    assert s2.retunes == 1


def test_decision_to_json_round_trips():
    d = AutoscaleDecision(action="scale_up", outcome="trigger",
                          reason="r", members_before=2,
                          members_after=4, target=4,
                          evidence={"utilization": 2.0})
    doc = d.to_json()
    want = mod(REF, "fleet.autoscaler").AutoscaleDecision(
        action="scale_up", outcome="trigger", reason="r",
        members_before=2, members_after=4, target=4,
        evidence={"utilization": 2.0}, t=d.t).to_json()
    assert doc == want
    assert doc["action"] == "scale_up" and doc["target"] == 4
    assert doc["evidence"] == {"utilization": 2.0}
    assert doc["t"] <= time.time()


def test_autoscaler_validates_bounds():
    with pytest.raises(ValueError):
        FleetAutoscaler(_FakeController(), min_replicas=0)
    with pytest.raises(ValueError):
        FleetAutoscaler(_FakeController(), min_replicas=4,
                        max_replicas=2)


@pytest.mark.parametrize("pkg", [PORT, REF])
def test_autoscaler_sizes_from_heterogeneous_capacity_mix(pkg):
    """With a placement plan the autoscaler sizes from the per-replica
    capacity mix, not ceil(demand / one-capacity); both packages size
    the same."""
    scaler_cls = mod(pkg, "fleet.autoscaler").FleetAutoscaler
    plan_cls = mod(pkg, "fleet.multimodel").PlacementPlan

    class _Ctl:
        placement = plan_cls(
            assignments={"replica-0": ["a"], "replica-1": ["b"]},
            capacity_rows_s={"replica-0": 3000.0, "replica-1": 1000.0},
            model_rows_s={"a": 3000.0, "b": 1000.0})
    scaler = scaler_cls.__new__(scaler_cls)
    scaler.controller = _Ctl()
    scaler.target_utilization = 0.5
    scaler.max_replicas = 8
    capacity = {"per_replica_rows_s": 2000.0}
    mix = scaler._capacity_mix(["replica-0", "replica-1"], [], capacity)
    assert mix["replica-0"] == pytest.approx(3000.0)
    assert mix["replica-1"] == pytest.approx(1000.0)
    n = scaler._sized_target({
        "demand_rows_s": 2500.0, "capacity_mix": mix,
        "capacity": {"per_replica_rows_s": 2000.0}})
    assert n == 3
    n = scaler._sized_target({
        "demand_rows_s": 2500.0, "capacity_mix": {},
        "capacity": {"per_replica_rows_s": 2000.0}})
    assert n == 3  # ceil(2500 / (2000 * 0.5))


# -- device faults pass through ------------------------------------------------

def test_device_fault_in_scale_up_is_not_an_admission_shortfall():
    """A ``KernelError`` while admitting a new replica escapes ``step()``
    (the reference records it as an admission failure and moves on)."""
    fc = _FakeController(n=2)
    _overload(fc)
    fc.add_error = KernelError("bin_matrix kernel launch failed")
    s = _scaler(PORT, fc, interval_s=0.5, target_utilization=0.7)
    s.step()
    with pytest.raises(KernelError):
        s.step()
    # an ordinary admission failure is still recorded as a shortfall
    fc2 = _FakeController(n=2)
    _overload(fc2)
    fc2.add_error = RuntimeError("probe timed out")
    s2 = _scaler(PORT, fc2, interval_s=0.5, target_utilization=0.7)
    s2.step()
    d = s2.step()
    assert d.action == "scale_up" and d.evidence["added"] == []
    assert d.evidence["admission_failures"] == [
        "RuntimeError: probe timed out"]


def test_device_fault_ends_the_control_loop_not_a_step_error():
    fc = _FakeController(n=2)
    _overload(fc)
    fc.add_error = KernelError("bin_matrix kernel launch failed")
    s = _scaler(PORT, fc, interval_s=0.05, up_consecutive=1)
    s.start()
    deadline = time.monotonic() + 10.0
    while time.monotonic() < deadline and s.alive():
        time.sleep(0.02)
    s.stop(timeout_s=5.0)
    assert s.crashed and not s.alive()
    assert s.errors == 0
    assert s.snapshot()["crashed"] is True


# -- live drills on port workers -------------------------------------------------

def test_worker_retune_verb_applies_chunk_cap(fleet_registry, tmp_path):
    records = fleet_registry["records"]
    with _controller(fleet_registry, tmp_path, 1) as fc:
        out = fc.router.score_batch(records[:30], timeout_s=60.0)
        assert len(out) == 30
        doc = fc.router.control("replica-0", "retune",
                                {"max_batch_size": 8}, timeout_s=30.0)
        assert doc["ok"] and doc["applied"]["max_batch_size"] == 8
        assert doc["knobs"]["source"] == "autotune"
        out = fc.router.score_batch(records[:30], timeout_s=60.0)
        assert len(out) == 30
        info = fc.router.control("replica-0", "status", timeout_s=30.0)
        assert info["knobs"]["max_batch_size"] == 8
        doc = fc.router.control(
            "replica-0", "retune",
            {"max_batch_size": 0, "source": "hand_set"}, timeout_s=30.0)
        assert doc["knobs"] == {"max_batch_size": None,
                                "max_wait_us": None,
                                "source": "hand_set"}


def test_traffic_ramp_grows_and_shrinks_without_dropping_rows(
        fleet_registry, tmp_path):
    from transmogrifai_tpu_torch.obs.trace import tracer

    records = fleet_registry["records"]
    batch = records[:24]
    t_start = time.monotonic()
    with _controller(
        fleet_registry, tmp_path, 2, transport="tcp", max_restarts=0,
        worker_env={"TX_FAULTS": "serving.slow_batch:every=1:delay=0.03"},
    ) as fc:
        fc.router.score_batch(batch, timeout_s=60.0)  # warm
        delivered: list = []
        errors: list = []
        stop_pump = threading.Event()

        def pump() -> None:
            while not stop_pump.is_set():
                try:
                    res = fc.router.submit(records=batch).wait(120.0)
                    delivered.append(res.n_rows)
                except Exception as e:  # noqa: BLE001 - ledger counts
                    errors.append(repr(e))

        threads = [threading.Thread(target=pump) for _ in range(6)]
        with tracer().span("autoscale-ramp-drill") as ramp_span:
            scaler = FleetAutoscaler(
                fc, min_replicas=2, max_replicas=4, interval_s=0.25,
                up_consecutive=2, down_consecutive=3,
                cooldown_windows=2, retune_enabled=False,
                probe_timeout_s=120.0, drain_timeout_s=60.0)
            scaler.start()
            try:
                for t in threads:
                    t.start()
                deadline = time.monotonic() + RAMP_DEADLINE_S
                while time.monotonic() < deadline:
                    if len(fc.member_instances()) >= 4:
                        break
                    time.sleep(0.1)
                grown = len(fc.member_instances())
                stop_pump.set()
                for t in threads:
                    t.join(timeout=120.0)
                assert grown >= 4, \
                    f"fleet never grew under load: {grown} members"
                while time.monotonic() < deadline:
                    if len(fc.member_instances()) <= 2:
                        break
                    time.sleep(0.1)
                assert len(fc.member_instances()) == 2, \
                    "fleet never shrank back after load stopped"
            finally:
                stop_pump.set()
                scaler.stop()

        assert errors == []
        snap = fc.router.snapshot()
        assert snap["rows_ok"] == (len(delivered) + 1) * len(batch)
        assert sum(delivered) == len(delivered) * len(batch)
        assert snap["requests_failed"] == 0

        actions = [d.action for d in scaler.decisions()]
        assert "adopt" == actions[0]
        assert "scale_up" in actions and "scale_down" in actions
        up = next(d for d in scaler.decisions()
                  if d.action == "scale_up")
        assert up.evidence["capacity"]["per_replica_rows_s"] > 0
        assert up.evidence["governor"]["triggers"] >= 1
        assert up.members_after > up.members_before
        down = next(d for d in scaler.decisions()
                    if d.action == "scale_down")
        assert down.members_after < down.members_before
        assert all(r.get("drained") for r in down.evidence["retired"])
        decision_spans = [
            s for s in tracer().spans(ramp_span.trace_id)
            if s["name"] == "autoscaler.decision"]
        assert len(decision_spans) >= 3  # adopt + up + down at least
        assert {s["trace"] for s in decision_spans} \
            == {ramp_span.trace_id}

        status = fc.status()
        assert status["autoscaler"]["scale_ups"] >= 1
        assert status["autoscaler"]["scale_downs"] >= 1
        assert status["autoscaler"]["replicas_added"] >= 2
    assert time.monotonic() - t_start < RAMP_DEADLINE_S + 60.0


def test_scale_down_victim_sigkilled_mid_drain_conserves_rows(
        fleet_registry, tmp_path):
    records = fleet_registry["records"]
    batch = records[:24]
    with _controller(
        fleet_registry, tmp_path, 3, max_restarts=0,
        worker_env={"TX_FAULTS": "serving.slow_batch:every=1:delay=0.15"},
    ) as fc:
        fc.router.score_batch(batch, timeout_s=60.0)  # warm
        victim_pid = fc._replicas["replica-2"].proc.pid
        delivered: list = []
        errors: list = []
        submitted = 36

        def pump(k: int) -> None:
            for _ in range(k):
                try:
                    res = fc.router.submit(records=batch).wait(120.0)
                    delivered.append(res.n_rows)
                except Exception as e:  # noqa: BLE001 - ledger counts
                    errors.append(repr(e))

        threads = [threading.Thread(target=pump, args=(submitted // 4,))
                   for _ in range(4)]
        for t in threads:
            t.start()
        time.sleep(0.4)  # saturate: the victim holds in-flight work
        report: dict = {}

        def retire() -> None:
            report.update(fc.remove_replica("replica-2",
                                            drain_timeout_s=60.0))

        retirer = threading.Thread(target=retire)
        retirer.start()
        time.sleep(0.1)  # the drain is underway, batches in flight
        os.kill(victim_pid, signal.SIGKILL)
        retirer.join(timeout=120.0)
        assert not retirer.is_alive(), "removal hung on a dead victim"
        for t in threads:
            t.join(timeout=120.0)

        assert errors == []
        assert len(delivered) == submitted
        assert sum(delivered) == submitted * len(batch)
        snap = fc.router.snapshot()
        assert snap["rows_ok"] == (submitted + 1) * len(batch)
        assert report["instance"] == "replica-2"
        assert sorted(fc.member_instances()) \
            == ["replica-0", "replica-1"]
        live = {h.instance for h in fc.router.live_replicas()}
        assert live == {"replica-0", "replica-1"}
        post = fc.router.score_batch(batch, timeout_s=60.0)
        assert len(post) == len(batch)


def test_autoscaler_crash_leaves_the_data_plane_serving(
        fleet_registry, tmp_path):
    records = fleet_registry["records"]
    batch = records[:16]
    with _controller(fleet_registry, tmp_path, 2,
                     max_restarts=0) as fc:
        fc.router.score_batch(batch, timeout_s=60.0)  # warm
        faults.configure("autoscaler.crash:on=2")
        scaler = FleetAutoscaler(fc, min_replicas=2, max_replicas=4,
                                 interval_s=0.1, retune_enabled=False)
        scaler.start()
        deadline = time.monotonic() + 30.0
        while time.monotonic() < deadline and scaler.alive():
            time.sleep(0.05)
        faults.reset()
        assert not scaler.alive() and scaler.crashed
        assert scaler.snapshot()["crashed"] is True

        out = fc.router.score_batch(batch, timeout_s=60.0)
        assert len(out) == len(batch)
        assert sorted(fc.member_instances()) \
            == ["replica-0", "replica-1"]

        scaler2 = FleetAutoscaler(fc, min_replicas=2, max_replicas=4,
                                  interval_s=0.1,
                                  retune_enabled=False)
        scaler2.start()
        try:
            time.sleep(0.6)
        finally:
            scaler2.stop()
        decisions = scaler2.decisions()
        assert decisions[0].action == "adopt"
        assert scaler2.scale_ups == 0 and scaler2.scale_downs == 0
        assert all(d.action in ("adopt", "hold") for d in decisions)
        assert fc.status()["autoscaler"]["crashed"] is False


def test_health_knobs_flow_through_controller(fleet_registry, tmp_path):
    with _controller(fleet_registry, tmp_path, 1, eject_after=5,
                     probe_interval_s=0.25,
                     probe_timeout_s=1.25) as fc:
        assert fc.router.eject_after == 5
        assert fc.router.probe_interval_s == 0.25
        assert fc.router.probe_timeout_s == 1.25
        assert fc.router.handle("replica-0").health.eject_after == 5


def test_bulk_job_re_resolves_router_when_fleet_grows_mid_job(
        fleet_registry, tmp_path):
    """The bulk job re-resolves its router at every shard boundary, so a
    replica the fleet adds mid-job serves the next shard."""
    from transmogrifai_tpu_torch.bulk import BulkScoringJob
    from transmogrifai_tpu_torch.testkit.drills import (
        tiny_drill_pipeline,
        write_shard_csv,
    )

    _wf, data, _records, _pred = tiny_drill_pipeline(n=120, seed=0,
                                                     device="cpu")
    model = fleet_registry["model"]
    rows = [{"y": data["y"][i], "a": data["a"][i], "c": data["c"][i]}
            for i in range(120)]
    shards = []
    for k in range(3):
        p = str(tmp_path / f"in-{k}.csv")
        write_shard_csv(p, rows[k * 40:(k + 1) * 40])
        shards.append(p)
    with _controller(fleet_registry, tmp_path, 2, max_restarts=0) as fc:
        resolutions = [0]

        def live_router():
            resolutions[0] += 1
            if resolutions[0] == 2:
                # the fleet grows AT the first shard boundary
                fc.add_replica(probe_timeout_s=120.0)
            return fc.router

        jd = str(tmp_path / "job")
        s = BulkScoringJob(model, jd, shards, router=live_router,
                           chunk_rows=16, max_in_flight=4).run()
        led = s["ledger"]
        assert led["balanced"] and led["rows_in"] == 120
        # one resolution at construction + one per shard boundary
        assert resolutions[0] == 1 + 3
        live = {h.instance for h in fc.router.live_replicas()}
        assert "replica-2" in live
        assert len(fc.member_instances()) == 3

        # a CONTROLLER source re-resolves the same way
        jd2 = str(tmp_path / "job2")
        s2 = BulkScoringJob(model, jd2, shards, router=fc,
                            chunk_rows=16, max_in_flight=4).run()
        assert s2["ledger"]["balanced"]
