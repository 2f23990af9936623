"""The continuous-training loop, port against reference.

Ports the contracts of ``tests/test_continuous.py`` (less its CLI cases:
``cli.py`` is not ported) onto ``transmogrifai_tpu_torch.continuous``:

* governor decisions on the same score sequences, and the shard
  follower's ids on the same directory: equal to the reference's;
* the direct-mode loop on the same shards: the same verdict per cycle,
  the same trigger, publish and promote, the window scores within 1e-9
  of the reference's (one host JS divergence each), and one trace id per
  cycle;
* crash recovery: the ``continuous.refit_crash`` kill drill in a port
  child (``sys.modules["jax"] = None``) leaves the old stable, and the
  next cycle recovers;
* a device fault in the refit propagates and the registry keeps its
  stable;
* the constructor takes the reference's keywords (``train_cache_dir``,
  accepted and unused, and the four canary knobs), a ``module:function``
  factory loads through ``fleet.worker.load_workflow_factory``, and
  ``fleet=`` runs the canary through a ``FleetController``;
* fleet mode end to end on port replica workers (CPU, one thread each):
  a mid-stream shift on a live two-replica fleet is detected, refit,
  canaried and auto-promoted, the old model serving throughout with
  zero dropped rows, the cycle under one trace id.  It is held to the
  reference's contract (the JAX package's own e2e needs
  ``jax.experimental.enable_x64``, which jax 0.9 removed, and the port
  keeps no compiled-program cache, so the reference's cache-hit checks
  have no counterpart).
"""
from __future__ import annotations

import csv
import json
import os
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import pytest

from torch_parity import (
    DEVICE_FAULTS,
    PORT,
    REF,
    mod,
    reset_uids,
    tiny_pipeline,
)

from transmogrifai_tpu_torch.testkit.drills import (
    CONTINUOUS_REFIT_CRASH_TEMPLATE,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _disarm():
    for pkg in (REF, PORT):
        mod(pkg, "faults.injection").reset()
    yield
    for pkg in (REF, PORT):
        mod(pkg, "faults.injection").reset()


def shard_rows(n: int = 64, seed: int = 0, shift: float = 0.0) -> list:
    """n (y, a, c) rows: ``a`` ~ N(shift, 1), ``y`` thresholds on the
    centred value, so the labels stay balanced whatever the shift while
    the marginal of ``a`` (what the drift monitor watches) moves."""
    rng = np.random.RandomState(seed)
    a = rng.randn(n) + float(shift)
    y = ((a - float(shift) + 0.3 * rng.randn(n)) > 0).astype(float)
    return [{"y": float(y[i]), "a": float(a[i]), "c": ("u", "v", "w")[i % 3]}
            for i in range(n)]


def write_shard(path: str, rows: list) -> str:
    """Atomically publish one y,a,c shard CSV (tmp + os.replace), the
    follower's producer contract."""
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
    with os.fdopen(fd, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=["y", "a", "c"])
        w.writeheader()
        w.writerows(rows)
    os.replace(tmp, path)
    return path


def _factory(pkg):
    def build():
        reset_uids(pkg)
        return tiny_pipeline(pkg)[0]
    return build


def _trainer(pkg, root, **kw):
    watch = os.path.join(root, "watch")
    os.makedirs(watch, exist_ok=True)
    kw.setdefault("drift_threshold", 0.35)
    kw.setdefault("consecutive_windows", 2)
    kw.setdefault("cooldown_windows", 1)
    kw.setdefault("min_window_rows", 32)
    kw.setdefault("refit_rows", 256)
    kw.setdefault("train_fused", False)
    kw.setdefault("bootstrap", True)
    return mod(pkg, "continuous").ContinuousTrainer(
        watch, os.path.join(root, "registry"), _factory(pkg),
        status_dir=root, **kw)


# ---------------------------------------------------------------------------
# RefitGovernor and the shard follower
# ---------------------------------------------------------------------------
SEQUENCES = [
    # (threshold, consecutive, cooldown, [(score, forced), ...])
    (0.5, 3, 2, [(0.6, False), (0.6, False), (0.4, False), (0.6, False),
                 (0.9, False), (0.7, False), (0.8, False), (0.1, False),
                 (0.9, False)]),
    (0.5, 1, 2, [(0.9, False), (0.99, False), (0.2, False), (0.9, False)]),
    (0.5, 3, 2, [(0.0, True), (0.0, True), (0.7, False), (0.7, True)]),
    (0.1, 2, 0, [(0.2, False)] * 7),
]


@pytest.mark.parametrize("seq", SEQUENCES, ids=range(len(SEQUENCES)))
def test_governor_decisions_equal_the_reference(seq):
    thr, consecutive, cooldown, windows = seq
    out = {}
    for pkg in (REF, PORT):
        gov = mod(pkg, "continuous").RefitGovernor(
            threshold=thr, consecutive=consecutive, cooldown=cooldown)
        verdicts = [gov.observe_window(s, forced=f) for s, f in windows]
        out[pkg] = (verdicts, gov.snapshot())
    assert out[PORT] == out[REF]
    assert set(out[PORT][0]) <= set(mod(PORT, "continuous.governor")
                                    .VERDICTS)


def test_governor_hysteresis_cooldown_and_forced():
    gov = mod(PORT, "continuous").RefitGovernor(
        threshold=0.5, consecutive=3, cooldown=2)
    assert [gov.observe_window(s) for s in (0.6, 0.6, 0.4)] == [
        "over", "over", "clear"]
    assert gov.over_streak == 0 and gov.triggers == 0
    assert [gov.observe_window(s) for s in (0.6, 0.9, 0.7)] == [
        "over", "over", "trigger"]
    assert gov.cooldown_left == 2
    assert gov.observe_window(0.0, forced=True) == "suppressed"
    assert gov.suppressed == 1
    with pytest.raises(ValueError):
        mod(PORT, "continuous").RefitGovernor(consecutive=0)
    with pytest.raises(ValueError):
        mod(PORT, "continuous").RefitGovernor(cooldown=-1)


def test_follower_ids_equal_the_reference(tmp_path):
    """Monotonic ids, exactly-once by name, name order within a poll,
    non-shard files ignored - the same ids from both packages' followers
    over one directory."""
    watch = tmp_path / "watch"
    followers = {pkg: mod(pkg, "readers.pipeline").ShardDirectoryFollower(
        str(watch)) for pkg in (REF, PORT)}

    def poll():
        got = {pkg: [(s.shard_id, os.path.basename(s.path), s.fmt)
                     for s in f.poll()] for pkg, f in followers.items()}
        assert got[PORT] == got[REF]
        return got[PORT]

    assert poll() == []  # missing dir: nothing yet, not an error
    watch.mkdir()
    write_shard(str(watch / "s0001.csv"), shard_rows(4, seed=1))
    (watch / "notes.txt").write_text("not a shard")
    (watch / "subdir").mkdir()
    assert poll() == [(0, "s0001.csv", "csv")]
    write_shard(str(watch / "s0001.csv"), shard_rows(4, seed=2))
    assert poll() == []  # an in-place overwrite is not re-read
    write_shard(str(watch / "s0003.csv"), shard_rows(4, seed=3))
    write_shard(str(watch / "s0002.avro"), shard_rows(4, seed=4))
    assert poll() == [(1, "s0002.avro", "avro"), (2, "s0003.csv", "csv")]
    assert followers[PORT].shards_seen == 3
    pinned = mod(PORT, "readers.pipeline").ShardDirectoryFollower(
        str(watch), fmt="csv")
    assert {s.fmt for s in pinned.poll()} == {"csv"}


def test_follower_rides_the_pipeline_round_trip(tmp_path):
    rows = shard_rows(12, seed=5)
    write_shard(str(tmp_path / "a.csv"), rows[:6])
    write_shard(str(tmp_path / "b.csv"), rows[6:])
    pl = mod(PORT, "readers.pipeline")
    ft = mod(PORT, "types.feature_types")
    follower = pl.ShardDirectoryFollower(str(tmp_path))
    schema = {"y": ft.RealNN, "a": ft.Real, "c": ft.PickList}
    pipe = follower.pipeline(follower.poll(), schema, workers=2)
    cols = {n: c.to_list() for n, c in pl.pipelined_columns(pipe).items()}
    assert cols["c"] == [r["c"] for r in rows]
    assert cols["a"] == pytest.approx([r["a"] for r in rows])
    assert follower.pipeline([], schema) is None


def test_windowed_reset_catches_a_shift_the_cumulative_merge_dilutes():
    """The reason the loop is windowed: after enough baseline traffic the
    cumulative merge waters a full shift down below the warn threshold,
    while the same monitor reset at the window boundary saturates."""
    wf, _data, records, _name = tiny_pipeline(PORT)
    model = wf.train()
    mon = mod(PORT, "schema.drift").DriftMonitor(model.schema_contract)
    base = records[:64]
    shifted = mod(PORT, "testkit.random_data").shift_records(
        base, "a", delta=30.0)
    for _ in range(19):
        mon.observe(base)
    mon.observe(shifted)
    diluted = mon.scores()["a"]
    assert diluted < mon.warn_threshold
    mon.reset()
    mon.observe(shifted)
    assert mon.scores()["a"] > max(0.9, 5 * diluted)


# ---------------------------------------------------------------------------
# the direct-mode loop
# ---------------------------------------------------------------------------
SCRIPT = [  # (shard rows or None, expected verdict)
    (None, "idle"),
    (shard_rows(8, seed=20), "thin"),
    (shard_rows(64, seed=21), "clear"),
    (shard_rows(64, seed=22, shift=3.0), "over"),
    (shard_rows(64, seed=23, shift=3.0), "trigger"),
    (shard_rows(64, seed=24, shift=3.0), "clear"),
]


def _drive(pkg, root):
    trainer = _trainer(pkg, root)
    v1 = trainer.version
    cycles = []
    for i, (rows, _want) in enumerate(SCRIPT):
        if rows is not None:
            write_shard(os.path.join(trainer.watch_dir, f"s{i:04d}.csv"),
                        rows)
        cycles.append(trainer.run_cycle())
    return trainer, v1, cycles


def test_direct_mode_detects_refits_and_promotes_like_reference(tmp_path):
    """The same shards through both packages' trainers: the same verdict
    per cycle (idle, thin, clear, over, trigger -> publish -> promote,
    then the refit's own contract reading the shifted stream as clear),
    the same versions, window scores within
    1e-9, the trigger cycle under one trace id, the status document and
    the ``tx_continuous_*`` scrape."""
    runs = {pkg: _drive(pkg, str(tmp_path / pkg)) for pkg in (REF, PORT)}
    trainer, v1, cycles = runs[PORT]
    assert [c["verdict"] for c in cycles] == [w for _, w in SCRIPT]
    _, v1_ref, cycles_ref = runs[REF]
    assert v1 == v1_ref
    for got, want in zip(cycles, cycles_ref):
        for key in ("cycle", "verdict", "rows", "shards", "outcome",
                    "published", "forced"):
            assert got.get(key) == want.get(key), key
        assert abs(got["max_js"] - want["max_js"]) <= 1e-9
        assert sorted(got.get("scores", {})) == sorted(
            want.get("scores", {}))
    trig = cycles[4]
    assert trig["outcome"] == "promote" and trig["published"] != v1
    assert trainer.registry.stable == trig["published"] == trainer.version
    assert trainer.refits == trainer.promotes == 1
    assert trig["refit"]["rows"] == 8 + 64 * 3
    assert trainer.monitor.contract is trainer.model.schema_contract
    obs = mod(PORT, "obs")
    names = {s["name"] for s in obs.tracer().spans()
             if s.get("trace") == trig["trace"]}
    assert {"continuous.cycle", "continuous.detect", "continuous.refit",
            "continuous.publish", "continuous.verdict"} <= names
    text = obs.prometheus_text_from_json(obs.metrics_registry().to_json())
    assert "tx_continuous_cycles" in text
    assert "tx_continuous_refit_cache_hits" in text
    with open(os.path.join(str(tmp_path / PORT),
                           mod(PORT, "continuous").STATUS_FILENAME)) as f:
        doc = json.load(f)
    assert doc["mode"] == "direct" and doc["stable_version"] == trainer.version
    assert doc["counters"]["refits"] == 1
    assert doc["governor"]["triggers"] == 1
    assert doc["last_cycle"]["verdict"] == "clear"
    ref_doc = runs[REF][0].status()
    assert sorted(doc) == sorted(ref_doc)
    assert sorted(doc["counters"]) == sorted(ref_doc["counters"])
    assert doc["counters"] == dict(ref_doc["counters"],
                                   last_max_js=doc["counters"]["last_max_js"])


def test_trainer_without_stable_requires_bootstrap(tmp_path):
    os.makedirs(tmp_path / "watch")
    cont = mod(PORT, "continuous")
    with pytest.raises(cont.ContinuousError, match="no stable"):
        cont.ContinuousTrainer(str(tmp_path / "watch"),
                               str(tmp_path / "registry"), _factory(PORT))


def test_run_loop_exits_on_idle_and_max_cycles(tmp_path):
    trainer = _trainer(PORT, str(tmp_path))
    cycles = trainer.run(max_cycles=5, idle_exit=2, poll_interval_s=0.01)
    assert [c["verdict"] for c in cycles] == ["idle", "idle"]
    write_shard(os.path.join(trainer.watch_dir, "s0.csv"),
                shard_rows(64, seed=30))
    cycles = trainer.run(max_cycles=1, poll_interval_s=0.01)
    assert len(cycles) == 1 and cycles[0]["rows"] == 64


def test_false_positive_trigger_promotes_healthy_refit(tmp_path):
    trainer = _trainer(PORT, str(tmp_path), drift_threshold=0.9,
                       consecutive_windows=3)
    v1 = trainer.version
    write_shard(os.path.join(trainer.watch_dir, "s0.csv"),
                shard_rows(64, seed=40))
    assert trainer.run_cycle()["verdict"] == "clear"
    mod(PORT, "faults.injection").configure("drift.false_positive:on=1")
    write_shard(os.path.join(trainer.watch_dir, "s1.csv"),
                shard_rows(64, seed=41))
    c = trainer.run_cycle()
    mod(PORT, "faults.injection").reset()
    assert c["forced"] is True and c["max_js"] < 0.9
    assert c["verdict"] == "trigger" and c["outcome"] == "promote"
    assert trainer.forced_triggers == 1
    assert trainer.registry.stable == c["published"] != v1
    write_shard(os.path.join(trainer.watch_dir, "s2.csv"),
                shard_rows(64, seed=42))
    c = trainer.run_cycle()
    assert c["forced"] is False and c["verdict"] in ("clear", "suppressed")


#: the refit-crash child: the port's testkit template (the tiny drill
#: factory on the CPU, the same stages as ``_factory``)
REFIT_CRASHER = CONTINUOUS_REFIT_CRASH_TEMPLATE

def test_refit_crash_leaves_old_stable_and_next_cycle_recovers(tmp_path):
    reg_root = str(tmp_path / "registry")
    watch = str(tmp_path / "watch")
    os.makedirs(watch)
    registry_mod = mod(PORT, "registry")
    model = _factory(PORT)().train()
    v1 = registry_mod.ModelRegistry(reg_root).publish(
        model, stage="stable").version
    write_shard(os.path.join(watch, "s0.csv"),
                shard_rows(64, seed=50, shift=3.0))
    script = tmp_path / "crasher.py"
    script.write_text(REFIT_CRASHER.format(
        repo=REPO, tests=os.path.join(REPO, "tests"), watch=watch,
        root=reg_root, fault="continuous.refit_crash:on=1"))
    env = dict(os.environ)
    env.pop("TX_FAULTS", None)
    proc = subprocess.run([sys.executable, str(script)], env=env,
                          timeout=300)
    assert proc.returncode == mod(PORT, "faults").DEFAULT_KILL_EXIT
    reg = registry_mod.ModelRegistry(reg_root, create=False)
    assert reg.stable == v1 and reg.verify()["ok"]
    trainer = mod(PORT, "continuous").ContinuousTrainer(
        watch, reg_root, _factory(PORT), drift_threshold=0.3,
        consecutive_windows=1, cooldown_windows=0, min_window_rows=8,
        refit_rows=256, train_fused=False)
    c = trainer.run_cycle()
    assert c["verdict"] == "trigger" and c["outcome"] == "promote"
    assert trainer.registry.stable == c["published"] != v1


@pytest.mark.parametrize("make_fault", DEVICE_FAULTS)
def test_device_fault_in_the_refit_propagates_and_keeps_stable(
        tmp_path, make_fault):
    """The refit has no catch-all: a device fault ends the cycle before
    the publish, so the registry keeps its stable and the next cycle can
    refit again."""
    trainer = _trainer(PORT, str(tmp_path), consecutive_windows=1,
                       cooldown_windows=0)
    v1 = trainer.version
    fault = make_fault()
    ok_factory = trainer.workflow_factory

    def broken():
        wf = ok_factory()
        wf.train = lambda: (_ for _ in ()).throw(fault)
        return wf

    trainer.workflow_factory = broken
    write_shard(os.path.join(trainer.watch_dir, "s0.csv"),
                shard_rows(64, seed=70, shift=3.0))
    with pytest.raises(type(fault)) as exc:
        trainer.run_cycle()
    assert exc.value is fault
    assert trainer.registry.stable == v1 and trainer.promotes == 0
    trainer.workflow_factory = ok_factory
    write_shard(os.path.join(trainer.watch_dir, "s1.csv"),
                shard_rows(64, seed=71, shift=3.0))
    c = trainer.run_cycle()
    assert c["outcome"] == "promote" and trainer.registry.stable != v1


def test_string_factory_and_fleet_mode_raise_naming_item_12(tmp_path):
    """A ``module:function`` factory loads through the fleet worker's
    loader (the reference's convention), a malformed one raises its
    ``ValueError``, and ``fleet=`` puts the trainer in fleet mode: the
    publish goes to the fleet's canary, and the status says so."""
    cont = mod(PORT, "continuous")
    os.makedirs(tmp_path / "watch")
    trainer = cont.ContinuousTrainer(
        str(tmp_path / "watch"), str(tmp_path / "registry"),
        "torch_fleet:tiny_cpu", bootstrap=True)
    assert trainer.registry.stable == trainer.version
    assert trainer.status()["mode"] == "direct"
    with pytest.raises(ValueError, match="module:function"):
        cont.ContinuousTrainer(str(tmp_path / "watch"),
                               str(tmp_path / "registry"), "no_colon",
                               bootstrap=True)

    class _Fleet:
        """The FleetController surface fleet mode drives."""

        def __init__(self):
            self.calls = []

        def start_canary(self, version, fraction):
            self.calls.append(("canary", version, fraction))

        def check_canary(self):
            return None

        def canary_telemetry(self):
            return {"canary": {"rows_scored": 50}}

        def promote_canary(self):
            self.calls.append(("promote",))

    fleet = _Fleet()
    trainer = cont.ContinuousTrainer(
        str(tmp_path / "watch"), str(tmp_path / "registry"),
        "torch_fleet:tiny_cpu", fleet=fleet, canary_fraction=0.25,
        drift_threshold=0.3, consecutive_windows=1, cooldown_windows=0,
        min_window_rows=32, refit_rows=256, train_fused=False,
        status_dir=str(tmp_path))
    write_shard(os.path.join(trainer.watch_dir, "s0.csv"),
                shard_rows(64, seed=80, shift=3.0))
    c = trainer.run_cycle()
    assert c["verdict"] == "trigger" and c["outcome"] == "promote"
    assert fleet.calls == [("canary", c["published"], 0.25), ("promote",)]
    assert c["canary_rows"] == 50
    assert trainer.version == c["published"]
    assert trainer.status()["mode"] == "fleet"


def test_constructor_takes_the_reference_keywords(tmp_path):
    """Both packages' trainers accept ``train_cache_dir`` and the four
    canary knobs and store them alike; the port leaves the cache dir
    unused (it keeps no compiled-program cache)."""
    kw = dict(train_cache_dir=str(tmp_path / "cache"), canary_fraction=0.3,
              canary_min_rows=12, canary_timeout_s=7.5, canary_poll_s=0.001)
    got = {}
    for pkg in (REF, PORT):
        root = str(tmp_path / pkg)
        trainer = _trainer(pkg, root, **kw)
        got[pkg] = {k: getattr(trainer, k) for k in kw}
        assert trainer.fleet is None
    assert got[PORT] == got[REF]
    assert got[PORT]["canary_poll_s"] == 0.01  # floored alike
    assert not os.path.exists(tmp_path / "cache")


CONT_WORKER_SPEC = (
    "transmogrifai_tpu_torch.testkit.drills:continuous_drill_workflow")


def test_fleet_mode_e2e_shift_refit_canary_promote(tmp_path):
    """A mid-stream shift on a live two-replica fleet of port workers is
    detected, refit, canaried at half the traffic and auto-promoted:
    the superseded model serves throughout, no row is dropped, and the
    promoted cycle runs under one trace id."""
    from torch_fleet import controller

    from transmogrifai_tpu_torch.obs import tracer
    from transmogrifai_tpu_torch.obs.slo import SLObjective
    from transmogrifai_tpu_torch.registry import ModelRegistry
    from transmogrifai_tpu_torch.testkit.drills import (
        continuous_drill_workflow,
        continuous_shard_rows,
        write_shard_csv,
    )

    reg_root = str(tmp_path / "registry")
    watch = str(tmp_path / "watch")
    os.makedirs(watch)
    n_train = 256
    v1 = ModelRegistry(reg_root).publish(
        continuous_drill_workflow(n=n_train, device="cpu").train(),
        stage="stable").version
    batch_base = [{k: r[k] for k in ("a", "c")}
                  for r in continuous_shard_rows(40, seed=99)]
    batch_shifted = [{k: r[k] for k in ("a", "c")}
                     for r in continuous_shard_rows(40, seed=98,
                                                    shift=3.0)]
    current = {"batch": batch_base}
    results: list = []
    errors: list = []
    stop = threading.Event()
    # the rollback signal is a health objective (NaN-guard refusals):
    # during a genuine shift the drift objective fires because of the
    # very traffic that triggered the refit
    health_slo = SLObjective(
        name="fleet-nonfinite", kind="threshold",
        metric="serving.breaker.rows_nonfinite", objective=0.5,
        windows_s=(30.0, 5.0))
    with controller(reg_root, CONT_WORKER_SPEC, 2, str(tmp_path / "fleet"),
                    slo_objectives=[health_slo]) as fc:
        fc.router.score_batch(batch_base, timeout_s=120.0)

        def pump() -> None:
            while not stop.is_set():
                try:
                    results.append(fc.router.submit(
                        records=current["batch"]).wait(120.0))
                except Exception as e:  # noqa: BLE001 - the drill counts
                    errors.append(repr(e))

        threads = [threading.Thread(target=pump) for _ in range(2)]
        for t in threads:
            t.start()
        try:
            trainer = mod(PORT, "continuous").ContinuousTrainer(
                watch, reg_root, "torch_fleet:continuous_drill_cpu",
                fleet=fc, status_dir=str(tmp_path),
                drift_threshold=0.4, consecutive_windows=4,
                cooldown_windows=2, min_window_rows=64,
                refit_rows=n_train, train_cache_dir=str(tmp_path / "c"),
                canary_fraction=0.5, canary_min_rows=48,
                canary_timeout_s=120.0)
            assert trainer.version == v1
            write_shard_csv(os.path.join(watch, "s0000.csv"),
                            continuous_shard_rows(64, seed=10))
            c = trainer.run_cycle()
            assert c["verdict"] == "clear", c
            current["batch"] = batch_shifted
            for i in range(1, 4):
                write_shard_csv(
                    os.path.join(watch, f"s{i:04d}.csv"),
                    continuous_shard_rows(64, seed=10 + i, shift=3.0))
                c = trainer.run_cycle()
                assert c["verdict"] == "over", c
            write_shard_csv(os.path.join(watch, "s0004.csv"),
                            continuous_shard_rows(64, seed=14, shift=3.0))
            c = trainer.run_cycle()
            assert c["verdict"] == "trigger", c
            assert c["outcome"] == "promote", c
            time.sleep(0.4)
        finally:
            stop.set()
            for t in threads:
                t.join(timeout=120.0)

        v2 = c["published"]
        assert v2 != v1 and fc.registry.stable == v2
        assert trainer.version == v2
        assert c["refit"]["rows"] == n_train
        assert errors == []
        assert all(res.n_rows == len(batch_base) for res in results)
        snap = fc.router.snapshot()
        assert snap["rows_ok"] == (sum(r.n_rows for r in results)
                                   + len(batch_base))
        versions = {res.version for res in results}
        assert None not in versions
        assert versions <= {v1, v2}
        assert v1 in versions
        assert c["canary_rows"] >= 48
        assert not os.path.exists(tmp_path / "c")

    names = {s["name"] for s in tracer().spans()
             if s.get("trace") == c["trace"]
             and str(s["name"]).startswith("continuous.")}
    assert {"continuous.cycle", "continuous.detect",
            "continuous.refit", "continuous.publish",
            "continuous.canary", "continuous.verdict"} <= names
    with open(os.path.join(str(tmp_path),
                           mod(PORT, "continuous").STATUS_FILENAME)) as f:
        doc = json.load(f)
    assert doc["mode"] == "fleet"
    assert doc["counters"]["promotes"] == 1
    assert doc["last_trace"] == c["trace"]


# ---------------------------------------------------------------------------
# the `continuous` run type
# ---------------------------------------------------------------------------
def test_runner_continuous_run_type_bootstraps_and_reports(tmp_path):
    watch = str(tmp_path / "watch")
    os.makedirs(watch)
    write_shard(os.path.join(watch, "s0.csv"),
                shard_rows(64, seed=60, shift=3.0))
    runner = mod(PORT, "workflow.runner").OpWorkflowRunner(
        _factory(PORT)(), workflow_factory=_factory(PORT))
    r = runner.run("continuous", mod(PORT, "workflow.params").OpParams(
        model_location=str(tmp_path / "model"),
        metrics_location=str(tmp_path / "metrics"),
        custom_params={
            "watch_dir": watch,
            "drift_threshold": 0.3,
            "drift_consecutive": 1,
            "drift_cooldown": 0,
            "continuous_window_rows": 32,
            "continuous_refit_rows": 256,
            "continuous_max_cycles": 3,
            "continuous_idle_exit": 1,
            "continuous_poll_s": 0.01,
            "train_fused": False,
        }))
    m = r.metrics
    assert r.run_type == "continuous" and m["run_type"] == "continuous"
    assert m["mode"] == "direct"
    assert m["counters"]["refits"] >= 1 and m["counters"]["promotes"] >= 1
    reg = mod(PORT, "registry").ModelRegistry(
        os.path.join(str(tmp_path / "model"), "registry"), create=False)
    assert reg.stable is not None and reg.verify()["ok"]
    with open(os.path.join(str(tmp_path / "metrics"),
                           "continuous_metrics.json")) as f:
        saved = json.load(f)
    assert saved["counters"]["cycles"] == m["counters"]["cycles"]
    assert os.path.exists(os.path.join(
        str(tmp_path / "metrics"), mod(PORT, "continuous").STATUS_FILENAME))
    with pytest.raises(ValueError, match="watch_dir"):
        runner.run("continuous", mod(PORT, "workflow.params").OpParams(
            model_location=str(tmp_path / "x")))
