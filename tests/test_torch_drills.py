"""The drills' testkit, port against reference.

``transmogrifai_tpu_torch.testkit.drills`` holds the JAX package's
factories (ported earlier) and now its eleven child-script templates
and ``corrupted_csv_drill``.  Held on the CPU:

* ``corrupted_csv_drill`` writes the reference's file byte for byte and
  returns its ground truth and raw features;
* the templates are the reference's set, each formats with the
  reference's keys (a template that builds a workflow also takes
  ``device``, ``"cpu"`` by default) and each runs as its reference
  twin's contract says, as a port child with jax unimportable;
* ``autotune.knobs.measure_wall`` and the mesh telemetry's shipping of a
  degradation event, the two names the earlier slices left out.
"""
from __future__ import annotations

import ast
import json
import os
import string
import subprocess
import sys
import time

import pytest

from torch_parity import PORT, REF, mod

from transmogrifai_tpu_torch.faults import injection as faults
from transmogrifai_tpu_torch.testkit import drills

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

TEMPLATES = sorted(n for n in dir(drills) if n.endswith("_TEMPLATE"))


@pytest.fixture(autouse=True)
def _disarm():
    faults.reset()
    yield
    faults.reset()


def _env(**extra) -> dict:
    env = dict(drills.drill_env(), OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    env.update(extra)
    return env


def _run(tmp_path, src: str, timeout: float = 300.0, **env):
    script = tmp_path / "child.py"
    script.write_text(src)
    return subprocess.run([sys.executable, str(script)], env=_env(**env),
                          capture_output=True, text=True, timeout=timeout)


# -- the factories --------------------------------------------------------------

@pytest.mark.parametrize("kw", [
    {}, {"n_rows": 120, "n_type_flips": 3, "n_truncated": 2, "seed": 11}])
def test_corrupted_csv_drill_bit_equal_to_reference(tmp_path, kw):
    (tmp_path / "port").mkdir()
    (tmp_path / "ref").mkdir()
    path, feats, truth = drills.corrupted_csv_drill(
        str(tmp_path / "port"), **kw)
    rpath, rfeats, rtruth = mod(REF, "testkit.drills").corrupted_csv_drill(
        str(tmp_path / "ref"), **kw)
    with open(path, "rb") as f, open(rpath, "rb") as g:
        assert f.read() == g.read()
    assert os.path.basename(path) == os.path.basename(rpath)
    assert truth == rtruth
    assert [(f.name, f.ftype.__name__, f.is_response) for f in feats] \
        == [(f.name, f.ftype.__name__, f.is_response) for f in rfeats]


def test_templates_are_the_reference_set():
    ref = mod(REF, "testkit.drills")
    assert TEMPLATES == sorted(n for n in dir(ref) if n.endswith("_TEMPLATE"))
    assert len(TEMPLATES) == 11


def _keys(template: str) -> set:
    return {f for _, f, _, _ in string.Formatter().parse(template)
            if f is not None}


@pytest.mark.parametrize("name", TEMPLATES)
def test_template_formats_with_the_reference_keys(name):
    """A template takes the reference's keys, plus ``device`` where it
    builds a workflow and ``model_dir``/``factory`` for the bulk child,
    each with a default, so the reference's call formats it."""
    tpl = getattr(drills, name)
    ref_keys = _keys(getattr(mod(REF, "testkit.drills"), name))
    port_keys = _keys(tpl)
    assert ref_keys <= port_keys | {"process_id"}
    assert port_keys - ref_keys <= set(tpl.defaults)
    ast.parse(tpl.format(**{k: "0" for k in ref_keys}))


# -- each template's contract --------------------------------------------------------

def test_die_once_child(tmp_path):
    src = drills.DIE_ONCE_CHILD_TEMPLATE.format(
        marker=str(tmp_path / "marker"), first_exit=7, then_exit=0)
    assert _run(tmp_path, src).returncode == 7
    assert _run(tmp_path, src).returncode == 0


@pytest.mark.parametrize("mode", ["die", "hang"])
def test_mesh_peer_child(tmp_path, mode):
    PeerHealth = mod(PORT, "parallel.resilience").PeerHealth
    hb_dir = str(tmp_path / "hb")
    script = tmp_path / "peer.py"
    script.write_text(drills.MESH_PEER_CHILD_TEMPLATE.format(
        repo=REPO, hb_dir=hb_dir, peer_id=1, beats=2, interval=0.05,
        mode=mode, exit_code=9))
    proc = subprocess.Popen([sys.executable, str(script)], env=_env())
    try:
        ph = PeerHealth(hb_dir, process_id=0, stale_after_s=0.6)
        ph.beat()
        deadline = time.monotonic() + 30.0
        while time.monotonic() < deadline and not ph.dead_peers():
            time.sleep(0.05)
        assert ph.dead_peers() == [1]
        if mode == "die":
            assert proc.wait(timeout=60) == 9
        else:
            assert proc.poll() is None  # alive, no longer beating
    finally:
        if proc.poll() is None:
            proc.kill()
        proc.wait(timeout=30)


def test_mesh_bootstrap_child(tmp_path):
    src = drills.MESH_BOOTSTRAP_CHILD_TEMPLATE.format(
        repo=REPO, addr="localhost:1")
    proc = _run(tmp_path, src, timeout=120,
                TX_FAULTS="mesh.init_no_coordinator:on=1:delay=600",
                TX_MESH_INIT_TIMEOUT_S="2")
    assert proc.returncode == 42, proc.stdout + proc.stderr
    assert "MESH_BOOTSTRAP_ERROR" in proc.stdout


def test_crash_saver_child(tmp_path):
    path = str(tmp_path / "m")
    src = drills.CRASH_SAVER_TEMPLATE.format(
        repo=REPO, path=path, fault="io.save_model.crash:on=1")
    proc = _run(tmp_path, src)
    assert proc.returncode == faults.DEFAULT_KILL_EXIT, proc.stderr[-2000:]
    mio = mod(PORT, "serialization.model_io")
    assert mio.verify_artifact(path) is None
    model = mio.load_model(path, drills.tiny_drill_pipeline(device="cpu")[0])
    assert model.schema_contract is not None


def test_registry_crash_publisher_child(tmp_path):
    root = str(tmp_path / "reg")
    src = drills.REGISTRY_CRASH_PUBLISHER_TEMPLATE.format(
        repo=REPO, root=root, fault="registry.publish_crash:on=1")
    proc = _run(tmp_path, src)
    assert proc.returncode == faults.DEFAULT_KILL_EXIT, proc.stderr[-2000:]
    reg = mod(PORT, "registry").ModelRegistry(root, create=False)
    assert [v.version for v in reg.versions()] == ["v1"]
    assert reg.stable == "v1"
    report = reg.verify()
    assert report["ok"] and report["versions"]["v1"] is None
    assert any("v2" in o for o in report["orphans"])


def test_continuous_seed_trainer_child_publishes_cold(tmp_path):
    root = str(tmp_path / "reg")
    src = drills.CONTINUOUS_SEED_TRAINER_TEMPLATE.format(
        repo=REPO, n=96, seed=3, cache_dir=str(tmp_path / "cache"),
        root=root)
    proc = _run(tmp_path, src)
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = next(ln for ln in proc.stdout.splitlines()
                if ln.startswith("SEEDED"))
    _, version, trail = line.split(" ", 2)
    assert version == "v1"
    trail = json.loads(trail)
    assert trail is not None
    # no compiled-program cache: the cache dir is stored, never written
    assert not os.path.exists(tmp_path / "cache")
    assert json.dumps(trail).count('"cache": "none"') >= 1
    reg = mod(PORT, "registry").ModelRegistry(root, create=False)
    assert reg.stable == "v1" and reg.verify()["ok"]


def test_continuous_refit_crash_child(tmp_path):
    from transmogrifai_tpu_torch.continuous import ContinuousTrainer
    from transmogrifai_tpu_torch.registry import ModelRegistry

    root = str(tmp_path / "reg")
    watch = str(tmp_path / "watch")
    os.makedirs(watch)
    model = drills.continuous_tiny_factory(device="cpu").train()
    v1 = ModelRegistry(root).publish(model, stage="stable").version
    drills.write_shard_csv(os.path.join(watch, "s0.csv"),
                           drills.continuous_shard_rows(64, seed=50,
                                                        shift=3.0))
    src = drills.CONTINUOUS_REFIT_CRASH_TEMPLATE.format(
        repo=REPO, watch=watch, root=root,
        fault="continuous.refit_crash:on=1")
    proc = _run(tmp_path, src)
    assert proc.returncode == faults.DEFAULT_KILL_EXIT, proc.stderr[-2000:]
    reg = ModelRegistry(root, create=False)
    assert reg.stable == v1 and reg.verify()["ok"]
    trainer = ContinuousTrainer(
        watch, root,
        lambda: drills.continuous_tiny_factory(device="cpu"),
        drift_threshold=0.3, consecutive_windows=1, cooldown_windows=0,
        min_window_rows=8, refit_rows=256, train_fused=False)
    c = trainer.run_cycle()
    assert c["verdict"] == "trigger" and c["outcome"] == "promote"


def test_fleet_shipper_and_deploy_children(tmp_path):
    obs = mod(PORT, "obs")
    agg_dir = str(tmp_path / "agg")
    src = drills.FLEET_SHIPPER_CHILD_TEMPLATE.format(
        repo=REPO, agg_dir=agg_dir, interval=0.01, duration=0.3)
    proc = _run(tmp_path, src, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.startswith("SHIPPER_READY")
    pid = proc.stdout.split()[1]
    src = drills.FLEET_DEPLOY_CHILD_TEMPLATE.format(repo=REPO,
                                                    agg_dir=agg_dir)
    assert _run(tmp_path, src, timeout=120).returncode == 0
    agg = obs.FleetAggregator(agg_dir, stale_after_s=300.0)
    names = {r["name"] for r in agg.merged_spans()}
    assert {"shipper.tick", "deploy.child"} <= names
    assert any(i.startswith(f"{pid}-") for i in agg.last_report["instances"])


def test_fleet_drill_child_under_supervision(tmp_path):
    obs = mod(PORT, "obs")
    agg_dir = str(tmp_path / "agg")
    heartbeat = str(tmp_path / "beat")
    src = drills.FLEET_DRILL_CHILD_TEMPLATE.format(
        repo=REPO, agg_dir=agg_dir, heartbeat=heartbeat,
        marker=str(tmp_path / "marker"), first_exit=7,
        grand=drills.FLEET_DEPLOY_CHILD_TEMPLATE.format(
            repo=REPO, agg_dir=agg_dir))
    supervise = mod(PORT, "workflow.supervisor").supervise
    env = _env()
    env.pop(obs.TRACE_CONTEXT_ENV, None)
    with obs.tracer().span("drills.root") as root:
        result = supervise(
            [sys.executable, "-c", src], heartbeat_path=heartbeat,
            stale_after_s=120.0, max_restarts=2, poll_s=0.1, env=env,
            backoff_base_s=0.05, backoff_seed=0)
    assert result.returncode == 0 and result.attempts == 2
    agg = obs.FleetAggregator(agg_dir, stale_after_s=300.0)
    ours = [r for r in agg.merged_spans() if r["trace"] == root.trace_id]
    assert len({r["pid"] for r in ours}) >= 3
    names = [r["name"] for r in ours]
    assert names.count("child.work") == 2
    assert names.count("deploy.child") == 2


def test_bulk_kill_child_trains_and_dies(tmp_path):
    """The reference's form: the child trains the tiny drill pipeline on
    the CPU and dies in the armed window, leaving a loadable journal."""
    shards = []
    _wf, data, _records, _pred = drills.tiny_drill_pipeline(device="cpu")
    rows = [{"y": data["y"][i], "a": data["a"][i], "c": data["c"][i]}
            for i in range(120)]
    for k in range(3):
        p = str(tmp_path / f"in-{k}.csv")
        drills.write_shard_csv(p, rows[k * 40:(k + 1) * 40])
        shards.append(p)
    jd = str(tmp_path / "job")
    src = drills.BULK_KILL_CHILD_TEMPLATE.format(
        repo=REPO, fault="bulk.output_crash:on=2", n=120, job_dir=jd,
        shards=shards, chunk=16)
    proc = _run(tmp_path, src)
    assert proc.returncode == faults.DEFAULT_KILL_EXIT, proc.stderr[-2000:]
    j = mod(PORT, "bulk").BulkJournal.load(jd)
    assert j.states()["committed"] == 1
    assert j.shard(1)["state"] == "assigned"


# -- the names the earlier slices left out ---------------------------------------

def test_measure_wall_times_one_call():
    from transmogrifai_tpu_torch.autotune.knobs import measure_wall

    calls = []
    wall = measure_wall(lambda: (calls.append(1), time.sleep(0.02)))
    assert calls == [1]
    assert isinstance(wall, float) and 0.015 < wall < 5.0
    ref = mod(REF, "autotune.knobs").measure_wall
    assert ref(lambda: None) >= 0.0 and measure_wall(lambda: None) >= 0.0


def test_mesh_degradation_events_ship_the_obs_plane(tmp_path, monkeypatch):
    """A bootstrap timeout, a detection or a shrink ships this process's
    obs plane to ``TX_OBS_FLEET_DIR`` at once, as the reference's mesh
    telemetry does; with no aggregation dir nothing is written."""
    obs = mod(PORT, "obs")
    resilience = mod(PORT, "parallel.resilience")
    tel = resilience.MeshTelemetry()
    tel.record_bootstrap_timeout("localhost:1", 2.0)  # no dir: nothing
    agg_dir = str(tmp_path / "agg")
    monkeypatch.setenv("TX_OBS_FLEET_DIR", agg_dir)
    tel.record_bootstrap_timeout("localhost:1", 2.0)
    assert len(obs.FleetAggregator(agg_dir).shards()) == 1
    tel.record_detection("drill", 1.0, "dead", 0.5, [1])
    tel.record_shrink("drill", True, 0.1, 1)
    assert tel.snapshot()["bootstrap_timeouts"] == 2
