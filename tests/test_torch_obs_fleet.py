"""Cross-process observability, port against reference.

Ports the contracts of ``tests/test_obs_fleet.py`` (less its CLI cases,
which come with ``cli.py``, and its SLO cases, held since
``tests/test_torch_slo.py``) onto ``transmogrifai_tpu_torch.obs``:

* the trace-context seam (``TX_OBS_TRACE_CONTEXT``): export, adopt,
  ``adopt_context``, ``child_env`` setting and stripping it, and the
  supervisor's re-dispatch carrying it - a supervised run of port
  children (``sys.modules["jax"] = None``) merges into ONE trace tree;
* trace and span ids collision-free across four concurrent processes;
* aggregator merges: the same shard directory read by both packages'
  ``FleetAggregator`` gives the same scrape, rollup and documents, with
  torn shards skipped and dead ones aged out;
* shippers killed mid-write never surface a torn read;
* the runner's ``fleet_dir`` shipping and the deployment's path-valued
  fleet view.
"""
from __future__ import annotations

import json
import os
import signal
import subprocess
import sys
import time

import pytest

from torch_parity import PORT, REF, mod, tiny_pipeline

from transmogrifai_tpu_torch.testkit.drills import (
    FLEET_DEPLOY_CHILD_TEMPLATE,
    FLEET_DRILL_CHILD_TEMPLATE,
    FLEET_SHIPPER_CHILD_TEMPLATE,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _obs(pkg=PORT):
    return mod(pkg, "obs")


@pytest.fixture(autouse=True)
def _fresh_obs():
    for pkg in (REF, PORT):
        _obs(pkg).reset_metrics_registry()
        _obs(pkg).reset_tracer()
    yield
    for pkg in (REF, PORT):
        _obs(pkg).reset_metrics_registry()
        _obs(pkg).reset_tracer()
        _obs(pkg).set_process_instance(None)


def _child_env() -> dict:
    env = dict(os.environ)
    env.pop(_obs().TRACE_CONTEXT_ENV, None)
    env.pop("TX_FAULTS", None)
    return env


#: the first lines of every port child: the torch package only
CHILD_PRELUDE = """
import os, sys
sys.path.insert(0, {repo!r})
sys.modules["jax"] = None  # the torch package never needs it
"""


# ---------------------------------------------------------------------------
# trace-context propagation
# ---------------------------------------------------------------------------
def test_context_export_adopt_roundtrip(monkeypatch):
    obs = _obs()
    trace = mod(PORT, "obs.trace")
    tr = obs.tracer()
    with tr.span("parent.root") as root:
        ctx = tr.current_context()
        assert ctx == obs.current_context() == (
            f"{root.trace_id}:{root.span_id}")
        assert obs.parse_context(ctx) == (root.trace_id, root.span_id)
        monkeypatch.setenv(obs.TRACE_CONTEXT_ENV, ctx)
        child_tr = trace.Tracer()  # a child process's construction path
    assert child_tr.contexts_adopted == 1
    assert child_tr.snapshot()["contexts_adopted"] == 1
    with child_tr.span("child.root") as c:
        assert c.trace_id == root.trace_id and c.parent_id == root.span_id
    with child_tr.span("child.a") as a:
        with child_tr.span("child.b") as b:
            assert b.parent_id == a.span_id and b.trace_id == root.trace_id
    # a middle process with no span open relays the ADOPTED context on
    assert child_tr.current_context() == ctx
    for bad in ("garbage", "", "t:not-an-int", None):
        assert obs.parse_context(bad) == (None, None)
        assert mod(REF, "obs.trace").parse_context(bad) == (None, None)
    # in-process adoption: refused mid-span or twice, accepted otherwise
    monkeypatch.delenv(obs.TRACE_CONTEXT_ENV)
    fresh = trace.Tracer()
    assert fresh.current_context() is None
    assert not fresh.adopt_context("garbage")
    with fresh.span("open"):
        assert not fresh.adopt_context(ctx)
    assert fresh.adopt_context(ctx) and fresh.contexts_adopted == 1
    assert not fresh.adopt_context(ctx)
    with fresh.span("joined") as j:
        assert j.trace_id == root.trace_id


def test_child_env_sets_and_strips_context(monkeypatch):
    obs = _obs()
    with obs.tracer().span("spawner"):
        env = obs.child_env({"KEEP": "1"})
        assert env["KEEP"] == "1" and obs.TRACE_CONTEXT_ENV in env
    monkeypatch.delenv(obs.TRACE_CONTEXT_ENV, raising=False)
    env = obs.child_env({obs.TRACE_CONTEXT_ENV: "stale:1", "KEEP": "1"})
    assert obs.TRACE_CONTEXT_ENV not in env and env["KEEP"] == "1"
    # the supervisor's dispatch environment is this seam
    supervisor = mod(PORT, "workflow.supervisor")
    assert supervisor._child_env is obs.child_env
    assert obs.TRACE_CONTEXT_ENV == _obs(REF).TRACE_CONTEXT_ENV


ID_MINTER = CHILD_PRELUDE + """
from transmogrifai_tpu_torch.obs.trace import Tracer
tr = Tracer(capacity=8)
with open({out!r}, "w") as f:
    for _ in range({n}):
        s = tr.span("mint")
        f.write(s.trace_id + " " + str(s.span_id) + "\\n")
"""


def test_trace_and_span_ids_collision_safe_4_processes(tmp_path):
    """Ids minted in four CONCURRENT processes collide nowhere: trace ids
    are prefixed by pid and a start nonce, span ids count up from a
    random 63-bit base - the join keys of the merged fleet tree."""
    n = 5_000
    outs = [str(tmp_path / f"ids-{i}.txt") for i in range(4)]
    procs = [subprocess.Popen(
        [sys.executable, "-c", ID_MINTER.format(repo=REPO, out=out, n=n)],
        env=_child_env()) for out in outs]
    for p in procs:
        p.wait(timeout=180)
        assert p.returncode == 0
    trace_ids, span_ids, total = set(), set(), 0
    for out in outs:
        with open(out) as f:
            for line in f:
                t, _, s = line.strip().partition(" ")
                trace_ids.add(t)
                span_ids.add(int(s))
                total += 1
    assert total == 4 * n
    assert len(trace_ids) == total and len(span_ids) == total


# ---------------------------------------------------------------------------
# fleet aggregation
# ---------------------------------------------------------------------------
def _ship_two_replicas(agg_dir):
    obs = _obs()
    reg = obs.metrics_registry()
    c, g = reg.counter("work.rows"), reg.gauge("work.depth")
    try:
        for inst, rows, depth in (("r1", 10, 3.0), ("r2", 32, 7.0)):
            c.inc(rows - c.value)
            g.set(depth)
            obs.set_process_instance(inst)
            obs.ship_now(agg_dir)
    finally:
        obs.set_process_instance(None)


def _aggregate(pkg, agg_dir, stale=300.0):
    agg = _obs(pkg).FleetAggregator(agg_dir, stale_after_s=stale)
    doc = agg.to_json()
    return {
        "text": agg.prometheus_text(),
        "report": dict(agg.last_report),
        "rollup": doc["fleet"],
        "processes": sorted(doc["processes"]),
        "docs": agg.merged_metrics_docs(),
        "trees": [(t["name"], t["trace"]) for t in agg.span_trees()],
    }


def test_aggregator_merges_equal_the_reference(tmp_path):
    """Shards shipped by the port merge into one scrape (per-process
    samples under distinct instance labels, fleet sums and maxes), and
    the reference's aggregator reads the same directory to the same
    scrape, rollup and documents."""
    agg_dir = str(tmp_path / "agg")
    _ship_two_replicas(agg_dir)
    got = {pkg: _aggregate(pkg, agg_dir) for pkg in (REF, PORT)}
    text = got[PORT]["text"]
    assert 'tx_work_rows{instance="r1"} 10' in text
    assert 'tx_work_rows{instance="r2"} 32' in text
    assert 'tx_work_rows{instance="fleet",agg="sum"} 42' in text
    assert 'tx_work_rows{instance="fleet",agg="max"} 32' in text
    assert 'tx_work_depth{instance="fleet",agg="max"} 7' in text
    assert got[PORT]["report"]["instances"] == ["r1", "r2"]
    assert got[PORT]["processes"] == ["r1", "r2"]
    assert got[PORT]["rollup"]["sum"]["tx_work_rows"] == 42
    assert got[PORT] == got[REF]


def test_aggregator_skips_torn_and_ages_out_dead_like_reference(tmp_path):
    obs = _obs()
    agg_dir = str(tmp_path / "agg")
    os.makedirs(agg_dir)
    obs.set_process_instance("live")
    obs.ship_now(agg_dir)
    obs.set_process_instance(None)
    suffix = mod(PORT, "obs.fleet").SHARD_SUFFIX
    torn = os.path.join(agg_dir, "torn" + suffix)
    with open(torn, "w") as f:
        f.write('{"instance": "torn", "metrics": {"ser')
    dead = os.path.join(agg_dir, "dead" + suffix)
    with open(dead, "w") as f:
        json.dump({"instance": "dead", "pid": 1, "metrics": {},
                   "spans": []}, f)
    old = time.time() - 3600.0
    os.utime(dead, (old, old))
    assert obs.read_json_torn_safe(torn) is None
    assert obs.read_json_torn_safe(str(tmp_path / "missing")) is None
    got = {pkg: _aggregate(pkg, agg_dir, stale=5.0) for pkg in (REF, PORT)}
    rep = got[PORT]["report"]
    assert rep["instances"] == ["live"]
    assert rep["shards_torn"] == 1 and rep["shards_stale"] == 1
    assert 'instance="live"' in got[PORT]["text"]
    assert "torn" not in got[PORT]["text"]
    assert got[PORT] == got[REF]


def test_read_jsonl_tolerant_equals_the_reference(tmp_path):
    p = tmp_path / "spans.jsonl"
    p.write_bytes(b'{"a": 1}\n\n[1, 2]\nnot json\n{"b": 2}\n{"trunc')
    got = _obs().read_jsonl_tolerant(str(p))
    assert got == _obs(REF).read_jsonl_tolerant(str(p))
    assert got == ([{"a": 1}, {"b": 2}], 3)


def test_rollup_sums_multiple_views_of_one_kind(tmp_path):
    """Two views of one kind in one process (a deploy's stable + canary
    ServingTelemetry) both reach the fleet rollup."""
    telemetry = mod(PORT, "serving.telemetry")
    stable, canary = telemetry.ServingTelemetry(), telemetry.ServingTelemetry()
    for _ in range(10):
        stable.record_request(0.001, "ok")
    for _ in range(3):
        canary.record_request(0.001, "ok")
    agg_dir = str(tmp_path / "agg")
    _obs().set_process_instance("deployer")
    _obs().ship_now(agg_dir)
    _obs().set_process_instance(None)
    rollup = _obs().FleetAggregator(agg_dir,
                                    stale_after_s=300.0).fleet_rollup()
    assert rollup["sum"]["tx_serving_rows_scored"] == 13
    assert rollup["max"]["tx_serving_rows_scored"] == 10
    views = list(mod(PORT, "obs.fleet").serving_views(
        _obs().metrics_registry().to_json()))
    assert len(views) >= 2


def test_instance_identity_sanitized_for_labels_and_filenames(tmp_path):
    obs = _obs()
    agg_dir = str(tmp_path / "agg")
    path = obs.ship_now(agg_dir, instance='evil"name/../../x')
    suffix = mod(PORT, "obs.fleet").SHARD_SUFFIX
    assert os.path.dirname(path) == agg_dir
    assert "/" not in os.path.basename(path)[: -len(suffix)]
    text = obs.FleetAggregator(agg_dir, stale_after_s=300.0).prometheus_text()
    assert 'instance="evil_name_.._.._x"' in text


#: the shipper child: the port's testkit template
SHIPPER = FLEET_SHIPPER_CHILD_TEMPLATE

def test_concurrent_shippers_sigkill_one_mid_write(tmp_path):
    """Three port processes ship into one aggregation dir while the
    parent aggregates; one is SIGKILLed mid-loop.  No torn read ever
    surfaces, and the killed process ages out while the others stay."""
    agg_dir = str(tmp_path / "agg")
    procs = [subprocess.Popen(
        [sys.executable, "-c", SHIPPER.format(
            repo=REPO, agg_dir=agg_dir, interval=0.01, duration=30.0)],
        env=_child_env(), stdout=subprocess.PIPE, text=True)
        for _ in range(3)]
    try:
        pids = []
        for p in procs:
            line = p.stdout.readline()
            assert line.startswith("SHIPPER_READY"), line
            pids.append(int(line.split()[1]))
        agg = _obs().FleetAggregator(agg_dir, stale_after_s=1.0)
        deadline = time.monotonic() + 30.0
        while time.monotonic() < deadline:
            if agg.last_report.get("shards_live", 0) >= 3:
                break
            agg.shards()
            time.sleep(0.02)
        assert agg.last_report["shards_live"] == 3, agg.last_report
        victim = procs[0]
        os.kill(victim.pid, signal.SIGKILL)
        deadline = time.monotonic() + 3.0
        saw_two = False
        while time.monotonic() < deadline:
            shards = agg.shards()
            text = agg.prometheus_text()
            assert agg.last_report["shards_torn"] == 0, agg.last_report
            live = set(agg.last_report["instances"])
            if len(shards) == 2:
                saw_two = True
                assert not any(i.startswith(f"{victim.pid}-") for i in live)
                for pid in pids[1:]:
                    assert f'instance="{pid}-' in text
                break
            time.sleep(0.05)
        assert saw_two, "killed shipper never aged out of the scrape"
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait(timeout=30)
            p.stdout.close()


#: the deploy grandchild and the supervised child: the port's templates
GRANDCHILD = FLEET_DEPLOY_CHILD_TEMPLATE
DISPATCHED = FLEET_DRILL_CHILD_TEMPLATE

def test_e2e_supervised_fleet_drill(tmp_path):
    """A supervised run of port children (one re-dispatch after a
    die-once exit, each attempt spawning a grandchild) merges into ONE
    trace tree whose root trace id appears in spans from every pid, and
    one scrape with every process under its own instance label."""
    obs = _obs()
    agg_dir = str(tmp_path / "agg")
    heartbeat = str(tmp_path / "beat")
    child_src = DISPATCHED.format(
        repo=REPO, agg_dir=agg_dir, heartbeat=heartbeat,
        marker=str(tmp_path / "marker"), first_exit=7,
        grand=GRANDCHILD.format(repo=REPO, agg_dir=agg_dir))
    supervise = mod(PORT, "workflow.supervisor").supervise
    with obs.tracer().span("fleet.drill.root") as root:
        result = supervise(
            [sys.executable, "-c", child_src], heartbeat_path=heartbeat,
            stale_after_s=120.0, max_restarts=2, poll_s=0.1,
            env=_child_env(), backoff_base_s=0.05, backoff_seed=0)
    assert result.returncode == 0 and result.attempts == 2
    obs.ship_now(agg_dir)  # the parent's own shard, root span included
    agg = obs.FleetAggregator(agg_dir, stale_after_s=300.0)
    ours = [r for r in agg.merged_spans() if r["trace"] == root.trace_id]
    pids = {r["pid"] for r in ours}
    assert len(pids) >= 5 and os.getpid() in pids
    trees = [t for t in agg.span_trees() if t["trace"] == root.trace_id]
    assert len(trees) == 1 and trees[0]["name"] == "fleet.drill.root"

    def walk(node):
        yield node
        for c in node.get("children", ()):
            yield from walk(c)

    nodes = list(walk(trees[0]))
    names = [nd["name"] for nd in nodes]
    assert names.count("supervisor.dispatch") == 2
    assert names.count("child.work") == 2
    assert names.count("deploy.child") == 2
    assert {nd["trace"] for nd in nodes} == {root.trace_id}
    for nd in nodes:
        if nd["name"] == "child.work":
            assert any(c["name"] == "deploy.child" for c in nd["children"])
    text = agg.prometheus_text()
    instances = agg.last_report["instances"]
    assert len(instances) == len(set(instances)) >= 5
    for inst in instances:
        assert f'tx_obs_tracer_spans_recorded{{instance="{inst}"' in text


# ---------------------------------------------------------------------------
# the shipping seams of the runner and the deployment
# ---------------------------------------------------------------------------
def test_runner_fleet_dir_ships_like_reference(tmp_path, monkeypatch):
    """A train run with ``fleet_dir`` ships the process's plane after the
    run: one shard whose spans hold the run's root span, in both packages;
    an unwritable aggregation dir is logged, never raised."""
    shards = {}
    for pkg in (REF, PORT):
        wf = tiny_pipeline(pkg)[0]
        agg_dir = str(tmp_path / f"agg-{pkg}")
        res = mod(pkg, "workflow.runner").OpWorkflowRunner(wf).run(
            "train", mod(pkg, "workflow.params").OpParams(
                custom_params={"fleet_dir": agg_dir}))
        assert res.model is not None
        got = _obs(pkg).FleetAggregator(agg_dir,
                                        stale_after_s=300.0).shards()
        assert len(got) == 1
        shards[pkg] = sorted({s["name"] for s in got[0]["spans"]})
    assert "run.train" in shards[PORT] and "workflow.train" in shards[PORT]
    assert set(shards[REF]) >= set(shards[PORT]) - {"workflow.ingest"}
    blocker = tmp_path / "a-file"
    blocker.write_text("x")
    monkeypatch.setenv("TX_OBS_FLEET_DIR", str(blocker / "agg"))
    wf = tiny_pipeline(PORT)[0]
    res = mod(PORT, "workflow.runner").OpWorkflowRunner(wf).run(
        "train", mod(PORT, "workflow.params").OpParams())
    assert res.model is not None


def test_shipper_beats_and_ships_on_stop(tmp_path):
    obs = _obs()
    agg_dir = str(tmp_path / "agg")
    calls = []

    def extra():
        calls.append(1)
        return {"fleet": {"generation": len(calls)}}

    with obs.ObsShipper(agg_dir, interval_s=0.02, instance="replica-0",
                        extra_fn=extra) as shipper:
        deadline = time.monotonic() + 10.0
        while shipper.ships_ok < 2 and time.monotonic() < deadline:
            time.sleep(0.02)
    assert shipper.ships_ok >= 3 and shipper.ships_failed == 0
    shard = obs.FleetAggregator(agg_dir, stale_after_s=300.0).shards()[0]
    assert shard["instance"] == "replica-0"
    assert shard["fleet"]["generation"] == len(calls)


# ---------------------------------------------------------------------------
# a live fleet's shards
# ---------------------------------------------------------------------------
def test_fleet_shards_carry_replica_router_and_health_views(tmp_path):
    """One scrape of a port fleet's aggregation dir: each replica's shard
    carries its ``fleet_replica`` view (its device and rows scored), the
    router's own shard (``ship_router_obs``) carries the ``fleet_router``
    and ``fleet_health`` views that ``health_views`` extracts, and the
    replicas' serving views roll up under ``instance="fleet"``."""
    from torch_fleet import PORT_TINY_SPEC, controller, publish_tiny

    fleet_obs = mod(PORT, "obs.fleet")
    reg = publish_tiny(str(tmp_path / "registry"), n_versions=1)
    with controller(reg["root"], PORT_TINY_SPEC, 2, str(tmp_path / "fleet"),
                    ship_router_obs=True) as fc:
        for _ in range(3):
            fc.router.score_batch(reg["records"][:16], timeout_s=60.0)

        def shipped():
            docs = {str(d.get("instance")): d.get("metrics", {})
                    for d in fc.aggregator.shards()}
            reps = [docs.get(f"replica-{i}", {}).get("views", {})
                    for i in range(2)]
            return docs if "router" in docs and sum(
                v.get("fleet_replica/0", {}).get("rows_scored", 0)
                for v in reps) == 48 else None

        deadline = time.monotonic() + 30.0
        while shipped() is None and time.monotonic() < deadline:
            time.sleep(0.1)
        docs = shipped()
        assert docs is not None
        for i in range(2):
            view = docs[f"replica-{i}"]["views"]["fleet_replica/0"]
            assert view["device"] == "cpu" and view["instance"] == \
                f"replica-{i}"
        health = dict(fleet_obs.health_views(docs["router"]))
        assert health and all(set(h["replicas"]) == {"replica-0",
                                                      "replica-1"}
                              for h in health.values())
        assert dict(fleet_obs.health_views(docs["replica-0"])) == {}
        assert 'instance="fleet",agg="sum"' in fc.aggregator.prometheus_text()
