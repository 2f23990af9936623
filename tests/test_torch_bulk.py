"""Exactly-once bulk scoring, port against reference.

``transmogrifai_tpu_torch.bulk`` is a host copy of the JAX package's
checkpointed, kill-survivable batch-inference job whose chunks score
through the port's fused programs.  Held on the CPU:

* against the reference: the reference trains the tiny drill pipeline
  and saves it; the port loads the artifact (``interop``), so both
  score with the same weights.  The port's numpy-fused output bytes
  are equal to the reference's ``BulkScoringJob`` output, its
  torch-fused route on CPU tensors stays within ``ULP_BUDGETS``, and
  the journal documents are equal apart from pids, instance names,
  paths and timestamps;
* the contracts of the JAX package's tests/test_bulk.py on the port: a
  SIGKILL at every journal state boundary (a port child,
  ``testkit.drills.BULK_KILL_CHILD_TEMPLATE``, loading the parent's
  saved model) resumes to bytes equal to an uninterrupted run, torn
  journals, corrupted outputs, the trace, the metrics view, the CLI,
  the runner's ``bulk`` run type and a fleet of port workers
  (``device="cpu"``) losing a replica mid-shard;
* a device fault while scoring a chunk ends the job with that shard
  uncommitted, and a resume completes it.
"""
from __future__ import annotations

import csv
import json
import os
import subprocess
import sys

import pytest

from torch_fleet import PORT_TINY_SPEC, controller, publish_tiny
from torch_parity import (
    PORT,
    REF,
    ULP_BUDGETS,
    assert_rows_close,
    mod,
    reset_uids,
    strip_volatile,
    tiny_pipeline,
)

from transmogrifai_tpu_torch.bulk import (
    OUTPUT_DIR,
    STATE_ASSIGNED,
    STATE_COMMITTED,
    BulkJournal,
    BulkScoringJob,
    TornJournalError,
    concatenated_output,
)
from transmogrifai_tpu_torch.bulk.journal import output_name
from transmogrifai_tpu_torch.faults import injection as faults
from transmogrifai_tpu_torch.interop import load_reference_artifact
from transmogrifai_tpu_torch.serialization.model_io import LAST_GOOD_SUFFIX
from transmogrifai_tpu_torch.testkit.drills import (
    BULK_KILL_CHILD_TEMPLATE,
    drill_env,
    tiny_drill_pipeline,
    write_shard_csv,
)
from transmogrifai_tpu_torch.workflow.workflow import OpWorkflowModel

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

N_ROWS = 120
N_SHARDS = 3
ROWS_PER_SHARD = 40
POISON_INDEX = 45  # row 5 of shard 1: a non-numeric cell -> quarantine
CHUNK_ROWS = 16

#: the journal keys two runs (or two packages) never share
_VOLATILE = ("created_unix", "unix", "pid", "instance", "assigned_to",
             "path", "job_dir", "trace_context", "sha256")


@pytest.fixture(autouse=True)
def _disarm_faults():
    faults.reset()
    mod(REF, "faults.injection").reset()
    yield
    faults.reset()
    mod(REF, "faults.injection").reset()


def _drill_rows(data):
    rows = [{"y": data["y"][i], "a": data["a"][i], "c": data["c"][i]}
            for i in range(N_ROWS)]
    rows[POISON_INDEX] = dict(rows[POISON_INDEX], a="not-a-number")
    return rows


def _write_shards(dirpath: str, rows) -> list:
    shards = []
    for k in range(N_SHARDS):
        p = os.path.join(dirpath, f"in-{k}.csv")
        write_shard_csv(p, rows[k * ROWS_PER_SHARD:(k + 1) * ROWS_PER_SHARD])
        shards.append(p)
    return shards


def _port_workflow():
    """The tiny drill workflow on the CPU, built from fresh uid counters
    (a kill child's fresh process builds the same feature names)."""
    reset_uids(PORT)
    return tiny_drill_pipeline(n=N_ROWS, seed=0, device="cpu")[0]


@pytest.fixture(scope="module")
def bulk_env(tmp_path_factory):
    """The reference's model and its uninterrupted run, the same weights
    in the port (carried over, saved once more as the port's artifact the
    kill children load), and the port's uninterrupted run: the
    byte-identity oracle every resume drill compares against."""
    base = str(tmp_path_factory.mktemp("bulk"))
    reset_uids(REF)
    ref_wf, data, _records, pred_name = tiny_pipeline(REF, n=N_ROWS)
    rows = _drill_rows(data)
    shards = _write_shards(base, rows)
    ref_model = ref_wf.train()
    ref_art = os.path.join(base, "ref-model")
    ref_model.save(ref_art)
    ref_bulk = mod(REF, "bulk")
    ref_dir = os.path.join(base, "ref-job")
    ref_summary = ref_bulk.BulkScoringJob(
        ref_model, ref_dir, shards, chunk_rows=CHUNK_ROWS).run()
    carried = load_reference_artifact(ref_art, _port_workflow())
    port_art = os.path.join(base, "port-model")
    carried.save(port_art)
    model = OpWorkflowModel.load(port_art, _port_workflow())
    port_dir = os.path.join(base, "port-job")
    summary = BulkScoringJob(model, port_dir, shards,
                             chunk_rows=CHUNK_ROWS).run()
    assert summary["ledger"]["balanced"], "reference run must balance"
    return {
        "model": model, "rows": rows, "shards": shards,
        "pred_name": pred_name, "port_art": port_art,
        "ref_model": ref_model, "ref_dir": ref_dir,
        "ref_bytes": ref_bulk.concatenated_output(ref_dir),
        "ref_summary": ref_summary,
        "port_dir": port_dir, "ref": concatenated_output(port_dir),
        "summary": summary,
    }


# -- against the reference -----------------------------------------------------

def test_numpy_fused_output_bytes_equal_to_reference(bulk_env):
    """A CPU model scores numpy-fused: the port's output bytes are the
    reference's, shard for shard, with the same ledger."""
    assert bulk_env["summary"]["scorer_backend"] == "numpy"
    assert bulk_env["ref"] == bulk_env["ref_bytes"]
    assert bulk_env["summary"]["ledger"] == bulk_env["ref_summary"]["ledger"]
    for sid in range(N_SHARDS):
        with open(os.path.join(bulk_env["port_dir"], OUTPUT_DIR,
                               output_name(sid)), "rb") as f:
            got = f.read()
        with open(os.path.join(bulk_env["ref_dir"], OUTPUT_DIR,
                               output_name(sid)), "rb") as f:
            assert got == f.read(), sid


def test_journal_documents_equal_to_reference(bulk_env):
    """The journal and ``status_doc()`` are the reference's apart from
    pids, instance names, paths and timestamps."""
    got = BulkJournal.load(bulk_env["port_dir"])
    want = mod(REF, "bulk").BulkJournal.load(bulk_env["ref_dir"])
    assert strip_volatile(got.doc, _VOLATILE) \
        == strip_volatile(want.doc, _VOLATILE)
    assert strip_volatile(got.status_doc(), _VOLATILE) \
        == strip_volatile(want.status_doc(), _VOLATILE)
    for sid in got.shard_ids():
        assert got.shard(sid)["output_sha256"] \
            == want.shard(sid)["output_sha256"]


def test_torch_fused_route_within_ulp_budget(bulk_env, tmp_path):
    """``fused_backend="torch"`` runs the device program on CPU tensors
    (the card's route, with the plain twins of the kernels): every row
    within the LR family's ULP budget of the reference's bytes."""
    jd = str(tmp_path / "job")
    s = BulkScoringJob(bulk_env["model"], jd, bulk_env["shards"],
                       chunk_rows=CHUNK_ROWS, fused_backend="torch").run()
    assert s["scorer_backend"] == "torch"
    assert s["ledger"] == bulk_env["ref_summary"]["ledger"]
    got = [json.loads(ln) for ln in concatenated_output(jd).splitlines()]
    want = [json.loads(ln) for ln in bulk_env["ref_bytes"].splitlines()]
    ulps, atol = ULP_BUDGETS["lr"]
    assert_rows_close(got, want, ulps, atol)


def test_bulk_journal_helpers_equal_to_reference(tmp_path):
    ref = mod(REF, "bulk.journal")
    port = mod(PORT, "bulk.journal")
    for sid in (0, 7, 12345):
        assert port.output_name(sid) == ref.output_name(sid)
    blob = b"exactly-once\n" * 1000
    assert port.sha256_bytes(blob) == ref.sha256_bytes(blob)
    p = str(tmp_path / "blob")
    with open(p, "wb") as f:
        f.write(blob)
    assert port.sha256_file(p) == ref.sha256_file(p)
    assert port.sha256_file(str(tmp_path / "none")) == (None, 0)
    assert port.STATES == ref.STATES
    assert (port.JOURNAL_FILENAME, port.OUTPUT_DIR) \
        == (ref.JOURNAL_FILENAME, ref.OUTPUT_DIR)


# -- the clean path --------------------------------------------------------------

def test_fresh_job_scores_every_shard_and_balances(bulk_env):
    s = bulk_env["summary"]
    assert s["resumed"] is False
    assert s["shards"] == N_SHARDS
    assert s["shards_scored_this_run"] == N_SHARDS
    led = s["ledger"]
    assert led["complete"] and led["balanced"]
    assert led["rows_in"] == N_ROWS
    assert led["rows_quarantined"] == 1
    assert led["rows_out"] == N_ROWS - 1
    assert led["shards"]["1"]["rows_quarantined"] == 1
    assert led["shards"]["0"]["rows_quarantined"] == 0
    j = BulkJournal.load(bulk_env["port_dir"])
    assert j.states()[STATE_COMMITTED] == N_SHARDS
    assert all(j.verify_output(sid) for sid in j.shard_ids())
    lines = bulk_env["ref"].decode("utf-8").splitlines()
    assert len(lines) == N_ROWS - 1
    assert all(isinstance(json.loads(ln), dict) for ln in lines)


def test_second_clean_run_is_byte_identical(bulk_env, tmp_path):
    jd = str(tmp_path / "job")
    s = BulkScoringJob(bulk_env["model"], jd, bulk_env["shards"],
                       chunk_rows=CHUNK_ROWS).run()
    assert s["resumed"] is False
    assert concatenated_output(jd) == bulk_env["ref"]


def test_columnar_feed_matches_record_scoring(bulk_env):
    """The direct chunk->env feed produces the SAME rows as scoring the
    per-record dicts through the scorer's batch path."""
    from transmogrifai_tpu_torch.local.scorer import LocalScorer

    clean = [r for i, r in enumerate(bulk_env["rows"])
             if i != POISON_INDEX]
    records = [{"a": float(r["a"]), "c": r["c"]} for r in clean]
    scorer = LocalScorer(bulk_env["model"], fused=True)
    want = [json.dumps(r, sort_keys=True, separators=(",", ":"),
                       default=str)
            for r in scorer.score_batch(records)]
    assert bulk_env["ref"].decode("utf-8").splitlines() == want


# -- SIGKILL at every journal state boundary -------------------------------------

# the journal commit sequence for 3 shards is create(1), then per shard
# assigned/scored/committed (2..10); on=N walks the kill across each
# distinct boundary, and bulk.output_crash:on=2 lands in the "output
# durable, receipt lost" window of the SECOND shard
KILL_FAULTS = (
    "bulk.commit_crash:on=1",   # planned: every shard still pending
    "bulk.commit_crash:on=3",   # shard 0 scored, not yet committed
    "bulk.commit_crash:on=5",   # shard 1 assigned, scoring in flight
    "bulk.commit_crash:on=7",   # shard 1 committed, shard 2 pending
    "bulk.output_crash:on=2",   # shard 1 output written, unreceipted
)


def _kill_child(bulk_env, tmp_path, jd: str, fault: str) -> int:
    script = tmp_path / "child.py"
    script.write_text(BULK_KILL_CHILD_TEMPLATE.format(
        repo=REPO, fault=fault, n=N_ROWS, job_dir=jd,
        shards=bulk_env["shards"], chunk=CHUNK_ROWS,
        model_dir=bulk_env["port_art"]))
    env = dict(drill_env(), OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    return subprocess.run([sys.executable, str(script)], env=env,
                          timeout=300).returncode


@pytest.mark.parametrize("fault", KILL_FAULTS)
def test_sigkill_at_state_boundary_resumes_byte_identical(
        bulk_env, tmp_path, fault):
    jd = str(tmp_path / "job")
    assert _kill_child(bulk_env, tmp_path, jd, fault) \
        == faults.DEFAULT_KILL_EXIT  # really killed
    j = BulkJournal.load(jd)
    assert j.states()[STATE_COMMITTED] < N_SHARDS
    s = BulkScoringJob(bulk_env["model"], jd).run()
    assert s["resumed"] is True
    assert concatenated_output(jd) == bulk_env["ref"]
    led = s["ledger"]
    assert led["complete"] and led["balanced"]
    assert led["rows_in"] == N_ROWS
    assert led["rows_out"] == N_ROWS - 1
    assert led["rows_quarantined"] == 1
    (resume,) = s["resumes"]
    assert resume["pid"] == os.getpid()
    assert resume["from_last_good"] is False
    j2 = BulkJournal.load(jd)
    assert j2.states()[STATE_COMMITTED] == N_SHARDS
    assert all(j2.verify_output(sid) for sid in j2.shard_ids())


def test_output_crash_resume_rescores_the_unreceipted_shard(
        bulk_env, tmp_path):
    jd = str(tmp_path / "job")
    assert _kill_child(bulk_env, tmp_path, jd, "bulk.output_crash:on=1") \
        == faults.DEFAULT_KILL_EXIT
    j = BulkJournal.load(jd)
    assert j.shard(0)["state"] == "assigned"
    assert os.path.exists(os.path.join(jd, OUTPUT_DIR, output_name(0)))
    s = BulkScoringJob(bulk_env["model"], jd).run()
    (resume,) = s["resumes"]
    assert resume["recovered_states"]["0"] == "assigned"
    assert 0 in resume["rescored_shards"]
    assert concatenated_output(jd) == bulk_env["ref"]
    assert s["ledger"]["balanced"]


def test_rerun_of_a_completed_job_is_a_noop_resume(bulk_env, tmp_path):
    jd = str(tmp_path / "job")
    BulkScoringJob(bulk_env["model"], jd, bulk_env["shards"],
                   chunk_rows=CHUNK_ROWS).run()
    s = BulkScoringJob(bulk_env["model"], jd, bulk_env["shards"]).run()
    assert s["resumed"] is True
    assert s["shards_scored_this_run"] == 0
    last = s["resumes"][-1]
    assert last["recovered_states"] == {}
    assert last["rescored_shards"] == []
    assert concatenated_output(jd) == bulk_env["ref"]


def test_job_dir_refuses_a_different_input_set(bulk_env, tmp_path):
    other = str(tmp_path / "other.csv")
    write_shard_csv(other, [{"y": 1.0, "a": 0.5, "c": "u"}])
    with pytest.raises(ValueError, match="different input set"):
        BulkScoringJob(bulk_env["model"], bulk_env["port_dir"],
                       [other]).run()


# -- device faults end the job -------------------------------------------------

@pytest.mark.parametrize("on", [1, 2])
def test_device_fault_ends_the_job_and_resume_completes(
        bulk_env, tmp_path, monkeypatch, on):
    """A ``KernelError`` raised while scoring a chunk (shard 0's or shard
    1's: a CSV shard arrives as one chunk) escapes ``run()``: the shard being scored
    stays ``assigned`` (uncommitted), nothing is quarantined for it, the
    committed shards are intact, and a resume scores it to the bytes of
    an uninterrupted run."""
    from transmogrifai_tpu_torch.parallel.kernels import KernelError

    jd = str(tmp_path / "job")
    job = BulkScoringJob(bulk_env["model"], jd, bulk_env["shards"],
                         chunk_rows=CHUNK_ROWS)
    plain = job._score_chunk_local
    calls = {"n": 0}

    def faulty(chunk):
        calls["n"] += 1
        if calls["n"] == on:
            raise KernelError("bin_matrix kernel launch failed: "
                              "CUDA error 700")
        return plain(chunk)

    monkeypatch.setattr(job, "_score_chunk_local", faulty)
    with pytest.raises(KernelError):
        job.run()
    j = BulkJournal.load(jd)
    hit = on - 1
    assert j.shard(hit)["state"] == STATE_ASSIGNED
    assert j.shard(hit)["rows_quarantined"] is None
    assert all(j.shard(s)["state"] == STATE_COMMITTED
               for s in range(hit))
    assert j.ledger()["rows_quarantined"] == 0
    s = BulkScoringJob(bulk_env["model"], jd).run()
    assert s["resumed"] is True
    assert s["resumes"][-1]["recovered_states"] == {str(hit): "assigned"}
    assert concatenated_output(jd) == bulk_env["ref"]
    assert s["ledger"]["balanced"]


# -- journal durability ----------------------------------------------------------

def test_torn_primary_recovers_from_last_good(bulk_env, tmp_path):
    jd = str(tmp_path / "job")
    BulkScoringJob(bulk_env["model"], jd, bulk_env["shards"],
                   chunk_rows=CHUNK_ROWS).run()
    faults.configure("bulk.journal_torn:times=1")
    j = BulkJournal.load(jd)
    assert j.recovered_from_last_good is True
    assert j.states()[STATE_COMMITTED] == N_SHARDS - 1
    faults.configure("bulk.journal_torn:times=1")
    s = BulkScoringJob(bulk_env["model"], jd).run()
    last = s["resumes"][-1]
    assert last["from_last_good"] is True
    assert last["rescored_shards"] == []
    assert last["recovered_states"] == {"2": "scored"}
    assert concatenated_output(jd) == bulk_env["ref"]
    assert s["ledger"]["balanced"]


def test_torn_primary_and_fallback_is_loud(bulk_env, tmp_path):
    jd = str(tmp_path / "job")
    BulkScoringJob(bulk_env["model"], jd, bulk_env["shards"],
                   chunk_rows=CHUNK_ROWS).run()
    primary = os.path.join(jd, "journal.json")
    for path in (primary, primary + LAST_GOOD_SUFFIX):
        with open(path, "r+b") as f:
            f.truncate(30)
    assert BulkJournal.exists(jd)
    with pytest.raises(TornJournalError):
        BulkJournal.load(jd)


def test_corrupted_committed_output_is_caught_and_rescored(
        bulk_env, tmp_path):
    jd = str(tmp_path / "job")
    BulkScoringJob(bulk_env["model"], jd, bulk_env["shards"],
                   chunk_rows=CHUNK_ROWS).run()
    with open(os.path.join(jd, OUTPUT_DIR, output_name(1)), "r+b") as f:
        f.truncate(10)
    j = BulkJournal.load(jd)
    assert j.verify_output(0) and not j.verify_output(1)
    s = BulkScoringJob(bulk_env["model"], jd).run()
    last = s["resumes"][-1]
    assert last["recovered_states"] == {"1": "committed"}
    assert last["rescored_shards"] == [1]
    assert concatenated_output(jd) == bulk_env["ref"]
    assert s["ledger"]["balanced"]


def test_empty_shard_commits_with_zero_rows(bulk_env, tmp_path):
    empty = str(tmp_path / "empty.csv")
    with open(empty, "w", newline="") as f:
        csv.DictWriter(f, fieldnames=["y", "a", "c"]).writeheader()
    jd = str(tmp_path / "job")
    s = BulkScoringJob(bulk_env["model"], jd,
                       [bulk_env["shards"][0], empty],
                       chunk_rows=CHUNK_ROWS).run()
    assert s["ledger"]["balanced"]
    j = BulkJournal.load(jd)
    rec = j.shard(1)
    assert rec["state"] == STATE_COMMITTED
    assert rec["rows_in"] == 0 and rec["rows_out"] == 0
    assert os.path.getsize(j.output_path(1)) == 0
    assert j.verify_output(1)


# -- one trace across plan -> score -> commit -> resume -------------------------

def test_one_trace_spans_plan_to_resume(bulk_env, tmp_path):
    from transmogrifai_tpu_torch.obs.trace import reset_tracer, tracer

    jd = str(tmp_path / "job")
    reset_tracer()
    try:
        BulkScoringJob(bulk_env["model"], jd, bulk_env["shards"],
                       chunk_rows=CHUNK_ROWS).run()
        ctx = BulkJournal.load(jd).doc["trace_context"]
        assert ctx, "planning must stamp its trace context"
        trace_id = ctx.split(":")[0]
        reset_tracer()
        BulkScoringJob(bulk_env["model"], jd).run()
        names = {r["name"] for r in tracer().spans(trace_id)}
        assert "bulk.run" in names and "bulk.resume" in names
        assert BulkJournal.load(jd).doc["trace_context"] == ctx
    finally:
        reset_tracer()


# -- the metrics view, the CLI, the workflow run type ---------------------------

def test_bulk_metrics_view_rides_the_scrape(bulk_env, tmp_path):
    from transmogrifai_tpu_torch.obs.metrics import (
        metrics_registry,
        reset_metrics_registry,
    )

    reset_metrics_registry()
    try:
        job = BulkScoringJob(bulk_env["model"], str(tmp_path / "job"),
                             bulk_env["shards"], chunk_rows=CHUNK_ROWS)
        job.run()
        text = metrics_registry().prometheus_text()
        samples = {}
        for line in text.splitlines():
            if line.startswith("tx_bulk_"):
                name = line.split("{", 1)[0]
                samples[name] = float(line.rsplit(" ", 1)[1])
        assert samples["tx_bulk_shards_total"] == N_SHARDS
        assert samples["tx_bulk_shards_committed"] == N_SHARDS
        assert samples["tx_bulk_shards_pending"] == 0
        assert samples["tx_bulk_rows_out"] == N_ROWS - 1
        assert samples["tx_bulk_rows_quarantined"] == 1
        assert samples["tx_bulk_rows_per_s"] > 0
        assert set(job.snapshot()) == set(mod(REF, "bulk").BulkScoringJob(
            bulk_env["ref_model"], bulk_env["ref_dir"]).snapshot())
    finally:
        reset_metrics_registry()


def test_cli_bulk_status_prints_the_journal(bulk_env, capsys):
    from transmogrifai_tpu_torch.cli import main

    rc = main(["bulk", "status", bulk_env["port_dir"]])
    out = capsys.readouterr().out
    assert rc == 0
    doc = json.loads(out)
    assert doc["n_shards"] == N_SHARDS
    assert doc["states"][STATE_COMMITTED] == N_SHARDS
    assert doc["ledger"]["balanced"] is True
    assert doc["ledger"]["rows_quarantined"] == 1
    assert doc["trace_context"]
    ref_rc = mod(REF, "cli").main(["bulk", "status", bulk_env["ref_dir"]])
    want = json.loads(capsys.readouterr().out)
    assert ref_rc == rc
    assert strip_volatile(doc, _VOLATILE) == strip_volatile(want, _VOLATILE)


def test_cli_bulk_status_torn_journal_exits_1(tmp_path, capsys):
    from transmogrifai_tpu_torch.cli import main

    jd = str(tmp_path / "job")
    os.makedirs(jd)
    with open(os.path.join(jd, "journal.json"), "w") as f:
        f.write("{ torn")
    rc = main(["bulk", "status", jd])
    doc = json.loads(capsys.readouterr().out)
    assert rc == 1
    assert doc["error"].startswith("TornJournalError")
    assert mod(REF, "cli").main(["bulk", "status", jd]) == 1
    assert json.loads(capsys.readouterr().out)["error"].startswith(
        "TornJournalError")


def test_runner_bulk_run_type(tmp_path):
    from transmogrifai_tpu_torch.workflow.params import OpParams
    from transmogrifai_tpu_torch.workflow.runner import OpWorkflowRunner

    reset_uids(PORT)
    wf, data, _records, _pred = tiny_drill_pipeline(n=N_ROWS, seed=0,
                                                    device="cpu")
    rows = _drill_rows(data)
    mloc = str(tmp_path / "model")
    OpWorkflowRunner(wf).run("train", OpParams(model_location=mloc))
    shards = _write_shards(str(tmp_path), rows)
    params = OpParams(
        model_location=mloc,
        write_location=str(tmp_path / "out"),
        metrics_location=str(tmp_path / "metrics"),
        custom_params={"bulk_inputs": shards,
                       "bulk_chunk_rows": CHUNK_ROWS},
    )
    r = OpWorkflowRunner(_port_workflow()).run("bulk", params)
    assert r.run_type == "bulk"
    assert r.metrics["ledger"]["balanced"] is True
    assert r.metrics["ledger"]["rows_in"] == N_ROWS
    assert r.metrics["scorer_backend"] == "numpy"
    jd = os.path.join(str(tmp_path / "out"), "bulk")
    assert BulkJournal.load(jd).states()[STATE_COMMITTED] == N_SHARDS
    with open(tmp_path / "metrics" / "bulk_metrics.json") as f:
        saved = json.load(f)
    assert saved["run_type"] == "bulk"
    assert saved["ledger"]["balanced"] is True
    # the device route on request; "xla" is the reference's and refused
    params.custom_params.update(bulk_fused_backend="torch",
                                bulk_job_dir=str(tmp_path / "job-torch"))
    r2 = OpWorkflowRunner(_port_workflow()).run("bulk", params)
    assert r2.metrics["scorer_backend"] == "torch"
    params.custom_params.update(bulk_fused_backend="xla",
                                bulk_job_dir=str(tmp_path / "job-xla"))
    with pytest.raises(ValueError, match="bulk_fused_backend"):
        OpWorkflowRunner(_port_workflow()).run("bulk", params)


# -- fleet mode -------------------------------------------------------------------

def test_fleet_replica_death_midshard_keeps_output_exactly_once(
        bulk_env, tmp_path):
    root = str(tmp_path / "registry")
    mod(PORT, "registry").ModelRegistry(root).publish(
        bulk_env["model"], stage="stable")
    shards = bulk_env["shards"]
    with controller(
        root, PORT_TINY_SPEC, 2, str(tmp_path / "fleet"), max_restarts=0,
        # replica-1 dies on its FIRST bulk chunk; the router must
        # reassign the in-flight batch to the survivor
        worker_env_overrides={
            "replica-1": {"TX_FAULTS": "bulk.replica_die_midshard:on=1"},
        },
    ) as fc:
        jd = str(tmp_path / "job")
        s = BulkScoringJob(bulk_env["model"], jd, shards, router=fc.router,
                           chunk_rows=CHUNK_ROWS, max_in_flight=4).run()
        led = s["ledger"]
        assert led["complete"] and led["balanced"]
        assert led["rows_in"] == N_ROWS
        assert led["rows_out"] == N_ROWS - 1
        snap = fc.router.snapshot()
        assert snap["replica_deaths"] == 1
        assert snap["retries"] >= 1  # the victim died holding a chunk
        got = concatenated_output(jd)
        assert len(got.splitlines()) == N_ROWS - 1
        # the fleet's rows are the local run's (the workers' CPU model is
        # the same artifact): the failover duplicated WORK, never OUTPUT
        want = [json.loads(ln) for ln in bulk_env["ref"].splitlines()]
        rows = [json.loads(ln) for ln in got.splitlines()]
        assert [list(r.values()) for r in rows] \
            == [list(r.values()) for r in want]
        jd2 = str(tmp_path / "job2")
        s2 = BulkScoringJob(bulk_env["model"], jd2, shards,
                            router=fc.router, chunk_rows=CHUNK_ROWS,
                            max_in_flight=4).run()
        assert s2["ledger"]["balanced"]
        assert concatenated_output(jd2) == got


def test_bulk_job_scores_one_hosted_model(tmp_path):
    from transmogrifai_tpu_torch.fleet import UnhostedModelError

    reg = publish_tiny(str(tmp_path / "mm-registry"))
    reset_uids(PORT)
    wf, data, _records, _pred = tiny_drill_pipeline(n=80, seed=0,
                                                    device="cpu")
    model = wf.train()
    rows = [{"y": data["y"][i], "a": data["a"][i], "c": data["c"][i]}
            for i in range(80)]
    shards = []
    for k in range(2):
        p = str(tmp_path / f"in-{k}.csv")
        write_shard_csv(p, rows[k * 40:(k + 1) * 40])
        shards.append(p)
    models = {"alpha": reg["v1"], "beta": reg["v2"]}
    with controller(reg["root"], PORT_TINY_SPEC, 2,
                    str(tmp_path / "fleet"), models=models) as fc:
        jd = str(tmp_path / "job")
        job = BulkScoringJob(model, jd, shards, router=fc.router,
                             model_id="alpha", chunk_rows=16, workers=1)
        summary = job.run()
        led = summary["ledger"]
        assert led["rows_in"] == 80 and led["rows_out"] == 80
        assert led["rows_in"] == led["rows_out"] + led["rows_quarantined"]
        with open(os.path.join(jd, "journal.json")) as f:
            doc = json.load(f)
        assert doc["params"]["model_id"] == "alpha"
        assert fc.router.snapshot()["rows_by_model"].get("alpha") == 80
        job2 = BulkScoringJob(model, str(tmp_path / "job2"), shards,
                              router=fc.router, model_id="ghost",
                              chunk_rows=16, workers=1)
        with pytest.raises(UnhostedModelError):
            job2.run()
    with pytest.raises(ValueError):
        BulkScoringJob(model, str(tmp_path / "job3"), shards,
                       model_id="alpha")  # model_id needs a fleet
