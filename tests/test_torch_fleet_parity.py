"""The fleet slice as a whole, port against reference.

``torch_parity.reference_pair`` gives the same fitted model in both
packages (the JAX package trains and saves it, the port loads the
artifact).  Each package publishes it into a registry of its own and
runs a two-replica fleet over it - the reference's workers on
``JAX_PLATFORMS=cpu`` (as its controller sets), the port's on
``device="cpu"`` at one thread each, both serving numpy-fused - and
the same records are routed through each router:

* the routed rows are bit-equal (tolerance 0), as
  tests/test_torch_serving.py holds the endpoints, and the routers'
  ``rows_ok`` and batch counters agree;
* the runner's ``fleet`` run type on the CPU: both packages'
  ``OpWorkflowRunner(...).run("fleet")`` publish, bring a fleet up,
  pump the reader's rows and roll a new version mid-traffic, and the
  port's ``fleet_metrics.json`` carries the reference's keys.
"""
from __future__ import annotations

import json

import pytest

from torch_fleet import (
    PORT_TINY_SPEC,
    REF_TINY_SPEC,
    WORKER_ENV,
    controller,
)
from torch_parity import PORT, REF, mod, reference_pair, tiny_pipeline

NUMPY_FUSED = ["--fused-backend", "numpy"]


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    """(reference model, port model, records, workspace): the tiny drill
    pipeline trained once in the JAX package."""
    ws = tmp_path_factory.mktemp("fleet-parity")
    ref, port = reference_pair(lambda pkg: tiny_pipeline(pkg)[0],
                               str(ws / "ref_model"))
    _wf, _data, records, _name = tiny_pipeline(PORT)
    port.save(str(ws / "port_model"))
    return ref, port, records, ws


def _ref_controller(root, work_dir, **kw):
    return mod(REF, "fleet").FleetController(
        root, REF_TINY_SPEC, n_replicas=2, work_dir=work_dir,
        ship_interval_s=0.15, worker_env=dict(WORKER_ENV),
        router_kw={"max_in_flight_per_replica": 2, "max_queue": 64}, **kw)


def _route(fc, batches):
    out = [fc.router.score_batch(b, timeout_s=120.0) for b in batches]
    snap = fc.router.snapshot()
    return out, {k: snap[k] for k in ("rows_ok", "requests_ok",
                                      "rows_failed", "requests_failed")}


def test_fleet_rows_bit_equal_to_reference_fleet(pair):
    ref_model, port_model, records, ws = pair
    roots = {}
    for pkg, model in ((REF, ref_model), (PORT, port_model)):
        roots[pkg] = str(ws / f"{pkg}_registry")
        mod(pkg, "registry").ModelRegistry(roots[pkg]).publish(
            model, stage="stable")
    batches = [records[lo:lo + n] for lo, n in
               ((0, 1), (1, 7), (8, 33), (41, 64), (0, len(records)))]
    with _ref_controller(roots[REF], str(ws / "ref_fleet"),
                         worker_args=NUMPY_FUSED) as fc:
        want, want_counts = _route(fc, batches)
    with controller(roots[PORT], PORT_TINY_SPEC, 2, str(ws / "port_fleet"),
                    worker_args=NUMPY_FUSED) as fc:
        got, got_counts = _route(fc, batches)
        replicas = fc.status()["replicas"]
    assert got == want
    assert got_counts == want_counts
    assert got_counts["rows_ok"] == sum(len(b) for b in batches)
    assert got_counts["requests_ok"] == len(batches)
    assert set(replicas) == {"replica-0", "replica-1"}


def _keys(doc, prefix=""):
    out = set()
    for k, v in doc.items():
        out.add(prefix + k)
        if isinstance(v, dict) and k not in ("replicas", "router"):
            out |= _keys(v, prefix + k + ".")
    return out


def _fleet_run(pkg, pair, monkeypatch):
    ref_model, port_model, _records, ws = pair
    name = "ref_model" if pkg == REF else "port_model"
    out = ws / f"{pkg}_run"
    spec = REF_TINY_SPEC if pkg == REF else PORT_TINY_SPEC
    for k, v in WORKER_ENV.items():
        monkeypatch.setenv(k, v)
    params = mod(pkg, "workflow.params").OpParams(
        model_location=str(ws / name),
        metrics_location=str(out / "metrics"),
        custom_params={
            "registry_root": str(out / "registry"),
            "fleet_workflow": spec,
            "fleet_replicas": 2,
            "fleet_work_dir": str(out / "fleet"),
            "fleet_batch_rows": 16,
            "fleet_concurrency": 2,
            "serving_fused_backend": "numpy",
        })
    wf = tiny_pipeline(pkg)[0]
    runner = mod(pkg, "workflow.runner").OpWorkflowRunner(wf)
    # a second version to roll to mid-traffic: the same artifact again
    reg = mod(pkg, "registry").ModelRegistry(str(out / "registry"))
    reg.publish(ref_model if pkg == REF else port_model, stage="candidate")
    params.custom_params["fleet_deploy_version"] = "v1"
    res = runner.run("fleet", params)
    with open(out / "metrics" / "fleet_metrics.json") as f:
        saved = json.load(f)
    return res, saved


def test_runner_fleet_run_has_the_reference_keys(pair, monkeypatch):
    _ref, _port, records, _ws = pair
    _want_res, want = _fleet_run(REF, pair, monkeypatch)
    got_res, got = _fleet_run(PORT, pair, monkeypatch)
    assert got_res.run_type == "fleet" and got["run_type"] == "fleet"
    assert _keys(got) == _keys(want)
    assert set(got["status"]) == set(want["status"])
    for k in ("rows_submitted", "rows_ok", "rows_failed", "replicas",
              "published_version", "errors"):
        assert got[k] == want[k], k
    assert got["rows_ok"] == len(records) and got["errors"] == []
    assert [s["instance"] for s in got["rolling_deploy"]] == [
        s["instance"] for s in want["rolling_deploy"]]
    assert got_res.metrics["rows_ok"] == got["rows_ok"]
