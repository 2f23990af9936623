"""Helpers shared by the tests/test_torch_fleet_*.py and
tests/test_torch_multimodel.py fleet drills.

Replica workers are separate processes.  On this host every port
fleet runs with ``device="cpu"`` (the default ``"cuda"`` raises without
a card) and each worker is held to one torch/OpenMP thread, so six
pytest workers that each spawn a few replicas do not oversubscribe the
CPU.  ``WORKER_ENV`` also puts this directory on the children's
``PYTHONPATH``, so a worker can load the CPU factories below as
``torch_fleet:<name>``.
"""
from __future__ import annotations

import os
import time

TESTS = os.path.dirname(os.path.abspath(__file__))

#: env of every replica worker the port's fleet tests spawn
WORKER_ENV = {
    "OMP_NUM_THREADS": "1",
    "MKL_NUM_THREADS": "1",
    "PYTHONPATH": TESTS,
}

#: the package's factories, loaded by port workers (which set their own
#: ``--device`` on the workflow) and by reference workers alike
PORT_TINY_SPEC = "transmogrifai_tpu_torch.testkit.drills:tiny_drill_pipeline"
REF_TINY_SPEC = "transmogrifai_tpu.testkit.drills:tiny_drill_pipeline"


def controller(root: str, spec: str, n_replicas: int, work_dir: str,
               **kw):
    """A port ``FleetController`` of CPU replicas at one thread each, with
    the drills' router defaults (2 in flight per replica, queue 64)."""
    from transmogrifai_tpu_torch.fleet import FleetController

    kw.setdefault("router_kw", {})
    kw["router_kw"].setdefault("max_in_flight_per_replica", 2)
    kw["router_kw"].setdefault("max_queue", 64)
    kw["worker_env"] = dict(WORKER_ENV, **kw.get("worker_env", {}))
    kw.setdefault("ship_interval_s", 0.15)
    return FleetController(root, spec, n_replicas=n_replicas,
                           work_dir=work_dir, device="cpu", **kw)


def publish_tiny(root: str, n_versions: int = 3) -> dict:
    """One tiny drill model trained on the CPU, published ``n_versions``
    times (v1 stable, the rest candidates): the registry every drill
    serves."""
    from transmogrifai_tpu_torch.registry import ModelRegistry
    from transmogrifai_tpu_torch.testkit.drills import tiny_drill_pipeline
    from transmogrifai_tpu_torch.utils.uid import reset_uids

    # a worker builds its first workflow in a fresh process: the same
    # feature names as this build
    reset_uids()
    wf, _data, records, pred_name = tiny_drill_pipeline(device="cpu")
    model = wf.train()
    reg = ModelRegistry(root)
    out = {"root": root, "records": records, "pred_name": pred_name,
           "model": model}
    for i in range(n_versions):
        v = reg.publish(model, stage="stable" if i == 0 else "candidate")
        out[f"v{i + 1}"] = v.version
    return out


def wait_for(predicate, timeout_s: float, what: str) -> None:
    deadline = time.monotonic() + timeout_s
    while time.monotonic() <= deadline:
        if predicate():
            return
        time.sleep(0.05)
    raise AssertionError(f"timed out waiting for {what}")


# -- CPU factories, importable as torch_fleet:<name> -------------------------

def tiny_cpu():
    """The tiny drill workflow on the CPU."""
    from transmogrifai_tpu_torch.testkit.drills import tiny_drill_pipeline

    return tiny_drill_pipeline(device="cpu")[0]


def continuous_drill_cpu():
    """The selector-backed continuous drill workflow on the CPU."""
    from transmogrifai_tpu_torch.testkit.drills import (
        continuous_drill_workflow,
    )

    return continuous_drill_workflow(device="cpu")


def device_fault_tiny():
    """The tiny drill workflow whose scoring raises ``KernelError`` for
    a record carrying ``"fault": True``: a worker that loads it meets a
    device fault on exactly the requests that ask for one (its warm-up
    and ordinary traffic score normally)."""
    from transmogrifai_tpu_torch.parallel.kernels import KernelError
    from transmogrifai_tpu_torch.serving import endpoint as _endpoint

    cls = _endpoint.CompiledEndpoint
    if not getattr(cls, "_fault_armed", False):
        plain = cls.score_batch

        def score_batch(self, records, *args, **kw):
            if any(r.get("fault") for r in records):
                raise KernelError(
                    "bin_matrix kernel launch failed: CUDA error 700")
            return plain(self, records, *args, **kw)

        cls.score_batch = score_batch
        cls._fault_armed = True
    return tiny_cpu()
