"""Shared fixtures for the fault/robustness and fleet drills.

Host copy of the importable factories of ``transmogrifai_tpu/testkit/
drills.py``: one tiny-but-real pipeline (FeatureBuilder -> transmogrify ->
LR through the full stage stack), the serving-fleet workload and the
continuous-training drill surface.  Each factory is importable as
``transmogrifai_tpu_torch.testkit.drills:<name>``, the ``module:function``
convention fleet replica workers and the continuous trainer load a
workflow by, so every process rebuilds the identical workflow.

Each workflow is built on ``device`` (the card by default, like
``OpWorkflow()``); a fleet replica sets its own ``--device`` on every
workflow it loads into.

The child-script templates at the end are the drills' kill, crash and
fleet children (a kill must land in a child process:
``faults.inject_kill`` calls ``os._exit``).  Each imports
``transmogrifai_tpu_torch`` only and formats with the JAX package's
keys; a template that builds a workflow also takes ``device``, which is
``"cpu"`` unless the caller formats in another one.
"""
from __future__ import annotations


def tiny_drill_pipeline(n: int = 120, seed: int = 0, device: str = "cuda"):
    """-> (workflow, data, records, prediction_name): a seconds-to-train
    mixed-type pipeline whose numbers still come from the real stage
    stack."""
    import numpy as np

    from .. import dsl  # noqa: F401 - feature operators
    from .. import FeatureBuilder, OpWorkflow
    from ..models.logistic_regression import OpLogisticRegression
    from ..ops.transmogrifier import transmogrify
    from ..types import feature_types as ft

    rng = np.random.RandomState(seed)
    data = {
        "y": (rng.rand(n) > 0.5).astype(float).tolist(),
        "a": rng.randn(n).tolist(),
        "c": [("u", "v", "w")[i % 3] for i in range(n)],
    }
    y = FeatureBuilder(ft.RealNN, "y").as_response()
    a = FeatureBuilder(ft.Real, "a").as_predictor()
    c = FeatureBuilder(ft.PickList, "c").as_predictor()
    vec = transmogrify([a, c])
    pred = OpLogisticRegression(reg_param=0.01).set_input(y, vec).get_output()
    wf = (OpWorkflow(device=device).set_result_features(pred)
          .set_input_dataset(data))
    records = [{"a": data["a"][i], "c": data["c"][i]} for i in range(n)]
    return wf, data, records, pred.name


def corrupted_csv_drill(dirpath: str, n_rows: int = 500,
                        n_type_flips: int = 5, n_truncated: int = 3,
                        seed: int = 7):
    """-> (csv_path, raw_features, truth): a corrupted CSV matching the
    tiny drill pipeline's schema (y response, a numeric, c picklist)
    plus the exact corruption ground truth (random_data.
    write_corrupted_csv) - ONE fixture shared by the quarantine tests
    and the chaos-composition drill, so their expected counts can never
    drift apart."""
    import os

    from .. import dsl  # noqa: F401 - feature operators
    from .. import FeatureBuilder
    from ..types import feature_types as ft
    from .random_data import write_corrupted_csv

    path = os.path.join(dirpath, "corrupted.csv")
    truth = write_corrupted_csv(
        path, n_rows=n_rows, n_type_flips=n_type_flips,
        n_truncated=n_truncated, seed=seed,
    )
    y = FeatureBuilder(ft.RealNN, "y").as_response()
    a = FeatureBuilder(ft.Real, "a").as_predictor()
    c = FeatureBuilder(ft.PickList, "c").as_predictor()
    return path, [y, a, c], truth


def serving_fleet_workflow(n: int = 891, seed: int = 7,
                           device: str = "cuda"):
    """-> (workflow, records): the synthetic mixed-type serving
    pipeline (picklists + reals + integrals through transmogrify ->
    sanity check -> LR) - the fleet workload.  IMPORTABLE as
    ``transmogrifai_tpu_torch.testkit.drills:serving_fleet_workflow`` so
    replica worker processes can rebuild the workflow a registry
    artifact was trained under (deterministic for a fixed seed)."""
    import numpy as np

    from .. import dsl  # noqa: F401 - feature operators
    from .. import FeatureBuilder, OpWorkflow
    from ..models.logistic_regression import OpLogisticRegression
    from ..ops.transmogrifier import transmogrify
    from ..types import feature_types as ft

    rng = np.random.RandomState(seed)
    cabins = ["A1", "B2", "C3", "D4", None]
    data = {
        "label": (rng.rand(n) > 0.6).astype(float).tolist(),
        "klass": [str(rng.randint(1, 4)) for _ in range(n)],
        "sex": [("male", "female")[rng.randint(2)] for _ in range(n)],
        "age": [float(a) if rng.rand() > 0.2 else None
                for a in rng.uniform(1, 80, n)],
        "fare": rng.uniform(5, 500, n).round(2).tolist(),
        "sibs": rng.randint(0, 5, n).astype(float).tolist(),
        "cabin": [cabins[rng.randint(len(cabins))] for _ in range(n)],
    }
    label = FeatureBuilder(ft.RealNN, "label").as_response()
    klass = FeatureBuilder(ft.PickList, "klass").as_predictor()
    sex = FeatureBuilder(ft.PickList, "sex").as_predictor()
    age = FeatureBuilder(ft.Real, "age").as_predictor()
    fare = FeatureBuilder(ft.Real, "fare").as_predictor()
    sibs = FeatureBuilder(ft.Integral, "sibs").as_predictor()
    cabin = FeatureBuilder(ft.PickList, "cabin").as_predictor()
    vec = transmogrify(
        [klass, sex, age.fill_missing_with_mean().z_normalize(), fare,
         sibs, cabin]
    )
    checked = label.sanity_check(vec, remove_bad_features=True)
    pred = OpLogisticRegression(reg_param=0.01).set_input(
        label, checked).get_output()
    wf = (OpWorkflow(device=device).set_result_features(pred)
          .set_input_dataset(data))
    feature_names = ("klass", "sex", "age", "fare", "sibs", "cabin")
    records = [{k: data[k][i] for k in feature_names} for i in range(n)]
    return wf, records


def drill_env() -> dict:
    """Child-process env for supervision/crash drills: no inherited fault
    plan (TX_FAULTS would re-arm in the child).  The ambient trace
    context rides along (``obs.fleet.child_env``): a drill child's spans
    join the test's trace, exactly like a production child's join its
    dispatching run's."""
    import os

    from ..obs.fleet import child_env

    env = child_env(dict(os.environ))
    env.pop("TX_FAULTS", None)
    return env


# -- continuous-training drill surface -----------------------------------
def continuous_shard_rows(n: int = 64, seed: int = 0,
                          shift: float = 0.0) -> list:
    """-> n row dicts (y, a, c) matching the tiny drill schema.  ``a``
    is N(shift, 1) and ``y`` thresholds on the CENTERED value, so the
    label balance (and therefore trainability) survives any shift while
    the marginal of ``a`` - what the drift monitor watches - moves with
    it.  Deterministic per (n, seed, shift), and equal to the JAX
    package's rows for the same arguments."""
    import numpy as np

    rng = np.random.RandomState(seed)
    a = rng.randn(n) + float(shift)
    y = ((a - float(shift) + 0.3 * rng.randn(n)) > 0).astype(float)
    return [
        {"y": float(y[i]), "a": float(a[i]),
         "c": ("u", "v", "w")[i % 3]}
        for i in range(n)
    ]


def write_shard_csv(path: str, rows: list) -> str:
    """Atomically publish one y,a,c shard CSV (tmp + os.replace): the
    producer contract :class:`~..readers.pipeline.ShardDirectoryFollower`
    documents - the follower must never see a half-written file."""
    import csv
    import os
    import tempfile

    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
    with os.fdopen(fd, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=["y", "a", "c"])
        w.writeheader()
        w.writerows(rows)
    os.replace(tmp, path)
    return path


def continuous_drill_workflow(n: int = 256, seed: int = 0,
                              device: str = "cuda"):
    """-> a selector-backed workflow over the y/a/c drill schema, input
    dataset attached (``continuous_shard_rows(n, seed)``).  IMPORTABLE
    as ``transmogrifai_tpu_torch.testkit.drills:continuous_drill_workflow``,
    the daemon/worker/seed-trainer factory convention.  The selector is
    2 folds x a 2-point LR grid."""
    from .. import dsl  # noqa: F401 - feature operators
    from .. import FeatureBuilder, OpWorkflow
    from ..models.logistic_regression import OpLogisticRegression
    from ..ops.transmogrifier import transmogrify
    from ..selector.factories import BinaryClassificationModelSelector
    from ..types import feature_types as ft

    rows = continuous_shard_rows(n, seed)
    data = {k: [r[k] for r in rows] for k in ("y", "a", "c")}
    y = FeatureBuilder(ft.RealNN, "y").as_response()
    a = FeatureBuilder(ft.Real, "a").as_predictor()
    c = FeatureBuilder(ft.PickList, "c").as_predictor()
    vec = transmogrify([a, c])
    selector = BinaryClassificationModelSelector.with_cross_validation(
        num_folds=2,
        models_and_parameters=[
            (OpLogisticRegression(max_iter=6),
             [{"reg_param": r, "elastic_net_param": 0.1}
              for r in (0.01, 0.1)]),
        ],
        splitter=None,
        device=device,
    )
    pred = selector.set_input(y, vec).get_output()
    return (OpWorkflow(device=device).set_result_features(pred)
            .set_input_dataset(data))


def continuous_tiny_factory(device: str = "cuda"):
    """-> the plain-LR tiny drill workflow (no selector): the FAST
    factory for continuous drills that exercise crash/recovery paths."""
    return tiny_drill_pipeline(device=device)[0]


# -- child-script templates ---------------------------------------------------
class ChildTemplate(str):
    """A child script's source whose :meth:`format` fills the keys the
    caller leaves out from ``defaults`` (``device="cpu"`` and the like),
    so a template formats with the JAX package's keys alone."""

    def __new__(cls, source: str, **defaults):
        self = super().__new__(cls, source)
        self.defaults = dict(defaults)
        return self

    def format(self, *args, **kwargs) -> str:
        return str.format(self, *args, **dict(self.defaults, **kwargs))


#: the first lines of every port child: the repo on the path and the
#: JAX modules unimportable (the torch package never needs them)
_PRELUDE = """
import os, sys
sys.path.insert(0, {repo!r})
sys.modules["jax"] = None
"""


#: child for the continuous warm-refit drills: cold-train the selector
#: drill workflow of exactly ``n`` rows on ``device`` and publish the
#: model as stable v1 into the registry at ``root``.  ``cache_dir`` is
#: the JAX package's key: it is set on each validator as
#: ``train_cache_dir`` and left unused, because the port keeps no
#: compiled-program cache - so this child proves a COLD publish (the
#: trail's ``cache`` is ``"none"``), not a cache rehydration.
CONTINUOUS_SEED_TRAINER_TEMPLATE = ChildTemplate(_PRELUDE + """
import json
os.environ.setdefault("TX_PRODUCT_MESH", "0")
from transmogrifai_tpu_torch.testkit.drills import continuous_drill_workflow
from transmogrifai_tpu_torch.registry import ModelRegistry
from transmogrifai_tpu_torch.workflow.dag import compute_dag
from transmogrifai_tpu_torch.workflow.runner import train_fused_summary
wf = continuous_drill_workflow(n={n}, seed={seed}, device={device!r})
validators = []
for layer in compute_dag(wf.result_features):
    for stage in layer:
        if getattr(stage, "is_model_selector", False):
            stage.validator.train_fused = True
            stage.validator.train_cache_dir = {cache_dir!r}
            validators.append(stage.validator)
model = wf.train()
trail = train_fused_summary(validators)
reg = ModelRegistry({root!r})
entry = reg.publish(model, stage="stable")
print("SEEDED", entry.version, json.dumps(trail), flush=True)
os._exit(0)
""", device="cpu")


#: child for the ``continuous.refit_crash`` drills: run one trainer
#: cycle over a pre-seeded registry + a pre-written drifted shard with
#: the kill armed - the refit completes, then the process dies in the
#: window BEFORE the registry publish (exit DEFAULT_KILL_EXIT).  The
#: parent asserts the registry still points at the old stable and a
#: fresh (unarmed) trainer's next cycle recovers end-to-end.  Tiny
#: factory on ``device`` + consecutive=1/cooldown=0 + train_fused off.
CONTINUOUS_REFIT_CRASH_TEMPLATE = ChildTemplate(_PRELUDE + """
import functools
from transmogrifai_tpu_torch.continuous import ContinuousTrainer
from transmogrifai_tpu_torch.faults import injection
from transmogrifai_tpu_torch.testkit.drills import continuous_tiny_factory
trainer = ContinuousTrainer(
    {watch!r}, {root!r},
    functools.partial(continuous_tiny_factory, device={device!r}),
    drift_threshold=0.05, consecutive_windows=1, cooldown_windows=0,
    min_window_rows=8, refit_rows=256, train_fused=False,
)
injection.configure({fault!r})            # arm the crash
trainer.run_cycle()                       # dies at continuous.refit_crash
os._exit(0)                               # unreachable when armed
""", device="cpu")


#: child script for supervision drills: exits ``first_exit`` on the run
#: that creates ``marker``, ``then_exit`` on every run after (die-once
#: recovery when then_exit=0, differing-exit-codes when both non-zero).
DIE_ONCE_CHILD_TEMPLATE = ChildTemplate("""
import os, sys
p = {marker!r}
if not os.path.exists(p):
    open(p, 'w').close()
    sys.exit({first_exit})
sys.exit({then_exit})
""")


#: child for the mesh-peer drills: beats its PeerHealth heartbeat
#: ``beats`` times at ``interval`` seconds, then either dies
#: (``mode='die'``, exit ``exit_code``) or wedges alive-but-beatless
#: (``mode='hang'``) - the two stall classes a surviving mesh process
#: must tell apart from heartbeat files alone (liveness never rides the
#: possibly wedged collective channel).
MESH_PEER_CHILD_TEMPLATE = ChildTemplate(_PRELUDE + """
import time
from transmogrifai_tpu_torch.parallel.resilience import PeerHealth
ph = PeerHealth({hb_dir!r}, process_id={peer_id})
for _ in range({beats}):
    ph.beat()
    time.sleep({interval})
if {mode!r} == "die":
    os._exit({exit_code})
time.sleep(600)  # hang: alive but no longer beating
""")


#: child for the bootstrap-deadline drills: ``parallel.distributed.
#: initialize()`` against a coordinator that never answers (armed via
#: TX_FAULTS ``mesh.init_no_coordinator`` in the child env, or a
#: genuinely unreachable ``addr``) must raise MeshBootstrapError within
#: TX_MESH_INIT_TIMEOUT_S - exit 42 proves the named error, any other
#: loud failure exits 43, and an indefinite hang fails the drill's
#: subprocess timeout.  ``process_id`` and ``backend`` default to 0 and
#: ``"gloo"``.
MESH_BOOTSTRAP_CHILD_TEMPLATE = ChildTemplate(_PRELUDE + """
from transmogrifai_tpu_torch.parallel.distributed import (
    MeshBootstrapError, initialize)
try:
    initialize(coordinator_address={addr!r}, num_processes=2,
               process_id={process_id}, backend={backend!r})
except MeshBootstrapError as e:
    print("MESH_BOOTSTRAP_ERROR:", str(e)[:160], flush=True)
    os._exit(42)  # _exit: a half-dialled rendezvous must not block exit
except Exception as e:
    print("OTHER_ERROR:", type(e).__name__, str(e)[:160], flush=True)
    os._exit(43)
print("NO_ERROR", flush=True)
os._exit(0)
""", process_id=0, backend="gloo")


#: child for the registry publish-crash drills: train the tiny pipeline
#: on ``device``, publish + promote a clean v1 into the registry at
#: ``root``, arm ``fault`` (e.g. "registry.publish_crash:on=1"), publish
#: again and die in the window between the artifact save and the index
#: commit.  Exits 0 only if the kill failed to fire; the parent asserts
#: the registry is still loadable at v1.
REGISTRY_CRASH_PUBLISHER_TEMPLATE = ChildTemplate(_PRELUDE + """
from transmogrifai_tpu_torch.testkit.drills import tiny_drill_pipeline
from transmogrifai_tpu_torch.registry import ModelRegistry
wf, _data, _records, _name = tiny_drill_pipeline(device={device!r})
model = wf.train()
reg = ModelRegistry({root!r})
v1 = reg.publish(model, metrics={{"auroc": 0.9}})
reg.promote(v1.version, to="stable")
from transmogrifai_tpu_torch.faults import injection
injection.configure({fault!r})            # arm the crash
reg.publish(model)                        # dies at the injected point
os._exit(0)                               # unreachable when armed
""", device="cpu")


#: child script for the kill-during-save drills: train the tiny pipeline
#: on ``device``, save a clean v1, arm ``fault`` (e.g.
#: "io.save_model.crash_window:on=1"), save again and die at the
#: injected point.  Format with repo / path / fault; exits 0 only if the
#: kill failed to fire.
CRASH_SAVER_TEMPLATE = ChildTemplate(_PRELUDE + """
from transmogrifai_tpu_torch.testkit.drills import tiny_drill_pipeline
wf, _data, _records, _name = tiny_drill_pipeline(device={device!r})
model = wf.train()
model.save({path!r})                      # clean v1
from transmogrifai_tpu_torch.faults import injection
injection.configure({fault!r})            # arm the crash
model.save({path!r})                      # dies at the injected point
os._exit(0)                               # unreachable when armed
""", device="cpu")


#: child for the fleet-aggregation drills: beats metrics + spans into
#: its own obs shard every ``interval`` seconds for ``duration``
#: seconds, then exits 0.  Adopts the parent's trace context from the
#: env seam automatically (the tracer reads TX_OBS_TRACE_CONTEXT at
#: construction), so its spans merge into the dispatching test's trace;
#: SIGKILLing it mid-loop is the torn-write/staleness drill - the
#: atomic-rename shipping discipline must leave the aggregation dir
#: readable.
FLEET_SHIPPER_CHILD_TEMPLATE = ChildTemplate(_PRELUDE + """
import time
from transmogrifai_tpu_torch.obs import metrics_registry, ship_now, span
ticks = metrics_registry().counter("drill.ticks")
print("SHIPPER_READY", os.getpid(), flush=True)
deadline = time.monotonic() + {duration}
while time.monotonic() < deadline:
    with span("shipper.tick", pid=os.getpid()):
        ticks.inc()
    ship_now({agg_dir!r})
    time.sleep({interval})
os._exit(0)
""")


#: grandchild for the supervised-fleet e2e drill: the "deploy child" -
#: joins the trace via the env seam, records a span, ships its shard,
#: exits.  Spawned BY :data:`FLEET_DRILL_CHILD_TEMPLATE` through
#: ``obs.fleet.child_env()``, two process hops below the test.
FLEET_DEPLOY_CHILD_TEMPLATE = ChildTemplate(_PRELUDE + """
from transmogrifai_tpu_torch.obs import ship_now, span
with span("deploy.child", pid=os.getpid()):
    pass
ship_now({agg_dir!r})
os._exit(0)
""")


#: supervised child for the e2e fleet drill: the child adopts the
#: supervisor's exported trace context, beats the supervision
#: heartbeat, records spans, spawns the deploy grandchild (``grand`` is
#: the already-formatted FLEET_DEPLOY_CHILD source) with the context
#: re-exported, ships its own shard, then die-once exits ``first_exit``
#: on the run that creates ``marker`` and 0 after - so one supervise()
#: call produces spans from at least three pids (attempt 1, attempt 2,
#: grandchild) under ONE trace id.
FLEET_DRILL_CHILD_TEMPLATE = ChildTemplate(_PRELUDE + """
import subprocess
from transmogrifai_tpu_torch.obs import fleet, ship_now, span
from transmogrifai_tpu_torch.workflow.supervisor import beat
beat({heartbeat!r})
with span("child.work", pid=os.getpid()):
    rc = subprocess.run(
        [sys.executable, "-c", {grand!r}],
        env=fleet.child_env(), timeout=120,
    ).returncode
beat({heartbeat!r})
ship_now({agg_dir!r})
if rc != 0:
    sys.exit(99)
marker = {marker!r}
if not os.path.exists(marker):
    open(marker, "w").close()
    sys.exit({first_exit})
sys.exit(0)
""")


#: child for the exactly-once bulk-scoring kill drills (the bulk tests,
#: the chaos composition's bulk phase and the card's ``[bulk]`` step):
#: arms one ``bulk.*`` fault, builds the job's model, then runs a
#: BulkScoringJob that the armed fault must SIGKILL mid-flight -
#: ``os._exit(3)`` is unreachable when armed.  By default the model is
#: the tiny drill pipeline trained on ``device`` from seed 0 (the JAX
#: package's child); with ``model_dir`` set the child instead LOADS that
#: saved model into the workflow of the ``factory`` (``module:function``,
#: rebuilt on ``device``), so the resuming parent scores with
#: bit-identical weights whatever the host's thread count.
BULK_KILL_CHILD_TEMPLATE = ChildTemplate(_PRELUDE + """
from transmogrifai_tpu_torch.faults import injection
injection.configure({fault!r})
from transmogrifai_tpu_torch.bulk import BulkScoringJob
if {model_dir!r} is None:
    from transmogrifai_tpu_torch.testkit.drills import tiny_drill_pipeline
    wf, _data, _records, _pred = tiny_drill_pipeline(
        n={n}, seed=0, device={device!r})
    model = wf.train()
else:
    from transmogrifai_tpu_torch.fleet.worker import load_workflow_factory
    from transmogrifai_tpu_torch.workflow.workflow import OpWorkflowModel
    built = load_workflow_factory({factory!r})()
    wf = built[0] if isinstance(built, tuple) else built
    wf.device = {device!r}
    model = OpWorkflowModel.load({model_dir!r}, wf)
BulkScoringJob(model, {job_dir!r}, {shards!r}, chunk_rows={chunk}).run()
os._exit(3)  # unreachable: the armed fault must kill first
""", device="cpu", model_dir=None,
    factory="transmogrifai_tpu_torch.testkit.drills:tiny_drill_pipeline")
