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
workflow it loads into.  The JAX package's child-script templates are
not ported yet (ROADMAP.md queue 1, L3).
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
