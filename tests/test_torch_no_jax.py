"""The torch package stands alone: it imports no jax and nothing of the
JAX package, its entry points run on CUDA unless told otherwise, and its
kernel wrapper has no fallback path."""
import ast
import pathlib
import subprocess
import sys

import pytest
import torch

from torch_parity import PORT, mod, passenger_slice, passengers, reset_uids, workflow

ROOT = pathlib.Path(__file__).resolve().parent.parent
PKG = ROOT / PORT

_CHILD = r"""
import importlib, pkgutil, sys
sys.modules["jax"] = None  # any import of jax now raises ImportError
import transmogrifai_tpu_torch as tt
for m in pkgutil.walk_packages(tt.__path__, "transmogrifai_tpu_torch."):
    importlib.import_module(m.name)
assert not any(k == "transmogrifai_tpu" or k.startswith("transmogrifai_tpu.")
               for k in sys.modules), "the JAX package was imported"
from transmogrifai_tpu_torch.examples.synthetic import synthetic_passengers
from transmogrifai_tpu_torch.features.feature_builder import FeatureBuilder
from transmogrifai_tpu_torch.models.logistic_regression import OpLogisticRegression
from transmogrifai_tpu_torch.ops.transmogrifier import transmogrify
from transmogrifai_tpu_torch.preparators.sanity_checker import SanityChecker
y = FeatureBuilder.RealNN("survived").as_response()
vec = transmogrify([FeatureBuilder.Real("age").as_predictor(),
                    FeatureBuilder.PickList("gender").as_predictor()])
checked = SanityChecker().set_input(y, vec).get_output()
pred = OpLogisticRegression(max_iter=3).set_input(y, checked).get_output()
data = synthetic_passengers(300, with_text=False)
model = tt.OpWorkflow(device="cpu").set_result_features(pred) \
    .set_input_dataset(data).train()
assert len(model.score(data)[pred.name].prediction) == 300
from transmogrifai_tpu_torch.models.trees import OpGBTClassifier
vec = transmogrify([FeatureBuilder.Real("height").as_predictor()], label=y)
pred = OpGBTClassifier(num_trees=2).set_input(y, vec).get_output()
model = tt.OpWorkflow(device="cpu").set_result_features(pred) \
    .set_input_dataset(data).train()
assert len(model.score(data)[pred.name].prediction) == 300
from transmogrifai_tpu_torch.selector.factories import (
    BinaryClassificationModelSelector, rf_grid)
from transmogrifai_tpu_torch.models.trees import OpRandomForestClassifier
from transmogrifai_tpu_torch.models.linear_svc import OpLinearSVC
sel = BinaryClassificationModelSelector.with_cross_validation(
    models_and_parameters=[
        (OpRandomForestClassifier(num_trees=2), rf_grid()[:2]),
        (OpLinearSVC(max_iter=3), [{"reg_param": 0.1}])])
pred = sel.set_input(y, vec).get_output()
model = tt.OpWorkflow(device="cpu").set_result_features(pred) \
    .set_input_dataset(data).train()
assert len(model.score(data)[pred.name].prediction) == 300
print("OK")
"""


def test_imports_and_trains_without_jax(subprocess_env):
    out = subprocess.run(
        [sys.executable, "-c", _CHILD], env=subprocess_env, cwd=str(ROOT),
        capture_output=True, text=True, timeout=240,
    )
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().endswith("OK")


def _imported_modules(path: pathlib.Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module or "")
    return names


@pytest.mark.parametrize(
    "path",
    sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"],
    ids=lambda p: str(p.relative_to(ROOT)),
)
def test_no_jax_or_reference_import(path):
    for name in _imported_modules(path):
        top = name.split(".")[0]
        assert top != "jax" and top != "jaxlib", f"{path} imports {name}"
        assert top != "transmogrifai_tpu", f"{path} imports {name}"


@pytest.mark.parametrize(
    "rel", ["parallel/kernels.py", "models/trees.py", "models/tree_kernel.py",
            "ops/bucketizers.py"],
)
def test_kernel_paths_have_no_fallback(rel):
    """No try/except around a build, a launch or the binning that calls
    one, and no environment switch: a CUDA input launches the kernel or
    raises."""
    src = (PKG / rel).read_text()
    tree = ast.parse(src)
    assert not [n for n in ast.walk(tree) if isinstance(n, ast.Try)]
    # the one environment read is where the CUDA toolkit lives
    assert all("CUDA_HOME" in line for line in src.splitlines()
               if "environ" in line)


def test_tree_stages_default_to_cuda():
    trees = mod(PORT, "models.trees")
    for cls in (trees.OpGBTClassifier, trees.OpGBTRegressor,
                trees.OpXGBoostClassifier, trees.OpDecisionTreeClassifier,
                trees.OpRandomForestRegressor,
                mod(PORT, "ops.bucketizers").DecisionTreeNumericBucketizer):
        assert cls().device == "cuda"
    if not torch.cuda.is_available():
        import numpy as np

        with pytest.raises(RuntimeError, match="CUDA is not available"):
            trees.OpGBTClassifier().fit_arrays(np.ones((4, 2)), np.eye(2)[[0, 1, 0, 1], 0])


@pytest.mark.parametrize("path,cls", [
    ("models.trees", "OpRandomForestClassifier"),
    ("models.linear_svc", "OpLinearSVC"),
    ("models.naive_bayes", "OpNaiveBayes"),
])
def test_default_selector_families_default_to_cuda(path, cls):
    """Each family the parameterless selector (and naive Bayes) builds runs
    on the card unless told otherwise, and its fits and folds raise
    without one."""
    import numpy as np

    est = getattr(mod(PORT, path), cls)()
    assert est.device == "cuda"
    if not torch.cuda.is_available():
        X, y = np.ones((4, 2)), np.array([0.0, 1.0, 0.0, 1.0])
        for call in (lambda: est.fit_arrays(X, y),
                     lambda: est.fit_arrays_folds(X, y, np.ones((2, 4)))
                     if hasattr(est, "fit_arrays_folds")
                     else est.fit_arrays_batched(X, y, np.ones((2, 4)),
                                                 np.zeros(2), np.zeros(2))):
            with pytest.raises(RuntimeError, match="CUDA is not available"):
                call()


def test_default_device_is_cuda():
    reset_uids(PORT)
    _, _, pred = passenger_slice(PORT)
    wf = mod(PORT, "workflow.workflow").OpWorkflow()
    assert wf.device == "cuda"
    wf.set_result_features(pred).set_input_dataset(passengers(PORT, 50))
    for st in (pred.origin_stage, pred.origin_stage.input_features[1].origin_stage):
        st_default = type(st)()
        assert st_default.device == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            wf.train()


def test_workflow_device_reaches_every_device_stage():
    reset_uids(PORT)
    _, _, pred = passenger_slice(PORT)  # stages built with device="cpu"
    lr_stage = pred.origin_stage
    checker = lr_stage.input_features[1].origin_stage
    lr_stage.device = checker.device = "cuda"  # the workflow's overrides
    workflow(PORT, pred, passengers(PORT, 200)).train()
    assert lr_stage.device == checker.device == "cpu"
