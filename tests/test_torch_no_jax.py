"""The torch package stands alone: it imports no jax and nothing of the
JAX package, its entry points run on CUDA unless told otherwise, and its
kernel wrapper has no fallback path."""
import ast
import pathlib
import re
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
full = synthetic_passengers(300)
vec = transmogrify([FeatureBuilder.Text("description").as_predictor(),
                    FeatureBuilder.Date("boarded").as_predictor(),
                    FeatureBuilder.Real("age").as_predictor()], label=y)
checked = SanityChecker().set_input(y, vec).get_output()
pred = OpLogisticRegression(max_iter=3).set_input(y, checked).get_output()
model = tt.OpWorkflow(device="cpu").set_result_features(pred) \
    .set_input_dataset(full).train()
assert model.score(full)[vec.name].values.shape[1] > 512
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
import os, tempfile
import transmogrifai_tpu_torch.dsl
from transmogrifai_tpu_torch.examples.synthetic import write_readme_csv
from transmogrifai_tpu_torch.readers.csv_reader import CSVReader
from transmogrifai_tpu_torch.selector.factories import lr_grid
def readme_wf(reader):
    y = FeatureBuilder.RealNN("survived").as_response()
    age = FeatureBuilder.Real("age").as_predictor()
    vec = transmogrify([FeatureBuilder.PickList("sex").as_predictor(),
                        age.fill_missing_with_mean().z_normalize()])
    checked = y.sanity_check(vec, remove_bad_features=True)
    sel = BinaryClassificationModelSelector.with_cross_validation(
        num_folds=3, models_and_parameters=[
            (OpLogisticRegression(max_iter=3), lr_grid()[:2])])
    pred = sel.set_input(y, checked).get_output()
    return tt.OpWorkflow(device="cpu").set_result_features(pred) \
        .set_reader(reader)
with tempfile.TemporaryDirectory() as tmp:
    reader = CSVReader(write_readme_csv(os.path.join(tmp, "t.csv"), 300))
    model = readme_wf(reader).train()
    assert reader.route == "native", reader.route
    assert "Selected model OpLogisticRegression" in model.summary_pretty()
    model.save(os.path.join(tmp, "m"))
    loaded = tt.OpWorkflowModel.load(os.path.join(tmp, "m"),
                                     readme_wf(reader))
    rec = [{"sex": "male", "age": 30.0}, {"sex": None}]
    for backend in ("numpy", "torch"):
        scorer = loaded.score_function(fused_backend=backend)
        assert scorer.fused_backend == backend, scorer.fused_reason
        # the loaded model adopts the fresh workflow's uids: compare values
        got = [list(r.values()) for r in scorer.score_batch(rec)]
        want = model.score_function(fused_backend=backend).score_batch(rec)
        assert got == [list(r.values()) for r in want]
assert not any(k == "transmogrifai_tpu" or k.startswith("transmogrifai_tpu.")
               for k in sys.modules), "the JAX package was imported"
print("OK")
"""


def test_imports_and_trains_without_jax(subprocess_env):
    out = subprocess.run(
        [sys.executable, "-c", _CHILD], env=subprocess_env, cwd=str(ROOT),
        capture_output=True, text=True, timeout=240,
    )
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().endswith("OK")


_FLEET_CHILD = r"""
import sys
sys.modules["jax"] = None  # any import of jax now raises ImportError
import transmogrifai_tpu_torch.fleet as fleet
import transmogrifai_tpu_torch.fleet.worker as worker
from transmogrifai_tpu_torch.testkit import drills
assert not any(k == "transmogrifai_tpu" or k.startswith("transmogrifai_tpu.")
               for k in sys.modules), "the JAX package was imported"
assert worker.load_workflow_factory(
    "transmogrifai_tpu_torch.testkit.drills:continuous_tiny_factory"
) is drills.continuous_tiny_factory
wf, _data, records, _name = drills.tiny_drill_pipeline(device="cpu")
assert wf.device == "cpu" and drills.tiny_drill_pipeline()[0].device == "cuda"
model = wf.train()
chan = fleet.encode_results(model.score_function().score_batch(records[:4]))
assert len(fleet.decode_results(chan)) == 4
assert not any(k == "transmogrifai_tpu" or k.startswith("transmogrifai_tpu.")
               for k in sys.modules), "the JAX package was imported"
print("OK")
"""


def test_fleet_and_drills_import_without_jax(subprocess_env):
    """``fleet/`` and ``testkit/drills.py`` import, load a factory spec and
    serve a drill model with jax unimportable, and pull in nothing of the
    JAX package; the drills build on the card unless told otherwise."""
    out = subprocess.run(
        [sys.executable, "-c", _FLEET_CHILD], env=subprocess_env,
        cwd=str(ROOT), capture_output=True, text=True, timeout=240,
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
    sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py", ROOT / "kernel_ab.py"],
    ids=lambda p: str(p.relative_to(ROOT)),
)
def test_no_jax_or_reference_import(path):
    for name in _imported_modules(path):
        top = name.split(".")[0]
        assert top != "jax" and top != "jaxlib", f"{path} imports {name}"
        assert top != "transmogrifai_tpu", f"{path} imports {name}"


def _source_imports(src: str) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(src)):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module or "")
    return names


def _assert_port_only(src: str, where: str) -> None:
    """``src`` imports the port and neither jax nor the JAX package, and
    names no ``transmogrifai_tpu`` module even in a string."""
    imports = _source_imports(src)
    for name in imports:
        top = name.split(".")[0]
        assert top not in ("jax", "jaxlib", "transmogrifai_tpu"), \
            f"{where} imports {name}"
    assert not re.search(r"\btransmogrifai_tpu\b(?!_torch)", src), where
    assert "JAX_PLATFORMS" not in src, where


class _AnyKey(dict):
    """format_map values for a template's keys: a placeholder each."""

    def __missing__(self, key):
        return "1"


_TEMPLATES = sorted(
    n for n in dir(mod(PORT, "testkit.drills")) if n.endswith("_TEMPLATE"))


@pytest.mark.parametrize("name", _TEMPLATES)
def test_drill_templates_import_only_the_port(name):
    """Each child template imports ``transmogrifai_tpu_torch`` only (the
    ones that import the package at all), with jax made unimportable
    first."""
    tpl = getattr(mod(PORT, "testkit.drills"), name)
    src = str.format_map(tpl, _AnyKey(tpl.defaults))
    _assert_port_only(src, name)
    if any(n.startswith(PORT) for n in _source_imports(src)):
        assert 'sys.modules["jax"] = None' in src, name


def test_generated_project_imports_only_the_port(tmp_path):
    """``cli gen`` emits a project whose sources import the port only."""
    csv_path = tmp_path / "data.csv"
    csv_path.write_text("y,a,c\n" + "".join(
        f"{i % 2},{i * 0.5},{'uvw'[i % 3]}\n" for i in range(40)))
    out = tmp_path / "app"
    mod(PORT, "cli").generate(str(csv_path), "y", "App", str(out))
    sources = sorted(out.glob("*.py"))
    assert {p.name for p in sources} == {
        "main.py", "score.py", "serve.py", "test_smoke.py"}
    for p in sources:
        src = p.read_text()
        _assert_port_only(src, p.name)
        assert any(n.startswith(PORT) for n in _source_imports(src)) \
            or p.name == "test_smoke.py", p.name


@pytest.mark.parametrize(
    "rel", ["parallel/kernels.py", "models/trees.py", "models/tree_kernel.py",
            "ops/bucketizers.py"],
)
def test_kernel_paths_have_no_fallback(rel):
    """No try/except around a build, a launch or the binning that calls
    one, and no environment switch: a CUDA input launches the kernel or
    raises.  The one try allowed turns a library that cannot be loaded
    into a ``KernelError``: no ``else`` or ``finally``, and each handler's
    body is that one raise."""
    src = (PKG / rel).read_text()
    tree = ast.parse(src)
    for node in ast.walk(tree):
        if not isinstance(node, ast.Try):
            continue
        assert not node.orelse and not node.finalbody, ast.unparse(node)
        for h in node.handlers:
            assert len(h.body) == 1 and isinstance(h.body[0], ast.Raise), \
                ast.unparse(h)
            exc = h.body[0].exc
            assert (isinstance(exc, ast.Call)
                    and getattr(exc.func, "id", None) == "KernelError"), \
                ast.unparse(h)
    assert sum(isinstance(n, ast.Try) for n in ast.walk(tree)) <= (
        rel == "parallel/kernels.py")
    # the one environment read is where the CUDA toolkit lives
    assert all("CUDA_HOME" in line for line in src.splitlines()
               if "environ" in line)


def test_tree_stages_default_to_cuda():
    trees = mod(PORT, "models.trees")
    for cls in (trees.OpGBTClassifier, trees.OpGBTRegressor,
                trees.OpXGBoostClassifier, trees.OpDecisionTreeClassifier,
                trees.OpRandomForestRegressor,
                mod(PORT, "ops.bucketizers").DecisionTreeNumericBucketizer,
                mod(PORT, "ops.bucketizers").DecisionTreeNumericMapBucketizer):
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
