"""Style gates of the JAX package's tests/test_style.py that guard the
serving, workflow, serialization and registry code, applied to the torch
package ``transmogrifai_tpu_torch/``:

- every broad ``except Exception`` under serving/ and workflow/ must
  re-raise, use the bound exception, or record telemetry or a log entry:
  silent swallowing is how serving degradation hides (the JAX package's
  ``test_serving_and_workflow_broad_excepts_leave_a_trace``);
- model artifacts (model.json, arrays.npz, manifest.json, schema.json)
  and ``registry.json`` are written only via serialization/ and
  registry/: no ``np.save``/``np.savez*`` call and no write-mode
  ``open()`` of an artifact file anywhere else, so every published
  version rides the crash-consistent fsync + manifest + rename path (the
  JAX package's ``test_model_artifacts_written_only_via_serialization_
  and_registry``).
"""
import ast
import pathlib

ROOT = (pathlib.Path(__file__).resolve().parent.parent
        / "transmogrifai_tpu_torch")
MODULES = sorted(ROOT.rglob("*.py"))
assert MODULES, "transmogrifai_tpu_torch package not found"

_LOGGING_ATTRS = {"exception", "error", "warning", "info", "debug"}
_ARTIFACT_FILES = (
    "model.json", "arrays.npz", "manifest.json", "schema.json",
    "registry.json",
)
_ARTIFACT_WRITE_EXEMPT_DIRS = ("serialization", "registry")
_NP_SAVERS = {"save", "savez", "savez_compressed"}


def _rel(p: pathlib.Path) -> tuple:
    return p.relative_to(ROOT).parts


def _is_broad(handler: ast.ExceptHandler) -> bool:
    t = handler.type
    names = []
    if isinstance(t, ast.Name):
        names = [t.id]
    elif isinstance(t, ast.Tuple):
        names = [e.id for e in t.elts if isinstance(e, ast.Name)]
    return any(n in ("Exception", "BaseException") for n in names)


def _handler_is_accounted(handler: ast.ExceptHandler) -> bool:
    """The failure leaves a trace: the handler re-raises, uses the bound
    exception, or calls a record*/log method."""
    for node in ast.walk(handler):
        if isinstance(node, ast.Raise):
            return True
        if (handler.name is not None and isinstance(node, ast.Name)
                and node.id == handler.name):
            return True
        if isinstance(node, ast.Call) and isinstance(node.func,
                                                     ast.Attribute):
            attr = node.func.attr
            if attr.startswith("record") or attr in _LOGGING_ATTRS:
                return True
    return False


def _broad_handlers(dirs):
    for p in MODULES:
        if _rel(p)[0] not in dirs:
            continue
        for node in ast.walk(ast.parse(p.read_text(encoding="utf-8"))):
            if isinstance(node, ast.ExceptHandler) and _is_broad(node):
                yield p, node


def test_serving_and_workflow_broad_excepts_leave_a_trace():
    handlers = list(_broad_handlers(("serving", "workflow")))
    # the gate is not vacuous: the serving catch-alls are in its scan
    assert sum(_rel(p)[0] == "serving" for p, _ in handlers) >= 5
    offenders = [f"{p}:{h.lineno}" for p, h in handlers
                 if not _handler_is_accounted(h)]
    assert not offenders, offenders


def _call_writes_artifact(node: ast.Call) -> bool:
    """A write-mode ``open()`` whose path argument mentions an artifact
    filename literal."""
    if not (isinstance(node.func, ast.Name) and node.func.id == "open"):
        return False
    mode = ""
    if len(node.args) >= 2 and isinstance(node.args[1], ast.Constant):
        mode = str(node.args[1].value)
    for kw in node.keywords:
        if kw.arg == "mode" and isinstance(kw.value, ast.Constant):
            mode = str(kw.value.value)
    if not any(c in mode for c in "wax+"):
        return False
    for arg in node.args[:1]:
        for sub in ast.walk(arg):
            if isinstance(sub, ast.Constant) and isinstance(sub.value, str):
                if any(sub.value.endswith(n) for n in _ARTIFACT_FILES):
                    return True
    return False


def test_model_artifacts_written_only_via_serialization_and_registry():
    offenders = []
    for p in MODULES:
        if _rel(p)[0] in _ARTIFACT_WRITE_EXEMPT_DIRS:
            continue
        for node in ast.walk(ast.parse(p.read_text(encoding="utf-8"))):
            if not isinstance(node, ast.Call):
                continue
            f = node.func
            if (isinstance(f, ast.Attribute) and f.attr in _NP_SAVERS
                    and isinstance(f.value, ast.Name)
                    and f.value.id in ("np", "numpy")):
                offenders.append(f"{p}:{node.lineno} np.{f.attr}")
            elif _call_writes_artifact(node):
                offenders.append(f"{p}:{node.lineno} open(<artifact>, 'w')")
    assert not offenders, offenders


def test_the_artifact_gate_catches_a_raw_write():
    """The gate's own check: a write-mode open of registry.json and an
    np.savez are caught; a read-mode open is not."""
    tree = ast.parse(
        "open(os.path.join(d, 'registry.json'), 'w')\n"
        "open(os.path.join(d, 'registry.json'), 'rb')\n"
        "np.savez(path, a=a)\n")
    calls = [n for n in ast.walk(tree) if isinstance(n, ast.Call)
             and isinstance(n.func, ast.Name) and n.func.id == "open"]
    assert [_call_writes_artifact(c) for c in calls] == [True, False]
    handler = ast.parse(
        "try:\n    f()\nexcept Exception:\n    pass\n").body[0].handlers[0]
    assert _is_broad(handler) and not _handler_is_accounted(handler)
