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

The fleet (``fleet/``, its autoscaler included) and the bulk job
(``bulk/``) are held to the same broad-except rule, to the JAX package's
bounded-wait gate (``test_no_unbounded_blocking_waits_under_parallel_
and_workflow``: every ``.join()``/``.wait()``/``.get()``/``.recv()``
passes a timeout) and to the device-fault rule of the training
operations.
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


def test_fleet_broad_excepts_leave_a_trace():
    """Every broad ``except`` under fleet/ and bulk/ re-raises, uses the
    bound exception, or records telemetry or a log entry: a replica,
    router, controller, autoscaler or bulk failure is never swallowed
    silently."""
    handlers = list(_broad_handlers(("fleet", "bulk")))
    # router, worker and controller loops, and the autoscaler's four
    assert len(handlers) >= 14
    offenders = [f"{p}:{h.lineno}" for p, h in handlers
                 if not _handler_is_accounted(h)]
    assert not offenders, offenders


#: the blocking calls that must carry a timeout under fleet/
_BLOCKING_METHODS = {"join", "wait", "get", "recv"}


def _unbounded_waits(tree) -> list:
    """Line numbers of zero-argument ``.join()``/``.wait()``/``.get()``/
    ``.recv()`` calls: the unbounded forms (``d.get(k)``, ``"sep".join(
    xs)`` and ``q.get(timeout=...)`` carry arguments and pass)."""
    return [node.lineno for node in ast.walk(tree)
            if isinstance(node, ast.Call)
            and isinstance(node.func, ast.Attribute)
            and node.func.attr in _BLOCKING_METHODS
            and not node.args and not node.keywords]


def test_no_unbounded_blocking_waits_under_fleet():
    """Under fleet/ and bulk/ every blocking wait passes a timeout: a
    SIGKILLed replica or a wedged router peer must never block dispatch,
    failover, worker shutdown, the autoscaler's loop or a bulk job's
    fleet window forever (every fleet wait runs in 50 ms quanta)."""
    files = sorted((ROOT / "fleet").rglob("*.py")) \
        + sorted((ROOT / "bulk").rglob("*.py"))
    assert len(files) == 10
    offenders, seen = [], 0
    for p in files:
        tree = ast.parse(p.read_text(encoding="utf-8"))
        seen += sum(isinstance(n, ast.Call)
                    and isinstance(n.func, ast.Attribute)
                    and n.func.attr in _BLOCKING_METHODS
                    for n in ast.walk(tree))
        offenders += [f"{p}:{n}" for n in _unbounded_waits(tree)]
    # the gate is not vacuous: the fleet core's calls, the autoscaler's
    # 21 and the bulk job's 30
    assert seen >= 71
    assert not offenders, offenders
    # the gate's own check: a bare wait is caught, a bounded one is not
    assert _unbounded_waits(ast.parse(
        "ev.wait()\nev.wait(0.05)\nt.join(timeout=1)\nchan.recv()\n"
        "d.get(k)\n")) == [1, 4]


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


# -- the training operations layer ---------------------------------------------------

def test_pipeline_queue_waits_are_bounded():
    """Under readers/pipeline.py every queue ``.put()`` carries an explicit
    ``timeout=`` and every zero-argument ``.get()``/``.join()`` is
    forbidden (the JAX package's ``test_pipeline_queue_waits_are_
    bounded``): a full prefetch buffer with a dead consumer, or a wedged
    worker at join time, must never block ingest - or a card run - past
    its time limit.  ``"sep".join(xs)`` and ``d.get(k)`` carry arguments
    and pass; ``q.put(item)`` does not (it still blocks unboundedly)."""
    p = ROOT / "readers" / "pipeline.py"
    tree = ast.parse(p.read_text(encoding="utf-8"))
    offenders, seen = [], 0
    for node in ast.walk(tree):
        if not (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr in ("put", "get", "join")):
            continue
        seen += 1
        has_timeout = any(kw.arg == "timeout" for kw in node.keywords)
        ok = has_timeout if node.func.attr == "put" else (
            has_timeout or bool(node.args))
        if not ok:
            offenders.append(f"{p}:{node.lineno} .{node.func.attr}()")
    assert seen >= 5  # the gate is not vacuous
    assert not offenders, offenders


def test_autotune_reads_telemetry_via_public_apis_only():
    """autotune/ reads observations only through public obs-plane APIs
    (registry, profiler and tracer snapshots, span exports): no
    single-underscore attribute of a foreign object is touched anywhere
    in the package; ``self._x``/``cls._x`` own state is the exception
    (the JAX package's ``test_autotune_reads_telemetry_via_public_apis_
    only``)."""
    files = sorted((ROOT / "autotune").rglob("*.py"))
    assert len(files) == 4
    offenders = []
    for p in files:
        for node in ast.walk(ast.parse(p.read_text(encoding="utf-8"))):
            if not isinstance(node, ast.Attribute):
                continue
            if not node.attr.startswith("_") or node.attr.startswith("__"):
                continue
            if isinstance(node.value, ast.Name) and node.value.id in (
                    "self", "cls"):
                continue
            offenders.append(f"{p}:{node.lineno} .{node.attr}")
    assert not offenders, offenders


#: the only functions of obs/fleet.py allowed to parse foreign JSON
_FLEET_LOADER_FUNCS = {"read_json_torn_safe", "read_jsonl_tolerant"}


def _json_parses_outside(tree, allowed) -> list:
    found = []

    def walk(node, func_name):
        for child in ast.iter_child_nodes(node):
            name = func_name
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                name = child.name
            if (isinstance(child, ast.Call)
                    and isinstance(child.func, ast.Attribute)
                    and child.func.attr in ("load", "loads")
                    and isinstance(child.func.value, ast.Name)
                    and child.func.value.id == "json"
                    and func_name not in allowed):
                found.append(child.lineno)
            walk(child, name)

    walk(tree, "<module>")
    return found


def test_fleet_reads_snapshots_only_via_torn_safe_loader():
    """obs/fleet.py calls ``json.load``/``json.loads`` only inside the
    torn-read-safe loaders (the JAX package's ``test_fleet_reads_
    snapshots_only_via_torn_safe_loader``): shard files are written by
    other processes that can be killed mid-write, so a direct parse
    elsewhere would let one dying process crash the whole scrape."""
    p = ROOT / "obs" / "fleet.py"
    offenders = _json_parses_outside(
        ast.parse(p.read_text(encoding="utf-8")), _FLEET_LOADER_FUNCS)
    assert not offenders, [f"{p}:{n}" for n in offenders]
    # the gate's own check: a parse outside the loaders is caught
    assert _json_parses_outside(ast.parse(
        "def read_json_torn_safe(p):\n    return json.loads(p)\n"
        "def other(p):\n    return json.load(p)\n"),
        _FLEET_LOADER_FUNCS) == [4]


#: the training-operations modules whose catch-alls must pass a device
#: fault through (``parallel.kernels.is_device_fault``)
_DEVICE_FAULT_SCOPE = (("autotune",), ("bulk",), ("continuous",),
                       ("fleet",), ("readers", "pipeline.py"),
                       ("selector", "validator.py"))


def test_training_ops_catch_alls_pass_device_faults_through():
    """Every broad ``except`` of the autotuner, the bulk job, the
    continuous trainer, the fleet (its autoscaler included), the sharded
    pipeline and the validator either re-raises
    unconditionally or consults ``is_device_fault``: a device fault is
    never scored as a failed rung, a losing probe, a failed refit, a
    degraded fused dispatch or a per-request replica error."""
    offenders, seen = [], 0
    for p in MODULES:
        rel = _rel(p)
        if not any(rel[:len(s)] == s for s in _DEVICE_FAULT_SCOPE):
            continue
        for node in ast.walk(ast.parse(p.read_text(encoding="utf-8"))):
            if not (isinstance(node, ast.ExceptHandler) and _is_broad(node)):
                continue
            seen += 1
            names = {n.id for n in ast.walk(node) if isinstance(n, ast.Name)}
            bare_raise = any(isinstance(n, ast.Raise) and n.exc is None
                             for n in node.body)
            if "is_device_fault" not in names and not bare_raise:
                offenders.append(f"{p}:{node.lineno}")
    # rung, fused dispatch, probe, pipeline worker, the fleet's channel,
    # router, worker and controller, and the autoscaler's four
    assert seen >= 24
    assert not offenders, offenders
