"""Workflow model persistence.

Counterpart of ``transmogrifai_tpu/serialization/model_io.py`` and of
OpWorkflowModelWriter / OpWorkflowModelReader (reference:
core/.../OpWorkflowModelWriter.scala:52-140, OpWorkflowModelReader.scala):
the whole fitted workflow saves as one JSON document (stage classes, params,
metadata, result-feature names) plus an .npz of every array-valued piece of
fitted state.  Loading mirrors the reference's contract: the model is
restored INTO the same code-defined workflow (OpWorkflow.loadModel,
OpWorkflow.scala:468) - stages are re-paired with the freshly built DAG in
deterministic order, so feature wiring never needs serializing.

Persistence is crash-consistent (the user-level-checkpointing recovery
primitive, TensorFlow §4.2): the artifact writes into a temp directory,
every file is fsynced, a ``manifest.json`` records per-file SHA-256 +
sizes, and the finished directory swaps into place by rename - the
previous artifact survives as ``<path>.last-good``.  A crash at ANY
instant therefore leaves a loadable artifact: either the old one (crash
before the swap) or the new one (crash after), and ``load_model``
verifies checksums before trusting anything, falling back to the
last-good copy when the primary is truncated, bit-flipped, or missing.
Injection points ``io.save_model.crash`` / ``io.save_model.crash_window``
(faults/injection.py) drill both crash windows.

Fitted state that is a torch tensor is written as numpy and comes back as
a tensor on the target workflow's device; every estimator a loaded model
scores with takes ``workflow.device``.  The JAX package's serialized XLA
executables (``xla_cache.*``) have no torch twin: this package writes no
executable cache and reads none.
"""
from __future__ import annotations

import glob
import hashlib
import importlib
import json
import logging
import os
import shutil
import zipfile
import zlib
from typing import Any, Optional

import numpy as np

import torch

from ..faults import injection as _faults

log = logging.getLogger("transmogrifai_tpu_torch.serialization")

MODEL_JSON = "model.json"
ARRAYS_NPZ = "arrays.npz"
MANIFEST_JSON = "manifest.json"
SCHEMA_JSON = "schema.json"
LAST_GOOD_SUFFIX = ".last-good"


class ModelLoadError(RuntimeError):
    """A model artifact cannot be restored; the message names the
    artifact file and (where applicable) the stage path inside it."""


class ModelIntegrityError(ModelLoadError):
    """Checksum/manifest verification failed and no last-good artifact
    could recover the load (truncation, bit-flips, missing files)."""


class _ArrayStore:
    """arrays.npz accessor that turns a missing/mismatched key into a
    ModelLoadError naming the stage path and the artifact file instead
    of a raw KeyError deep inside ``_decode``."""

    def __init__(self, npz, artifact: str) -> None:
        self._npz = npz
        self._artifact = artifact

    def __getitem__(self, key: str):
        try:
            return self._npz[key]
        except KeyError:
            raise ModelLoadError(
                f"model artifact {self._artifact} has no array for stage "
                f"path '{key}': {os.path.basename(self._artifact)} is "
                "truncated or belongs to a different model.json"
            ) from None
        except (zipfile.BadZipFile, zlib.error, OSError, ValueError) as e:
            # npz members decompress lazily: a corrupt legacy (manifest-
            # less) artifact surfaces HERE, not at np.load - still a
            # ModelLoadError, never a raw zlib traceback
            raise ModelLoadError(
                f"model artifact {self._artifact} is corrupt at stage "
                f"path '{key}': {type(e).__name__}: {e}"
            ) from e


def _encode(value: Any, arrays: dict[str, np.ndarray], path: str) -> Any:
    if isinstance(value, np.ndarray):
        arrays[path] = value
        return {"__npz__": path}
    if isinstance(value, torch.Tensor):
        # written as numpy; _decode puts it back on the load's device
        arrays[path] = value.detach().cpu().numpy()
        return {"__npz__": path, "__tensor__": True}
    if isinstance(value, (np.floating, np.integer)):
        return value.item()
    if isinstance(value, dict):
        return {
            "__dict__": {
                k: _encode(v, arrays, f"{path}.{k}") for k, v in value.items()
            }
        }
    if isinstance(value, (list, tuple)):
        enc = [_encode(v, arrays, f"{path}[{i}]") for i, v in enumerate(value)]
        return {"__list__": enc, "__tuple__": isinstance(value, tuple)}
    if isinstance(value, (set, frozenset)):
        try:
            items = sorted(value)
        except TypeError:
            items = list(value)
        enc = [_encode(v, arrays, f"{path}{{{i}}}") for i, v in enumerate(items)]
        return {"__set__": enc, "__frozen__": isinstance(value, frozenset)}
    if value is None or isinstance(value, (bool, int, float, str)):
        return value
    raise TypeError(
        f"cannot serialize {type(value).__name__} at {path}; stages must keep "
        "fitted state as arrays/scalars/dicts/lists"
    )


def _decode(value: Any, arrays, device: Optional[str] = None) -> Any:
    """Inverse of :func:`_encode`; a saved tensor comes back as a tensor
    on ``device`` (the CPU when None)."""
    if isinstance(value, dict):
        if "__npz__" in value:
            arr = arrays[value["__npz__"]]
            if value.get("__tensor__"):
                return torch.tensor(np.asarray(arr), device=device or "cpu")
            return arr
        if "__dict__" in value:
            return {k: _decode(v, arrays, device)
                    for k, v in value["__dict__"].items()}
        if "__list__" in value:
            items = [_decode(v, arrays, device) for v in value["__list__"]]
            return tuple(items) if value.get("__tuple__") else items
        if "__set__" in value:
            items = [_decode(v, arrays, device) for v in value["__set__"]]
            return frozenset(items) if value.get("__frozen__") else set(items)
    return value


# attributes owned by the stage machinery, not fitted state
_SKIP_ATTRS = {
    "input_features", "_output", "uid", "operation_name", "params",
    "metadata", "estimator_ref", "selector", "validator", "models",
    "splitter", "evaluators", "validation_result", "fn", "predicate",
    "model", "output_type", "input_types", "prefer_numpy",
    # per-process transform memoizations (vectorizer_base/combiner/
    # sanity_checker): identity-keyed, must never persist
    "_meta_cache", "_combine_cache", "_select_cache",
    "_metas_memo", "_pivot_helpers",
}


def stage_state(stage) -> dict[str, Any]:
    out = {}
    for k, v in vars(stage).items():
        if k in _SKIP_ATTRS:
            continue
        out[k] = v
    return out


def _write_fsync(path: str, data: bytes) -> None:
    """Write + flush + fsync: the bytes are durable before any rename
    can publish a directory that references them."""
    with open(path, "wb") as f:
        f.write(data)
        f.flush()
        os.fsync(f.fileno())


def write_bytes_atomic(path: str, data: bytes) -> None:
    """Crash-consistent single-file byte write: fsync'd temp file in the
    target directory, atomic ``os.replace``, directory fsync.  The
    sidecar files that ride next to a model artifact reuse this instead
    of re-inventing the discipline; a reader never observes a torn file,
    only the old bytes or the new ones."""
    parent = os.path.dirname(path) or "."
    os.makedirs(parent, exist_ok=True)
    tmp = f"{path}.tmp-{os.getpid()}"
    _write_fsync(tmp, data)
    os.replace(tmp, path)
    _fsync_dir(parent)


def _fsync_dir(path: str) -> None:
    """fsync a directory so renames within it are durable (best-effort:
    some filesystems refuse directory fds)."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        log.debug("directory fsync unsupported for %s", path)
    finally:
        os.close(fd)


def _sha256(data: bytes) -> str:
    return hashlib.sha256(data).hexdigest()


def _writer_alive(tmp_dir: str) -> bool:
    """True when the pid encoded in a ``<path>.tmp-<pid>`` save tempdir
    still belongs to a live process on THIS host (liveness is the reap
    guard; unparseable names count as live = never reaped)."""
    suffix = tmp_dir.rpartition(".tmp-")[2]
    try:
        pid = int(suffix)
    except ValueError:
        return True
    if pid == os.getpid():
        return False  # our own leftover from a failed earlier save
    try:
        os.kill(pid, 0)
        return True
    except ProcessLookupError:
        return False
    except OSError:
        return True  # EPERM etc: the pid exists, leave it alone


_HASH_CHUNK = 1 << 20


def _sha256_file(path: str) -> tuple[str, int]:
    """Chunked (bounded-memory) file hash -> (hexdigest, byte size)."""
    h = hashlib.sha256()
    size = 0
    with open(path, "rb") as f:
        while True:
            chunk = f.read(_HASH_CHUNK)
            if not chunk:
                break
            h.update(chunk)
            size += len(chunk)
    return h.hexdigest(), size


def save_model(model, path: str) -> None:
    """Crash-consistent save: tempdir write -> fsync -> manifest ->
    atomic rename swap (the previous artifact survives as
    ``<path>.last-good``)."""
    path = os.path.abspath(path).rstrip(os.sep)
    arrays: dict[str, np.ndarray] = {}
    stages_doc = []
    for i, stage in enumerate(model.stages):
        cls = type(stage)
        doc: dict[str, Any] = {
            "index": i,
            "class": f"{cls.__module__}.{cls.__qualname__}",
            "uid": stage.uid,
            "operation_name": stage.operation_name,
            "output_name": stage.output_name,
            "params": _encode(stage.params, arrays, f"s{i}.params"),
            "metadata": _encode(stage.metadata, arrays, f"s{i}.metadata"),
            "state": _encode(stage_state(stage), arrays, f"s{i}.state"),
        }
        if hasattr(stage, "estimator_ref"):
            est = stage.estimator_ref
            doc["estimator"] = {
                "class": f"{type(est).__module__}.{type(est).__qualname__}",
                "params": _encode(est.params, arrays, f"s{i}.est_params"),
            }
        stages_doc.append(doc)
    doc = {
        "format_version": 1,
        "result_features": [f.name for f in model.result_features],
        "raw_features": [
            {"name": f.name, "type": f.ftype.__name__, "is_response": f.is_response}
            for f in model.raw_features
        ],
        # the RAW blacklist re-derives the whole DAG surgery at load
        # (cascaded drops are a deterministic function of it); without it
        # a fresh workflow still carries the pre-surgery stage count and
        # load cannot pair stages (reference: OpWorkflowModelWriter saves
        # blacklistedFeatures, reader reapplies setBlacklist)
        "blacklisted_raw": [
            f.name for f in getattr(model, "blacklisted_features", ())
            if f.is_raw()
        ],
        "parameters": _encode(model.parameters, arrays, "wf.params"),
        "train_time_s": model.train_time_s,
        "stages": stages_doc,
    }
    json_bytes = json.dumps(doc, indent=1, default=str).encode("utf-8")
    # the schema contract (schema/contract.py) rides INSIDE the same
    # crash-consistent artifact: serve-time drift enforcement must load
    # the exact data shape this model trained on, checksummed and
    # last-good-recoverable like every other artifact file
    contract = getattr(model, "schema_contract", None)
    schema_bytes = None
    if contract is not None:
        schema_bytes = json.dumps(
            contract.to_json(), indent=1, default=str
        ).encode("utf-8")

    parent = os.path.dirname(path) or "."
    os.makedirs(parent, exist_ok=True)
    # reap tempdirs leaked by CRASHED saves: each holds a full artifact
    # copy.  Only dead writers' dirs are removed - a concurrent save by
    # a live process (retried fleet jobs sharing a path) must not have
    # its tempdir clobbered mid-write
    for stale in glob.glob(glob.escape(path) + ".tmp-*"):
        if os.path.isdir(stale) and not _writer_alive(stale):
            shutil.rmtree(stale, ignore_errors=True)
    tmp = f"{path}.tmp-{os.getpid()}"
    if os.path.isdir(tmp):  # same-pid leftover (pid reuse / prior error)
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    _write_fsync(os.path.join(tmp, MODEL_JSON), json_bytes)
    # crash drill: death here must leave the PREVIOUS artifact untouched
    # (the half-written tempdir is invisible to load_model)
    _faults.inject_kill("io.save_model.crash")
    npz_tmp = os.path.join(tmp, ARRAYS_NPZ)
    # stream the npz straight to disk (no whole-archive BytesIO), then
    # fsync it and checksum it back in bounded-memory chunks
    np.savez_compressed(npz_tmp, **arrays)
    with open(npz_tmp, "rb") as f:
        os.fsync(f.fileno())
    npz_sha, npz_size = _sha256_file(npz_tmp)
    manifest = {
        "format_version": 1,
        "files": {
            MODEL_JSON: {"sha256": _sha256(json_bytes),
                         "bytes": len(json_bytes)},
            ARRAYS_NPZ: {"sha256": npz_sha, "bytes": npz_size},
        },
    }
    if schema_bytes is not None:
        _write_fsync(os.path.join(tmp, SCHEMA_JSON), schema_bytes)
        manifest["files"][SCHEMA_JSON] = {
            "sha256": _sha256(schema_bytes), "bytes": len(schema_bytes),
        }
    _write_fsync(
        os.path.join(tmp, MANIFEST_JSON),
        json.dumps(manifest, indent=1, sort_keys=True).encode("utf-8"),
    )
    _fsync_dir(tmp)

    last_good = path + LAST_GOOD_SUFFIX
    try:
        if os.path.isdir(path):
            if os.path.isdir(last_good):
                shutil.rmtree(last_good)
            os.rename(path, last_good)
        # crash drill: death between the two renames leaves NO primary
        # artifact - load_model must recover from <path>.last-good
        _faults.inject_kill("io.save_model.crash_window")
        os.rename(tmp, path)
    except OSError as e:
        # rename(2) refuses to move a mount point (EBUSY) - e.g. a k8s/
        # docker volume mounted directly at the artifact path.  Publish
        # by copy instead: payload files first, manifest LAST, each via
        # a file-level atomic replace - a crash mid-publish leaves a
        # manifest that mismatches the new payload, which verification
        # detects and recovers from last-good
        _publish_by_copy(tmp, path, last_good, reason=str(e))
    else:
        # the swap moved the WHOLE old directory aside; co-located
        # non-artifact files (the runner's summary.json, user-kept eval
        # reports) must survive the re-save, not vanish into last-good
        _carry_extras(last_good, path)
    _fsync_dir(parent)


_ARTIFACT_FILES = frozenset(
    (MODEL_JSON, ARRAYS_NPZ, MANIFEST_JSON, SCHEMA_JSON)
)

#: artifact files that are OPTIONAL per model: absent from the new save,
#: a stale copy from the replaced artifact must not survive a
#: publish-by-copy to masquerade as this model's
_OPTIONAL_ARTIFACT_FILES = (SCHEMA_JSON,)


def _carry_extras(old_dir: str, new_dir: str) -> None:
    """Copy non-artifact entries the previous save directory carried
    into the freshly published one (best-effort: extras must never fail
    a completed save)."""
    if not os.path.isdir(old_dir):
        return
    for name in os.listdir(old_dir):
        if name in _ARTIFACT_FILES:
            continue
        src = os.path.join(old_dir, name)
        dst = os.path.join(new_dir, name)
        if os.path.exists(dst):
            continue
        try:
            if os.path.isdir(src):
                shutil.copytree(src, dst)
            else:
                shutil.copy2(src, dst)
        except OSError as e:
            log.warning("could not carry %s into the new artifact: %s",
                        src, e)


def _publish_by_copy(tmp: str, path: str, last_good: str,
                     reason: str) -> None:
    log.warning(
        "atomic artifact swap unavailable for %s (%s); publishing by "
        "file copy - still crash-detectable via the manifest", path, reason,
    )
    if os.path.isdir(path) and verify_artifact(path) is None:
        if os.path.isdir(last_good):
            shutil.rmtree(last_good)
        try:
            shutil.copytree(path, last_good)
        except OSError:
            log.warning("could not snapshot %s to %s; continuing without "
                        "a last-good copy", path, last_good)
    os.makedirs(path, exist_ok=True)
    # payload before manifest: until the manifest flips, verification
    # sees old-manifest-vs-new-payload and rejects the half-published dir
    for name in (MODEL_JSON, ARRAYS_NPZ, SCHEMA_JSON, MANIFEST_JSON):
        src = os.path.join(tmp, name)
        if name in _OPTIONAL_ARTIFACT_FILES and not os.path.exists(src):
            # contract-less model: a STALE optional file
            # from the replaced artifact must not survive to masquerade
            # as this model's
            stale = os.path.join(path, name)
            if os.path.exists(stale):
                os.remove(stale)
            continue
        part = os.path.join(path, name + ".part")
        with open(src, "rb") as fsrc, open(part, "wb") as fdst:
            shutil.copyfileobj(fsrc, fdst, _HASH_CHUNK)
            fdst.flush()
            os.fsync(fdst.fileno())
        os.replace(part, os.path.join(path, name))
    _fsync_dir(path)
    shutil.rmtree(tmp, ignore_errors=True)


def verify_artifact(path: str) -> Optional[str]:
    """Checksum-verify a saved artifact against its manifest; returns
    None when intact, else a human-readable description of the damage.
    A manifest-less directory with both payload files is accepted as a
    legacy (pre-manifest) artifact."""
    if not os.path.isdir(path):
        return f"artifact directory {path} missing"
    manifest_path = os.path.join(path, MANIFEST_JSON)
    if not os.path.exists(manifest_path):
        missing = [
            f for f in (MODEL_JSON, ARRAYS_NPZ)
            if not os.path.exists(os.path.join(path, f))
        ]
        if missing:
            return f"artifact {path} incomplete: missing {missing}"
        log.warning(
            "model artifact %s has no %s (legacy save): loading without "
            "checksum verification", path, MANIFEST_JSON,
        )
        return None
    try:
        with open(manifest_path, "rb") as f:
            manifest = json.loads(f.read().decode("utf-8"))
        files = manifest["files"]
    except (OSError, ValueError, KeyError, UnicodeDecodeError) as e:
        return f"manifest {manifest_path} unreadable: {e}"
    for name, meta in files.items():
        fpath = os.path.join(path, name)
        try:
            sha, size = _sha256_file(fpath)
        except OSError as e:
            return f"artifact file {fpath} unreadable: {e}"
        if size != meta.get("bytes"):
            return (
                f"artifact file {fpath} truncated: {size} bytes, "
                f"manifest records {meta.get('bytes')}"
            )
        if sha != meta.get("sha256"):
            return (
                f"artifact file {fpath} failed its SHA-256 checksum "
                "(bit-flip or partial overwrite)"
            )
    return None


def resolve_artifact(path: str) -> str:
    """Return a checksum-verified artifact directory for ``path``:
    the primary when intact, else the ``.last-good`` predecessor (a
    crash mid-save, see save_model).  Raises ModelIntegrityError when
    neither verifies."""
    path = os.path.abspath(path).rstrip(os.sep)
    err = verify_artifact(path)
    if err is None:
        return path
    last_good = path + LAST_GOOD_SUFFIX
    lg_err = verify_artifact(last_good)
    if lg_err is None:
        log.warning(
            "model artifact failed verification (%s); recovering from "
            "last-good artifact %s", err, last_good,
        )
        return last_good
    raise ModelIntegrityError(
        f"{err}; last-good recovery also failed ({lg_err})"
    )


#: the only package whose classes an artifact may name: a class path is
#: data, and importing another package's (the JAX package's) would pull
#: that package and its runtime into the process
_PACKAGE = __name__.partition(".")[0]


def _load_class(qualname: str):
    if not qualname.startswith(_PACKAGE + "."):
        raise ModelLoadError(
            f"the saved stage class {qualname} is not one of "
            f"{_PACKAGE}'s, and load_model imports no other package; an "
            "artifact the JAX package saved loads through "
            f"{_PACKAGE}.interop.load_reference_artifact(path, workflow)"
        )
    module, _, name = qualname.rpartition(".")
    mod = importlib.import_module(module)
    obj = mod
    for part in name.split("."):
        obj = getattr(obj, part)
    return obj


def read_artifact(path: str) -> tuple[str, dict, "_ArrayStore"]:
    """(verified artifact directory, its model.json document, its arrays)
    for ``path``, recovering from ``.last-good`` as :func:`resolve_artifact`
    does; raises ModelLoadError when a file does not parse."""
    path = resolve_artifact(path)
    json_path = os.path.join(path, MODEL_JSON)
    npz_path = os.path.join(path, ARRAYS_NPZ)
    try:
        with open(json_path) as f:
            doc = json.load(f)
    except ValueError as e:
        raise ModelLoadError(f"model artifact {json_path} is not valid "
                             f"JSON: {e}") from e
    try:
        arrays = _ArrayStore(np.load(npz_path, allow_pickle=False), npz_path)
    except (OSError, ValueError, zipfile.BadZipFile, zlib.error) as e:
        raise ModelLoadError(
            f"model artifact {npz_path} is not a readable npz: {e}"
        ) from e
    return path, doc, arrays


def read_schema_contract(path: str):
    """The artifact's schema contract, or None for a contract-less one."""
    schema_path = os.path.join(path, SCHEMA_JSON)
    if not os.path.exists(schema_path):
        return None
    from ..schema.contract import SchemaContract

    try:
        with open(schema_path) as f:
            return SchemaContract.from_json(json.load(f))
    except (ValueError, KeyError, TypeError) as e:
        raise ModelLoadError(
            f"model artifact {schema_path} is not a valid schema "
            f"contract: {e}"
        ) from e


def apply_saved_blacklist(doc: dict, workflow) -> None:
    """Re-derive the saved RawFeatureFilter blacklist on the freshly built
    ``workflow`` (its DAG surgery, ``OpWorkflow._apply_blacklist``), so
    its stages pair with the saved ones (reference: the loader reapplies
    setBlacklist)."""
    bl_names = set(doc.get("blacklisted_raw", ()))
    already = {f.name for f in workflow.blacklisted_features if f.is_raw()}
    if bl_names == already:
        return
    if already:
        raise ValueError(
            "target workflow already carries a different blacklist "
            f"({sorted(already)}) than the saved model ({sorted(bl_names)}); "
            "load needs a freshly built workflow"
        )
    by_name = {f.name: f for f in workflow.raw_features}
    missing = bl_names - set(by_name)
    if missing:
        raise ValueError(
            f"saved model blacklists raw features {sorted(missing)} "
            "absent from the target workflow"
        )
    workflow.blacklisted_features = [by_name[n] for n in sorted(bl_names)]
    workflow._apply_blacklist()


def load_model(path: str, workflow):
    """Restore into the code-defined workflow (reference contract:
    OpWorkflow.loadModel), scoring on ``workflow.device``."""
    from ..utils.device import resolve_device
    from ..workflow.dag import compute_dag, flatten
    from ..workflow.workflow import OpWorkflowModel

    device = str(workflow.device)
    resolve_device(device)

    path, doc, arrays = read_artifact(path)

    apply_saved_blacklist(doc, workflow)

    dag = compute_dag(workflow.result_features)
    dag_stages = flatten(dag)
    if len(dag_stages) != len(doc["stages"]):
        raise ValueError(
            f"workflow has {len(dag_stages)} stages but saved model has "
            f"{len(doc['stages'])}; load requires the same code-defined workflow"
        )

    fitted = []
    for stage_def, saved in zip(dag_stages, doc["stages"]):
        cls = _load_class(saved["class"])
        # stages pair positionally with the code-defined workflow; estimators
        # save their fitted-model class, so accept either an exact class match
        # or estimator->model pairs (both carry the estimator's operation_name)
        if (
            type(stage_def).__name__ != cls.__name__
            and stage_def.operation_name != saved["operation_name"]
        ):
            raise ValueError(
                f"saved stage {saved['class']} does not match workflow stage "
                f"{type(stage_def).__name__} at the same DAG position; load "
                "requires the same code-defined workflow"
            )
        inst = cls.__new__(cls)
        # baseline attrs from the (unfitted) DAG stage, then saved state
        inst.__dict__.update(
            {
                k: v
                for k, v in vars(stage_def).items()
                if k not in ("params", "metadata")
            }
        )
        # adopt the TARGET workflow's uid so DAG substitution by uid works
        # regardless of where the fresh build's uid counters start
        inst.uid = stage_def.uid
        inst.operation_name = saved["operation_name"]
        inst.params = _decode(saved["params"], arrays, device)
        inst.metadata = _decode(saved["metadata"], arrays, device)
        for k, v in _decode(saved["state"], arrays, device).items():
            setattr(inst, k, v)
        if hasattr(inst, "device"):
            inst.device = device
        if "estimator" in saved:
            est_cls = _load_class(saved["estimator"]["class"])
            est = est_cls()
            est.params = _decode(saved["estimator"]["params"], arrays, device)
            if hasattr(est, "device"):
                est.device = device  # scoring runs on the workflow's device
            inst.estimator_ref = est
        inst.input_features = stage_def.input_features
        inst._output = stage_def._output if stage_def._output else None
        # fitted stage replaces the estimator: same output feature
        stage_def._output = stage_def.get_output()
        inst._output = stage_def._output
        fitted.append(inst)

    model = OpWorkflowModel(
        result_features=workflow.result_features,
        raw_features=workflow.raw_features,
        stages=fitted,
        parameters=_decode(doc["parameters"], arrays, device),
        train_time_s=doc.get("train_time_s", 0.0),
        blacklisted_features=workflow.blacklisted_features,
        device=device,
    )
    # schema contract (optional: pre-contract artifacts have none) - the
    # serve tier's drift guards need the trained data shape; checksummed
    # via the manifest, so corruption was already caught above
    model.schema_contract = read_schema_contract(path)
    return model
