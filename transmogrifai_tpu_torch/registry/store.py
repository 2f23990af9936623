"""Versioned, content-addressed model registry over crash-consistent artifacts.

The model-lifecycle layer TensorFlow's production story hinges on
(reference frame: TF-Serving's versioned servable store + TensorFlow
§4.2 user-level checkpointing, PAPERS.md; the reference's own
OpWorkflowModelWriter persists one terminal artifact and stops there):
a fitted model is not a terminal artifact but ONE VERSION in a lineage
that advances (publish → canary → stable) and reverts (rollback)
while serving.

Layout under ``root``::

    registry.json             # the version index (checksummed, see below)
    registry.json.last-good   # previous index (crash recovery)
    versions/v<N>/            # one crash-consistent model_io artifact each

Every version entry records the artifact's ``manifest.json`` SHA-256
(content address: the manifest already checksums every payload file, so
hashing it pins the whole artifact), the schema-contract hash, eval
metrics, the parent version it was derived from, and its stage lineage.
``registry.json`` itself follows the same crash-consistency discipline
as ``serialization/model_io.py``: a self-checksum over the canonical
payload, tempfile write + fsync + atomic rename, with the previous
index surviving as ``registry.json.last-good`` — a crash at ANY instant
(drilled via the ``registry.publish_crash`` fault point, which kills
between the artifact publish and the index commit) leaves the registry
loadable at the prior version, with the orphaned artifact directory
reported by :meth:`ModelRegistry.verify` rather than trusted.

Stage machine::

    publish → candidate ─ promote(to="canary") → canary ─ promote → stable
                   └─────────── promote(to="stable") ──────────────┘
    canary ─ rollback → rolled_back        stable ─ rollback → rolled_back
                                           (stable pointer reverts to parent)

Writers serialize at two levels: an in-process RLock, plus an exclusive
``flock(2)`` on ``registry.lock`` held across every read-modify-write —
an operator's second PROCESS may mutate the same index, and without the
file lock its stale read-modify-write could silently drop a concurrently
published version.  The atomic-rename commit keeps concurrent READERS
consistent without any lock.

Port of ``transmogrifai_tpu/registry/store.py`` on the port's
``serialization/model_io.py``.  The port's artifacts carry no compiled
executables (the torch program is plain ops and kernel launches), so
``verify``'s ``stale_executables`` is always empty.
"""
from __future__ import annotations

import contextlib
import json
import logging
import os
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Optional

from ..faults import injection as _faults
from ..obs import trace as _obs_trace
from ..serialization.model_io import (
    MANIFEST_JSON,
    SCHEMA_JSON,
    _fsync_dir,
    _sha256,
    _sha256_file,
    _write_fsync,
    load_model,
    save_model,
    verify_artifact,
)

log = logging.getLogger("transmogrifai_tpu_torch.registry")

REGISTRY_JSON = "registry.json"
REGISTRY_LOCK = "registry.lock"
LAST_GOOD_SUFFIX = ".last-good"
VERSIONS_DIR = "versions"

REGISTRY_FORMAT_VERSION = 1

#: lineage events kept in registry.json (bounded: the registry index
#: must stay small enough to read on every serve-plane decision)
MAX_LINEAGE_EVENTS = 512

STAGES = ("candidate", "canary", "stable", "retired", "rolled_back")


class RegistryError(RuntimeError):
    """A registry operation failed; the message names version + reason."""


class RegistryIntegrityError(RegistryError):
    """registry.json failed its checksum and no last-good copy could
    recover it (truncation, bit-flips, partial overwrite)."""


@dataclass
class RegistryVersion:
    """One published model version's index entry."""

    version: str
    path: str  # relative to the registry root
    created_at: float
    manifest_sha256: str
    schema_sha256: Optional[str] = None
    metrics: dict = field(default_factory=dict)
    parent: Optional[str] = None
    stage: str = "candidate"

    def to_json(self) -> dict:
        return {
            "version": self.version,
            "path": self.path,
            "created_at": self.created_at,
            "manifest_sha256": self.manifest_sha256,
            "schema_sha256": self.schema_sha256,
            "metrics": dict(self.metrics),
            "parent": self.parent,
            "stage": self.stage,
        }

    @staticmethod
    def from_json(doc: dict) -> "RegistryVersion":
        return RegistryVersion(
            version=doc["version"],
            path=doc["path"],
            created_at=float(doc.get("created_at", 0.0)),
            manifest_sha256=doc["manifest_sha256"],
            schema_sha256=doc.get("schema_sha256"),
            metrics=dict(doc.get("metrics", {})),
            parent=doc.get("parent"),
            stage=doc.get("stage", "candidate"),
        )


def _doc_checksum(doc: dict) -> str:
    """Self-checksum over the canonical payload (everything except the
    checksum field itself)."""
    payload = {k: v for k, v in doc.items() if k != "checksum"}
    return _sha256(
        json.dumps(payload, sort_keys=True, default=str).encode("utf-8")
    )


class ModelRegistry:
    """Versioned model store + stage lineage over one root directory."""

    def __init__(self, root: str, create: bool = True) -> None:
        self.root = os.path.abspath(root)
        self._lock = threading.RLock()
        self._flock_warned = False
        index = os.path.join(self.root, REGISTRY_JSON)
        if not os.path.exists(index):
            if not create:
                raise RegistryError(f"no registry at {self.root}")
            os.makedirs(os.path.join(self.root, VERSIONS_DIR), exist_ok=True)
            with self._exclusive():
                if not os.path.exists(index):  # raced creator won
                    self._commit(self._empty_doc())

    # -- locking ------------------------------------------------------------
    @contextlib.contextmanager
    def _exclusive(self):
        """In-process RLock + exclusive flock on ``registry.lock``: every
        read-modify-write (publish/promote/rollback) holds both, so a
        concurrent mutation from ANOTHER process (the operator CLI) can
        never interleave its stale read with our commit and drop an
        entry.  On filesystems without flock support the file lock
        degrades to in-process-only with a one-time warning."""
        with self._lock:
            lock_fd = None
            try:
                try:
                    import fcntl

                    lock_fd = os.open(
                        os.path.join(self.root, REGISTRY_LOCK),
                        os.O_RDWR | os.O_CREAT, 0o644,
                    )
                    fcntl.flock(lock_fd, fcntl.LOCK_EX)
                except (ImportError, OSError) as e:
                    if not self._flock_warned:
                        self._flock_warned = True
                        log.warning(
                            "registry %s: no cross-process file lock "
                            "(%s); concurrent writers from other "
                            "processes are unsafe", self.root, e,
                        )
                    if lock_fd is not None:
                        os.close(lock_fd)
                        lock_fd = None
                yield
            finally:
                if lock_fd is not None:
                    os.close(lock_fd)  # releases the flock

    # -- index IO -----------------------------------------------------------
    @staticmethod
    def _empty_doc() -> dict:
        return {
            "format_version": REGISTRY_FORMAT_VERSION,
            "versions": {},
            "stable": None,
            "canary": None,
            "lineage": [],
        }

    def _index_path(self) -> str:
        return os.path.join(self.root, REGISTRY_JSON)

    @staticmethod
    def _verify_bytes(data: bytes) -> Optional[dict]:
        """Parse + checksum-verify index bytes; None when damaged."""
        try:
            doc = json.loads(data.decode("utf-8"))
        except (ValueError, UnicodeDecodeError):
            return None
        if not isinstance(doc, dict) or "versions" not in doc:
            return None
        if doc.get("checksum") != _doc_checksum(doc):
            return None
        return doc

    @classmethod
    def _verify_doc(cls, path: str) -> Optional[dict]:
        """Parse + checksum-verify one index file; None when damaged."""
        try:
            with open(path, "rb") as f:
                data = f.read()
        except OSError:
            return None
        return cls._verify_bytes(data)

    def _read(self) -> dict:
        """The verified index, recovering from ``.last-good`` when the
        primary is damaged (the model_io resolve_artifact discipline)."""
        path = self._index_path()
        doc = self._verify_doc(path)
        if doc is not None:
            return doc
        last_good = path + LAST_GOOD_SUFFIX
        doc = self._verify_doc(last_good)
        if doc is not None:
            log.warning(
                "registry index %s failed verification; recovered from "
                "last-good copy %s", path, last_good,
            )
            return doc
        raise RegistryIntegrityError(
            f"registry index {path} failed its checksum and no last-good "
            "copy could recover it"
        )

    def _commit(self, doc: dict) -> None:
        """Atomic index update: last-good snapshot of the current index,
        then tempfile + fsync + rename.  A crash at any instant leaves a
        verifiable index (old or new)."""
        doc["format_version"] = REGISTRY_FORMAT_VERSION
        doc["updated_at"] = time.time()
        doc["checksum"] = _doc_checksum(doc)
        path = self._index_path()
        data = json.dumps(doc, indent=1, sort_keys=True,
                          default=str).encode("utf-8")
        if os.path.exists(path):
            try:
                with open(path, "rb") as f:
                    prev = f.read()
                # snapshot ONLY a verified primary: a corrupt primary
                # copied over the last-good would destroy the one copy
                # _read() can still recover from, and a crash in this
                # commit window would then brick the registry
                if self._verify_bytes(prev) is not None:
                    _write_fsync(path + LAST_GOOD_SUFFIX + ".tmp", prev)
                    os.replace(path + LAST_GOOD_SUFFIX + ".tmp",
                               path + LAST_GOOD_SUFFIX)
                else:
                    log.warning(
                        "registry index %s fails verification; keeping "
                        "the existing last-good snapshot", path,
                    )
            except OSError as e:
                log.warning("could not snapshot %s to last-good: %s",
                            path, e)
        tmp = f"{path}.tmp-{os.getpid()}"
        _write_fsync(tmp, data)
        os.replace(tmp, path)
        _fsync_dir(self.root)

    def _append_lineage(self, doc: dict, **event: Any) -> None:
        event["t"] = time.time()
        doc.setdefault("lineage", []).append(event)
        if len(doc["lineage"]) > MAX_LINEAGE_EVENTS:
            del doc["lineage"][0]

    # -- queries ------------------------------------------------------------
    @staticmethod
    def _version_sort_key(vid: str) -> tuple:
        """Canonical ``v<N>`` ids sort numerically; anything else (a
        hand-migrated or future-format id _next_version already warns
        about) sorts after them lexically instead of crashing the
        listing."""
        try:
            return (0, int(vid[1:]), vid)
        except (ValueError, IndexError):
            return (1, 0, vid)

    def versions(self) -> list[RegistryVersion]:
        doc = self._read()
        out = [RegistryVersion.from_json(v) for v in doc["versions"].values()]
        out.sort(key=lambda v: self._version_sort_key(v.version))
        return out

    def get(self, version: str) -> RegistryVersion:
        doc = self._read()
        entry = doc["versions"].get(version)
        if entry is None:
            raise RegistryError(
                f"no version {version!r} in registry {self.root} "
                f"(have: {sorted(doc['versions'])})"
            )
        return RegistryVersion.from_json(entry)

    @property
    def stable(self) -> Optional[str]:
        return self._read().get("stable")

    @property
    def canary(self) -> Optional[str]:
        return self._read().get("canary")

    def lineage(self) -> list[dict]:
        return [dict(e) for e in self._read().get("lineage", [])]

    def artifact_path(self, version: str) -> str:
        return os.path.join(self.root, self.get(version).path)

    # -- publish ------------------------------------------------------------
    def _next_version(self, doc: dict) -> str:
        """Smallest unused ``v<N>``, counting BOTH index entries and
        existing version directories: a reserved-but-uncommitted dir
        (another process mid-publish, or a crash orphan) must never be
        handed out again."""
        names = set(doc["versions"])
        vdir = os.path.join(self.root, VERSIONS_DIR)
        if os.path.isdir(vdir):
            names.update(
                name for name in os.listdir(vdir)
                if not name.endswith(LAST_GOOD_SUFFIX)
            )
        n = 0
        for vid in names:
            try:
                n = max(n, int(vid[1:]))
            except (ValueError, IndexError):
                log.warning("ignoring non-canonical version id %r", vid)
        return f"v{n + 1}"

    def publish(self, model, metrics: Optional[dict] = None,
                parent: Optional[str] = None,
                stage: str = "candidate") -> RegistryVersion:
        """One ``registry.publish`` trace span per publish (obs/): the
        artifact save + index commit ride the ambient run trace, the
        published version tagged on exit."""
        with _obs_trace.span("registry.publish", stage=stage) as sp:
            entry = self._publish(model, metrics=metrics, parent=parent,
                                  stage=stage)
            sp.set_attr("version", entry.version)
            return entry

    def _publish(self, model, metrics: Optional[dict] = None,
                 parent: Optional[str] = None,
                 stage: str = "candidate") -> RegistryVersion:
        """Save ``model`` as the next version and record it in the index.

        The exclusive lock is held only to RESERVE the version id (a
        mkdir marker _next_version respects) and again to commit the
        index entry — never across the artifact write itself, so a
        multi-hundred-MB fsync'd save cannot block an operator's
        concurrent rollback.  The artifact save is
        crash-consistent on its own (model_io); the index commit is
        atomic on its own; the window BETWEEN them is the publish crash
        window (``registry.publish_crash`` drills it): a crash there
        leaves an orphaned artifact directory the index never
        references — the registry stays at the prior version.
        """
        if stage not in ("candidate", "stable", "canary"):
            raise RegistryError(
                f"cannot publish directly into stage {stage!r}"
            )
        with self._exclusive():
            doc = self._read()
            vid = self._next_version(doc)
            rel = os.path.join(VERSIONS_DIR, vid)
            path = os.path.join(self.root, rel)
            os.makedirs(path)  # the id reservation marker
        save_model(model, path)
        # crash drill: death here (artifact published, index not yet
        # committed) must leave the registry at the prior version
        _faults.inject_kill("registry.publish_crash")
        manifest_sha, _size = _sha256_file(
            os.path.join(path, MANIFEST_JSON)
        )
        schema_path = os.path.join(path, SCHEMA_JSON)
        schema_sha = (
            _sha256_file(schema_path)[0]
            if os.path.exists(schema_path) else None
        )
        with self._exclusive():
            doc = self._read()
            if parent is None:
                parent = doc.get("stable")
            entry = RegistryVersion(
                version=vid,
                path=rel,
                created_at=time.time(),
                manifest_sha256=manifest_sha,
                schema_sha256=schema_sha,
                metrics=dict(metrics or {}),
                parent=parent,
                stage="candidate",
            )
            doc["versions"][vid] = entry.to_json()
            self._append_lineage(doc, event="publish", version=vid,
                                 parent=parent)
            self._commit(doc)
        # outside the lock: promote() takes it again, and a second flock
        # on the same file would deadlock against our own fd
        self._attribute_telemetry(vid)
        if stage != "candidate":
            return self.promote(vid, to=stage)
        return entry

    @staticmethod
    def _attribute_telemetry(version: str) -> None:
        """Stamp the process-wide mesh/data accumulators with the
        version just published: the degraded-training events and ingest
        counts recorded by THIS process produced this version, and
        every later snapshot/export should say so (the ServingTelemetry
        side is stamped per generation by the DeploymentController).
        Best-effort — scoring-only installs may strip the parallel
        tier."""
        try:
            from ..schema.quarantine import data_telemetry

            data_telemetry().set_model_version(version)
        except ImportError:
            log.debug("no data telemetry to attribute %s to", version)
        try:
            from ..parallel.resilience import mesh_telemetry

            mesh_telemetry().set_model_version(version)
        except ImportError:
            log.debug("no mesh telemetry to attribute %s to", version)

    # -- stage transitions --------------------------------------------------
    def promote(self, version: str, to: str = "stable") -> RegistryVersion:
        """candidate → canary, candidate/canary → stable.  Promoting to
        stable retires the previous stable (still loadable — rollback
        may revert to it) and clears the canary pointer when the canary
        itself was promoted."""
        if to not in ("stable", "canary"):
            raise RegistryError(f"cannot promote to stage {to!r}")
        with self._exclusive():
            doc = self._read()
            entry = doc["versions"].get(version)
            if entry is None:
                raise RegistryError(f"no version {version!r} to promote")
            allowed = ("candidate", "canary") if to == "stable" else (
                "candidate",)
            if entry["stage"] not in allowed:
                raise RegistryError(
                    f"cannot promote {version} from stage "
                    f"{entry['stage']!r} to {to!r} (allowed from: "
                    f"{allowed})"
                )
            err = verify_artifact(os.path.join(self.root, entry["path"]))
            if err is not None:
                raise RegistryIntegrityError(
                    f"refusing to promote {version}: {err}"
                )
            from_stage = entry["stage"]
            entry["stage"] = to
            if to == "stable":
                prev = doc.get("stable")
                if prev and prev != version and prev in doc["versions"]:
                    doc["versions"][prev]["stage"] = "retired"
                doc["stable"] = version
                if doc.get("canary") == version:
                    doc["canary"] = None
            else:
                prev_canary = doc.get("canary")
                if prev_canary and prev_canary != version:
                    raise RegistryError(
                        f"canary slot already held by {prev_canary}; "
                        "roll it back or promote it first"
                    )
                doc["canary"] = version
            self._append_lineage(doc, event="promote", version=version,
                                 from_stage=from_stage, to_stage=to)
            self._commit(doc)
            return RegistryVersion.from_json(entry)

    def release_canary(self, reason: str = "") -> Optional[dict]:
        """End a canary observation window UNDECIDED: the version
        returns to ``candidate`` (re-promotable later — unlike a
        rollback, no judgement is recorded against it) and the slot
        frees.  The serve plane calls this when a deploy run ends with
        its canary still live, so a later run's canary never serves
        untracked while the registry still points at the old one."""
        with self._exclusive():
            doc = self._read()
            vid = doc.get("canary")
            if vid is None:
                return None
            doc["canary"] = None
            entry = doc["versions"].get(vid)
            if entry is not None and entry["stage"] == "canary":
                entry["stage"] = "candidate"
            event = {"event": "canary_release", "version": vid,
                     "reason": reason}
            self._append_lineage(doc, **event)
            self._commit(doc)
            log.info("op_registry canary %s released undecided%s", vid,
                     f": {reason}" if reason else "")
            return dict(event)

    def describe(self, lineage: bool = False) -> dict:
        """One consistent read of the whole registry state (stable /
        canary pointers, versions, optionally the lineage) — the CLI's
        ``list`` view.  A single ``_read()`` so the pointers can never
        disagree with the version stages when another process commits
        mid-listing."""
        doc = self._read()
        versions = [RegistryVersion.from_json(v)
                    for v in doc["versions"].values()]
        versions.sort(key=lambda v: self._version_sort_key(v.version))
        out: dict[str, Any] = {
            "root": self.root,
            "stable": doc.get("stable"),
            "canary": doc.get("canary"),
            "versions": [v.to_json() for v in versions],
        }
        if lineage:
            out["lineage"] = [dict(e) for e in doc.get("lineage", [])]
        return out

    def rollback(self, version: Optional[str] = None, reason: str = "",
                 evidence: Optional[dict] = None) -> dict:
        """Demote a version.  Default target: the canary when one is
        live, else the stable.  Rolling back the STABLE reverts the
        stable pointer to the entry's parent (which must verify).  The
        decision + evidence land in the lineage so ``summary_json()``
        consumers can attribute the demotion."""
        with self._exclusive():
            doc = self._read()
            if version is None:
                version = doc.get("canary") or doc.get("stable")
            if version is None:
                raise RegistryError("nothing to roll back: no canary or "
                                    "stable version")
            entry = doc["versions"].get(version)
            if entry is None:
                raise RegistryError(f"no version {version!r} to roll back")
            from_stage = entry["stage"]
            reverted_to = None
            if doc.get("canary") == version:
                doc["canary"] = None
            elif doc.get("stable") == version:
                parent = entry.get("parent")
                if parent is None or parent not in doc["versions"]:
                    raise RegistryError(
                        f"cannot roll back stable {version}: no parent "
                        "version recorded to revert to"
                    )
                parent_stage = doc["versions"][parent]["stage"]
                if parent_stage != "retired":
                    # a parent the operator explicitly demoted
                    # (rolled_back) — or one that never served
                    # (candidate) — must not silently become the
                    # serving stable again
                    raise RegistryError(
                        f"cannot roll back stable {version}: parent "
                        f"{parent} is {parent_stage!r}, not a retired "
                        "ex-stable; promote a known-good version "
                        "explicitly instead"
                    )
                err = verify_artifact(
                    os.path.join(self.root, doc["versions"][parent]["path"])
                )
                if err is not None:
                    raise RegistryIntegrityError(
                        f"cannot roll back to parent {parent}: {err}"
                    )
                doc["versions"][parent]["stage"] = "stable"
                doc["stable"] = parent
                reverted_to = parent
            entry["stage"] = "rolled_back"
            event = {
                "event": "rollback", "version": version,
                "from_stage": from_stage, "reason": reason,
            }
            if reverted_to is not None:
                event["stable_reverted_to"] = reverted_to
            if evidence:
                event["evidence"] = evidence
            self._append_lineage(doc, **event)
            self._commit(doc)
            log.warning(
                "op_registry version %s rolled back from %s%s%s",
                version, from_stage,
                f" (stable reverted to {reverted_to})" if reverted_to
                else "",
                f": {reason}" if reason else "",
            )
            return dict(event)

    # -- verification / loading ---------------------------------------------
    def verify(self, version: Optional[str] = None) -> dict:
        """Checksum-verify the index and version artifacts.

        Returns ``{"index_ok": bool, "versions": {vid: None|error},
        "orphans": [...], "stale_executables": {vid: warning},
        "ok": bool}``.  ``ok`` requires BOTH the primary index and every
        checked version to verify: a registry serving from its
        ``.last-good`` copy is one commit stale (a promote may have
        silently reverted), so it must fail the check loudly even though
        it remains operable.  ``version=None`` checks every recorded
        version; orphaned artifact directories (published but never
        committed — the publish crash window) are reported, never
        trusted.

        ``stale_executables`` keeps the JAX package's report shape: it
        names versions whose cached compiled executables were built for
        another runtime.  The port's artifacts carry none, so it stays
        empty."""
        index_ok = self._verify_doc(self._index_path()) is not None
        doc = self._read()
        targets = [version] if version is not None else sorted(
            doc["versions"])
        report: dict[str, Any] = {
            "index_ok": index_ok,
            "recovered_from_last_good": not index_ok,
            "versions": {},
            "orphans": [],
            "stale_executables": {},
        }
        for vid in targets:
            entry = doc["versions"].get(vid)
            if entry is None:
                report["versions"][vid] = "not in the registry index"
                continue
            path = os.path.join(self.root, entry["path"])
            err = verify_artifact(path)
            if err is None:
                sha, _ = _sha256_file(os.path.join(path, MANIFEST_JSON))
                if sha != entry["manifest_sha256"]:
                    err = (
                        f"artifact manifest hash {sha[:12]}… does not "
                        "match the registered version (artifact replaced "
                        "outside the registry)"
                    )
            report["versions"][vid] = err
            if err is None:
                warn = self._stale_executable_warning(path)
                if warn is not None:
                    report["stale_executables"][vid] = warn
                    log.warning("op_registry version %s: %s", vid, warn)
        vdir = os.path.join(self.root, VERSIONS_DIR)
        if version is None and os.path.isdir(vdir):
            known = {e["path"] for e in doc["versions"].values()}
            for name in sorted(os.listdir(vdir)):
                rel = os.path.join(VERSIONS_DIR, name)
                if rel not in known and not name.endswith(
                        LAST_GOOD_SUFFIX) and "tmp" not in name:
                    report["orphans"].append(rel)
        report["ok"] = index_ok and all(
            v is None for v in report["versions"].values())
        return report

    @staticmethod
    def _stale_executable_warning(path: str) -> Optional[str]:
        """Named staleness warning for a version's cached compiled
        executables, or None.  The port saves no executables into an
        artifact (the torch device program is rebuilt from the fitted
        stages at load), so there is never one to go stale."""
        return None

    def load(self, version: str, workflow):
        """Restore one version into a code-defined workflow (the
        load_model contract), verifying the registered content address
        first."""
        entry = self.get(version)
        path = os.path.join(self.root, entry.path)
        err = verify_artifact(path)
        if err is not None:
            raise RegistryIntegrityError(
                f"version {version} failed verification: {err}"
            )
        sha, _ = _sha256_file(os.path.join(path, MANIFEST_JSON))
        if sha != entry.manifest_sha256:
            raise RegistryIntegrityError(
                f"version {version} artifact does not match its "
                "registered manifest hash (replaced outside the registry)"
            )
        return load_model(path, workflow)

    def load_stable(self, workflow):
        stable = self.stable
        if stable is None:
            raise RegistryError(f"registry {self.root} has no stable "
                                "version")
        return self.load(stable, workflow)
