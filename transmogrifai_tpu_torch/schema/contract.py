"""Schema contracts: the fit-time data shape a model is entitled to.

Host copy of ``transmogrifai_tpu/schema/contract.py``.  Counterpart of the reference's feature-validation contract (reference:
core/.../filters/RawFeatureFilter.scala compares score-time feature
distributions against the training Summary; OpWorkflowModelWriter
persists the trained feature metadata): at fit time the workflow
captures every raw feature's name, dtype, nullability and a
:class:`~..filters.feature_distribution.FeatureDistribution` summary,
and the contract travels INSIDE the crash-consistent model artifact
(``schema.json``, checksummed by the manifest — serialization/
model_io.py).  At serve time the endpoint and the local scorer validate
incoming batches against it: a renamed / re-typed / missing column is a
named :class:`SchemaDriftError`, and distribution drift is scored by JS
divergence against the training histograms (schema/drift.py).
"""
from __future__ import annotations

import logging
import time
from dataclasses import dataclass
from typing import Any, Mapping, Optional, Sequence

import numpy as np

from ..filters.feature_distribution import (
    FeatureDistribution,
    compute_distribution,
)
from ..types.feature_types import feature_type_by_name

log = logging.getLogger("transmogrifai_tpu_torch.schema")

CONTRACT_FORMAT_VERSION = 1

#: rows examined per batch for value-level type checks: enough to catch
#: a re-typed column immediately, bounded so validation stays O(1)-ish
#: per batch no matter the batch size
TYPE_CHECK_SAMPLE_ROWS = 64

#: fit-time distribution capture is capped: histograms stabilize long
#: before this, and text bucketing is per-value python work
CAPTURE_MAX_ROWS = 100_000

_NUMERIC_OK = (bool, int, float, np.integer, np.floating, np.bool_)


class SchemaDriftError(ValueError):
    """A serve batch violates the training schema contract; the message
    names every offending feature.  ``violations`` carries the
    structured list: dicts of kind ('missing_column' | 'extra_column' |
    'type_flip' | 'injected'), feature, detail.  A plain string builds
    a pre-rendered error (the scheduler's shed-marker relay)."""

    def __init__(self, violations) -> None:
        if isinstance(violations, str):
            self.violations: list[dict] = []
            super().__init__(violations)
            return
        self.violations = list(violations)
        parts = [
            f"{v['kind']}: {v['feature']}" + (
                f" ({v['detail']})" if v.get("detail") else ""
            )
            for v in self.violations
        ]
        super().__init__(
            "serve batch violates the training schema contract — "
            + "; ".join(parts)
        )


def log_violations_once(violations: Sequence[dict], warned: set,
                        logger, context: str) -> None:
    """policy='warn' logging shared by every enforcement site (serving
    endpoint, local scorer): each DISTINCT (kind, feature) violation
    logs once per ``warned`` set, so a drifting client cannot flood the
    logs batch after batch."""
    for v in violations:
        sig = (v["kind"], v["feature"])
        if sig in warned:
            continue
        warned.add(sig)
        logger.warning(
            "schema drift (policy=warn, %s): %s: %s — %s",
            context, v["kind"], v["feature"], v.get("detail", ""),
        )


def collect_violations(contract, records: Sequence[Mapping[str, Any]],
                       extra_violations: Sequence[dict] = ()) -> list[dict]:
    """THE batch-vs-contract check every serve surface shares (serving
    endpoint, local scorer, registry deployment controller): one
    implementation so registry-driven swaps can never diverge between
    surfaces.  ``extra_violations`` carries caller-injected entries
    (e.g. the ``serving.schema_drift`` fault point); a None contract or
    empty batch validates vacuously."""
    violations = list(extra_violations)
    if contract is not None and records:
        violations.extend(contract.validate_records(records))
    return violations


def apply_drift_policy(violations: Sequence[dict], policy: str,
                       warned: set, logger, context: str) -> bool:
    """The policy dispatch shared by the same surfaces: raises
    :class:`SchemaDriftError` under ``policy='raise'``, warns once per
    distinct violation under ``'warn'``, and returns True exactly when
    the caller must SHED the batch (``policy='shed'`` with violations).
    Telemetry accounting stays with the caller — it happens BEFORE this
    call so a raised error is still counted."""
    if not violations:
        return False
    if policy == "raise":
        raise SchemaDriftError(violations)
    if policy == "warn":
        log_violations_once(violations, warned, logger, context)
        return False
    return policy == "shed"


@dataclass
class FeatureSpec:
    """One raw feature's contracted shape."""

    name: str
    type_name: str
    kind: str
    nullable: bool
    is_response: bool = False

    def to_json(self) -> dict:
        return {
            "name": self.name,
            "type": self.type_name,
            "kind": self.kind,
            "nullable": self.nullable,
            "is_response": self.is_response,
        }

    @staticmethod
    def from_json(doc: dict) -> "FeatureSpec":
        return FeatureSpec(
            name=doc["name"],
            type_name=doc["type"],
            kind=doc["kind"],
            nullable=bool(doc["nullable"]),
            is_response=bool(doc.get("is_response", False)),
        )


class SchemaContract:
    """Raw-feature schema + training distributions, captured at fit."""

    def __init__(
        self,
        features: Sequence[FeatureSpec],
        distributions: Optional[Mapping[str, FeatureDistribution]] = None,
        n_rows: int = 0,
        sampled_rows: int = 0,
        captured_at: Optional[float] = None,
    ) -> None:
        self.features = list(features)
        self.distributions = dict(distributions or {})
        self.n_rows = int(n_rows)
        self.sampled_rows = int(sampled_rows)
        self.captured_at = (
            time.time() if captured_at is None else float(captured_at)
        )
        self._by_name = {f.name: f for f in self.features}

    # -- capture ------------------------------------------------------------
    @classmethod
    def capture(
        cls,
        raw_features: Sequence,
        dataset,
        n_bins: int = 32,
        max_rows: int = CAPTURE_MAX_ROWS,
    ) -> "SchemaContract":
        """Fit-time capture from the (post-RawFeatureFilter) raw data.

        Distribution capture samples an even stride of at most
        ``max_rows`` rows; columns whose type has no distribution (maps,
        predictions) keep their FeatureSpec with no histogram.
        """
        specs = [
            FeatureSpec(
                name=f.name,
                type_name=f.ftype.__name__,
                kind=f.ftype.kind,
                nullable=not f.ftype.non_nullable,
                is_response=bool(f.is_response),
            )
            for f in raw_features
        ]
        dists: dict[str, FeatureDistribution] = {}
        n = len(dataset) if dataset is not None else 0
        sampled = 0
        if n:
            if n > max_rows:
                idx = np.linspace(0, n - 1, max_rows).astype(np.int64)
                sample = dataset.take(idx)
                sampled = max_rows
            else:
                sample = dataset
                sampled = n
            for spec in specs:
                if spec.name not in dataset:
                    continue
                try:
                    dists[spec.name] = compute_distribution(
                        spec.name, sample[spec.name], n_bins=n_bins
                    )
                except TypeError as e:
                    # no distribution for this column type (maps etc.):
                    # the FeatureSpec still validates structurally
                    log.debug("no distribution captured for %s: %s",
                              spec.name, e)
        return cls(specs, dists, n_rows=n, sampled_rows=sampled)

    # -- lookups ------------------------------------------------------------
    def feature(self, name: str) -> Optional[FeatureSpec]:
        return self._by_name.get(name)

    @property
    def predictor_names(self) -> tuple[str, ...]:
        return tuple(f.name for f in self.features if not f.is_response)

    @property
    def names(self) -> tuple[str, ...]:
        return tuple(f.name for f in self.features)

    # -- serve-time validation ----------------------------------------------
    def validate_records(
        self,
        records: Sequence[Mapping[str, Any]],
        sample_rows: int = TYPE_CHECK_SAMPLE_ROWS,
    ) -> list[dict]:
        """Structural check of a serve batch against the contract;
        returns the violation list (empty = conformant), never raises —
        the POLICY (raise/warn/shed) belongs to the caller.

        * ``missing_column`` — a contracted predictor absent from every
          record of the batch (response features are exempt: scoring
          never requires the label);
        * ``extra_column``  — a key the contract has never heard of (a
          renamed column shows up as missing + extra);
        * ``type_flip``     — a value whose python type contradicts the
          contracted kind (string in a numeric feature, number in a
          text feature), checked over the first ``sample_rows`` rows.
        """
        if not records:
            return []
        violations: list[dict] = []
        # the key scan is deliberately O(batch): a key present in ANY
        # record counts as present (only the per-VALUE type check below
        # is sample-bounded)
        seen_keys: set = set().union(*(r.keys() for r in records))
        for spec in self.features:
            if spec.is_response:
                continue
            if spec.name not in seen_keys:
                violations.append({
                    "kind": "missing_column",
                    "feature": spec.name,
                    "detail": f"contracted {spec.type_name} column absent "
                              "from the batch",
                })
        for key in sorted(seen_keys):
            if key not in self._by_name:
                violations.append({
                    "kind": "extra_column",
                    "feature": key,
                    "detail": "column not in the training contract",
                })
        for spec in self.features:
            if spec.is_response or spec.name not in seen_keys:
                continue
            bad = self._first_type_flip(spec, records[:sample_rows])
            if bad is not None:
                violations.append(bad)
        return violations

    def _first_type_flip(
        self, spec: FeatureSpec, records: Sequence[Mapping[str, Any]]
    ) -> Optional[dict]:
        for i, r in enumerate(records):
            v = r.get(spec.name)
            if v is None:
                continue
            if spec.kind == "numeric" and not isinstance(v, _NUMERIC_OK):
                return {
                    "kind": "type_flip",
                    "feature": spec.name,
                    "detail": f"row {i}: expected {spec.type_name} "
                              f"(numeric), got {type(v).__name__} "
                              f"{str(v)[:40]!r}",
                }
            if spec.kind == "text" and not isinstance(v, str):
                return {
                    "kind": "type_flip",
                    "feature": spec.name,
                    "detail": f"row {i}: expected {spec.type_name} (text), "
                              f"got {type(v).__name__} {str(v)[:40]!r}",
                }
        return None

    def ftype_of(self, name: str):
        """The contracted FeatureType class (for rebuilding columns on
        the drift path)."""
        spec = self._by_name.get(name)
        return None if spec is None else feature_type_by_name(spec.type_name)

    # -- persistence --------------------------------------------------------
    def to_json(self) -> dict:
        return {
            "format_version": CONTRACT_FORMAT_VERSION,
            "captured_at": self.captured_at,
            "n_rows": self.n_rows,
            "sampled_rows": self.sampled_rows,
            "features": [f.to_json() for f in self.features],
            "distributions": {
                name: d.to_json() for name, d in self.distributions.items()
            },
        }

    @staticmethod
    def from_json(doc: dict) -> "SchemaContract":
        return SchemaContract(
            features=[FeatureSpec.from_json(f) for f in doc["features"]],
            distributions={
                name: FeatureDistribution.from_json(d)
                for name, d in doc.get("distributions", {}).items()
            },
            n_rows=int(doc.get("n_rows", 0)),
            sampled_rows=int(doc.get("sampled_rows", 0)),
            captured_at=doc.get("captured_at"),
        )
