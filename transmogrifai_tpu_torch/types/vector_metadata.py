"""Per-column provenance metadata for assembled feature vectors.

Counterpart of the reference's OpVectorColumnMetadata /
OpVectorMetadata (reference: features/src/main/scala/com/salesforce/op/utils/
spark/OpVectorColumnMetadata.scala and OpVectorMetadata.scala:49-66).

Every vectorizer that emits an OPVector column attaches one
:class:`VectorColumnMeta` per output dimension recording which raw feature
produced it, the categorical grouping, the indicator value for one-hot
columns, and whether the column is a null-tracking indicator.  This is the
backbone of SanityChecker <-> ModelInsights <-> LOCO interpretability, so it
is carried alongside the dense array from day one.
"""
from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Optional, Sequence

OTHER_STRING = "OTHER"
NULL_STRING = "NullIndicatorValue"


@dataclass(frozen=True)
class VectorColumnMeta:
    """Provenance of a single dimension of a feature vector."""

    parent_feature_name: str
    parent_feature_type: str
    grouping: Optional[str] = None
    indicator_value: Optional[str] = None
    descriptor_value: Optional[str] = None
    index: int = 0

    @property
    def is_null_indicator(self) -> bool:
        return self.indicator_value == NULL_STRING

    @property
    def is_other_indicator(self) -> bool:
        return self.indicator_value == OTHER_STRING

    def column_name(self) -> str:
        parts = [self.parent_feature_name]
        if self.grouping is not None and self.grouping != self.parent_feature_name:
            parts.append(self.grouping)
        if self.indicator_value is not None:
            parts.append(self.indicator_value)
        elif self.descriptor_value is not None:
            parts.append(self.descriptor_value)
        return "_".join(parts) + f"_{self.index}"

    def pretty_name(self) -> str:
        """Human-facing name used by ModelInsights tables, e.g. sex = "female"."""
        base = self.grouping or self.parent_feature_name
        if self.indicator_value == NULL_STRING:
            return f"{base} = null"
        if self.indicator_value is not None:
            return f'{base} = "{self.indicator_value}"'
        if self.descriptor_value is not None:
            return f"{base} ({self.descriptor_value})"
        return base

    def to_json(self) -> dict:
        return {
            "parent_feature_name": self.parent_feature_name,
            "parent_feature_type": self.parent_feature_type,
            "grouping": self.grouping,
            "indicator_value": self.indicator_value,
            "descriptor_value": self.descriptor_value,
            "index": self.index,
        }

    @staticmethod
    def from_json(d: dict) -> "VectorColumnMeta":
        return VectorColumnMeta(**d)


@dataclass(frozen=True)
class VectorMetadata:
    """Metadata for a whole OPVector feature: ordered column provenance."""

    name: str
    columns: tuple[VectorColumnMeta, ...] = field(default_factory=tuple)

    @property
    def size(self) -> int:
        return len(self.columns)

    def reindexed(self) -> "VectorMetadata":
        # no-op fast path: fitted pipelines rebuild identical metadata on
        # EVERY transform call (row scoring pays ~1500 dataclass copies
        # per row without it - profiled 70 rows/s -> the dominant cost)
        if all(c.index == i for i, c in enumerate(self.columns)):
            return self
        cols = tuple(replace(c, index=i) for i, c in enumerate(self.columns))
        return VectorMetadata(self.name, cols)

    @staticmethod
    def combine(name: str, metas: Sequence["VectorMetadata"]) -> "VectorMetadata":
        """Concatenate metadata of several vectors (VectorsCombiner semantics,
        reference: core/.../impl/feature/VectorsCombiner.scala:47-82)."""
        cols: list[VectorColumnMeta] = []
        for m in metas:
            cols.extend(m.columns)
        return VectorMetadata(name, tuple(cols)).reindexed()

    def select(self, indices: Sequence[int]) -> "VectorMetadata":
        cols = tuple(self.columns[i] for i in indices)
        return VectorMetadata(self.name, cols).reindexed()

    def column_names(self) -> list[str]:
        return [c.column_name() for c in self.columns]

    def column_history(self, features: Optional[dict] = None) -> list[dict]:
        """Per-column lineage records (counterpart of OpVectorColumnHistory,
        reference: features/.../utils/spark/OpVectorColumnMetadata.scala +
        OpVectorColumnHistory): provenance fields plus, when a
        {feature_name: Feature} mapping is supplied, the origin raw
        features and stage uids that produced each column's parent."""
        out = []
        for c in self.columns:
            entry = {
                "columnName": c.column_name(),
                "parentFeatureName": c.parent_feature_name,
                "parentFeatureType": c.parent_feature_type,
                "grouping": c.grouping,
                "indicatorValue": c.indicator_value,
                "descriptorValue": c.descriptor_value,
                "index": c.index,
            }
            feat = (features or {}).get(c.parent_feature_name)
            if feat is not None and hasattr(feat, "history"):
                entry.update(feat.history())
            out.append(entry)
        return out

    def grouping_indices(self) -> dict[tuple[str, str], list[int]]:
        """Indices of indicator columns per (parent, grouping) categorical
        group - used by SanityChecker's Cramer's V contingency tables."""
        groups: dict[tuple[str, str], list[int]] = {}
        for i, c in enumerate(self.columns):
            if c.indicator_value is not None:
                key = (c.parent_feature_name, c.grouping or c.parent_feature_name)
                groups.setdefault(key, []).append(i)
        return groups

    def to_json(self) -> dict:
        return {"name": self.name, "columns": [c.to_json() for c in self.columns]}

    @staticmethod
    def from_json(d: dict) -> "VectorMetadata":
        return VectorMetadata(
            d["name"], tuple(VectorColumnMeta.from_json(c) for c in d["columns"])
        )
