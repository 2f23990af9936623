"""SanityChecker summary metadata.

Counterpart of SanityCheckerMetadata (reference: core/.../impl/preparators/
SanityCheckerMetadata.scala): typed summary written into the stage metadata
channel and consumed by ModelInsights.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional


@dataclass
class ColumnStatistics:
    name: str
    pretty_name: str
    parent: str
    mean: float
    variance: float
    min: float
    max: float
    corr_label: Optional[float]
    cramers_v: Optional[float]
    max_rule_confidence: Optional[float]
    support: Optional[float]
    is_null_indicator: bool
    dropped_reasons: list[str] = field(default_factory=list)

    def to_json(self) -> dict:
        return dict(self.__dict__)

    @staticmethod
    def from_json(d: dict) -> "ColumnStatistics":
        return ColumnStatistics(**d)


@dataclass
class SanityCheckerSummary:
    n_rows: int
    n_features: int
    n_kept: int
    column_stats: list[ColumnStatistics]
    dropped: list[str]
    cramers_v_by_group: dict[str, float]

    def to_json(self) -> dict:
        return {
            "n_rows": self.n_rows,
            "n_features": self.n_features,
            "n_kept": self.n_kept,
            "column_stats": [c.to_json() for c in self.column_stats],
            "dropped": self.dropped,
            "cramers_v_by_group": self.cramers_v_by_group,
        }

    @staticmethod
    def from_json(d: dict) -> "SanityCheckerSummary":
        return SanityCheckerSummary(
            n_rows=d["n_rows"],
            n_features=d["n_features"],
            n_kept=d["n_kept"],
            column_stats=[ColumnStatistics.from_json(c) for c in d["column_stats"]],
            dropped=d["dropped"],
            cramers_v_by_group=d["cramers_v_by_group"],
        )
