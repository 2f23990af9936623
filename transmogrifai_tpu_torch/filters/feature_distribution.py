"""Per-feature distribution summaries for RawFeatureFilter.

Host copy of ``transmogrifai_tpu/filters/feature_distribution.py`` (the
schema contract and the RawFeatureFilter read these summaries).  Counterpart of FeatureDistribution / PreparedFeatures / Summary (reference:
core/.../filters/FeatureDistribution.scala:286, PreparedFeatures.scala,
Summary.scala): for each raw feature (and each key of map features) track
count, null count, and a fixed-width histogram - numerics bin by value
range, text by murmur3 hash bucket.  Distributions are monoid-mergeable
(the reference reduces them over Spark partitions; here a partition is a
columnar chunk).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from functools import lru_cache
from typing import Optional

import numpy as np

from ..types.columns import (
    Column,
    GeolocationColumn,
    ListColumn,
    MapColumn,
    NumericColumn,
    TextColumn,
    VectorColumn,
)
from ..utils.hashing import murmur3_32


@dataclass
class FeatureDistribution:
    name: str
    key: Optional[str]  # map key, None for scalar features
    count: int
    nulls: int
    histogram: np.ndarray  # [n_bins]
    moments: tuple = (0.0, 0.0)  # (sum, sum_sq) of numeric values
    value_range: Optional[tuple] = None  # numeric bin range (train Summary)

    @property
    def fill_rate(self) -> float:
        return 1.0 - self.nulls / self.count if self.count else 0.0

    def merge(self, other: "FeatureDistribution") -> "FeatureDistribution":
        assert (self.name, self.key) == (other.name, other.key)
        # bin ranges must agree for histograms to be addable; mismatched
        # ranges (a score-side dist built without the train Summary) keep
        # None so js_divergence consumers can see the ranges diverged
        vr = self.value_range if self.value_range == other.value_range else None
        return FeatureDistribution(
            name=self.name,
            key=self.key,
            count=self.count + other.count,
            nulls=self.nulls + other.nulls,
            histogram=self.histogram + other.histogram,
            moments=(
                self.moments[0] + other.moments[0],
                self.moments[1] + other.moments[1],
            ),
            value_range=vr,
        )

    def js_divergence(self, other: "FeatureDistribution") -> float:
        """Jensen-Shannon divergence of normalized histograms (reference:
        FeatureDistribution.jsDivergence)."""
        p = self.histogram / max(self.histogram.sum(), 1e-12)
        q = other.histogram / max(other.histogram.sum(), 1e-12)
        m = 0.5 * (p + q)

        def kl(a, b):
            mask = a > 0
            return float(np.sum(a[mask] * np.log2(a[mask] / np.maximum(b[mask], 1e-12))))

        return 0.5 * kl(p, m) + 0.5 * kl(q, m)

    def to_json(self) -> dict:
        return {
            "name": self.name,
            "key": self.key,
            "count": self.count,
            "nulls": self.nulls,
            "fill_rate": self.fill_rate,
            "histogram": self.histogram.tolist(),
            "moments": list(self.moments),
            "value_range": (
                None if self.value_range is None else list(self.value_range)
            ),
        }

    @staticmethod
    def from_json(doc: dict) -> "FeatureDistribution":
        """Inverse of to_json (the schema-contract persistence path,
        schema/contract.py); pre-contract docs without moments/value_range
        still load."""
        return FeatureDistribution(
            name=doc["name"],
            key=doc.get("key"),
            count=int(doc["count"]),
            nulls=int(doc["nulls"]),
            histogram=np.asarray(doc["histogram"], dtype=np.float64),
            moments=tuple(doc.get("moments", (0.0, 0.0))),
            value_range=(
                None if doc.get("value_range") is None
                else tuple(doc["value_range"])
            ),
        )


TEXT_BUCKETS = 100


@lru_cache(maxsize=65536)
def _hash_bucket(v: str) -> int:
    # serve-time drift monitoring hashes every text value per batch;
    # categorical domains are tiny relative to row counts, so memoizing
    # value -> bucket removes the python murmur3 from the hot path
    # (bounded like ops/categorical._clean_cached)
    return murmur3_32(v.encode("utf-8")) % TEXT_BUCKETS


def _hash_buckets(values: list) -> np.ndarray:
    """Each value's bucket: one batch of the host library's murmur3 when
    it is built (a free-text column has about as many distinct values as
    rows, which the memo of ``_hash_bucket`` cannot hold), else the
    memoized python murmur3; both give the same buckets."""
    from ..utils.native import murmur3_batch

    hashed = murmur3_batch(values) if values else None
    if hashed is None:
        return np.fromiter((_hash_bucket(v) for v in values), np.int64,
                           len(values))
    return (hashed % TEXT_BUCKETS).astype(np.int64)


def compute_distribution(
    name: str,
    col: Column,
    n_bins: int = 100,
    value_range: Optional[tuple[float, float]] = None,
    key: Optional[str] = None,
) -> FeatureDistribution:
    """Distribution of one column.  ``value_range`` pins numeric bin edges so
    train and score histograms are comparable (the reference passes the
    training Summary into the scoring pass, Summary.scala)."""
    n = len(col)
    if isinstance(col, NumericColumn):
        present = col.values[col.mask]
        nulls = int(n - col.mask.sum())
        lo, hi = value_range if value_range else (
            (float(present.min()), float(present.max())) if present.size else (0.0, 1.0)
        )
        if hi <= lo:
            hi = lo + 1.0
        hist, _ = np.histogram(present, bins=n_bins, range=(lo, hi))
        # under/overflow bins so out-of-range drift (score data far outside
        # the train range) still shows up in the JS divergence
        under = float((present < lo).sum())
        over = float((present > hi).sum())
        full = np.concatenate([[under], hist.astype(np.float64), [over]])
        return FeatureDistribution(
            name, key, n, nulls, full,
            (float(present.sum()), float((present**2).sum())),
            value_range=(lo, hi),
        )
    if isinstance(col, TextColumn):
        present = [v for v in col.values if v is not None]
        hist = np.bincount(_hash_buckets(present), minlength=TEXT_BUCKETS)
        return FeatureDistribution(name, key, n, n - len(present),
                                   hist.astype(np.float64))
    if isinstance(col, (ListColumn,)):
        hist = np.zeros(TEXT_BUCKETS)
        nulls = 0
        for v in col.values:
            if not v:
                nulls += 1
            else:
                for x in v:
                    hist[_hash_bucket(str(x))] += 1
        return FeatureDistribution(name, key, n, nulls, hist)
    if isinstance(col, GeolocationColumn):
        nulls = int(n - col.mask.sum())
        lat = col.values[col.mask, 0]
        hist, _ = np.histogram(lat, bins=n_bins, range=(-90, 90))
        return FeatureDistribution(name, key, n, nulls, hist.astype(np.float64))
    if isinstance(col, VectorColumn):
        norms = np.linalg.norm(col.values, axis=1)
        hist, _ = np.histogram(norms, bins=n_bins)
        return FeatureDistribution(name, key, n, 0, hist.astype(np.float64))
    raise TypeError(f"no distribution for column type {type(col).__name__}")


def compute_map_distributions(
    name: str, col: MapColumn, n_bins: int = 100
) -> list[FeatureDistribution]:
    """Per-key distributions of a map feature (reference: PreparedFeatures
    key expansion)."""
    out = []
    n = len(col)
    for key in col.all_keys():
        vals = [d.get(key) for d in col.values]
        nulls = sum(1 for v in vals if v is None)
        numeric = all(
            isinstance(v, (int, float)) for v in vals if v is not None
        )
        hist = np.zeros(TEXT_BUCKETS)
        if numeric:
            arr = np.array([float(v) for v in vals if v is not None])
            if arr.size:
                h, _ = np.histogram(arr, bins=TEXT_BUCKETS)
                hist = h.astype(np.float64)
        else:
            for v in vals:
                if v is not None:
                    hist[_hash_bucket(str(v))] += 1
        out.append(FeatureDistribution(name, key, n, nulls, hist))
    return out
