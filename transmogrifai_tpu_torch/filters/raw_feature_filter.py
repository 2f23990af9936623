"""RawFeatureFilter: the data-quality gate ahead of the DAG.

Host copy of ``transmogrifai_tpu/filters/raw_feature_filter.py``
(reference: core/.../filters/RawFeatureFilter.scala:90,135-160 and
FeatureDistribution.scala) over this package's ``filters/
feature_distribution.py``: per raw feature (and per map key) distributions
of the training data and, when a scoring set is given, of the scoring data
(numeric bins pinned to the training range); a feature is dropped for

* a training fill rate below ``min_fill_rate``,
* a fill-rate difference or fill-ratio difference between train and score,
* a Jensen-Shannon divergence between train and score,
* a null-indicator to label correlation (the leakage guard).

Returns ``FilteredRawData`` (the cleaned columns, the blacklists and the
results); ``OpWorkflow`` does the DAG surgery (``_apply_blacklist``, the
reference's OpWorkflow.setBlacklist).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np

from ..features.feature import Feature
from ..types.columns import MapColumn, NumericColumn
from ..types.dataset import Dataset
from .feature_distribution import (
    FeatureDistribution,
    compute_distribution,
    compute_map_distributions,
)


@dataclass
class FilteredRawData:
    clean_data: Dataset
    blacklisted_features: list[Feature]
    blacklisted_map_keys: dict[str, list[str]]
    results: dict


class RawFeatureFilter:
    """Defaults mirror the reference (RawFeatureFilter.scala ctor)."""

    def __init__(
        self,
        scoring_data: Optional[Dataset] = None,
        min_fill_rate: float = 0.001,
        max_fill_difference: float = 0.90,
        max_fill_ratio_diff: float = 20.0,
        max_js_divergence: float = 0.90,
        max_correlation: float = 0.9,
        correlation_exclusion: Sequence[str] = (),
        protected_features: Sequence[str] = (),
        bins: int = 100,
    ) -> None:
        self.scoring_data = scoring_data
        self.min_fill_rate = min_fill_rate
        self.max_fill_difference = max_fill_difference
        self.max_fill_ratio_diff = max_fill_ratio_diff
        self.max_js_divergence = max_js_divergence
        self.max_correlation = max_correlation
        self.correlation_exclusion = set(correlation_exclusion)
        self.protected_features = set(protected_features)
        self.bins = bins

    def _distributions(
        self,
        data: Dataset,
        features: Sequence[Feature],
        range_hints: Optional[dict] = None,
    ) -> dict[tuple[str, Optional[str]], FeatureDistribution]:
        """``range_hints`` pins numeric bin ranges to the training Summary so
        train/score histograms are comparable (reference: Summary.scala passed
        into the scoring pass)."""
        out: dict[tuple[str, Optional[str]], FeatureDistribution] = {}
        hints = range_hints or {}
        for f in features:
            if f.name not in data:
                continue
            col = data[f.name]
            if isinstance(col, MapColumn):
                for dist in compute_map_distributions(f.name, col, self.bins):
                    out[(f.name, dist.key)] = dist
            else:
                dist = compute_distribution(
                    f.name, col, self.bins,
                    value_range=hints.get((f.name, None)),
                )
                out[(f.name, None)] = dist
        return out

    def filter_raw_data(
        self,
        train_data: Dataset,
        raw_features: Sequence[Feature],
        workflow=None,
    ) -> FilteredRawData:
        predictors = [f for f in raw_features if not f.is_response]
        responses = [f for f in raw_features if f.is_response]
        train_dists = self._distributions(train_data, predictors)
        hints = {
            k: d.value_range for k, d in train_dists.items()
            if d.value_range is not None
        }
        score_dists = (
            self._distributions(self.scoring_data, predictors, range_hints=hints)
            if self.scoring_data is not None
            else {}
        )

        reasons: dict[tuple[str, Optional[str]], list[str]] = {}

        def flag(k, why: str) -> None:
            reasons.setdefault(k, []).append(why)

        for k, td in train_dists.items():
            name, key = k
            if name in self.protected_features:
                continue
            if td.fill_rate < self.min_fill_rate:
                flag(k, f"train fill rate {td.fill_rate:.4f} < {self.min_fill_rate}")
            sd = score_dists.get(k)
            if sd is not None and sd.count > 0:
                fill_diff = abs(td.fill_rate - sd.fill_rate)
                if fill_diff > self.max_fill_difference:
                    flag(k, f"fill diff {fill_diff:.3f} > {self.max_fill_difference}")
                if sd.fill_rate > 0 and td.fill_rate > 0:
                    ratio = max(td.fill_rate, sd.fill_rate) / min(
                        td.fill_rate, sd.fill_rate
                    )
                    if ratio > self.max_fill_ratio_diff:
                        flag(k, f"fill ratio {ratio:.2f} > {self.max_fill_ratio_diff}")
                js = td.js_divergence(sd)
                if js > self.max_js_divergence:
                    flag(k, f"JS divergence {js:.3f} > {self.max_js_divergence}")

        # null-indicator <-> label correlation leakage guard (reference:
        # RawFeatureFilter null-label correlation check)
        label = next(
            (
                train_data[r.name]
                for r in responses
                if r.name in train_data and isinstance(train_data[r.name], NumericColumn)
            ),
            None,
        )
        if label is not None:
            y = np.asarray(label.values, dtype=np.float64)
            if np.std(y) > 0:
                for f in predictors:
                    if (
                        f.name in self.correlation_exclusion
                        or f.name in self.protected_features
                        or f.name not in train_data
                    ):
                        continue
                    col = train_data[f.name]
                    if isinstance(col, MapColumn):
                        continue
                    mask = getattr(col, "mask", None)
                    if mask is None:
                        continue
                    null_ind = (~np.asarray(mask, dtype=bool)).astype(np.float64)
                    if null_ind.std() == 0:
                        continue
                    corr = float(np.corrcoef(null_ind, y)[0, 1])
                    if abs(corr) > self.max_correlation:
                        flag(
                            (f.name, None),
                            f"null-label corr {corr:.3f} > {self.max_correlation}",
                        )

        dropped_features = sorted({name for (name, key) in reasons if key is None})
        dropped_map_keys: dict[str, list[str]] = {}
        for (name, key) in reasons:
            if key is not None:
                dropped_map_keys.setdefault(name, []).append(key)

        by_name = {f.name: f for f in predictors}
        blacklisted = [by_name[n] for n in dropped_features if n in by_name]
        clean = train_data.drop(dropped_features)
        # strip dropped map keys in place
        for name, keys in dropped_map_keys.items():
            if name in clean:
                col = clean[name]
                assert isinstance(col, MapColumn)
                gone = set(keys)
                clean = clean.with_column(
                    name,
                    MapColumn(
                        [
                            {k: v for k, v in d.items() if k not in gone}
                            for d in col.values
                        ],
                        col.feature_type,
                    ),
                )

        results = {
            "train_distributions": [d.to_json() for d in train_dists.values()],
            "score_distributions": [d.to_json() for d in score_dists.values()],
            "dropped": {
                f"{name}" + (f"[{key}]" if key else ""): why
                for (name, key), why in reasons.items()
            },
        }
        return FilteredRawData(
            clean_data=clean,
            blacklisted_features=blacklisted,
            blacklisted_map_keys=dropped_map_keys,
            results=results,
        )
