"""Numeric bucketizers, including supervised decision-tree bucketizing.

Counterparts of NumericBucketizer / DecisionTreeNumericBucketizer of
``transmogrifai_tpu/ops/bucketizers.py`` (reference: core/.../impl/feature/
NumericBucketizer.scala, DecisionTreeNumericBucketizer.scala): the
supervised variant fits a single-feature decision tree against the label
on the stage's ``device`` and keeps the split points only when total info
gain >= min_info_gain - reusing the histogram tree learner (one [n, 1]
fit).  The column is binned by kernel K2 (``parallel/kernels.bin_matrix``)
on the device; the JAX package bins it on the host, which gives the same
bins.  ``DecisionTreeNumericMapBucketizer`` fits one such tree per key of
a numeric map, each key's column binned by K2 alike.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from ..models.tree_kernel import bins_device_dtype, fit_tree, quantile_bin_edges
from ..obs import trace as _obs_trace
from ..parallel.kernels import bin_matrix
from ..stages.base import Estimator, Transformer
from ..types.columns import Column, NumericColumn, VectorColumn
from ..types.dataset import Dataset
from ..types.feature_types import OPNumeric, OPVector, RealNN
from ..types.vector_metadata import NULL_STRING, VectorColumnMeta, VectorMetadata
from ..utils.device import resolve_device


def _bucket_vector(
    values: np.ndarray,
    mask: np.ndarray,
    splits: Sequence[float],
    track_nulls: bool,
    feat_name: str,
    feat_type: str,
    out_name: str,
) -> Column:
    splits = list(splits)
    n_buckets = len(splits) + 1
    which = np.searchsorted(splits, values, side="right")
    width = n_buckets + (1 if track_nulls else 0)
    arr = np.zeros((len(values), width), dtype=np.float32)
    rows = np.arange(len(values))
    arr[rows[mask], which[mask]] = 1.0
    labels = []
    edges = [-np.inf] + splits + [np.inf]
    for i in range(n_buckets):
        labels.append(f"[{edges[i]:.4g}-{edges[i+1]:.4g})")
    metas = [
        VectorColumnMeta(
            parent_feature_name=feat_name,
            parent_feature_type=feat_type,
            grouping=feat_name,
            indicator_value=lab,
        )
        for lab in labels
    ]
    if track_nulls:
        arr[:, -1] = (~mask).astype(np.float32)
        metas.append(
            VectorColumnMeta(
                parent_feature_name=feat_name,
                parent_feature_type=feat_type,
                grouping=feat_name,
                indicator_value=NULL_STRING,
            )
        )
    return VectorColumn(arr, VectorMetadata(out_name, tuple(metas)).reindexed())


class NumericBucketizerModel(Transformer):
    output_type = OPVector

    def __init__(self, splits: Sequence[float], track_nulls: bool, **kw) -> None:
        super().__init__(**kw)
        self.splits = list(splits)
        self.track_nulls = track_nulls

    def transform_columns(self, cols: Sequence[Column], ds: Dataset) -> Column:
        col = cols[-1]
        assert isinstance(col, NumericColumn)
        feat = self.input_features[-1]
        return _bucket_vector(
            col.values, col.mask, self.splits, self.track_nulls,
            feat.name, feat.ftype.type_name(), self.output_name,
        )


class NumericBucketizer(Transformer):
    """Fixed-split bucketizing (reference: NumericBucketizer.scala)."""

    input_types = [OPNumeric]
    output_type = OPVector

    def __init__(self, splits: Sequence[float], track_nulls: bool = True, **kw):
        super().__init__(**kw)
        self.splits = list(splits)
        self.track_nulls = track_nulls

    def transform_columns(self, cols: Sequence[Column], ds: Dataset) -> Column:
        (col,) = cols
        assert isinstance(col, NumericColumn)
        feat = self.input_features[0]
        return _bucket_vector(
            col.values, col.mask, self.splits, self.track_nulls,
            feat.name, feat.ftype.type_name(), self.output_name,
        )


class DecisionTreeNumericBucketizer(Estimator):
    """Supervised bucketizing: single-feature decision-tree splits vs the
    label, kept only if the tree finds gain >= min_info_gain (reference:
    DecisionTreeNumericBucketizer.scala - maxDepth 4ish, minInfoGain 0.01).
    The tree grows on ``device`` (``"cuda"`` by default; ``OpWorkflow``
    sets it to its own)."""

    input_types = [RealNN, OPNumeric]
    output_type = OPVector

    def __init__(
        self,
        max_depth: int = 4,
        max_bins: int = 32,
        min_info_gain: float = 0.01,
        min_instances_per_node: int = 1,
        track_nulls: bool = True,
        device: str = "cuda",
        **kw,
    ) -> None:
        super().__init__(**kw)
        self.max_depth = max_depth
        self.max_bins = max_bins
        self.min_info_gain = min_info_gain
        self.min_instances_per_node = min_instances_per_node
        self.track_nulls = track_nulls
        self.device = str(device)

    def fit_model(self, cols: Sequence[Column], ds: Dataset):
        label, col = cols
        assert isinstance(label, NumericColumn) and isinstance(col, NumericColumn)
        y = np.asarray(label.values, dtype=np.float64)
        splits = _tree_splits(
            y[col.mask], col.values[col.mask],
            self.max_depth, self.max_bins,
            self.min_info_gain, self.min_instances_per_node,
            resolve_device(self.device),
        )
        model = NumericBucketizerModel(splits, self.track_nulls)
        model.metadata = {"splits": splits, "should_split": bool(splits)}
        self.metadata = model.metadata
        return model


def _tree_splits(
    yv: np.ndarray,
    xv: np.ndarray,
    max_depth: int,
    max_bins: int,
    min_info_gain: float,
    min_instances_per_node: int,
    device: torch.device,
) -> list[float]:
    """Split thresholds of a single-feature decision tree of (x -> label),
    grown on ``device``."""
    x = np.asarray(xv, np.float32).reshape(-1, 1)
    splits: list[float] = []
    if x.size:
        # the host's part of a fit: labels, stat rows and quantile edges
        with _obs_trace.span("bucketize.prep", n=int(x.shape[0])):
            classes = np.unique(yv)
            is_cls = len(classes) <= 20
            if is_cls:
                onehot = (yv[:, None] == classes[None, :]).astype(np.float32)
                stats = np.concatenate(
                    [np.ones((len(yv), 1), np.float32), onehot], axis=1
                )
                imp, C = "gini", stats.shape[1]
            else:
                stats = np.stack(
                    [np.ones_like(yv), yv, yv * yv], axis=1
                ).astype(np.float32)
                imp, C = "variance", 3
            edges = quantile_bin_edges(x, max_bins)
        bins = bin_matrix(
            torch.tensor(x, device=device),
            torch.tensor(np.ascontiguousarray(edges), device=device),
            bins_device_dtype(max_bins),
        )
        hf, ht, hl, hv = fit_tree(
            bins, torch.tensor(stats, device=device),
            torch.ones(len(yv), dtype=torch.float32, device=device),
            torch.ones((1,), dtype=torch.bool, device=device),
            max_depth, max_bins, imp, C,
            float(min_instances_per_node), float(min_info_gain),
        )
        hf, ht, hl = (h.cpu().numpy() for h in (hf, ht, hl))
        for node in range(len(hf)):
            if not hl[node] and ht[node] < len(edges[0]):
                splits.append(float(edges[0][ht[node]]))
    return sorted(set(splits))


class DecisionTreeNumericMapBucketizerModel(Transformer):
    """Fitted per-key supervised bucketizer for numeric maps: keys that
    found informative splits emit bucket one-hots; all fitted keys emit a
    null indicator when track_nulls (reference:
    DecisionTreeNumericMapBucketizer.scala:131 model transformFn)."""

    output_type = OPVector

    def __init__(self, splits_by_key: dict, should_split_by_key: dict,
                 track_nulls: bool = True, clean_keys: bool = True,
                 **kw) -> None:
        super().__init__(**kw)
        self.splits_by_key = dict(splits_by_key)
        self.should_split_by_key = dict(should_split_by_key)
        self.track_nulls = track_nulls
        self.clean_keys = clean_keys

    def transform_columns(self, cols: Sequence[Column], ds: Dataset) -> Column:
        from ..types.columns import MapColumn

        col = cols[-1]
        assert isinstance(col, MapColumn)
        feat = self.input_features[-1]
        n = len(col)
        keys = sorted(self.splits_by_key)
        # one cleaning pass per row (not per row per key)
        cleaned_rows = [
            {
                (kk.strip() if self.clean_keys else kk): vv
                for kk, vv in m.items()
            }
            for m in col.values
        ]
        arrays: list[np.ndarray] = []
        metas: list[VectorColumnMeta] = []
        for k in keys:
            vals = np.zeros(n, dtype=np.float64)
            mask = np.zeros(n, dtype=bool)
            for r, cleaned in enumerate(cleaned_rows):
                v = cleaned.get(k)
                if v is not None:
                    vals[r] = float(v)
                    mask[r] = True
            if self.should_split_by_key.get(k):
                block = _bucket_vector(
                    vals, mask, self.splits_by_key[k], self.track_nulls,
                    feat.name, feat.ftype.type_name(), self.output_name,
                )
                arr, ms = block.values, list(block.metadata.columns)
                # per-key grouping: _bucket_vector stamps the parent name
                ms = [
                    VectorColumnMeta(
                        parent_feature_name=feat.name,
                        parent_feature_type=feat.ftype.type_name(),
                        grouping=k,
                        indicator_value=m.indicator_value,
                    )
                    for m in ms
                ]
            elif self.track_nulls:
                arr = (~mask).astype(np.float32)[:, None]
                ms = [
                    VectorColumnMeta(
                        parent_feature_name=feat.name,
                        parent_feature_type=feat.ftype.type_name(),
                        grouping=k,
                        indicator_value=NULL_STRING,
                    )
                ]
            else:
                continue
            arrays.append(np.asarray(arr, np.float32))
            metas.extend(ms)
        values = (
            np.concatenate(arrays, axis=1)
            if arrays
            else np.zeros((n, 0), dtype=np.float32)
        )
        meta = VectorMetadata(self.output_name, tuple(metas)).reindexed()
        return VectorColumn(values, meta)


class DecisionTreeNumericMapBucketizer(Estimator):
    """Supervised bucketizing of every key of a numeric map against the
    label, one single-feature tree per key (reference:
    DecisionTreeNumericMapBucketizer.scala:56), each grown on ``device``
    (``"cuda"`` by default; ``OpWorkflow`` sets it to its own)."""

    input_types = None  # (RealNN label, numeric OPMap)
    output_type = OPVector

    def __init__(
        self,
        max_depth: int = 4,
        max_bins: int = 32,
        min_info_gain: float = 0.01,
        min_instances_per_node: int = 1,
        track_nulls: bool = True,
        clean_keys: bool = True,
        device: str = "cuda",
        **kw,
    ) -> None:
        super().__init__(**kw)
        self.max_depth = max_depth
        self.max_bins = max_bins
        self.min_info_gain = min_info_gain
        self.min_instances_per_node = min_instances_per_node
        self.track_nulls = track_nulls
        self.clean_keys = clean_keys
        self.device = str(device)

    def fit_model(self, cols: Sequence[Column], ds: Dataset):
        from ..types.columns import MapColumn

        label, col = cols
        assert isinstance(label, NumericColumn) and isinstance(col, MapColumn)
        y = np.asarray(label.values, dtype=np.float64)
        keyed: dict[str, tuple[list[float], list[float]]] = {}
        for r, m in enumerate(col.values):
            for kk, vv in m.items():
                if vv is None:
                    continue
                k = kk.strip() if self.clean_keys else kk
                xs, ys = keyed.setdefault(k, ([], []))
                xs.append(float(vv))
                ys.append(y[r])
        device = resolve_device(self.device)
        splits_by_key: dict[str, list[float]] = {}
        should_split: dict[str, bool] = {}
        for k in sorted(keyed):
            xs, ys = keyed[k]
            splits = _tree_splits(
                np.asarray(ys), np.asarray(xs),
                self.max_depth, self.max_bins,
                self.min_info_gain, self.min_instances_per_node, device,
            )
            splits_by_key[k] = splits
            should_split[k] = bool(splits)
        model = DecisionTreeNumericMapBucketizerModel(
            splits_by_key, should_split, self.track_nulls, self.clean_keys
        )
        model.metadata = {
            "splits_by_key": splits_by_key,
            "should_split_by_key": should_split,
        }
        self.metadata = model.metadata
        return model
