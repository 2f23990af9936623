"""Scaling and imputation stages on single numeric features.

Counterpart of ``transmogrifai_tpu/ops/scalers.py``: OpScalarStandardScaler,
FillMissingWithMean and PercentileCalibrator (reference: core/.../impl/
feature/OpScalarStandardScaler.scala, FillMissingWithMean.scala,
PercentileCalibrator.scala), host numpy in both packages.  The fitted
models lower to numpy (``lower``, the numpy-fused program) and to torch
(``lower_torch``, the device program).  The standard scaler and the mean
imputer are ``streaming_fittable``: the workflow's streaming ingest
accumulates their per-chunk moments while shards parse and their next
fit takes the merged moments.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from ..stages.base import (
    MASK_SUFFIX,
    Estimator,
    Lowering,
    TorchLowering,
    Transformer,
)
from ..types.columns import Column, NumericColumn
from ..types.dataset import Dataset
from ..types.feature_types import Real, RealNN
from ..utils.masked_stats import masked_mean


class _ScaleModel(Transformer):
    input_types = [Real]
    output_type = RealNN

    def __init__(self, mean: float, std: float, **kw) -> None:
        super().__init__(**kw)
        self.mean = mean
        self.std = std

    def transform_columns(self, cols: Sequence[Column], ds: Dataset) -> Column:
        (c,) = cols
        assert isinstance(c, NumericColumn)
        vals = (c.values - self.mean) / (self.std if self.std > 0 else 1.0)
        return NumericColumn(np.where(c.mask, vals, 0.0), c.mask, RealNN)

    def _lowering(self, where, cls):
        (feat,) = self.input_features
        name, out = feat.name, self.output_name
        mean = self.mean
        std = self.std if self.std > 0 else 1.0

        def fn(env: dict) -> dict:
            vals, mask = env[name], env[name + MASK_SUFFIX]
            return {out: where(mask, (vals - mean) / std, 0.0),
                    out + MASK_SUFFIX: mask}

        return cls(
            fn=fn, inputs=(name, name + MASK_SUFFIX),
            outputs=(out, out + MASK_SUFFIX),
            signature={out: "float64[n]", out + MASK_SUFFIX: "bool[n]"},
        )

    def lower(self):
        return self._lowering(np.where, Lowering)

    def lower_torch(self):
        return self._lowering(torch.where, TorchLowering)


class OpScalarStandardScaler(Estimator):
    """z-normalization (reference: OpScalarStandardScaler.scala)."""

    input_types = [Real]
    output_type = RealNN
    streaming_fittable = True

    def __init__(self, with_mean: bool = True, with_std: bool = True, **kw) -> None:
        super().__init__(**kw)
        self.with_mean = with_mean
        self.with_std = with_std

    def partial_fit_chunk(self, cols: Sequence[Column], ds: Dataset):
        """Mergeable moments (n, Σx, Σx²) of the present values."""
        (c,) = cols
        present = c.values[c.mask]
        return (int(present.size), float(present.sum()),
                float(np.square(present).sum()))

    def _merge_partial_fits(self, stats: list):
        n = sum(s[0] for s in stats)
        sx = sum(s[1] for s in stats)
        sxx = sum(s[2] for s in stats)
        return (n, sx, sxx)

    def fit_model(self, cols: Sequence[Column], ds: Dataset):
        streamed = self._take_streamed()
        if streamed is not None:
            n, sx, sxx = streamed
            mean = sx / n if self.with_mean and n else 0.0
            var = max(sxx / n - (sx / n) ** 2, 0.0) if n else 0.0
            std = float(np.sqrt(var)) if self.with_std and n else 1.0
            return _ScaleModel(float(mean), std)
        (c,) = cols
        assert isinstance(c, NumericColumn)
        present = c.values[c.mask]
        mean = float(present.mean()) if self.with_mean and present.size else 0.0
        std = float(present.std()) if self.with_std and present.size else 1.0
        return _ScaleModel(mean, std)


class _FillMeanModel(Transformer):
    input_types = [Real]
    output_type = RealNN

    def __init__(self, fill: float, **kw) -> None:
        super().__init__(**kw)
        self.fill = fill

    def transform_columns(self, cols: Sequence[Column], ds: Dataset) -> Column:
        (c,) = cols
        assert isinstance(c, NumericColumn)
        vals = np.where(c.mask, c.values, self.fill)
        return NumericColumn(vals, np.ones(len(c), dtype=bool), RealNN)

    def lower(self):
        (feat,) = self.input_features
        name, out = feat.name, self.output_name
        fill = self.fill

        def fn(env: dict) -> dict:
            vals, mask = env[name], env[name + MASK_SUFFIX]
            return {out: np.where(mask, vals, fill),
                    out + MASK_SUFFIX: np.ones(len(vals), dtype=bool)}

        return Lowering(
            fn=fn, inputs=(name, name + MASK_SUFFIX),
            outputs=(out, out + MASK_SUFFIX),
            signature={out: "float64[n]", out + MASK_SUFFIX: "bool[n]"},
        )

    def lower_torch(self):
        (feat,) = self.input_features
        name, out = feat.name, self.output_name
        fill = float(self.fill)

        def fn(env: dict) -> dict:
            vals, mask = env[name], env[name + MASK_SUFFIX]
            return {out: torch.where(mask, vals, fill),
                    out + MASK_SUFFIX: torch.ones_like(mask)}

        return TorchLowering(
            fn=fn, inputs=(name, name + MASK_SUFFIX),
            outputs=(out, out + MASK_SUFFIX),
            signature={out: "float64[n]", out + MASK_SUFFIX: "bool[n]"},
        )


class FillMissingWithMean(Estimator):
    """Real -> RealNN mean imputation (reference: FillMissingWithMean.scala)."""

    input_types = [Real]
    output_type = RealNN
    streaming_fittable = True

    def __init__(self, default: float = 0.0, **kw) -> None:
        super().__init__(**kw)
        self.default = default

    def partial_fit_chunk(self, cols: Sequence[Column], ds: Dataset):
        """Mergeable (n_present, Σx) of the present values."""
        (c,) = cols
        present = c.values[c.mask]
        return (int(present.size), float(present.sum()))

    def _merge_partial_fits(self, stats: list):
        return (sum(s[0] for s in stats), sum(s[1] for s in stats))

    def fit_model(self, cols: Sequence[Column], ds: Dataset):
        streamed = self._take_streamed()
        if streamed is not None:
            n, sx = streamed
            return _FillMeanModel(sx / n if n else self.default)
        (c,) = cols
        assert isinstance(c, NumericColumn)
        return _FillMeanModel(masked_mean(c.values, c.mask, self.default))


class _PercentileModel(Transformer):
    input_types = [Real]
    output_type = RealNN

    def __init__(self, splits: np.ndarray, buckets: int, **kw) -> None:
        super().__init__(**kw)
        self.splits = np.asarray(splits)
        self.buckets = buckets

    def transform_columns(self, cols: Sequence[Column], ds: Dataset) -> Column:
        (c,) = cols
        assert isinstance(c, NumericColumn)
        ranks = np.searchsorted(self.splits, c.values, side="right")
        scaled = ranks.astype(np.float64) * (99.0 / max(len(self.splits), 1))
        return NumericColumn(
            np.where(c.mask, np.clip(scaled, 0, 99), 0.0), c.mask, RealNN
        )

    def lower(self):
        (feat,) = self.input_features
        name, out = feat.name, self.output_name
        splits = self.splits
        scale = 99.0 / max(len(self.splits), 1)

        def fn(env: dict) -> dict:
            vals, mask = env[name], env[name + MASK_SUFFIX]
            ranks = np.searchsorted(splits, vals, side="right")
            scaled = ranks.astype(np.float64) * scale
            return {out: np.where(mask, np.clip(scaled, 0, 99), 0.0),
                    out + MASK_SUFFIX: mask}

        return Lowering(
            fn=fn, inputs=(name, name + MASK_SUFFIX),
            outputs=(out, out + MASK_SUFFIX),
            signature={out: "float64[n]", out + MASK_SUFFIX: "bool[n]"},
        )

    def lower_torch(self):
        (feat,) = self.input_features
        name, out = feat.name, self.output_name
        splits = np.asarray(self.splits, dtype=np.float64)
        scale = 99.0 / max(len(self.splits), 1)
        on_device: dict = {}  # device -> the splits tensor there

        def fn(env: dict) -> dict:
            vals, mask = env[name], env[name + MASK_SUFFIX]
            if len(splits):
                edges = on_device.get(vals.device)
                if edges is None:
                    edges = on_device[vals.device] = torch.as_tensor(
                        splits, device=vals.device)
                # numpy's searchsorted ranks NaN after every finite edge;
                # torch's binary search would not - map NaN to +inf
                safe = torch.where(torch.isnan(vals), torch.inf, vals)
                ranks = torch.searchsorted(edges, safe, right=True)
            else:
                ranks = torch.zeros_like(vals, dtype=torch.int64)
            scaled = ranks.to(torch.float64) * scale
            return {out: torch.where(mask, torch.clamp(scaled, 0, 99), 0.0),
                    out + MASK_SUFFIX: mask}

        return TorchLowering(
            fn=fn, inputs=(name, name + MASK_SUFFIX),
            outputs=(out, out + MASK_SUFFIX),
            signature={out: "float64[n]", out + MASK_SUFFIX: "bool[n]"},
        )


class PercentileCalibrator(Estimator):
    """Map scores into 0-99 percentile buckets (reference:
    PercentileCalibrator.scala)."""

    input_types = [Real]
    output_type = RealNN

    def __init__(self, buckets: int = 100, **kw) -> None:
        super().__init__(**kw)
        self.buckets = buckets

    def fit_model(self, cols: Sequence[Column], ds: Dataset):
        (c,) = cols
        assert isinstance(c, NumericColumn)
        present = c.values[c.mask]
        qs = np.linspace(0, 1, self.buckets + 1)[1:-1]
        splits = np.quantile(present, qs) if present.size else np.array([])
        return _PercentileModel(np.unique(splits), self.buckets)
