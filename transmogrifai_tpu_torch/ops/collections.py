"""Collection/map utility transformers.

Counterparts of FilterMap / ToOccurTransformer / OPCollectionTransformer /
ScalerTransformer / DescalerTransformer / IsotonicRegressionCalibrator
(reference: core/.../impl/feature/FilterMap.scala, ToOccurTransformer.scala,
OPCollectionTransformer.scala, ScalerTransformer.scala,
core/.../impl/regression/IsotonicRegressionCalibrator.scala).
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence

import numpy as np

from ..stages.base import Estimator, Transformer
from ..types.columns import (
    Column,
    ListColumn,
    MapColumn,
    NumericColumn,
    PredictionColumn,
    TextColumn,
)
from ..types.dataset import Dataset
from ..types.feature_types import (
    Binary,
    FeatureType,
    OPMap,
    Prediction,
    Real,
    RealNN,
)


class FilterMap(Transformer):
    """Allow/block map keys (and optionally values) (reference:
    FilterMap.scala)."""

    input_types = [OPMap]

    def __init__(
        self,
        allow_keys: Optional[Sequence[str]] = None,
        block_keys: Sequence[str] = (),
        clean_keys: bool = True,
        **kw,
    ) -> None:
        super().__init__(**kw)
        self.allow_keys = set(allow_keys) if allow_keys is not None else None
        self.block_keys = set(block_keys)
        self.clean_keys = clean_keys

    def set_input(self, *features):
        super().set_input(*features)
        self.output_type = features[0].ftype
        return self

    def transform_columns(self, cols: Sequence[Column], ds: Dataset) -> Column:
        (col,) = cols
        assert isinstance(col, MapColumn)

        def keep(k: str) -> bool:
            kk = k.strip() if self.clean_keys else k
            if kk in self.block_keys:
                return False
            return self.allow_keys is None or kk in self.allow_keys

        return MapColumn(
            [{k: v for k, v in d.items() if keep(k)} for d in col.values],
            col.feature_type,
        )


class ToOccurTransformer(Transformer):
    """Any feature -> Binary 'occurred' indicator (reference:
    ToOccurTransformer.scala - value present & non-empty -> 1)."""

    output_type = Binary

    def __init__(self, matches: Optional[Callable] = None, **kw) -> None:
        super().__init__(**kw)
        self.matches = matches

    def transform_columns(self, cols: Sequence[Column], ds: Dataset) -> Column:
        (col,) = cols
        if self.matches is not None:
            vals = [self.matches(v) for v in col.to_list()]
        elif isinstance(col, NumericColumn):
            vals = [(bool(m) and v != 0) for v, m in zip(col.values, col.mask)]
        elif isinstance(col, (TextColumn,)):
            vals = [v is not None for v in col.values]
        elif isinstance(col, (ListColumn, MapColumn)):
            vals = [bool(v) for v in col.values]
        else:
            vals = [True] * len(col)
        return NumericColumn(
            np.array([float(bool(v)) for v in vals]),
            np.ones(len(col), dtype=bool),
            Binary,
        )


class ScalerTransformer(Transformer):
    """Invertible scaling with the scaling args recorded in metadata so a
    descaler can round-trip them (reference: ScalerTransformer.scala -
    linear/log scalers carried through metadata)."""

    input_types = [Real]
    output_type = RealNN

    def __init__(self, scaling_type: str = "linear", slope: float = 1.0,
                 intercept: float = 0.0, **kw) -> None:
        super().__init__(**kw)
        self.scaling_type = scaling_type
        self.slope = slope
        self.intercept = intercept
        self.metadata = {
            "scaler": {
                "scaling_type": scaling_type,
                "slope": slope,
                "intercept": intercept,
            }
        }

    def transform_columns(self, cols: Sequence[Column], ds: Dataset) -> Column:
        (col,) = cols
        assert isinstance(col, NumericColumn)
        if self.scaling_type == "linear":
            vals = self.slope * col.values + self.intercept
        elif self.scaling_type == "log":
            vals = np.where(col.values > 0, np.log(np.maximum(col.values, 1e-300)), 0.0)
        else:
            raise ValueError(f"unknown scaling_type {self.scaling_type!r}")
        return NumericColumn(np.where(col.mask, vals, 0.0), col.mask, RealNN)


def _descale(values: np.ndarray, info: dict) -> np.ndarray:
    """Inverse of ScalerTransformer's forward map, from its recorded
    metadata - shared by DescalerTransformer and PredictionDescaler."""
    if info["scaling_type"] == "linear":
        slope = info["slope"] or 1.0
        return (values - info["intercept"]) / slope
    if info["scaling_type"] == "log":
        return np.exp(values)
    raise ValueError(f"unknown scaling_type {info['scaling_type']!r}")


def _scaler_info(feature, what: str) -> dict:
    origin = feature.origin_stage
    info = (origin.metadata if origin else {}).get("scaler")
    if info is None:
        raise ValueError(f"{what} input has no scaler metadata")
    return info


class DescalerTransformer(Transformer):
    """Inverse of ScalerTransformer: reads the scaler args from the scaled
    feature's origin stage metadata (reference: DescalerTransformer.scala).
    Inputs: (value_to_descale, scaled_feature_carrying_metadata)."""

    input_types = [Real, Real]
    output_type = RealNN

    def transform_columns(self, cols: Sequence[Column], ds: Dataset) -> Column:
        val, _ = cols
        assert isinstance(val, NumericColumn)
        info = _scaler_info(self.input_features[1], "descaler")
        vals = _descale(val.values, info)
        return NumericColumn(np.where(val.mask, vals, 0.0), val.mask, RealNN)


class IsotonicRegressionCalibrator(Estimator):
    """Monotone score calibration via pool-adjacent-violators (reference:
    IsotonicRegressionCalibrator.scala wrapping Spark IsotonicRegression)."""

    input_types = [RealNN, Real]
    output_type = RealNN

    def __init__(self, isotonic: bool = True, **kw) -> None:
        super().__init__(**kw)
        self.isotonic = isotonic

    def fit_model(self, cols: Sequence[Column], ds: Dataset):
        label, score = cols
        assert isinstance(label, NumericColumn) and isinstance(score, NumericColumn)
        y = np.asarray(label.values, dtype=np.float64)
        x = np.asarray(score.values, dtype=np.float64)
        if not self.isotonic:
            y = -y
        order = np.argsort(x, kind="stable")
        xs, ys = x[order], y[order]
        # pool adjacent violators
        vals = list(ys)
        wts = [1.0] * len(ys)
        starts = list(range(len(ys)))
        i = 0
        while i < len(vals) - 1:
            if vals[i] > vals[i + 1] + 1e-12:
                merged = (vals[i] * wts[i] + vals[i + 1] * wts[i + 1]) / (
                    wts[i] + wts[i + 1]
                )
                vals[i] = merged
                wts[i] += wts[i + 1]
                del vals[i + 1], wts[i + 1], starts[i + 1]
                while i > 0 and vals[i - 1] > vals[i] + 1e-12:
                    merged = (vals[i - 1] * wts[i - 1] + vals[i] * wts[i]) / (
                        wts[i - 1] + wts[i]
                    )
                    vals[i - 1] = merged
                    wts[i - 1] += wts[i]
                    del vals[i], wts[i], starts[i]
                    i -= 1
            else:
                i += 1
        boundaries = xs[starts]
        predictions = np.array(vals)
        if not self.isotonic:
            predictions = -predictions
        return _IsotonicModel(boundaries, predictions)


class _IsotonicModel(Transformer):
    input_types = [RealNN, Real]
    output_type = RealNN

    def __init__(self, boundaries: np.ndarray, predictions: np.ndarray, **kw):
        super().__init__(**kw)
        self.boundaries = np.asarray(boundaries)
        self.predictions = np.asarray(predictions)

    def transform_columns(self, cols: Sequence[Column], ds: Dataset) -> Column:
        score = cols[-1]
        assert isinstance(score, NumericColumn)
        x = score.values
        if len(self.boundaries) == 0:
            vals = np.zeros_like(x)
        else:
            idx = np.clip(
                np.searchsorted(self.boundaries, x, side="right") - 1,
                0, len(self.predictions) - 1,
            )
            vals = self.predictions[idx]
        return NumericColumn(vals, np.ones(len(score), bool), RealNN)


class PredictionDescaler(Transformer):
    """Applies the inverse of the scaling recorded on the 2nd input's
    origin ScalerTransformer to the Prediction's predicted value — the
    regression-on-scaled-label round-trip (reference:
    DescalerTransformer.scala:92 PredictionDescaler).
    Inputs: (prediction, scaled_feature_carrying_metadata)."""

    input_types = [Prediction, Real]
    output_type = RealNN

    def transform_columns(self, cols: Sequence[Column], ds: Dataset) -> Column:
        pred, _ = cols
        assert isinstance(pred, PredictionColumn)
        info = _scaler_info(self.input_features[1], "prediction descaler")
        out = _descale(np.asarray(pred.prediction, dtype=np.float64), info)
        return NumericColumn(out, np.ones(len(out), bool), RealNN)
