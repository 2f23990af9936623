"""Numeric vectorizers: impute + null-track.

Counterparts of RealVectorizer / IntegralVectorizer / BinaryVectorizer /
RealNNVectorizer (reference: core/.../impl/feature/RealVectorizer.scala,
IntegralVectorizer.scala, BinaryVectorizer.scala): each input feature
contributes a filled value column plus (when track_nulls) a null-indicator
column.  Fill strategies: mean (Real), mode (Integral), constant.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from ..stages.base import MASK_SUFFIX
from ..types.columns import Column, NumericColumn
from ..types.dataset import Dataset
from ..types.feature_types import Binary, Integral, Real, RealNN
from ..types.vector_metadata import NULL_STRING, VectorColumnMeta
from ..utils.masked_stats import masked_mean, masked_mode
from .vectorizer_base import SequenceVectorizer, SequenceVectorizerModel


class NumericVectorizerModel(SequenceVectorizerModel):
    def __init__(self, fill_values: Sequence[float], track_nulls: bool, **kw) -> None:
        super().__init__(**kw)
        self.fill_values = list(fill_values)
        self.track_nulls = track_nulls

    def blocks_for(self, col: Column, i: int) -> tuple[np.ndarray, list[VectorColumnMeta]]:
        assert isinstance(col, NumericColumn)
        feat = self.input_features[i]
        filled = np.where(col.mask, col.values, self.fill_values[i])
        blocks = [filled]
        if self.track_nulls:
            blocks.append((~col.mask).astype(np.float64))

        def build():
            tname = feat.ftype.type_name()
            ms = [
                VectorColumnMeta(
                    parent_feature_name=feat.name,
                    parent_feature_type=tname,
                )
            ]
            if self.track_nulls:
                ms.append(
                    VectorColumnMeta(
                        parent_feature_name=feat.name,
                        parent_feature_type=tname,
                        grouping=feat.name,
                        indicator_value=NULL_STRING,
                    )
                )
            return ms

        metas = self.cached_metas(
            i, (feat.name, feat.ftype.type_name(), self.track_nulls), build
        )
        return np.stack(blocks, axis=1), metas

    def lower_block(self, i: int):
        name = self.input_features[i].name
        fill = self.fill_values[i]
        track_nulls = self.track_nulls

        def block(env: dict) -> np.ndarray:
            vals, mask = env[name], env[name + MASK_SUFFIX]
            filled = np.where(mask, vals, fill)
            blocks = [filled]
            if track_nulls:
                blocks.append((~mask).astype(np.float64))
            return np.stack(blocks, axis=1)

        return block

    def lower_block_torch(self, i: int):
        name = self.input_features[i].name
        fill = float(self.fill_values[i])
        track_nulls = self.track_nulls

        def block(env: dict) -> torch.Tensor:
            vals, mask = env[name], env[name + MASK_SUFFIX]
            filled = torch.where(mask, vals, fill)
            blocks = [filled]
            if track_nulls:
                blocks.append((~mask).to(torch.float64))
            return torch.stack(blocks, dim=1)

        return block


class RealVectorizer(SequenceVectorizer):
    """Impute mean (default) or constant + null indicators (reference:
    RealVectorizer.scala)."""

    input_types = [Real, ...]

    def __init__(
        self,
        fill_with_mean: bool = True,
        fill_value: float = 0.0,
        track_nulls: bool = True,
        **kw,
    ) -> None:
        super().__init__(**kw)
        self.fill_with_mean = fill_with_mean
        self.fill_value = fill_value
        self.track_nulls = track_nulls

    def fit_model(self, cols: Sequence[Column], ds: Dataset):
        fills = []
        for c in cols:
            assert isinstance(c, NumericColumn)
            fills.append(
                masked_mean(c.values, c.mask, self.fill_value)
                if self.fill_with_mean
                else self.fill_value
            )
        return NumericVectorizerModel(fills, self.track_nulls)


class IntegralVectorizer(SequenceVectorizer):
    """Impute mode + null indicators (reference: IntegralVectorizer.scala)."""

    input_types = [Integral, ...]

    def __init__(
        self, fill_with_mode: bool = True, fill_value: float = 0.0,
        track_nulls: bool = True, **kw,
    ) -> None:
        super().__init__(**kw)
        self.fill_with_mode = fill_with_mode
        self.fill_value = fill_value
        self.track_nulls = track_nulls

    def fit_model(self, cols: Sequence[Column], ds: Dataset):
        fills = []
        for c in cols:
            assert isinstance(c, NumericColumn)
            fills.append(
                masked_mode(c.values, c.mask, self.fill_value)
                if self.fill_with_mode
                else self.fill_value
            )
        return NumericVectorizerModel(fills, self.track_nulls)


class BinaryVectorizer(SequenceVectorizer):
    """Fill false/true + null indicators (reference: BinaryVectorizer.scala)."""

    input_types = [Binary, ...]

    def __init__(self, fill_value: bool = False, track_nulls: bool = True, **kw) -> None:
        super().__init__(**kw)
        self.fill_value = fill_value
        self.track_nulls = track_nulls

    def fit_model(self, cols: Sequence[Column], ds: Dataset):
        return NumericVectorizerModel(
            [float(self.fill_value)] * len(cols), self.track_nulls
        )


class RealNNVectorizer(SequenceVectorizer):
    """Non-nullable reals: straight passthrough into the vector (reference:
    RealNNVectorizer in RealVectorizer.scala)."""

    input_types = [RealNN, ...]

    def fit_model(self, cols: Sequence[Column], ds: Dataset):
        return NumericVectorizerModel([0.0] * len(cols), track_nulls=False)
