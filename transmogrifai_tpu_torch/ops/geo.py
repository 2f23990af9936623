"""Geolocation vectorizer: fill with geographic centroid + null tracking.

Counterpart of GeolocationVectorizer (reference: core/.../impl/feature/
GeolocationVectorizer.scala:70-93): missing (lat, lon, acc) triples are
imputed with the fit-time GEOGRAPHIC midpoint (the GeolocationMidpoint
monoid's 3D unit-vector mean - an arithmetic lat/lon mean averages +179
and -179 longitude to 0, the wrong side of the planet), or a constant;
a null-indicator column is appended.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from ..types.columns import Column, GeolocationColumn
from ..types.dataset import Dataset
from ..types.feature_types import Geolocation
from ..types.vector_metadata import NULL_STRING, VectorColumnMeta
from .vectorizer_base import SequenceVectorizer, SequenceVectorizerModel


def geographic_midpoint(points: np.ndarray) -> np.ndarray:
    """Geographic centroid of [k, 3] (lat, lon, accuracy) rows: the same
    3D unit-vector mean as the GeolocationMidpoint monoid (reference
    delegates to that aggregator, GeolocationVectorizer.scala:88-92),
    vectorized for the fit hot path."""
    pts = np.asarray(points, dtype=np.float64).reshape(-1, 3)
    if pts.shape[0] == 0:
        return np.zeros(3)
    lat, lon = np.radians(pts[:, 0]), np.radians(pts[:, 1])
    x = np.mean(np.cos(lat) * np.cos(lon))
    y = np.mean(np.cos(lat) * np.sin(lon))
    z = np.mean(np.sin(lat))
    return np.array([
        np.degrees(np.arctan2(z, np.hypot(x, y))),
        np.degrees(np.arctan2(y, x)),
        pts[:, 2].mean(),
    ])


class GeolocationVectorizerModel(SequenceVectorizerModel):
    def __init__(self, fill_values: Sequence[np.ndarray], track_nulls: bool, **kw):
        super().__init__(**kw)
        self.fill_values = [np.asarray(f, dtype=np.float64) for f in fill_values]
        self.track_nulls = track_nulls

    def blocks_for(self, col: Column, i: int):
        assert isinstance(col, GeolocationColumn)
        feat = self.input_features[i]
        filled = np.where(col.mask[:, None], col.values, self.fill_values[i][None, :])
        blocks = [filled]
        if self.track_nulls:
            blocks.append((~col.mask).astype(np.float64)[:, None])

        def build():
            tname = feat.ftype.type_name()
            ms = [
                VectorColumnMeta(
                    parent_feature_name=feat.name,
                    parent_feature_type=tname,
                    descriptor_value=d,
                )
                for d in ("lat", "lon", "accuracy")
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
        return np.concatenate(blocks, axis=1), metas


class GeolocationVectorizer(SequenceVectorizer):
    input_types = [Geolocation, ...]

    def __init__(self, track_nulls: bool = True,
                 fill_with_constant: bool = False,
                 fill_value: Optional[Sequence[float]] = None, **kw) -> None:
        super().__init__(**kw)
        self.track_nulls = track_nulls
        self.fill_with_constant = fill_with_constant
        # reference default constant = Geolocation(0, 0, Unknown)
        # (TransmogrifierDefaults.DefaultGeolocation, Transmogrifier.scala:77)
        self.fill_value = (
            list(fill_value) if fill_value is not None else [0.0, 0.0, 0.0]
        )
        if len(self.fill_value) != 3:
            raise ValueError(
                "fill_value must be (lat, lon, accuracy), got "
                f"{self.fill_value!r}"
            )

    def fit_model(self, cols: Sequence[Column], ds: Dataset):
        fills = []
        for c in cols:
            assert isinstance(c, GeolocationColumn)
            if self.fill_with_constant:
                fills.append(np.asarray(self.fill_value, dtype=np.float64))
            elif c.mask.any():
                fills.append(geographic_midpoint(c.values[c.mask]))
            else:
                fills.append(np.zeros(3))
        return GeolocationVectorizerModel(fills, self.track_nulls)
