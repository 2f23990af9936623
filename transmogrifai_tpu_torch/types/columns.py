"""Columnar data representation.

Columnar redesign of the reference's row-object model: where the reference
stores one ``Option``-wrapped object per row per feature (reference:
features/.../types/FeatureType.scala:44), we store each feature as a whole
*column*:

* numeric-ish types  -> float32 value array + bool validity mask
* text-ish types     -> host-side object array (vectorized numpy string ops)
* vectors            -> dense float32 [n, d] + VectorMetadata provenance
* lists/sets/maps    -> host-side ragged representations
* Prediction         -> dense (prediction, rawPrediction, probability) arrays

Masks replace Option: ``mask[i] == True`` means the value is present.  All
device-bound math consumes (values, mask) pairs so null semantics survive
into the device computations (e.g. mean-impute must ignore masked entries, mirroring
SequenceAggregators.MeanSeqNullNum, reference: utils/.../spark/
SequenceAggregators.scala:76).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Iterable, Mapping, Optional, Sequence, Type

import numpy as np

from .feature_types import (
    FeatureType,
    Geolocation,
    OPVector,
    Prediction,
    Real,
    Text,
)
from .vector_metadata import VectorMetadata


class Column:
    """Abstract columnar container for one feature over n rows."""

    feature_type: Type[FeatureType]

    def __len__(self) -> int:  # pragma: no cover - abstract
        raise NotImplementedError

    def take(self, indices: np.ndarray) -> "Column":  # pragma: no cover
        raise NotImplementedError

    def to_list(self) -> list:  # pragma: no cover
        raise NotImplementedError


@dataclass
class NumericColumn(Column):
    """float64 values + validity mask. Missing slots hold 0.0 (never NaN so
    kernels can sum without nan-guards); the mask is the source of truth."""

    values: np.ndarray
    mask: np.ndarray
    feature_type: Type[FeatureType] = Real

    def __post_init__(self) -> None:
        self.values = np.asarray(self.values, dtype=np.float64)
        self.mask = np.asarray(self.mask, dtype=bool)
        assert self.values.shape == self.mask.shape
        # canonicalize: masked-out slots are zero
        if not self.mask.all():
            self.values = np.where(self.mask, self.values, 0.0)

    def __len__(self) -> int:
        return len(self.values)

    def take(self, indices: np.ndarray) -> "NumericColumn":
        return NumericColumn(self.values[indices], self.mask[indices], self.feature_type)

    def to_list(self) -> list:
        return [float(v) if m else None for v, m in zip(self.values, self.mask)]

    @staticmethod
    def from_list(
        data: Iterable[Optional[float]], feature_type: Type[FeatureType] = Real
    ) -> "NumericColumn":
        vals, mask = [], []
        for x in data:
            missing = x is None or (isinstance(x, float) and np.isnan(x))
            mask.append(not missing)
            vals.append(0.0 if missing else float(x))
        return NumericColumn(np.array(vals), np.array(mask), feature_type)


@dataclass
class TextColumn(Column):
    """Host-side nullable strings (numpy object array; None = missing)."""

    values: np.ndarray
    feature_type: Type[FeatureType] = Text

    def __post_init__(self) -> None:
        self.values = np.asarray(self.values, dtype=object)

    def __len__(self) -> int:
        return len(self.values)

    @property
    def mask(self) -> np.ndarray:
        return np.array([v is not None for v in self.values], dtype=bool)

    def take(self, indices: np.ndarray) -> "TextColumn":
        return TextColumn(self.values[indices], self.feature_type)

    def to_list(self) -> list:
        return list(self.values)

    @staticmethod
    def from_list(
        data: Iterable[Optional[str]], feature_type: Type[FeatureType] = Text
    ) -> "TextColumn":
        vals = [None if v is None or v == "" else str(v) for v in data]
        return TextColumn(np.array(vals, dtype=object), feature_type)


# -- single-pass record decoding --------------------------------------------
# Columnar decode of raw record dicts, sharing the from_list missing
# semantics above.  Lives here (not in local/fused.py, its hot-path
# consumer) so that schema/drift.py can import it without a schema ->
# local layering inversion.

_NAN = float("nan")


def text_values(values: Sequence) -> list:
    """Raw values -> host list of str-or-None (TextColumn.from_list
    semantics; a plain list because downstream encodes iterate it
    element-wise anyway).  Branch order puts the common case (a
    non-empty str) on the two-check path."""
    return [
        (v or None) if type(v) is str
        else (None if v is None or v == "" else str(v))
        for v in values
    ]


def list_values(values: Sequence, as_set: bool) -> list:
    """Raw values -> tuples (order kept) or frozensets: the
    textlist/datelist/multipicklist conversion of column_from_list."""
    if as_set:
        return [frozenset(v) if v else frozenset() for v in values]
    return [tuple(v) if v else tuple() for v in values]


def decode_text(records: Sequence[Mapping[str, Any]], name: str):
    """Raw values -> object [n] of str-or-None (TextColumn.from_list
    semantics, shared with the fused env decode via text_values so the
    two can never diverge)."""
    return np.array(
        text_values([r.get(name) for r in records]), dtype=object
    )


def is_present_nan(v) -> bool:
    """True when a NaN-converted input is one NumericColumn.from_list
    treats as PRESENT: any non-None value that is not a python float
    NaN (a str \"nan\", an np.float32 NaN).  Present-NaN rows must keep
    NaN so the serving output guard refuses them - masking them would
    silently mean-fill junk the interpreted path rejects."""
    return v is not None and not isinstance(v, float)


def present_nan_slots(flat_idx, values) -> list:
    """Indices (of ``flat_idx``) whose ``values`` entry is a
    present-NaN input per :func:`is_present_nan`."""
    return [i for i in flat_idx if is_present_nan(values[i])]


def decode_numeric(records: Sequence[Mapping[str, Any]], name: str):
    """Raw values -> (values float64 [n], mask bool [n]) with the exact
    missing semantics of NumericColumn.from_list: None or a python
    float NaN is missing (missing slots hold 0.0, the canonical masked
    form); NaN-valued inputs of any other type stay present as NaN."""
    vals = np.array(
        [_NAN if (v := r.get(name)) is None else v for r in records],
        dtype=np.float64,
    )
    if vals.ndim != 1:  # a batch of equal-length lists would build 2D
        raise TypeError(f"feature {name!r} values are not scalars")
    mask = ~np.isnan(vals)
    if not mask.all():  # junk-NaN recovery only when NaNs exist at all
        present = [
            i for i in np.flatnonzero(~mask).tolist()
            if is_present_nan(records[i].get(name))
        ]
        mask[present] = True
    return np.where(mask, vals, 0.0), mask


@dataclass
class ListColumn(Column):
    """Ragged host-side lists (TextList/DateList/MultiPickList).  Values are
    tuples (order preserved) or frozensets for set semantics."""

    values: list
    feature_type: Type[FeatureType]

    def __len__(self) -> int:
        return len(self.values)

    def take(self, indices: np.ndarray) -> "ListColumn":
        return ListColumn([self.values[i] for i in indices], self.feature_type)

    def to_list(self) -> list:
        return [list(v) for v in self.values]


@dataclass
class GeolocationColumn(Column):
    """Dense [n, 3] (lat, lon, accuracy) + validity mask (reference:
    types/Geolocation.scala:47)."""

    values: np.ndarray
    mask: np.ndarray
    feature_type: Type[FeatureType] = Geolocation

    def __post_init__(self) -> None:
        self.values = np.asarray(self.values, dtype=np.float64).reshape(-1, 3)
        self.mask = np.asarray(self.mask, dtype=bool)
        # the reference validates at construction (Geolocation.scala:50
        # Geolocation.validate: lat in [-90, 90], lon in [-180, 180]);
        # silent (95, 200) passthrough would poison every downstream
        # distance/vectorizer computation
        if self.mask.any():
            lat = self.values[self.mask, 0]
            lon = self.values[self.mask, 1]
            bad = ~(
                (lat >= -90) & (lat <= 90) & (lon >= -180) & (lon <= 180)
            )
            if bad.any():
                rows = np.flatnonzero(self.mask)[bad][:5]
                raise ValueError(
                    "invalid geolocation coordinates (lat must be in "
                    "[-90, 90], lon in [-180, 180]) at rows "
                    f"{rows.tolist()}: "
                    f"{self.values[rows].tolist()}"
                )

    def __len__(self) -> int:
        return len(self.mask)

    def take(self, indices: np.ndarray) -> "GeolocationColumn":
        return GeolocationColumn(self.values[indices], self.mask[indices])

    def to_list(self) -> list:
        return [list(v) if m else None for v, m in zip(self.values, self.mask)]


@dataclass
class MapColumn(Column):
    """Host-side list of dicts (missing = empty dict).  Typed by the map's
    value type; vectorizers expand keys into columnar form at fit time."""

    values: list
    feature_type: Type[FeatureType]

    def __len__(self) -> int:
        return len(self.values)

    def take(self, indices: np.ndarray) -> "MapColumn":
        return MapColumn([self.values[i] for i in indices], self.feature_type)

    def to_list(self) -> list:
        return list(self.values)

    def all_keys(self) -> list[str]:
        keys: dict[str, None] = {}
        for d in self.values:
            for k in d:
                keys.setdefault(k)
        return sorted(keys)


@dataclass
class VectorColumn(Column):
    """Dense float32 [n, d] feature matrix chunk + provenance metadata."""

    values: np.ndarray
    metadata: VectorMetadata
    feature_type: Type[FeatureType] = OPVector

    def __post_init__(self) -> None:
        self.values = np.asarray(self.values, dtype=np.float32)
        if self.values.ndim == 1:
            self.values = self.values[:, None]
        if self.metadata.size and self.metadata.size != self.values.shape[1]:
            raise ValueError(
                f"vector width {self.values.shape[1]} != metadata size {self.metadata.size}"
            )

    def __len__(self) -> int:
        return len(self.values)

    @property
    def width(self) -> int:
        return self.values.shape[1]

    def take(self, indices: np.ndarray) -> "VectorColumn":
        return VectorColumn(self.values[indices], self.metadata)

    def to_list(self) -> list:
        return [row.tolist() for row in self.values]


@dataclass
class PredictionColumn(Column):
    """Model output: prediction [n], rawPrediction [n,k], probability [n,k]
    (reference Prediction type: types/Maps.scala:302-357)."""

    prediction: np.ndarray
    raw_prediction: Optional[np.ndarray] = None
    probability: Optional[np.ndarray] = None
    feature_type: Type[FeatureType] = Prediction

    def __post_init__(self) -> None:
        self.prediction = np.asarray(self.prediction, dtype=np.float64).reshape(-1)
        if self.raw_prediction is not None:
            self.raw_prediction = np.asarray(self.raw_prediction, dtype=np.float64)
            if self.raw_prediction.ndim == 1:
                self.raw_prediction = self.raw_prediction[:, None]
        if self.probability is not None:
            self.probability = np.asarray(self.probability, dtype=np.float64)
            if self.probability.ndim == 1:
                self.probability = self.probability[:, None]

    def __len__(self) -> int:
        return len(self.prediction)

    def take(self, indices: np.ndarray) -> "PredictionColumn":
        return PredictionColumn(
            self.prediction[indices],
            None if self.raw_prediction is None else self.raw_prediction[indices],
            None if self.probability is None else self.probability[indices],
        )

    def to_list(self) -> list:
        out = []
        for i in range(len(self)):
            d: dict[str, Any] = {Prediction.KEY_PREDICTION: float(self.prediction[i])}
            if self.raw_prediction is not None:
                for j, v in enumerate(self.raw_prediction[i]):
                    d[f"{Prediction.KEY_RAW}_{j}"] = float(v)
            if self.probability is not None:
                for j, v in enumerate(self.probability[i]):
                    d[f"{Prediction.KEY_PROB}_{j}"] = float(v)
            out.append(d)
        return out


def column_from_list(
    data: Sequence, feature_type: Type[FeatureType]
) -> Column:
    """Build the right Column variant for a feature type from python values."""
    kind = feature_type.kind
    if kind == "numeric":
        if isinstance(data, np.ndarray) and data.dtype.kind in "fiub":
            vals = np.asarray(data, np.float64)
            mask = ~np.isnan(vals)
            return NumericColumn(np.where(mask, vals, 0.0), mask,
                                 feature_type)
        return NumericColumn.from_list(data, feature_type)
    if kind == "text":
        return TextColumn.from_list(data, feature_type)
    if kind in ("textlist", "datelist"):
        return ListColumn(list_values(data, as_set=False), feature_type)
    if kind == "multipicklist":
        return ListColumn(list_values(data, as_set=True), feature_type)
    if kind == "geolocation":
        dense = np.zeros((len(data), 3))
        mask = np.zeros(len(data), dtype=bool)
        for i, v in enumerate(data):
            if v:
                dense[i] = list(v)[:3]
                mask[i] = True
        return GeolocationColumn(dense, mask)
    if kind == "map":
        return MapColumn([dict(v) if v else {} for v in data], feature_type)
    if kind == "vector":
        arr = np.asarray([list(v) for v in data], dtype=np.float32)
        return VectorColumn(arr, VectorMetadata("anonymous", tuple()))
    raise TypeError(f"cannot build column for kind {kind!r}")


def concat_columns(parts: Sequence[Column]) -> Column:
    """Row-concatenate column chunks of one feature (the streaming
    ingest hand-off: readers/pipeline.py materializes per-chunk columns
    while shards parse, then joins them here).  Supported for the
    column kinds the pipelined readers produce."""
    if not parts:
        raise ValueError("concat_columns needs at least one part")
    if len(parts) == 1:
        return parts[0]
    first = parts[0]
    if isinstance(first, NumericColumn):
        return NumericColumn(
            np.concatenate([p.values for p in parts]),
            np.concatenate([p.mask for p in parts]),
            first.feature_type,
        )
    if isinstance(first, TextColumn):
        return TextColumn(
            np.concatenate([p.values for p in parts]), first.feature_type
        )
    if isinstance(first, ListColumn):
        out: list = []
        for p in parts:
            out.extend(p.values)
        return ListColumn(out, first.feature_type)
    if isinstance(first, VectorColumn):
        return VectorColumn(
            np.concatenate([p.values for p in parts], axis=0),
            first.metadata,
        )
    raise TypeError(
        f"concat_columns does not support {type(first).__name__}"
    )
