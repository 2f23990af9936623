"""FeatureBuilder: typed extraction of raw features.

Counterpart of the reference FeatureBuilder (reference: features/.../
FeatureBuilder.scala:47,190,239-341):

* fluent builder: ``FeatureBuilder(Real, "age").extract(fn).as_predictor()``
* ``from_dataframe(df, response=...)`` - infer one feature per column from a
  pandas DataFrame schema, returning (response, predictors), mirroring
  FeatureBuilder.fromDataFrame (FeatureBuilder.scala:190).
* ``from_schema(...)`` - same from an explicit {name: FeatureType} mapping.
"""
from __future__ import annotations

from typing import Any, Callable, Mapping, Optional, Sequence, Type

import numpy as np

from ..stages.feature_generator import FeatureGeneratorStage
from ..types import feature_types as ft
from ..types.feature_types import FeatureType
from .feature import Feature


class FeatureBuilder:
    def __init__(self, ftype: Type[FeatureType], name: str) -> None:
        self.ftype = ftype
        self.name = name
        self._extract_fn: Optional[Callable[[Any], Any]] = None
        self._aggregator = None
        self._window: Optional[float] = None

    def extract(self, fn: Callable[[Any], Any]) -> "FeatureBuilder":
        self._extract_fn = fn
        return self

    def aggregate(self, aggregator: Any) -> "FeatureBuilder":
        self._aggregator = aggregator
        return self

    def window(self, seconds: float) -> "FeatureBuilder":
        self._window = seconds
        return self

    def _build(self, is_response: bool) -> Feature:
        stage = FeatureGeneratorStage(
            feature_name=self.name,
            output_type=self.ftype,
            extract_fn=self._extract_fn,
            is_response=is_response,
            aggregator=self._aggregator,
            aggregate_window=self._window,
        )
        return stage.get_output()

    def as_predictor(self) -> Feature:
        return self._build(is_response=False)

    def as_response(self) -> Feature:
        return self._build(is_response=True)


# convenience constructors: FeatureBuilder.Real("age") etc.
def _mk_ctor(t: Type[FeatureType]):
    def ctor(name: str) -> FeatureBuilder:
        return FeatureBuilder(t, name)

    return staticmethod(ctor)


for _name, _t in ft.all_feature_types().items():
    if _name not in ("FeatureType",):
        setattr(FeatureBuilder, _name, _mk_ctor(_t))


def infer_feature_type(values: Sequence, dtype=None) -> Type[FeatureType]:
    """Best-effort type inference for a raw column (used by CSV auto-infer,
    reference: cli/.../SchemaSource.scala auto-infer + CSVAutoReaders)."""
    if dtype is not None:
        kind = np.dtype(dtype).kind if not str(dtype).startswith("object") else "O"
        if kind == "b":
            return ft.Binary
        if kind in "iu":
            return ft.Integral
        if kind == "f":
            return ft.Real
        if kind == "M":
            return ft.DateTime
    sample = [v for v in values if v is not None][:1000]
    if not sample:
        return ft.Text
    if all(isinstance(v, bool) for v in sample):
        return ft.Binary
    if all(isinstance(v, (int, np.integer)) and not isinstance(v, bool) for v in sample):
        return ft.Integral
    if all(isinstance(v, (int, float, np.floating, np.integer)) for v in sample):
        return ft.Real
    if all(isinstance(v, (set, frozenset)) for v in sample):
        return ft.MultiPickList
    if all(isinstance(v, dict) for v in sample):
        return ft.TextMap
    if all(isinstance(v, (list, tuple)) for v in sample):
        return ft.TextList
    return ft.Text


def from_schema(
    schema: Mapping[str, Type[FeatureType]],
    response: str,
    response_type: Type[FeatureType] = ft.RealNN,
) -> tuple[Feature, list[Feature]]:
    """Build (response, predictors) features from an explicit schema."""
    if response not in schema:
        raise KeyError(f"response column {response!r} not in schema")
    resp = FeatureBuilder(response_type, response).as_response()
    preds = [
        FeatureBuilder(t, name).as_predictor()
        for name, t in sorted(schema.items())
        if name != response
    ]
    return resp, preds


def from_dataframe(
    df,
    response: str,
    response_type: Type[FeatureType] = ft.RealNN,
    type_overrides: Optional[Mapping[str, Type[FeatureType]]] = None,
) -> tuple[Feature, list[Feature]]:
    """Infer one feature per pandas column (reference:
    FeatureBuilder.fromDataFrame, FeatureBuilder.scala:190)."""
    overrides = dict(type_overrides or {})
    schema: dict[str, Type[FeatureType]] = {}
    for name in df.columns:
        if name in overrides:
            schema[name] = overrides[name]
        else:
            col = df[name]
            vals = [None if (v is None or (isinstance(v, float) and np.isnan(v))) else v
                    for v in col.head(1000)]
            schema[name] = infer_feature_type(vals, col.dtype)
    return from_schema(schema, response, response_type)
