"""Raw-feature origin stage.

Counterpart of the reference FeatureGeneratorStage (reference: features/.../
stages/FeatureGeneratorStage.scala:60-109): the DAG origin node holding the
extraction function from a raw record plus an optional event aggregator and
time window.  Here extraction is columnar: ``extract_col``
receives the raw record *table* (Dataset or mapping of python lists) and
returns the feature's Column.  Generators run at ingest (reader) time, never
inside fit layers.
"""
from __future__ import annotations

from typing import Any, Callable, Optional, Sequence, Type

from ..features.feature import Feature
from ..types.columns import Column, column_from_list
from ..types.feature_types import FeatureType
from .base import PipelineStage


class FeatureGeneratorStage(PipelineStage):
    def __init__(
        self,
        feature_name: str,
        output_type: Type[FeatureType],
        extract_fn: Optional[Callable[[Any], Any]] = None,
        is_response: bool = False,
        aggregator: Optional[Any] = None,
        aggregate_window: Optional[float] = None,
        uid: Optional[str] = None,
    ) -> None:
        super().__init__(operation_name="FeatureGenerator", uid=uid)
        self.feature_name = feature_name
        self.output_type = output_type
        self.extract_fn = extract_fn
        self.is_response = is_response
        self.aggregator = aggregator
        self.aggregate_window = aggregate_window

    def get_output(self) -> Feature:
        if self._output is None:
            self._output = Feature(
                name=self.feature_name,
                ftype=self.output_type,
                is_response=self.is_response,
                origin_stage=self,
                parents=(),
            )
        return self._output

    def extract_column(self, records: Sequence[Any]) -> Column:
        """Row-wise extraction from raw records (reader path for custom
        extract functions; columnar readers bypass this)."""
        fn = self.extract_fn or (lambda rec: rec.get(self.feature_name))
        return column_from_list([fn(r) for r in records], self.output_type)
