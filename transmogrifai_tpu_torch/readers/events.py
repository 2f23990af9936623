"""Event readers: aggregate / conditional / joined / streaming.

Counterparts of the reference reader stack (reference: readers/.../
DataReader.scala:173-345 - AggregateDataReader :202-266,
ConditionalDataReader :283-345; JoinedDataReader.scala:124-214;
StreamingReader.scala:54; factory DataReaders.scala:44-198): collapse
per-key event streams into one training row per key, with time-based
predictor/response separation.
"""
from __future__ import annotations

from typing import Any, Callable, Iterable, Iterator, Optional, Sequence

import numpy as np

from ..features.aggregators import CutOffTime, Event, FeatureAggregator
from ..features.feature import Feature
from ..stages.feature_generator import FeatureGeneratorStage
from ..types.columns import column_from_list
from ..types.dataset import Dataset


class SimpleReader:
    """One record = one row (reference: DataReaders.Simple)."""

    def __init__(self, records: Iterable[dict], key_fn=None) -> None:
        self.records = list(records)
        self.key_fn = key_fn

    def generate_dataset(
        self, raw_features: Sequence[Feature], params: Optional[dict] = None
    ) -> Dataset:
        cols = {}
        for f in raw_features:
            gen = f.origin_stage
            assert isinstance(gen, FeatureGeneratorStage)
            cols[f.name] = gen.extract_column(self.records)
        return Dataset(cols)


class AggregateReader:
    """Group records by key and aggregate each feature's events relative to
    a cutoff time (reference: AggregateDataReader, DataReader.scala:202-266:
    predictors from events <= cutoff, responses from events > cutoff)."""

    def __init__(
        self,
        records: Iterable[dict],
        key_fn: Callable[[dict], Any],
        time_fn: Callable[[dict], float],
        cutoff: CutOffTime = CutOffTime(),
    ) -> None:
        self.records = list(records)
        self.key_fn = key_fn
        self.time_fn = time_fn
        self.cutoff = cutoff

    def _grouped(self) -> dict[Any, list[tuple[float, dict]]]:
        groups: dict[Any, list[tuple[float, dict]]] = {}
        for r in self.records:
            groups.setdefault(self.key_fn(r), []).append((self.time_fn(r), r))
        for events in groups.values():
            events.sort(key=lambda tr: tr[0])
        return groups

    def _cutoff_for(self, key: Any, events) -> CutOffTime:
        return self.cutoff

    def row_keys(self) -> list:
        """Group keys in output-row order (the 'key' column of the
        reference's aggregated frame, DataReader.scala:202) - what joins
        on the aggregation key align on."""
        return sorted(self._grouped(), key=str)

    def generate_dataset(
        self, raw_features: Sequence[Feature], params: Optional[dict] = None
    ) -> Dataset:
        groups = self._grouped()
        keys = sorted(groups, key=str)
        cols: dict[str, list] = {f.name: [] for f in raw_features}
        for f in raw_features:
            gen = f.origin_stage
            assert isinstance(gen, FeatureGeneratorStage)
            extract = gen.extract_fn or (lambda rec, _n=f.name: rec.get(_n))
            agg = FeatureAggregator(
                f.ftype,
                aggregator=gen.aggregator,
                is_response=f.is_response,
                window=gen.aggregate_window,
            )
            for key in keys:
                events = [
                    Event(ts, extract(rec)) for ts, rec in groups[key]
                ]
                cols[f.name].append(
                    agg.extract(events, self._cutoff_for(key, groups[key]))
                )
        return Dataset(
            {f.name: column_from_list(cols[f.name], f.ftype) for f in raw_features}
        )


class ConditionalReader(AggregateReader):
    """Per-key cutoff at the first (or last) record matching
    ``target_condition``; responses only within ``response_window`` after
    (reference: ConditionalDataReader, DataReader.scala:283-345).  Keys with
    no matching event are dropped."""

    def __init__(
        self,
        records: Iterable[dict],
        key_fn: Callable[[dict], Any],
        time_fn: Callable[[dict], float],
        target_condition: Callable[[dict], bool],
        response_window: Optional[float] = None,
        drop_if_no_condition: bool = True,
        use_first: bool = True,
    ) -> None:
        super().__init__(records, key_fn, time_fn)
        self.target_condition = target_condition
        self.response_window = response_window
        self.drop_if_no_condition = drop_if_no_condition
        self.use_first = use_first

    def _effective_groups(self):
        """(groups, cutoffs) after applying the target condition and the
        drop rule - shared by generate_dataset and row_keys."""
        groups = self._grouped()
        cutoffs: dict[Any, CutOffTime] = {}
        for key, events in groups.items():
            matches = [ts for ts, rec in events if self.target_condition(rec)]
            if matches:
                cutoffs[key] = CutOffTime(
                    matches[0] if self.use_first else matches[-1]
                )
        if self.drop_if_no_condition:
            groups = {k: v for k, v in groups.items() if k in cutoffs}
        return groups, cutoffs

    def row_keys(self) -> list:
        return sorted(self._effective_groups()[0], key=str)

    def generate_dataset(
        self, raw_features: Sequence[Feature], params: Optional[dict] = None
    ) -> Dataset:
        groups, cutoffs = self._effective_groups()
        self._per_key_cutoffs = cutoffs
        keys = sorted(groups, key=str)
        cols: dict[str, list] = {}
        for f in raw_features:
            gen = f.origin_stage
            assert isinstance(gen, FeatureGeneratorStage)
            extract = gen.extract_fn or (lambda rec, _n=f.name: rec.get(_n))
            window = gen.aggregate_window
            if f.is_response and window is None:
                window = self.response_window
            agg = FeatureAggregator(
                f.ftype, aggregator=gen.aggregator,
                is_response=f.is_response, window=window,
            )
            vals = []
            for key in keys:
                events = [Event(ts, extract(rec)) for ts, rec in groups[key]]
                vals.append(
                    agg.extract(events, cutoffs.get(key, CutOffTime()))
                )
            cols[f.name] = column_from_list(vals, f.ftype)
        return Dataset(cols)


class JoinedReader:
    """Join two readers' outputs on key columns (reference:
    JoinedDataReader.scala:124-214; JoinTypes inner/left/outer)."""

    def __init__(
        self,
        left,
        right,
        left_key: str,
        right_key: Optional[str] = None,
        join_type: str = "left",
    ) -> None:
        self.left = left
        self.right = right
        self.left_key = left_key
        self.right_key = right_key or left_key
        self.join_type = join_type

    def generate_dataset(
        self, raw_features: Sequence[Feature], params: Optional[dict] = None
    ) -> Dataset:
        import pandas as pd

        left_feats = [
            f for f in raw_features
            if f.name in getattr(self.left, "feature_names", set())
            or self._has_column(self.left, f)
        ]
        right_feats = [f for f in raw_features if f not in left_feats]
        lds = self.left.generate_dataset(left_feats, params)
        rds = self.right.generate_dataset(right_feats, params)
        ldf = pd.DataFrame(lds.to_pylists())
        rdf = pd.DataFrame(rds.to_pylists())
        # the join key must exist on both sides even when it is only declared
        # as a feature of one; pull it straight from the records
        for df, reader, key in (
            (ldf, self.left, self.left_key),
            (rdf, self.right, self.right_key),
        ):
            if key not in df.columns:
                # aggregate/conditional readers emit one row per GROUP -
                # their join key is the aggregation key, in row order
                if hasattr(reader, "row_keys"):
                    df[key] = reader.row_keys()
                    continue
                recs = getattr(reader, "records", None)
                if recs is None:
                    raise KeyError(f"join key {key!r} unavailable")
                df[key] = [r.get(key) for r in recs]
        how = {"inner": "inner", "left": "left", "outer": "outer"}[self.join_type]
        joined = ldf.merge(
            rdf, left_on=self.left_key, right_on=self.right_key, how=how
        )
        cols = {}
        for f in raw_features:
            vals = [
                None if (isinstance(v, float) and np.isnan(v)) else v
                for v in joined[f.name].tolist()
            ]
            cols[f.name] = column_from_list(vals, f.ftype)
        return Dataset(cols)

    @staticmethod
    def _has_column(reader, feature: Feature) -> bool:
        recs = getattr(reader, "records", None)
        if not recs:
            return False
        return any(feature.name in r for r in recs[:50])


class StreamingReader:
    """Micro-batch iterator (reference: StreamingReader.scala:54 /
    StreamingReaders.Simple): yields Datasets of up to batch_size rows,
    consumed by OpWorkflowRunner.streaming_score."""

    def __init__(self, record_stream: Iterable[dict], batch_size: int = 1000):
        self.record_stream = record_stream
        self.batch_size = batch_size

    def stream(self, raw_features: Sequence[Feature]) -> Iterator[Dataset]:
        batch: list[dict] = []
        for rec in self.record_stream:
            batch.append(rec)
            if len(batch) >= self.batch_size:
                yield SimpleReader(batch).generate_dataset(raw_features)
                batch = []
        if batch:
            yield SimpleReader(batch).generate_dataset(raw_features)
