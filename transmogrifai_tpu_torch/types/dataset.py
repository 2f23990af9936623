"""In-memory columnar dataset: the unit of data flowing through a workflow.

Plays the role of the reference's Spark DataFrame at the workflow boundary
(reference: readers/.../DataReader.scala:173 generateDataFrame), but columnar
and mask-based.  Columns are keyed by feature name; all columns share row
count.  Row-subsetting (folds, splits) is a single ``take``.
"""
from __future__ import annotations

from typing import Dict, Iterable, Iterator, Mapping, Optional, Sequence, Type

import numpy as np

from .columns import Column, column_from_list
from .feature_types import FeatureType


class Dataset:
    def __init__(self, columns: Optional[Mapping[str, Column]] = None) -> None:
        self._columns: Dict[str, Column] = dict(columns or {})
        n = {len(c) for c in self._columns.values()}
        if len(n) > 1:
            raise ValueError(f"ragged dataset: row counts {sorted(n)}")

    # -- container protocol -------------------------------------------------
    def __len__(self) -> int:
        if not self._columns:
            return 0
        return len(next(iter(self._columns.values())))

    @property
    def n_rows(self) -> int:
        return len(self)

    def __contains__(self, name: str) -> bool:
        return name in self._columns

    def __getitem__(self, name: str) -> Column:
        return self._columns[name]

    def __iter__(self) -> Iterator[str]:
        return iter(self._columns)

    def column_names(self) -> list[str]:
        return list(self._columns)

    def columns(self) -> Dict[str, Column]:
        return dict(self._columns)

    def set_column(self, name: str, col: Column,
                   validate: bool = True) -> None:
        """In-place column write for OWNED datasets (the serving hot loop:
        the functional with_column path rebuilds the dict and re-validates
        every column per stage).  validate=False skips the length check -
        callers own the no-ragged invariant and must re-check results."""
        if validate and self._columns and len(col) != len(self):
            raise ValueError(
                f"column {name!r} has {len(col)} rows, dataset has {len(self)}"
            )
        self._columns[name] = col

    # -- functional updates -------------------------------------------------
    def with_column(self, name: str, col: Column) -> "Dataset":
        if self._columns and len(col) != len(self):
            raise ValueError(
                f"column {name!r} has {len(col)} rows, dataset has {len(self)}"
            )
        cols = dict(self._columns)
        cols[name] = col
        return Dataset(cols)

    def with_columns(self, new: Mapping[str, Column]) -> "Dataset":
        ds = self
        for k, v in new.items():
            ds = ds.with_column(k, v)
        return ds

    def select(self, names: Iterable[str]) -> "Dataset":
        return Dataset({n: self._columns[n] for n in names})

    def drop(self, names: Iterable[str]) -> "Dataset":
        gone = set(names)
        return Dataset({n: c for n, c in self._columns.items() if n not in gone})

    def take(self, indices: np.ndarray) -> "Dataset":
        indices = np.asarray(indices)
        return Dataset({n: c.take(indices) for n, c in self._columns.items()})

    # -- constructors -------------------------------------------------------
    @staticmethod
    def concat(parts: Sequence["Dataset"]) -> "Dataset":
        """Row-concatenate chunk datasets sharing one column set (the
        streaming-ingest join, readers/pipeline.py).  Column order and
        names come from the first part; every part must carry the same
        columns."""
        from .columns import concat_columns

        parts = [p for p in parts if len(p)]
        if not parts:
            return Dataset()
        names = parts[0].column_names()
        for p in parts[1:]:
            if p.column_names() != names:
                raise ValueError(
                    "Dataset.concat parts disagree on columns: "
                    f"{names} vs {p.column_names()}"
                )
        return Dataset({
            n: concat_columns([p[n] for p in parts]) for n in names
        })

    @staticmethod
    def from_pylists(
        data: Mapping[str, Sequence], types: Mapping[str, Type[FeatureType]]
    ) -> "Dataset":
        return Dataset(
            {name: column_from_list(vals, types[name]) for name, vals in data.items()}
        )

    def to_pylists(self) -> dict[str, list]:
        return {n: c.to_list() for n, c in self._columns.items()}

    def __repr__(self) -> str:
        cols = ", ".join(
            f"{n}:{c.feature_type.__name__}" for n, c in self._columns.items()
        )
        return f"Dataset[{len(self)} rows]({cols})"
