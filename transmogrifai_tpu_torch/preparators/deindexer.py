"""Prediction de-indexing: indexed class predictions back to labels.

Counterpart of PredictionDeIndexer (reference: core/.../impl/preparators/
PredictionDeIndexer.scala): after a multiclass model trained on
StringIndexer-encoded labels, map the numeric ``prediction`` field back to
the original label strings.  Fitted against the label column's indexer
labels; unseen indices yield None (NoFilter semantics, like
OpIndexToStringNoFilter).
"""
from __future__ import annotations

from typing import Sequence

import numpy as np

from ..stages.base import Estimator, Transformer
from ..types.columns import Column, PredictionColumn, TextColumn
from ..types.dataset import Dataset
from ..types.feature_types import Prediction, Text


class PredictionDeIndexerModel(Transformer):
    """Inputs mirror the estimator's (label Text, Prediction); only the
    Prediction column is read at transform time."""

    input_types = [Text, Prediction]
    output_type = Text

    def __init__(self, labels: Sequence[str], **kw) -> None:
        super().__init__(**kw)
        self.labels = list(labels)

    def transform_columns(self, cols: Sequence[Column], ds: Dataset) -> Column:
        col = cols[-1]
        assert isinstance(col, PredictionColumn)
        out = np.empty(len(col), dtype=object)
        nl = len(self.labels)
        for i, p in enumerate(np.asarray(col.prediction)):
            j = int(p)
            out[i] = self.labels[j] if 0 <= j < nl else None
        return TextColumn(out, Text)


class PredictionDeIndexer(Estimator):
    """Two inputs: the raw text label feature (to learn the index order the
    way the StringIndexer did) and the Prediction to de-index."""

    input_types = [Text, Prediction]
    output_type = Text

    def fit_model(self, cols: Sequence[Column], ds: Dataset):
        label_col = cols[0]
        assert isinstance(label_col, TextColumn)
        from collections import Counter

        counts = Counter(v for v in label_col.values if v is not None)
        labels = [
            v for v, _ in sorted(counts.items(), key=lambda vc: (-vc[1], vc[0]))
        ]
        return PredictionDeIndexerModel(labels)
