"""Shared machinery for sequence vectorizers.

Counterpart of the reference's SequenceEstimator/SequenceTransformer bases
(reference: features/.../stages/base/sequence/SequenceEstimator.scala and
the vectorizer pattern of core/.../impl/feature/*Vectorizer.scala): a
vectorizer takes N same-type input features and emits ONE OPVector column
whose per-dimension provenance is recorded in VectorMetadata.

The JAX package's ``lower``/``lower_xla`` seams come with the fused-scoring
slice (ROADMAP.md queue 1, item 7).
"""
from __future__ import annotations

from typing import Sequence, Type

import numpy as np

from ..stages.base import Estimator, Transformer
from ..types.columns import Column, VectorColumn
from ..types.dataset import Dataset
from ..types.feature_types import FeatureType, OPVector
from ..types.vector_metadata import VectorColumnMeta, VectorMetadata


class SequenceVectorizerModel(Transformer):
    """Fitted vectorizer: builds [n, d] dense blocks per input feature and
    concatenates.  Subclasses implement ``blocks_for(col, feature_idx)``
    returning (array [n, k], list[VectorColumnMeta])."""

    output_type: Type[FeatureType] = OPVector

    def blocks_for(self, col: Column, i: int) -> tuple[np.ndarray, list[VectorColumnMeta]]:
        raise NotImplementedError

    def cached_metas(self, i: int, state: tuple, build):
        """Per-column memo for the block's VectorColumnMeta list: a fitted
        vectorizer's metas are fully determined by its fitted state, yet
        the naive path rebuilds hundreds of frozen dataclasses per
        transform - the dominant single-row serving cost after round 4's
        reindexed() memo.  ``state`` keys the entry to the exact fitted
        fields the metas derive from, so a post-fit mutation rebuilds
        instead of serving stale provenance.  Returning the SAME objects
        also turns transform_columns' full-tuple staleness compare into
        identity short-circuits."""
        memo = getattr(self, "_metas_memo", None)
        if memo is None:
            memo = self._metas_memo = {}
        hit = memo.get(i)
        if hit is not None and hit[0] == state:
            return hit[1]
        ms = build()
        memo[i] = (state, ms)
        return ms

    def transform_columns(self, cols: Sequence[Column], ds: Dataset) -> Column:
        arrays: list[np.ndarray] = []
        metas: list[VectorColumnMeta] = []
        for i, col in enumerate(cols):
            arr, ms = self.blocks_for(col, i)
            arrays.append(np.asarray(arr, dtype=np.float32))
            metas.extend(ms)
        values = (
            np.concatenate(arrays, axis=1)
            if arrays
            else np.zeros((len(ds), 0), dtype=np.float32)
        )
        # a FITTED vectorizer's metadata is static: cache the reindexed
        # tuple so repeated transforms (row scoring calls the whole DAG
        # per row) skip ~k dataclass copies per call - profiled as the
        # dominant single-row serving cost
        metas_t = tuple(metas)
        cache = getattr(self, "_meta_cache", None)
        if (
            cache is not None
            and cache[0] == self.output_name
            # full-tuple equality: metas are small frozen dataclasses, so
            # this is cheap relative to reindexed() and it catches post-fit
            # mutation of ANY column meta, not just the ends
            and cache[2] == metas_t
        ):
            meta = cache[1]
        else:
            meta = VectorMetadata(self.output_name, metas_t).reindexed()
            self._meta_cache = (self.output_name, meta, metas_t)
        return VectorColumn(values, meta)


class SequenceVectorizer(Estimator):
    """Estimator base for vectorizers needing fit-time statistics."""

    output_type: Type[FeatureType] = OPVector
