"""Vector assembly.

Counterparts of VectorsCombiner / DropIndicesByTransformer / AliasTransformer
(reference: core/.../impl/feature/VectorsCombiner.scala:47-82,
DropIndicesByTransformer.scala, AliasTransformer.scala): concatenate OPVector
columns preserving per-dimension provenance metadata.

The JAX package's ``lower``/``lower_xla`` seams come with the fused-scoring
slice (ROADMAP.md queue 1, item 7).
"""
from __future__ import annotations

from typing import Callable, Sequence

import numpy as np

from ..stages.base import Transformer
from ..types.columns import Column, VectorColumn
from ..types.dataset import Dataset
from ..types.feature_types import OPVector
from ..types.vector_metadata import VectorColumnMeta, VectorMetadata


class VectorsCombiner(Transformer):
    """Concatenate vectors + merge metadata (reference: VectorsCombiner.scala).
    Pure transformer here: metadata merging needs no fit pass because each
    input column already carries its own VectorMetadata."""

    input_types = [OPVector, ...]
    output_type = OPVector

    def transform_columns(self, cols: Sequence[Column], ds: Dataset) -> Column:
        vecs = []
        metas = []
        for c in cols:
            assert isinstance(c, VectorColumn)
            vecs.append(c.values)
            metas.append(c.metadata)
        values = (
            np.concatenate(vecs, axis=1)
            if vecs
            else np.zeros((len(ds), 0), dtype=np.float32)
        )
        # memoize by input-metadata identity: upstream fitted stages emit
        # cached metadata objects, so repeated transforms (per-row
        # serving) skip the O(total columns) merge; the cache holds the
        # input metas to pin their ids
        cache = getattr(self, "_combine_cache", None)
        key = tuple(id(m) for m in metas)
        if cache is not None and cache[0] == key:
            meta = cache[1]
        else:
            meta = VectorMetadata.combine(self.output_name, metas)
            self._combine_cache = (key, meta, metas)
        return VectorColumn(values, meta)


class DropIndicesByTransformer(Transformer):
    """Drop vector dimensions whose metadata matches a predicate (reference:
    DropIndicesByTransformer.scala)."""

    input_types = [OPVector]
    output_type = OPVector

    def __init__(self, predicate: Callable[[VectorColumnMeta], bool], **kw) -> None:
        super().__init__(**kw)
        self.predicate = predicate

    def transform_columns(self, cols: Sequence[Column], ds: Dataset) -> Column:
        (c,) = cols
        assert isinstance(c, VectorColumn)
        keep = [i for i, m in enumerate(c.metadata.columns) if not self.predicate(m)]
        return VectorColumn(
            c.values[:, keep],
            c.metadata.select(keep),
        )


class AliasTransformer(Transformer):
    """Rename a feature without copying data (reference:
    AliasTransformer.scala)."""

    def __init__(self, name: str, **kw) -> None:
        super().__init__(**kw)
        self.alias = name

    def make_output_name(self) -> str:
        return self.alias

    def transform_columns(self, cols: Sequence[Column], ds: Dataset) -> Column:
        (c,) = cols
        return c

    def set_input(self, *features):
        super().set_input(*features)
        self.output_type = features[0].ftype
        return self
