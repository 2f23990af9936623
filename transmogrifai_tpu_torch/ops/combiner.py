"""Vector assembly.

Counterparts of VectorsCombiner / DropIndicesByTransformer / AliasTransformer
(reference: core/.../impl/feature/VectorsCombiner.scala:47-82,
DropIndicesByTransformer.scala, AliasTransformer.scala): concatenate OPVector
columns preserving per-dimension provenance metadata.

The combiner and the alias lower to numpy (``lower``) and to torch
(``lower_torch``); a text alias stays on the host.
"""
from __future__ import annotations

from typing import Callable, Sequence

import numpy as np
import torch

from ..stages.base import MASK_SUFFIX, Lowering, TorchLowering, Transformer
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

    def lower(self):
        if not self.input_features:
            return None
        names = tuple(f.name for f in self.input_features)
        out = self.output_name

        def fn(env: dict) -> dict:
            return {out: np.concatenate([env[k] for k in names], axis=1)}

        return Lowering(
            fn=fn, inputs=names, outputs=(out,),
            signature={out: "float32[n,d]"},
        )

    def lower_torch(self):
        if not self.input_features:
            return None
        names = tuple(f.name for f in self.input_features)
        out = self.output_name

        def fn(env: dict) -> dict:
            return {out: torch.cat([env[k] for k in names], dim=1)}

        return TorchLowering(
            fn=fn, inputs=names, outputs=(out,),
            signature={out: "float32[n,d]"},
        )


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

    def _alias_lowering(self, kinds: tuple, cls):
        (feat,) = self.input_features
        kind = feat.ftype.kind
        if kind not in kinds:
            return None
        name, out = feat.name, self.output_name
        aux = (MASK_SUFFIX,) if kind == "numeric" else ()

        def fn(env: dict) -> dict:
            res = {out: env[name]}
            res.update({out + s: env[name + s] for s in aux})
            return res

        return cls(
            fn=fn, inputs=(name,) + tuple(name + s for s in aux),
            outputs=(out,) + tuple(out + s for s in aux),
            signature={out: "passthrough"},
        )

    def lower(self):
        return self._alias_lowering(("numeric", "text", "vector"), Lowering)

    def lower_torch(self):
        # text aliases stay host-side (object arrays are no tensors); the
        # host pre-step route covers them
        return self._alias_lowering(("numeric", "vector"), TorchLowering)
