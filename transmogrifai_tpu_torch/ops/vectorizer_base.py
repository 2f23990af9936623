"""Shared machinery for sequence vectorizers.

Counterpart of the reference's SequenceEstimator/SequenceTransformer bases
(reference: features/.../stages/base/sequence/SequenceEstimator.scala and
the vectorizer pattern of core/.../impl/feature/*Vectorizer.scala): a
vectorizer takes N same-type input features and emits ONE OPVector column
whose per-dimension provenance is recorded in VectorMetadata.

A fitted vectorizer lowers block by block: ``lower_block(i)`` is the numpy
closure for input ``i`` (the numpy-fused program) and ``lower_block_torch``
its torch mirror (the device program); either being None keeps the whole
stage off that program.
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence, Type

import numpy as np
import torch

from ..stages.base import (
    MASK_SUFFIX,
    Estimator,
    Lowering,
    TorchLowering,
    Transformer,
)
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

    # -- compile-to-kernel seam (stages/base.Lowering) ----------------------
    def lower_block(self, i: int) -> Optional[Callable[[dict], np.ndarray]]:
        """Array-level analog of ``blocks_for`` for input ``i``: a pure
        closure over the fitted state mapping the lowered env to the
        [n, k] float block.  None (the default) marks the block - and
        therefore the whole stage - as not lowerable."""
        return None

    def _block_inputs(self, block_of) -> Optional[tuple[list, list]]:
        """(block closures, env keys read) over every input, or None when
        any block does not lower."""
        blocks = []
        inputs: list[str] = []
        for i, feat in enumerate(self.input_features):
            fn_i = block_of(i)
            if fn_i is None:
                return None
            blocks.append(fn_i)
            inputs.append(feat.name)
            if feat.ftype.kind == "numeric":
                # numeric blocks read the @mask companion too; declared
                # so the compiler can validate it is actually produced
                inputs.append(feat.name + MASK_SUFFIX)
        return (blocks, inputs) if blocks else None

    def lower(self) -> Optional[Lowering]:
        found = self._block_inputs(self.lower_block)
        if found is None:
            return None
        blocks, inputs = found
        out = self.output_name

        def fn(env: dict) -> dict:
            arrays = [
                np.asarray(b(env), dtype=np.float32) for b in blocks
            ]
            return {out: np.concatenate(arrays, axis=1)}

        return Lowering(
            fn=fn,
            inputs=tuple(inputs),
            outputs=(out,),
            signature={out: "float32[n,d]"},
        )

    # -- device seam (stages/base.TorchLowering) ----------------------------
    def lower_block_torch(self, i: int) -> Optional[Callable[[dict], torch.Tensor]]:
        """Torch analog of ``lower_block`` for input ``i``.  None (the
        default) keeps the stage off the device program; a stage whose
        numpy lowering consumes only host-available keys (one-hot text
        pivots) then runs as a host pre-step instead."""
        return None

    def lower_torch(self) -> Optional[TorchLowering]:
        found = self._block_inputs(self.lower_block_torch)
        if found is None:
            return None
        blocks, inputs = found
        out = self.output_name

        def fn(env: dict) -> dict:
            arrays = [b(env).to(torch.float32) for b in blocks]
            return {out: torch.cat(arrays, dim=1)}

        return TorchLowering(
            fn=fn,
            inputs=tuple(inputs),
            outputs=(out,),
            signature={out: "float32[n,d]"},
        )


class SequenceVectorizer(Estimator):
    """Estimator base for vectorizers needing fit-time statistics."""

    output_type: Type[FeatureType] = OPVector
