"""Categorical pivot (one-hot) vectorizers and string indexing.

Counterparts of OpOneHotVectorizer / OpTextPivotVectorizer / OpStringIndexer
/ OpIndexToString (reference: core/.../impl/feature/OpOneHotVectorizer.scala,
OpStringIndexer.scala): pivot top-K values by support into indicator columns
plus OTHER and (optionally) null-indicator columns.  Label order is count
descending then value ascending - deterministic, matching the reference's
sorted pivots.

The pivot and the string indexer lower to numpy only (``lower_block``,
``lower``): strings never enter the device program, so a fused torch
pipeline runs them as host pre-steps.  The indexer's streamed fit from
per-chunk counts comes with streaming ingest (ROADMAP.md queue 1, item 12).
"""
from __future__ import annotations

from collections import Counter
from functools import lru_cache
from itertools import repeat
from typing import Sequence

import numpy as np

from ..stages.base import MASK_SUFFIX, Estimator, Lowering, Transformer
from ..types.columns import Column, ListColumn, NumericColumn, TextColumn
from ..types.dataset import Dataset
from ..types.feature_types import Real, RealNN, Text
from ..types.vector_metadata import (
    NULL_STRING,
    OTHER_STRING,
    VectorColumnMeta,
)
from .vectorizer_base import SequenceVectorizer, SequenceVectorizerModel


@lru_cache(maxsize=65536)
def _clean_cached(v: str) -> str:
    return v.strip().lower().replace(" ", "")


def _clean_value(v: str, clean_text: bool) -> str:
    # categorical domains are tiny relative to row counts, so this is
    # one strip/lower/replace per DISTINCT value instead of per cell -
    # the top tottime line of the batch-scoring profile (one call per
    # row x categorical column).  str keys only; anything else cleans
    # uncached.
    if not clean_text:
        return v
    try:
        return _clean_cached(v)
    except TypeError:  # unhashable or non-str oddity: clean directly
        return v.strip().lower().replace(" ", "")


def top_k_labels(
    counts: Counter, top_k: int, min_support: int
) -> list[str]:
    items = [(v, c) for v, c in counts.items() if c >= min_support]
    items.sort(key=lambda vc: (-vc[1], vc[0]))
    return [v for v, _ in items[:top_k]]


class OneHotModel(SequenceVectorizerModel):
    def __init__(
        self,
        labels_per_feature: Sequence[list[str]],
        track_nulls: bool,
        clean_text: bool,
        **kw,
    ) -> None:
        super().__init__(**kw)
        self.labels_per_feature = [list(l) for l in labels_per_feature]
        self.track_nulls = track_nulls
        self.clean_text = clean_text

    def _values_of(self, col: Column) -> tuple[list, np.ndarray]:
        """Per-row value-sets + presence mask for text or set columns."""
        if isinstance(col, TextColumn):
            vals = [
                None if v is None else (_clean_value(v, self.clean_text),)
                for v in col.values
            ]
        elif isinstance(col, ListColumn):
            vals = [
                tuple(_clean_value(x, self.clean_text) for x in v) if v else None
                for v in col.values
            ]
        elif isinstance(col, NumericColumn):
            vals = [
                (str(int(v)) if float(v).is_integer() else str(float(v)),) if m else None
                for v, m in zip(col.values, col.mask)
            ]
        else:  # pragma: no cover
            raise TypeError(f"cannot pivot column type {type(col).__name__}")
        mask = np.array([v is not None for v in vals], dtype=bool)
        return vals, mask

    def _text_codes(self, i: int, values) -> np.ndarray:
        """Raw text value -> column code (label index, OTHER, or -1 for
        missing) with the per-feature memo.  The single-value pivot hot
        path (batch-scoring profile top line)."""
        labels = self.labels_per_feature[i]
        other_j = len(labels)
        memos = getattr(self, "_code_memos", None)
        if memos is None:
            memos = self._code_memos = {}
        key = (tuple(labels), self.clean_text)
        hit = memos.get(i)
        if hit is None or hit[0] != key:
            # label->index built once per memo generation, not per batch:
            # only code_slow's first sightings need it
            memos[i] = hit = (
                key, {}, {v: j for j, v in enumerate(labels)},
            )
        memo, idx = hit[1], hit[2]
        if len(memo) > 65536:
            # same bound as _clean_cached: a high-cardinality text
            # feature must not grow the memo without limit in a
            # long-lived scoring process
            memo.clear()
        # missing IS a code: seeding the memo with None -> -1 lets the
        # whole batch encode through one C-level two-arg map
        memo.setdefault(None, -1)

        def code_slow(x):
            """First sighting of a value (or an unhashable oddity):
            clean + label lookup, memoized when possible."""
            if x is None:
                return -1
            try:
                hashable = True
                hash(x)
            except TypeError:
                hashable = False
            j = idx.get(_clean_value(x, self.clean_text))
            c = other_j if j is None else j
            if hashable:
                memo[x] = c
            return c

        _MISS = -2
        try:
            # steady state: ONE map(dict.get) call over the batch (the
            # C fast path); only first sightings take code_slow
            codes = np.array(
                list(map(memo.get, values, repeat(_MISS))),
                dtype=np.int64,
            )
        except TypeError:
            # an unhashable oddity in the batch: per-value tolerant pass
            return np.array(
                [code_slow(x) for x in values], dtype=np.int64,
            )
        miss = np.flatnonzero(codes == _MISS)
        if miss.size:
            codes[miss] = [code_slow(values[i]) for i in miss]
        return codes

    def _scatter_sets(self, vals, arr: np.ndarray, labels) -> None:
        """Indicator scatter for per-row value-sets (multi-value pivot)."""
        idx = {v: j for j, v in enumerate(labels)}
        other_j = len(labels)
        for r, vset in enumerate(vals):
            if vset is None:
                continue
            hit_other = False
            for v in vset:
                j = idx.get(v)
                if j is not None:
                    arr[r, j] = 1.0
                else:
                    hit_other = True
            if hit_other:
                arr[r, other_j] = 1.0

    def blocks_for(self, col: Column, i: int):
        feat = self.input_features[i]
        labels = self.labels_per_feature[i]
        n = len(col)
        width = len(labels) + 1 + (1 if self.track_nulls else 0)
        arr = np.zeros((n, width), dtype=np.float64)
        if isinstance(col, TextColumn):
            codes = self._text_codes(i, col.values)
            present = codes >= 0
            arr[np.nonzero(present)[0], codes[present]] = 1.0
        else:
            vals, present = self._values_of(col)
            self._scatter_sets(vals, arr, labels)
        def build():
            tname = feat.ftype.type_name()
            ms = [
                VectorColumnMeta(
                    parent_feature_name=feat.name,
                    parent_feature_type=tname,
                    grouping=feat.name,
                    indicator_value=lab,
                )
                for lab in labels
            ]
            ms.append(
                VectorColumnMeta(
                    parent_feature_name=feat.name,
                    parent_feature_type=tname,
                    grouping=feat.name,
                    indicator_value=OTHER_STRING,
                )
            )
            if self.track_nulls:
                ms.append(
                    VectorColumnMeta(
                        parent_feature_name=feat.name,
                        parent_feature_type=tname,
                        grouping=feat.name,
                        indicator_value=NULL_STRING,
                    )
                )
            return ms

        metas = self.cached_metas(
            i,
            (feat.name, feat.ftype.type_name(), tuple(labels),
             self.track_nulls),
            build,
        )
        if self.track_nulls:
            arr[:, -1] = (~present).astype(np.float64)
        return arr, metas

    def lower_block(self, i: int):
        feat = self.input_features[i]
        kind = feat.ftype.kind
        if kind not in ("text", "textlist", "multipicklist", "numeric"):
            return None
        name = feat.name
        labels = self.labels_per_feature[i]
        track_nulls, clean = self.track_nulls, self.clean_text
        width = len(labels) + 1 + (1 if track_nulls else 0)

        def block(env: dict) -> np.ndarray:
            values = env[name]
            n = len(values)
            arr = np.zeros((n, width), dtype=np.float64)
            if kind == "text":
                codes = self._text_codes(i, values)
                present = codes >= 0
                arr[np.nonzero(present)[0], codes[present]] = 1.0
            else:
                # the multi-value / numeric pivot branches of _values_of
                # over the lowered env representation (tuples/frozensets
                # for lists, values+mask arrays for numerics)
                if kind == "numeric":
                    mask = env[name + MASK_SUFFIX]
                    vals = [
                        (str(int(v)) if float(v).is_integer()
                         else str(float(v)),) if m else None
                        for v, m in zip(values, mask)
                    ]
                    present = np.asarray(mask, dtype=bool)
                else:
                    vals = [
                        tuple(_clean_value(x, clean) for x in v) if v
                        else None
                        for v in values
                    ]
                    present = np.array(
                        [v is not None for v in vals], dtype=bool
                    )
                self._scatter_sets(vals, arr, labels)
            if track_nulls:
                arr[:, -1] = (~present).astype(np.float64)
            return arr

        return block


class OneHotVectorizer(SequenceVectorizer):
    """Pivot top-K by support with OTHER + null columns (reference:
    OpOneHotVectorizer.scala; defaults TransmogrifierDefaults.scala:52-87:
    topK=20, minSupport=10, trackNulls=true)."""

    input_types = None  # accepts Text subtypes, MultiPickList, or numerics

    def __init__(
        self,
        top_k: int = 20,
        min_support: int = 10,
        track_nulls: bool = True,
        clean_text: bool = True,
        **kw,
    ) -> None:
        super().__init__(**kw)
        self.top_k = top_k
        self.min_support = min_support
        self.track_nulls = track_nulls
        self.clean_text = clean_text

    def fit_model(self, cols: Sequence[Column], ds: Dataset):
        model = OneHotModel([], self.track_nulls, self.clean_text)
        labels_per = []
        for col in cols:
            vals, _ = model._values_of(col)
            counts: Counter = Counter()
            for vset in vals:
                if vset:
                    counts.update(vset)
            labels_per.append(top_k_labels(counts, self.top_k, self.min_support))
        model.labels_per_feature = labels_per
        return model


class StringIndexerModel(Transformer):
    """value -> index; unseen values map to n_labels (NoFilter semantics,
    reference: OpStringIndexerNoFilter).  Output is RealNN like the
    reference's OpStringIndexer: every row gets an index (unseen/null ->
    the reserved tail slot), so the indexed label feeds selectors whose
    label input is RealNN directly."""

    output_type = RealNN

    def __init__(self, labels: list[str], **kw) -> None:
        super().__init__(**kw)
        self.labels = list(labels)

    def _encode(self, values) -> tuple:
        """str-or-None values -> (vals float64 [n], mask bool [n]): the
        ONE implementation of the NoFilter index semantics, shared by
        the interpreted and lowered paths so they can never diverge.
        UNSEEN strings get the reserved tail index; a MISSING value
        stays missing (masked, canonical 0.0) - it must not silently
        become a phantom class when the indexed feature is a training
        label (the predictor fit gate rejects masked labels)."""
        idx = getattr(self, "_idx_memo", None)
        if idx is None:
            idx = self._idx_memo = {
                v: float(j) for j, v in enumerate(self.labels)
            }
        unseen = float(len(self.labels))
        vals = np.array(
            [0.0 if v is None else idx.get(v, unseen) for v in values]
        )
        mask = np.array([v is not None for v in values], dtype=bool)
        return vals, mask

    def transform_columns(self, cols: Sequence[Column], ds: Dataset) -> Column:
        (col,) = cols
        assert isinstance(col, TextColumn)
        vals, mask = self._encode(col.values)
        return NumericColumn(vals, mask, RealNN)

    def lower(self):
        (feat,) = self.input_features
        if feat.ftype.kind != "text":
            return None
        name, out = feat.name, self.output_name
        encode = self._encode

        def fn(env: dict) -> dict:
            vals, mask = encode(env[name])
            return {out: vals, out + MASK_SUFFIX: mask}

        return Lowering(
            fn=fn, inputs=(name,), outputs=(out, out + MASK_SUFFIX),
            signature={out: "float64[n]", out + MASK_SUFFIX: "bool[n]"},
        )


class StringIndexer(Estimator):
    """Index labels by frequency desc then value asc (reference:
    OpStringIndexer.scala wrapping Spark StringIndexer semantics)."""

    input_types = [Text]
    output_type = RealNN

    def fit_model(self, cols: Sequence[Column], ds: Dataset):
        (col,) = cols
        counts = Counter(v for v in col.values if v is not None)
        labels = [v for v, _ in sorted(counts.items(), key=lambda vc: (-vc[1], vc[0]))]
        return StringIndexerModel(labels)


class IndexToString(Transformer):
    """Inverse of StringIndexer (reference: OpIndexToString.scala)."""

    input_types = [Real]
    output_type = Text

    def __init__(self, labels: list[str], **kw) -> None:
        super().__init__(**kw)
        self.labels = list(labels)

    def transform_columns(self, cols: Sequence[Column], ds: Dataset) -> Column:
        (col,) = cols
        assert isinstance(col, NumericColumn)
        out = [
            self.labels[int(v)] if m and 0 <= int(v) < len(self.labels) else None
            for v, m in zip(col.values, col.mask)
        ]
        return TextColumn(np.array(out, dtype=object), Text)
