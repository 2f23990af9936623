"""Map vectorizers: per-key expansion of every OPMap type.

Counterparts of the OPMapVectorizer family (reference: core/.../impl/
feature/OPMapVectorizer.scala, TextMapPivotVectorizer.scala,
SmartTextMapVectorizer.scala, MultiPickListMapVectorizer.scala,
DateMapToUnitCircleVectorizer.scala, GeolocationMapVectorizer.scala): the
key set of each map feature is discovered at fit time (sorted, optionally
filtered by white/blacklists); each key becomes a pseudo-column vectorized
by the value type's default strategy (impute+null-track for numerics,
top-K pivot for categorical text, circular encoding for dates, geo-mean
fill for geolocations).  Free-text keys get the SmartTextMapVectorizer
treatment: keys whose cardinality exceeds ``max_cardinality`` are
tokenize+hashed into ONE shared hash space per map feature (tokens salted
with the key name - the reference's shared HashSpaceStrategy), instead of
degrading to a top-K pivot's OTHER bucket.
"""
from __future__ import annotations

from collections import Counter
from typing import Optional, Sequence

import numpy as np

from ..features.feature import Feature
from ..types import feature_types as ft
from ..types.columns import Column, MapColumn
from ..types.dataset import Dataset
from ..types.vector_metadata import NULL_STRING, VectorColumnMeta
from ..utils.masked_stats import masked_mean, masked_mode
from .categorical import top_k_labels, _clean_value
from .dates import period_fraction
from .vectorizer_base import SequenceVectorizer, SequenceVectorizerModel


def _clean_key(k, clean_keys: bool = True):
    return k.strip() if clean_keys and isinstance(k, str) else k


def _cleaned_col(col: MapColumn, clean_keys: bool) -> MapColumn:
    """Key-cleaned view of a map column; BOTH fit and transform must read
    through this so ' a ' and 'a' merge into one fitted key (reference:
    cleanKeys in OPMapVectorizer.scala:77 applied via cleanMap on every
    pass).  Returns the column unchanged when no key needs cleaning."""
    if not clean_keys:
        return col
    changed = False
    rows = []
    for d in col.values:
        nd = {}
        for k, v in d.items():
            ck = _clean_key(k)
            if ck != k:
                changed = True
            nd[ck] = v
        rows.append(nd)
    return MapColumn(rows, col.feature_type) if changed else col


def _key_values(col: MapColumn, key: str) -> list:
    return [d.get(key) for d in col.values]


def _numeric_key_arrays(col: MapColumn, key: str) -> tuple[np.ndarray, np.ndarray]:
    vals = _key_values(col, key)
    mask = np.array([v is not None for v in vals], dtype=bool)
    arr = np.array([float(v) if v is not None else 0.0 for v in vals])
    return arr, mask


class MapVectorizerModel(SequenceVectorizerModel):
    """Fitted per-key plans.  plan: list per feature of
    {"key", "kind", "fill", "labels", "periods"}."""

    def __init__(self, plans: Sequence[list[dict]], track_nulls: bool,
                 clean_text: bool, clean_keys: bool = True, **kw) -> None:
        super().__init__(**kw)
        self.plans = list(plans)
        self.track_nulls = track_nulls
        self.clean_text = clean_text
        self.clean_keys = clean_keys

    def _plan_state(self, i: int) -> tuple:
        """Hashable digest of every fitted field the metas derive from
        (fill values change arrays, not metas, so they are excluded)."""
        return tuple(
            (p["key"] if "key" in p else None, p["kind"],
             tuple(p.get("labels") or ()), tuple(p.get("periods") or ()),
             tuple(p.get("keys") or ()), p.get("dims"))
            for p in self.plans[i]
        )

    def blocks_for(self, col: Column, i: int):
        assert isinstance(col, MapColumn)
        col = _cleaned_col(col, getattr(self, "clean_keys", True))
        feat = self.input_features[i]
        tname = feat.ftype.type_name()
        blocks: list[np.ndarray] = []
        # metas interleave with the plan walk, so the memo guards the
        # SAME loop instead of a mirror builder: on a hit the appends are
        # skipped and the cached list is returned (serving hot path)
        memo = getattr(self, "_metas_memo", None)
        if memo is None:
            memo = self._metas_memo = {}
        state = (feat.name, tname, self.track_nulls, self.clean_text,
                 self._plan_state(i))
        hit = memo.get(i)
        need_metas = hit is None or hit[0] != state
        metas: list[VectorColumnMeta] = [] if need_metas else hit[1]

        def add_meta(**kw) -> None:
            if need_metas:
                metas.append(VectorColumnMeta(
                    parent_feature_name=feat.name, parent_feature_type=tname,
                    **kw))

        def null_block(mask: np.ndarray, key: str) -> None:
            if self.track_nulls:
                blocks.append((~mask).astype(np.float64)[:, None])
                add_meta(grouping=key, indicator_value=NULL_STRING)

        for plan in self.plans[i]:
            key, kind = plan["key"], plan["kind"]
            if kind == "numeric":
                arr, mask = _numeric_key_arrays(col, key)
                filled = np.where(mask, arr, plan["fill"])
                blocks.append(filled[:, None])
                add_meta(grouping=key)
                null_block(mask, key)
            elif kind == "pivot":
                vals = _key_values(col, key)
                labels = plan["labels"]
                idx = {v: j for j, v in enumerate(labels)}
                arr = np.zeros((len(col), len(labels) + 1))
                mask = np.zeros(len(col), dtype=bool)
                for r, v in enumerate(vals):
                    if v is None:
                        continue
                    mask[r] = True
                    vs = (
                        [_clean_value(x, self.clean_text) for x in v]
                        if isinstance(v, (set, frozenset, list, tuple))
                        else [_clean_value(str(v), self.clean_text)]
                    )
                    for x in vs:
                        j = idx.get(x)
                        if j is None:
                            arr[r, len(labels)] = 1.0
                        else:
                            arr[r, j] = 1.0
                blocks.append(arr)
                for lab in labels + ["OTHER"]:
                    add_meta(grouping=key, indicator_value=lab)
                null_block(mask, key)
            elif kind == "date":
                arr, mask = _numeric_key_arrays(col, key)
                for p in plan["periods"]:
                    rad = 2.0 * np.pi * period_fraction(arr, p)
                    for trig, nm in ((np.sin, "sin"), (np.cos, "cos")):
                        blocks.append(np.where(mask, trig(rad), 0.0)[:, None])
                        add_meta(grouping=key, descriptor_value=f"{p}_{nm}")
                null_block(mask, key)
            elif kind == "geo":
                vals = _key_values(col, key)
                mask = np.array([v is not None for v in vals], dtype=bool)
                dense = np.array(
                    [list(v)[:3] if v is not None else [0.0, 0.0, 0.0] for v in vals]
                )
                filled = np.where(mask[:, None], dense, np.asarray(plan["fill"])[None, :])
                blocks.append(filled)
                for d in ("lat", "lon", "accuracy"):
                    add_meta(grouping=key, descriptor_value=d)
                null_block(mask, key)
            elif kind == "hash":
                # shared hash block for this feature's high-cardinality
                # free-text keys (SmartTextMapVectorizer.scala semantics):
                # tokens salted by key so identical words under different
                # keys occupy distinct slots in the shared space
                from .text import tokenize
                from ..utils.hashing import hashing_tf

                dims = int(plan["dims"])
                docs = []
                any_mask = np.zeros(len(col), dtype=bool)
                for r, d in enumerate(col.values):
                    toks: list[str] = []
                    for key in plan["keys"]:
                        v = d.get(key)
                        if v is None:
                            continue
                        any_mask[r] = True
                        toks.extend(
                            f"{key}={t}" for t in tokenize(str(v))
                        )
                    docs.append(toks)
                blocks.append(hashing_tf(docs, dims, seed=plan["seed"]))
                for j in range(dims):
                    add_meta(descriptor_value=f"hash_{j}")
                if self.track_nulls:
                    blocks.append((~any_mask).astype(np.float64)[:, None])
                    add_meta(indicator_value=NULL_STRING)
            else:  # pragma: no cover
                raise ValueError(kind)
        if need_metas:
            memo[i] = (state, metas)
        if not blocks:
            return np.zeros((len(col), 0)), []
        return np.concatenate(blocks, axis=1), metas


class MapVectorizer(SequenceVectorizer):
    """Generic map vectorizer dispatching on the map's value type."""

    input_types = [ft.OPMap, ...]

    def __init__(
        self,
        top_k: int = 20,
        min_support: int = 10,
        track_nulls: bool = True,
        clean_text: bool = True,
        clean_keys: bool = True,
        allow_keys: Optional[Sequence[str]] = None,
        block_keys: Optional[Sequence[str]] = None,
        date_periods: Sequence[str] = ("HourOfDay", "DayOfWeek", "DayOfMonth", "WeekOfYear"),
        max_cardinality: int = 30,
        hash_dims: int = 512,
        seed: int = 42,
        **kw,
    ) -> None:
        super().__init__(**kw)
        self.top_k = top_k
        self.min_support = min_support
        self.track_nulls = track_nulls
        self.clean_text = clean_text
        self.clean_keys = clean_keys
        # allow/block entries must live in the same (cleaned) key space the
        # fitted keys do, or whitespace-padded entries silently stop
        # filtering once the column is cleaned
        self.allow_keys = (
            {_clean_key(k, clean_keys) for k in allow_keys}
            if allow_keys else None
        )
        self.block_keys = {_clean_key(k, clean_keys) for k in (block_keys or ())}
        self.date_periods = tuple(date_periods)
        self.max_cardinality = max_cardinality
        self.hash_dims = hash_dims
        self.seed = seed

    def _keys_of(self, col: MapColumn) -> list[str]:
        keys = [k for k in col.all_keys() if k not in self.block_keys]
        if self.allow_keys is not None:
            keys = [k for k in keys if k in self.allow_keys]
        return sorted(keys)

    def fit_model(self, cols: Sequence[Column], ds: Dataset):
        plans = []
        for i, col in enumerate(cols):
            assert isinstance(col, MapColumn)
            col = _cleaned_col(col, self.clean_keys)
            vt = self.input_features[i].ftype.value_type or ft.Real
            feature_plans = []
            hash_keys: list[str] = []
            for key in self._keys_of(col):
                if issubclass(vt, ft.Date):
                    feature_plans.append(
                        {"key": key, "kind": "date", "periods": self.date_periods}
                    )
                elif issubclass(vt, ft.Geolocation):
                    from .geo import geographic_midpoint

                    vals = [v for v in _key_values(col, key) if v is not None]
                    fill = (
                        geographic_midpoint(
                            np.array([list(v)[:3] for v in vals])
                        )
                        if vals else np.zeros(3)
                    ).tolist()
                    feature_plans.append({"key": key, "kind": "geo", "fill": fill})
                elif issubclass(vt, ft.OPNumeric):
                    arr, mask = _numeric_key_arrays(col, key)
                    fill = (
                        masked_mode(arr, mask)
                        if issubclass(vt, (ft.Integral, ft.Binary))
                        else masked_mean(arr, mask)
                    )
                    feature_plans.append({"key": key, "kind": "numeric", "fill": fill})
                else:  # text-ish -> pivot, or hash when high-cardinality
                    counts: Counter = Counter()
                    for v in _key_values(col, key):
                        if v is None:
                            continue
                        if isinstance(v, (set, frozenset, list, tuple)):
                            counts.update(_clean_value(x, self.clean_text) for x in v)
                        else:
                            counts[_clean_value(str(v), self.clean_text)] += 1
                    # SmartTextMapVectorizer dispatch: FREE text (never
                    # categorical picklist-style values) whose cardinality
                    # blows past max_cardinality hashes instead of losing
                    # everything beyond top-K to the OTHER bucket
                    free_text = (
                        issubclass(vt, ft.Text) and not vt.is_categorical
                    )
                    if free_text and len(counts) > self.max_cardinality:
                        hash_keys.append(key)
                        continue
                    labels = top_k_labels(counts, self.top_k, self.min_support)
                    feature_plans.append({"key": key, "kind": "pivot", "labels": labels})
            if hash_keys:
                feature_plans.append({
                    "key": "|".join(hash_keys), "kind": "hash",
                    "keys": hash_keys, "dims": self.hash_dims,
                    "seed": self.seed,
                })
            plans.append(feature_plans)
        return MapVectorizerModel(
            plans, self.track_nulls, self.clean_text,
            clean_keys=self.clean_keys,
        )


def transmogrify_map_group(feats: Sequence[Feature], defaults) -> Feature:
    stage = MapVectorizer(
        top_k=defaults.top_k,
        min_support=defaults.min_support,
        track_nulls=defaults.track_nulls,
        clean_text=defaults.clean_text,
        date_periods=defaults.date_periods,
        max_cardinality=defaults.max_categorical_cardinality,
        hash_dims=defaults.hash_dims,
    )
    return stage.set_input(*feats).get_output()


class TextMapLenModel(SequenceVectorizerModel):
    """Fitted text-map length vectorizer: one column per fitted key holding
    the summed token lengths of that key's value (reference:
    TextMapLenEstimator.scala TextMapLenModel — tokenize then sum lengths)."""

    input_types = [ft.OPMap, ...]

    def __init__(self, all_keys: Sequence[Sequence[str]],
                 clean_keys: bool = True, **kw) -> None:
        super().__init__(**kw)
        self.all_keys = [list(ks) for ks in all_keys]
        self.clean_keys = clean_keys

    def blocks_for(self, col: Column, i: int):
        from .text import tokenize

        assert isinstance(col, MapColumn)
        feat = self.input_features[i]
        keys = self.all_keys[i] if i < len(self.all_keys) else []
        arr = np.zeros((len(col), len(keys)), dtype=np.float32)
        for r, m in enumerate(col.values):
            cleaned = {_clean_key(k, self.clean_keys): v for k, v in m.items()}
            for j, k in enumerate(keys):
                v = cleaned.get(k)
                if v is not None:
                    arr[r, j] = float(sum(len(t) for t in tokenize(str(v))))
        metas = self.cached_metas(
            i,
            (feat.name, feat.ftype.type_name(), tuple(keys)),
            lambda: [
                VectorColumnMeta(
                    parent_feature_name=feat.name,
                    parent_feature_type=feat.ftype.type_name(),
                    grouping=k,
                    descriptor_value="TextLen",
                )
                for k in keys
            ],
        )
        return arr, metas


class TextMapLenEstimator(SequenceVectorizer):
    """Per-key text lengths for text-valued maps; tokenization happens here
    because there is no map-of-TextList type (reference:
    TextMapLenEstimator.scala:44)."""

    input_types = [ft.OPMap, ...]

    def __init__(self, clean_keys: bool = True, **kw) -> None:
        super().__init__(**kw)
        self.clean_keys = clean_keys

    def _fit_keys(self, cols: Sequence[Column]) -> list[list[str]]:
        all_keys: list[list[str]] = []
        for col in cols:
            assert isinstance(col, MapColumn)
            keys: dict[str, None] = {}
            for m in col.values:
                for k in m:
                    keys.setdefault(_clean_key(k, self.clean_keys))
            all_keys.append(sorted(keys))
        return all_keys

    def fit_model(self, cols: Sequence[Column], ds: Dataset):
        all_keys = self._fit_keys(cols)
        model = TextMapLenModel(all_keys, self.clean_keys)
        model.metadata = {"keys": all_keys}
        self.metadata = model.metadata
        return model


class TextMapNullModel(SequenceVectorizerModel):
    """Fitted per-key null indicators for maps (reference:
    TextMapNullEstimator.scala TextMapNullModel)."""

    input_types = [ft.OPMap, ...]

    def __init__(self, all_keys: Sequence[Sequence[str]],
                 clean_keys: bool = True, **kw) -> None:
        super().__init__(**kw)
        self.all_keys = [list(ks) for ks in all_keys]
        self.clean_keys = clean_keys

    def blocks_for(self, col: Column, i: int):
        assert isinstance(col, MapColumn)
        feat = self.input_features[i]
        keys = self.all_keys[i] if i < len(self.all_keys) else []
        arr = np.zeros((len(col), len(keys)), dtype=np.float32)
        for r, m in enumerate(col.values):
            present = {_clean_key(k, self.clean_keys)
                       for k, v in m.items() if v is not None}
            for j, k in enumerate(keys):
                if k not in present:
                    arr[r, j] = 1.0
        metas = self.cached_metas(
            i,
            (feat.name, feat.ftype.type_name(), tuple(keys)),
            lambda: [
                VectorColumnMeta(
                    parent_feature_name=feat.name,
                    parent_feature_type=feat.ftype.type_name(),
                    grouping=k,
                    indicator_value=NULL_STRING,
                )
                for k in keys
            ],
        )
        return arr, metas


class TextMapNullEstimator(TextMapLenEstimator):
    """Per-key null-indicator columns for maps — the standalone null
    tracking used alongside shared-hash-space text-map hashing (reference:
    TextMapNullEstimator.scala:47)."""

    def fit_model(self, cols: Sequence[Column], ds: Dataset):
        all_keys = self._fit_keys(cols)
        model = TextMapNullModel(all_keys, self.clean_keys)
        model.metadata = {"keys": all_keys}
        self.metadata = model.metadata
        return model
