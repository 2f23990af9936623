"""Text processing: tokenization, hashing, cardinality-adaptive vectorization.

Counterparts of TextTokenizer, OPCollectionHashingVectorizer and
SmartTextVectorizer (reference: core/.../impl/feature/TextTokenizer.scala,
OPCollectionHashingVectorizer.scala, SmartTextVectorizer.scala:79-99):

* ``TextTokenizer`` - lowercasing + non-alphanumeric splitting + min-length
  filter (the Lucene standard-analyzer behavior the reference defaults to).
* ``TextStats`` - monoid value-count statistics with cardinality cap.
* ``SmartTextVectorizer`` - per feature: cardinality <= max_cardinality ->
  pivot (one-hot top-K); else -> tokenize + murmur3 hashing-TF; plus null
  indicators.  This is AutoML step 1's text work-horse.
"""
from __future__ import annotations

import re
from collections import Counter
from typing import Optional, Sequence

import numpy as np

from ..stages.base import Estimator, Transformer
from ..types.columns import Column, ListColumn, TextColumn, VectorColumn
from ..types.dataset import Dataset
from ..types.feature_types import OPVector, Text, TextList
from ..types.vector_metadata import NULL_STRING, VectorColumnMeta
from ..utils.hashing import hashing_tf
from .categorical import OneHotModel, top_k_labels, _clean_value
from .vectorizer_base import SequenceVectorizer, SequenceVectorizerModel

_TOKEN_RE = re.compile(r"[^\w]+", re.UNICODE)


def tokenize(
    text: Optional[str],
    to_lowercase: bool = True,
    min_token_length: int = 1,
) -> list[str]:
    """(reference: TextTokenizer.scala defaults: lucene standard analyzer,
    lowercase, minTokenLength=1)"""
    if not text:
        return []
    if to_lowercase:
        text = text.lower()
    return [t for t in _TOKEN_RE.split(text) if len(t) >= min_token_length]


class TextTokenizer(Transformer):
    """``remove_stopwords`` drops per-language function words like the
    reference's per-language Lucene analyzers (LuceneTextAnalyzer.scala);
    ``language`` is an ISO code or 'auto' (per-row detection via
    ops.lang_data, the TextTokenizer.scala languageDetection option)."""

    input_types = [Text]
    output_type = TextList

    def __init__(self, min_token_length: int = 1, to_lowercase: bool = True,
                 remove_stopwords: bool = False, language: str = "auto",
                 **kw):
        super().__init__(**kw)
        self.min_token_length = min_token_length
        self.to_lowercase = to_lowercase
        self.remove_stopwords = remove_stopwords
        self.language = language

    def _stop_set(self, text: Optional[str]):
        from .stopwords import stopwords_for

        lang = self.language
        if lang == "auto":
            from .lang_data import detect

            scores = detect(text or "")
            lang = next(iter(scores), "en")
        return stopwords_for(lang)

    def transform_columns(self, cols: Sequence[Column], ds: Dataset) -> Column:
        (col,) = cols
        assert isinstance(col, TextColumn)
        if not self.remove_stopwords:
            toks = [
                tuple(tokenize(v, self.to_lowercase, self.min_token_length))
                for v in col.values
            ]
        else:
            shared = (
                self._stop_set(None) if self.language != "auto" else None
            )
            toks = []
            for v in col.values:
                stop = shared if shared is not None else self._stop_set(v)
                toks.append(tuple(
                    t for t in tokenize(v, self.to_lowercase,
                                        self.min_token_length)
                    if t.lower() not in stop
                ))
        return ListColumn(toks, TextList)


class TextStats:
    """Monoid value-count stats (reference: SmartTextVectorizer.scala:79-99).
    Counts distinct raw values, capped at ``max_card + 1`` so huge-cardinality
    features stop accumulating early."""

    def __init__(self, max_card: int = 100) -> None:
        self.max_card = max_card
        self.value_counts: Counter = Counter()
        self.n_present = 0

    def update(self, value: Optional[str]) -> None:
        if value is None:
            return
        self.n_present += 1
        if len(self.value_counts) <= self.max_card or value in self.value_counts:
            self.value_counts[value] += 1

    @property
    def cardinality(self) -> int:
        return len(self.value_counts)

    def merge(self, other: "TextStats") -> "TextStats":
        # the cap applies on the distributed-merge path too, or combining
        # partition partials re-grows unbounded cardinality
        for v, c in other.value_counts.items():
            if (len(self.value_counts) <= self.max_card
                    or v in self.value_counts):
                self.value_counts[v] += c
        self.n_present += other.n_present
        return self


class SmartTextModel(SequenceVectorizerModel):
    def __init__(
        self,
        plans: Sequence[dict],
        hash_dims: int,
        track_nulls: bool,
        clean_text: bool,
        seed: int = 42,
        **kw,
    ) -> None:
        super().__init__(**kw)
        # plan per feature: {"mode": "pivot"|"hash"|"ignore", "labels": [...]}
        self.plans = list(plans)
        self.hash_dims = hash_dims
        self.track_nulls = track_nulls
        self.clean_text = clean_text
        self.seed = seed

    def blocks_for(self, col: Column, i: int):
        feat = self.input_features[i]
        plan = self.plans[i]
        tname = feat.ftype.type_name()
        if plan["mode"] == "pivot":
            # helper cached per column so ITS meta memo survives across
            # row-scoring calls (a fresh helper per call rebuilt every
            # label meta)
            helpers = getattr(self, "_pivot_helpers", None)
            if helpers is None:
                helpers = self._pivot_helpers = {}
            key = (feat.name, tuple(plan["labels"]), self.track_nulls,
                   self.clean_text)
            hit = helpers.get(i)
            if hit is None or hit[0] != key:
                helper = OneHotModel(
                    [plan["labels"]], self.track_nulls, self.clean_text
                )
                helper.input_features = (feat,)
                helpers[i] = (key, helper)
            else:
                helper = hit[1]
            return helper.blocks_for(col, 0)
        assert isinstance(col, TextColumn)
        mask = col.mask
        from ..utils.native import tokenize_hash_tf

        arr = tokenize_hash_tf(list(col.values), self.hash_dims, seed=self.seed)
        if arr is None:  # no native lib: pure-python fallback
            toks = [tokenize(v) for v in col.values]
            arr = hashing_tf(toks, self.hash_dims, seed=self.seed)
        def build():
            ms = [
                VectorColumnMeta(
                    parent_feature_name=feat.name,
                    parent_feature_type=tname,
                    descriptor_value=f"hash_{j}",
                )
                for j in range(self.hash_dims)
            ]
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
            i, (feat.name, tname, self.hash_dims, self.track_nulls), build
        )
        if self.track_nulls:
            arr = np.concatenate(
                [arr, (~mask).astype(np.float32)[:, None]], axis=1
            )
        return arr, metas


class TextListHashModel(SequenceVectorizerModel):
    def __init__(self, hash_dims: int, seed: int = 42, **kw) -> None:
        super().__init__(**kw)
        self.hash_dims = hash_dims
        self.seed = seed

    def blocks_for(self, col: Column, i: int):
        assert isinstance(col, ListColumn)
        feat = self.input_features[i]
        arr = hashing_tf(
            [list(v) for v in col.values], self.hash_dims, seed=self.seed
        )
        metas = self.cached_metas(
            i,
            (feat.name, feat.ftype.type_name(), self.hash_dims),
            lambda: [
                VectorColumnMeta(
                    parent_feature_name=feat.name,
                    parent_feature_type=feat.ftype.type_name(),
                    descriptor_value=f"hash_{j}",
                )
                for j in range(self.hash_dims)
            ],
        )
        return arr, metas


class TextListHashingVectorizer(SequenceVectorizer):
    """Hashing-TF over already-tokenized text lists (reference:
    OPCollectionHashingVectorizer.scala:42,76-86; 512 default dims)."""

    input_types = [TextList, ...]

    def __init__(self, hash_dims: int = 512, **kw) -> None:
        super().__init__(**kw)
        self.hash_dims = hash_dims

    def fit_model(self, cols: Sequence[Column], ds: Dataset):
        return TextListHashModel(self.hash_dims)


class SmartTextVectorizer(SequenceVectorizer):
    """Cardinality-adaptive text vectorization (reference:
    SmartTextVectorizer.scala:79-99; defaults TransmogrifierDefaults:
    maxCategoricalCardinality=30, 512 hash dims, topK=20, minSupport=10)."""

    input_types = [Text, ...]

    def __init__(
        self,
        max_cardinality: int = 30,
        top_k: int = 20,
        min_support: int = 10,
        hash_dims: int = 512,
        track_nulls: bool = True,
        clean_text: bool = True,
        **kw,
    ) -> None:
        super().__init__(**kw)
        self.max_cardinality = max_cardinality
        self.top_k = top_k
        self.min_support = min_support
        self.hash_dims = hash_dims
        self.track_nulls = track_nulls
        self.clean_text = clean_text

    def fit_model(self, cols: Sequence[Column], ds: Dataset):
        plans = []
        for col in cols:
            assert isinstance(col, TextColumn)
            stats = TextStats(max_card=max(self.max_cardinality * 2, 100))
            for v in col.values:
                stats.update(
                    None if v is None else _clean_value(v, self.clean_text)
                )
            if stats.cardinality <= self.max_cardinality:
                labels = top_k_labels(stats.value_counts, self.top_k, self.min_support)
                plans.append({"mode": "pivot", "labels": labels})
            else:
                plans.append({"mode": "hash", "labels": []})
        model = SmartTextModel(
            plans, self.hash_dims, self.track_nulls, self.clean_text
        )
        model.metadata = {
            "textStats": [
                {"mode": p["mode"], "nLabels": len(p["labels"])} for p in plans
            ]
        }
        return model


class TextListNullTransformer(SequenceVectorizerModel):
    """One null-indicator column per input TextList: 1.0 when the row's
    list is empty — the standalone null-tracking stage the hashing
    vectorizers rely on for shared hash spaces (reference:
    TextListNullTransformer.scala:48)."""

    input_types = [TextList, ...]

    def blocks_for(self, col: Column, i: int):
        assert isinstance(col, ListColumn)
        feat = self.input_features[i]
        arr = np.array(
            [[0.0 if v else 1.0] for v in col.values], dtype=np.float32
        )
        meta = VectorColumnMeta(
            parent_feature_name=feat.name,
            parent_feature_type=feat.ftype.type_name(),
            grouping=feat.name,
            indicator_value=NULL_STRING,
        )
        return arr, [meta]


class CountVectorizerModel(SequenceVectorizerModel):
    """Fitted vocabulary term counter (reference: OpCountVectorizer.scala
    wrapping spark ml CountVectorizerModel)."""

    input_types = [TextList]

    def __init__(self, vocabulary: Sequence[str], min_tf: float = 1.0,
                 binary: bool = False, **kw) -> None:
        super().__init__(**kw)
        self.vocabulary = list(vocabulary)
        self.min_tf = min_tf
        self.binary = binary

    def blocks_for(self, col: Column, i: int):
        assert isinstance(col, ListColumn)
        feat = self.input_features[i]
        index = {t: j for j, t in enumerate(self.vocabulary)}
        arr = np.zeros((len(col), len(self.vocabulary)), dtype=np.float32)
        for r, toks in enumerate(col.values):
            if not toks:
                continue
            counts = Counter(t for t in toks if t in index)
            # min_tf: int >= 1 is an absolute count; fraction is of the
            # row's token count (spark CountVectorizer minTF contract)
            thr = self.min_tf if self.min_tf >= 1.0 \
                else self.min_tf * len(toks)
            for t, c in counts.items():
                if c >= thr:
                    arr[r, index[t]] = 1.0 if self.binary else float(c)
        metas = self.cached_metas(
            i,
            (feat.name, feat.ftype.type_name(), tuple(self.vocabulary)),
            lambda: [
                VectorColumnMeta(
                    parent_feature_name=feat.name,
                    parent_feature_type=feat.ftype.type_name(),
                    grouping=feat.name,
                    indicator_value=term,
                )
                for term in self.vocabulary
            ],
        )
        return arr, metas


class OpCountVectorizer(SequenceVectorizer):
    """Vocabulary-based term-count vectorizer for TextList: the top
    ``vocab_size`` corpus terms appearing in >= min_df documents become
    count columns (reference: OpCountVectorizer.scala wrapping spark ml
    CountVectorizer — minDF/minTF int-is-count, fraction-is-ratio)."""

    input_types = [TextList]

    def __init__(self, vocab_size: int = 1 << 18, min_df: float = 1.0,
                 min_tf: float = 1.0, binary: bool = False, **kw) -> None:
        super().__init__(**kw)
        self.vocab_size = vocab_size
        self.min_df = min_df
        self.min_tf = min_tf
        self.binary = binary

    def fit_model(self, cols: Sequence[Column], ds: Dataset):
        (col,) = cols
        assert isinstance(col, ListColumn)
        df_counts: Counter = Counter()
        tf_counts: Counter = Counter()
        # fractional min_df is of ALL rows, empty documents included
        # (spark CountVectorizer minDF counts against the dataset size)
        n_docs = len(col)
        for toks in col.values:
            if not toks:
                continue
            tf_counts.update(toks)
            df_counts.update(set(toks))
        min_df = self.min_df if self.min_df >= 1.0 else self.min_df * n_docs
        # vocabulary: top vocab_size by corpus term frequency, ties and
        # order made deterministic by (-tf, term)
        eligible = [t for t, c in df_counts.items() if c >= min_df]
        eligible.sort(key=lambda t: (-tf_counts[t], t))
        vocab = eligible[: self.vocab_size]
        model = CountVectorizerModel(vocab, self.min_tf, self.binary)
        model.metadata = {"vocabulary": list(vocab)}
        self.metadata = model.metadata
        return model


class IDFModel(Transformer):
    """Scale a term-frequency vector by fitted idf weights."""

    input_types = [OPVector]
    output_type = OPVector

    def __init__(self, idf: np.ndarray, **kw) -> None:
        super().__init__(**kw)
        self.idf = np.asarray(idf, dtype=np.float64)

    def transform_columns(self, cols: Sequence[Column], ds: Dataset) -> Column:
        (c,) = cols
        assert isinstance(c, VectorColumn)
        return VectorColumn(c.values * self.idf[None, :], c.metadata)


class OpIDF(Estimator):
    """Inverse document frequency over a TF vector (reference: dsl
    RichTextFeature.scala idf/tfidf wrapping spark ml feature.IDF):
    idf_j = log((n + 1) / (df_j + 1)), df_j = documents with a non-zero
    j-th component; components with df below ``min_doc_freq`` zero out
    (spark's minDocFreq contract).  Vector metadata passes through
    unchanged - the columns are the same terms, rescaled."""

    input_types = [OPVector]
    output_type = OPVector

    def __init__(self, min_doc_freq: int = 0, **kw) -> None:
        super().__init__(**kw)
        self.min_doc_freq = int(min_doc_freq)

    def fit_model(self, cols: Sequence[Column], ds: Dataset):
        (c,) = cols
        assert isinstance(c, VectorColumn)
        n = len(c)
        df = (np.asarray(c.values) != 0.0).sum(axis=0).astype(np.float64)
        idf = np.log((n + 1.0) / (df + 1.0))
        if self.min_doc_freq > 0:
            idf = np.where(df >= self.min_doc_freq, idf, 0.0)
        return IDFModel(idf)
