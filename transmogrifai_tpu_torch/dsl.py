"""User-facing DSL: rich operations on features.

Counterpart of ``transmogrifai_tpu/dsl.py`` (reference: core/.../dsl/
RichFeaturesCollection.scala:69 transmogrify, RichNumericFeature.scala:479
sanityCheck + feature math, RichTextFeature pivot/tokenize).  Importing this
module patches operator methods onto Feature so user code reads like the
reference:

    family_size = sib_sp + par_ch + 1
    normed_age = age.fill_missing_with_mean().z_normalize()
    features = transmogrify([p_class, sex, age, ...])
    checked = survived.sanity_check(features, remove_bad_features=True)

Every method of the JAX package's DSL is on ``Feature``, LDA and word2vec
(``lda``, ``word2vec``: ``models/unsupervised.py``) included; ``UNPORTED``
is empty.
"""
from __future__ import annotations

from typing import Sequence, Union

import numpy as np

from .features.feature import Feature
from .ops.categorical import OneHotVectorizer
from .ops.scalers import FillMissingWithMean, OpScalarStandardScaler
from .ops.text import TextTokenizer
from .ops.transmogrifier import transmogrify
from .preparators.sanity_checker import SanityChecker
from .stages.base import LambdaTransformer
from .types.columns import Column, NumericColumn
from .types import feature_types as ft

Number = Union[int, float]


def _numeric_binary(op_name: str, fn) -> LambdaTransformer:
    def col_fn(a: Column, b: Column) -> Column:
        assert isinstance(a, NumericColumn) and isinstance(b, NumericColumn)
        # non-finite results (x/0, 0/0, inf-inf, overflow) become nulls
        # below, same as the reference's option-valued feature math —
        # silence the interim numpy warning rather than pay a pre-check pass
        with np.errstate(divide="ignore", invalid="ignore",
                         over="ignore", under="ignore"):
            vals = fn(a.values, b.values)
        mask = a.mask & b.mask
        ok = np.isfinite(vals)
        return NumericColumn(np.where(mask & ok, vals, 0.0), mask & ok, ft.Real)

    return LambdaTransformer(col_fn, ft.Real, operation_name=op_name)


def _numeric_unary(op_name: str, fn, out_type=ft.Real) -> LambdaTransformer:
    def col_fn(a: Column) -> Column:
        assert isinstance(a, NumericColumn)
        with np.errstate(divide="ignore", invalid="ignore",
                         over="ignore", under="ignore"):
            vals = fn(a.values)
        ok = np.isfinite(vals)
        return NumericColumn(np.where(a.mask & ok, vals, 0.0), a.mask & ok, out_type)

    return LambdaTransformer(col_fn, out_type, operation_name=op_name)


def _as_feature_op(self: Feature, other, op_name: str, fn, rev: bool = False):
    """feature-op-feature or feature-op-scalar arithmetic (reference:
    RichNumericFeature + - * /)."""
    if isinstance(other, Feature):
        stage = _numeric_binary(op_name, fn)
        return stage.set_input(self, other).get_output()
    k = float(other)
    scalar_fn = (lambda v: fn(np.full_like(v, k), v)) if rev else (lambda v: fn(v, k))
    stage = _numeric_unary(f"{op_name}_scalar", scalar_fn)
    return stage.set_input(self).get_output()


#: the methods whose stages are not ported yet, by the ROADMAP.md queue 1
#: item that brings them: none is left
UNPORTED: dict = {}


def _patch_feature() -> None:
    F = Feature
    F.__add__ = lambda s, o: _as_feature_op(s, o, "plus", np.add)
    F.__radd__ = lambda s, o: _as_feature_op(s, o, "plus", np.add, rev=True)
    F.__sub__ = lambda s, o: _as_feature_op(s, o, "minus", np.subtract)
    F.__rsub__ = lambda s, o: _as_feature_op(s, o, "minus", np.subtract, rev=True)
    F.__mul__ = lambda s, o: _as_feature_op(s, o, "times", np.multiply)
    F.__rmul__ = lambda s, o: _as_feature_op(s, o, "times", np.multiply, rev=True)
    F.__truediv__ = lambda s, o: _as_feature_op(s, o, "divide", np.divide)
    F.__rtruediv__ = lambda s, o: _as_feature_op(s, o, "divide", np.divide, rev=True)

    def fill_missing_with_mean(self: Feature, default: float = 0.0) -> Feature:
        return FillMissingWithMean(default=default).set_input(self).get_output()

    def z_normalize(self: Feature) -> Feature:
        return OpScalarStandardScaler().set_input(self).get_output()

    def pivot(self: Feature, top_k: int = 20, min_support: int = 10,
              track_nulls: bool = True) -> Feature:
        return (
            OneHotVectorizer(
                top_k=top_k, min_support=min_support, track_nulls=track_nulls
            )
            .set_input(self)
            .get_output()
        )

    def tokenize_f(self: Feature, **kw) -> Feature:
        return TextTokenizer(**kw).set_input(self).get_output()

    def sanity_check(
        self: Feature, features: Feature, remove_bad_features: bool = True, **kw
    ) -> Feature:
        checker = SanityChecker(remove_bad_features=remove_bad_features, **kw)
        return checker.set_input(self, features).get_output()

    def map_values(self: Feature, fn, output_type) -> Feature:
        """Row-function escape hatch (reference: FeatureLike.map) -
        vectorized over the host column values."""

        def col_fn(c: Column) -> Column:
            from .types.columns import column_from_list

            return column_from_list([fn(v) for v in c.to_list()], output_type)

        stage = LambdaTransformer(col_fn, output_type, operation_name="map")
        return stage.set_input(self).get_output()

    def alias(self: Feature, name: str) -> Feature:
        from .ops.combiner import AliasTransformer

        return AliasTransformer(name).set_input(self).get_output()

    # -- per-type .vectorize(...) (reference: Rich*Feature.vectorize) -------
    def vectorize(self: Feature, *, others: Sequence[Feature] = (),
                  **kw) -> Feature:
        """Type-dispatched default vectorizer for this feature (and
        optional same-type ``others`` sharing one stage), with the
        reference's per-type parameter surfaces (reference:
        RichNumericFeature.vectorize:325, RichTextFeature.vectorize:130,
        RichDateFeature/RichMapFeature/RichSetFeature/.vectorize)."""
        from .ops.categorical import OneHotVectorizer as _OneHot
        from .ops.dates import DateListVectorizer, DateVectorizer
        from .ops.geo import GeolocationVectorizer
        from .ops.maps import MapVectorizer
        from .ops.numeric import (
            BinaryVectorizer,
            IntegralVectorizer,
            RealNNVectorizer,
            RealVectorizer,
        )
        from .ops.text import SmartTextVectorizer, TextListHashingVectorizer

        t = self.ftype
        if issubclass(t, ft.OPMap):
            stage = MapVectorizer(**kw)
        elif issubclass(t, ft.Geolocation):
            stage = GeolocationVectorizer(**kw)
        elif issubclass(t, ft.DateList):  # before TextList (both OPList)
            stage = DateListVectorizer(**kw)
        elif issubclass(t, ft.Date):  # Date/DateTime (subtype of Integral)
            # reference parity: circular reps + SinceLast days
            # (RichDateFeature.vectorize:97-110)
            kw.setdefault("with_time_since", True)
            stage = DateVectorizer(**kw)
        elif issubclass(t, ft.Binary):
            stage = BinaryVectorizer(**kw)
        elif issubclass(t, ft.Integral):
            stage = IntegralVectorizer(**kw)
        elif issubclass(t, ft.RealNN):
            stage = RealNNVectorizer(**kw)
        elif issubclass(t, ft.Real):
            stage = RealVectorizer(**kw)
        elif issubclass(t, (ft.MultiPickList,)) or (
            issubclass(t, ft.Text) and t.is_categorical
        ):
            stage = _OneHot(**kw)
        elif issubclass(t, ft.TextList):
            stage = TextListHashingVectorizer(**kw)
        elif issubclass(t, ft.Text):
            stage = SmartTextVectorizer(**kw)
        elif issubclass(t, ft.OPVector):
            return self.combine(*others) if others else self
        else:
            raise TypeError(f"no default vectorizer for {t.__name__}")
        return stage.set_input(self, *others).get_output()

    def smart_vectorize(self: Feature, *, others: Sequence[Feature] = (),
                        **kw) -> Feature:
        """(reference: RichTextFeature.smartVectorize:214)"""
        from .ops.text import SmartTextVectorizer

        return SmartTextVectorizer(**kw).set_input(self, *others).get_output()

    # -- numeric enrichments (reference: RichNumericFeature) ----------------
    def bucketize(self: Feature, splits: Sequence[float],
                  track_nulls: bool = True) -> Feature:
        from .ops.bucketizers import NumericBucketizer

        return (
            NumericBucketizer(splits=list(splits), track_nulls=track_nulls)
            .set_input(self)
            .get_output()
        )

    def auto_bucketize(self: Feature, label: Feature, track_nulls: bool = True,
                       **kw) -> Feature:
        """(reference: RichNumericFeature.autoBucketize:298 - supervised
        decision-tree split points)"""
        from .ops.bucketizers import DecisionTreeNumericBucketizer

        return (
            DecisionTreeNumericBucketizer(track_nulls=track_nulls, **kw)
            .set_input(label, self)
            .get_output()
        )

    def scale(self: Feature, scaling_type: str = "linear", slope: float = 1.0,
              intercept: float = 0.0) -> Feature:
        from .ops.collections import ScalerTransformer

        return (
            ScalerTransformer(scaling_type=scaling_type, slope=slope,
                              intercept=intercept)
            .set_input(self)
            .get_output()
        )

    def descale(self: Feature, scaled_feature: Feature) -> Feature:
        """(reference: RichNumericFeature.descale:372 - reads the scaler
        args from the scaled feature's metadata).  Dispatches on the
        receiver's type: a Prediction routes to PredictionDescaler (the
        regression-on-scaled-label round trip, DescalerTransformer.
        scala:92) so ``prediction.descale(scaled_label)`` works the way
        users naturally write it."""
        from .ops.collections import DescalerTransformer, PredictionDescaler
        from .types.feature_types import Prediction

        stage = (
            PredictionDescaler()
            if issubclass(self.ftype, Prediction)
            else DescalerTransformer()
        )
        return stage.set_input(self, scaled_feature).get_output()

    def to_percentile(self: Feature, buckets: int = 100) -> Feature:
        from .ops.scalers import PercentileCalibrator

        return (
            PercentileCalibrator(buckets=buckets).set_input(self).get_output()
        )

    def to_isotonic_calibrated(self: Feature, label: Feature,
                               is_isotonic: bool = True) -> Feature:
        from .ops.collections import IsotonicRegressionCalibrator

        return (
            IsotonicRegressionCalibrator(isotonic=is_isotonic)
            .set_input(label, self)
            .get_output()
        )

    # -- text enrichments (reference: RichTextFeature) ----------------------
    def indexed(self: Feature) -> Feature:
        from .ops.categorical import StringIndexer

        return StringIndexer().set_input(self).get_output()

    def deindexed(self: Feature, labels: Sequence[str]) -> Feature:
        from .ops.categorical import IndexToString

        return IndexToString(labels=list(labels)).set_input(self).get_output()

    def to_ngram_similarity(self: Feature, that: Feature,
                            n_gram_size: int = 3) -> Feature:
        from .ops.text_analysis import NGramSimilarity

        return (
            NGramSimilarity(n=n_gram_size).set_input(self, that).get_output()
        )

    def detect_languages(self: Feature) -> Feature:
        from .ops.text_analysis import LangDetector

        return LangDetector().set_input(self).get_output()

    def recognize_entities(self: Feature) -> Feature:
        from .ops.text_analysis import NameEntityRecognizer

        return NameEntityRecognizer().set_input(self).get_output()

    def text_len(self: Feature) -> Feature:
        from .ops.text_analysis import TextLenTransformer

        return TextLenTransformer().set_input(self).get_output()

    def to_email_domain(self: Feature) -> Feature:
        from .ops.text_analysis import EmailToPickList

        return EmailToPickList().set_input(self).get_output()

    def to_email_prefix(self: Feature) -> Feature:
        return map_values(
            self,
            lambda v: (v.split("@", 1)[0] if v and "@" in v else None),
            ft.Text,
        )

    def to_domain(self: Feature) -> Feature:
        from .ops.text_analysis import UrlToDomain

        return UrlToDomain().set_input(self).get_output()

    def to_protocol(self: Feature) -> Feature:
        return map_values(
            self,
            lambda v: (v.split("://", 1)[0].lower()
                       if v and "://" in v else None),
            ft.Text,
        )

    def is_valid_url(self: Feature) -> Feature:
        import re as _re

        url_re = _re.compile(r"^(https?|ftp)://[^/\s:]+", _re.IGNORECASE)
        return map_values(
            self,
            lambda v: None if v is None else bool(url_re.match(v)),
            ft.Binary,
        )

    def is_valid_phone(self: Feature, region: str = "US") -> Feature:
        from .ops.text_analysis import PhoneNumberParser

        return PhoneNumberParser(region=region).set_input(self).get_output()

    def detect_mime_types(self: Feature) -> Feature:
        from .ops.text_analysis import MimeTypeDetector

        return MimeTypeDetector().set_input(self).get_output()

    # -- set/list/vector/map enrichments ------------------------------------
    def jaccard_similarity(self: Feature, that: Feature) -> Feature:
        from .ops.text_analysis import JaccardSimilarity

        return JaccardSimilarity().set_input(self, that).get_output()

    def combine(self: Feature, *others: Feature) -> Feature:
        """(reference: RichVectorFeature.combine)"""
        from .ops.combiner import VectorsCombiner

        return VectorsCombiner().set_input(self, *others).get_output()

    def drop_indices_by(self: Feature, predicate) -> Feature:
        from .ops.combiner import DropIndicesByTransformer

        return (
            DropIndicesByTransformer(predicate).set_input(self).get_output()
        )

    def filter_map(self: Feature, allow_keys=None, block_keys=(),
                   clean_keys: bool = True) -> Feature:
        from .ops.collections import FilterMap

        return (
            FilterMap(allow_keys=allow_keys, block_keys=block_keys,
                      clean_keys=clean_keys)
            .set_input(self)
            .get_output()
        )

    def to_occur(self: Feature, matches=None) -> Feature:
        from .ops.collections import ToOccurTransformer

        return ToOccurTransformer(matches=matches).set_input(self).get_output()

    # -- text-ML sugar (reference RichTextFeature tf/idf/tfidf, countVec,
    # lda, word2vec, removeStopWords, tokenizeRegex) ------------------------
    def tf(self: Feature, num_features: int = 512) -> Feature:
        """Hashing term frequencies of a TextList -> OPVector
        (reference: RichTextFeature.tf via HashingTF)."""
        from .ops.text import TextListHashingVectorizer

        return (
            TextListHashingVectorizer(hash_dims=num_features)
            .set_input(self).get_output()
        )

    def idf(self: Feature, min_doc_freq: int = 0) -> Feature:
        """Inverse document frequency scaling of a TF vector
        (reference: RichTextFeature.idf via ml.feature.IDF)."""
        from .ops.text import OpIDF

        return OpIDF(min_doc_freq=min_doc_freq).set_input(self).get_output()

    def tfidf(self: Feature, num_features: int = 512,
              min_doc_freq: int = 0) -> Feature:
        """tf then idf (reference: RichTextFeature.tfidf)."""
        return idf(tf(self, num_features), min_doc_freq)

    def count_vec(self: Feature, vocab_size: int = 1 << 18,
                  min_df: float = 1.0, min_tf: float = 1.0,
                  binary: bool = False) -> Feature:
        """Vocabulary term counts (reference: RichTextFeature.countVec)."""
        from .ops.text import OpCountVectorizer

        return (
            OpCountVectorizer(vocab_size=vocab_size, min_df=min_df,
                              min_tf=min_tf, binary=binary)
            .set_input(self).get_output()
        )

    def lda(self: Feature, k: int = 10, max_iter: int = 30) -> Feature:
        """Topic mixture of a term-count/TF vector (reference:
        RichVectorFeature.lda via ml.clustering.LDA)."""
        from .models.unsupervised import OpLDA

        return OpLDA(k=k, max_iter=max_iter).set_input(self).get_output()

    def word2vec(self: Feature, vector_size: int = 100,
                 min_count: int = 5) -> Feature:
        """Mean skip-gram embedding of a TextList (reference:
        RichTextFeature.word via ml.feature.Word2Vec)."""
        from .models.unsupervised import OpWord2Vec

        return (
            OpWord2Vec(vector_size=vector_size, min_count=min_count)
            .set_input(self).get_output()
        )

    def remove_stop_words(self: Feature, language: str = "en") -> Feature:
        """Drop function words from a TextList (reference:
        RichTextFeature.removeStopWords via StopWordsRemover)."""
        from .ops.stopwords import stopwords_for
        from .types.feature_types import TextList as _TL

        stops = stopwords_for(language)
        return map_values(
            self,
            lambda toks: tuple(t for t in (toks or ()) if t not in stops),
            _TL,
        )

    def tokenize_regex(self: Feature, pattern: str,
                       to_lowercase: bool = True) -> Feature:
        """Split on a regex (reference: RichTextFeature.tokenizeRegex)."""
        import re as _re

        from .types.feature_types import TextList as _TL

        rx = _re.compile(pattern)

        def _split(v):
            if not v:
                return ()
            toks = [t for t in rx.split(v) if t]
            return tuple(t.lower() for t in toks) if to_lowercase else tuple(toks)

        return map_values(self, _split, _TL)

    # -- row-level functional sugar (reference FeatureLike exists/filter/
    # replaceWith - Option-typed row ops become masked column maps) ---------
    def exists(self: Feature, fn) -> Feature:
        """True where the (non-missing) value satisfies ``fn``
        (reference: RichFeature.exists)."""
        from .types.feature_types import Binary as _B

        return map_values(
            self, lambda v: bool(v is not None and fn(v)), _B
        )

    def replace_with(self: Feature, old, new) -> Feature:
        """Substitute one value for another (reference:
        RichFeature.replaceWith)."""
        return map_values(
            self, lambda v, _o=old, _n=new: _n if v == _o else v, self.ftype
        )

    def filter_values(self: Feature, fn, default=None) -> Feature:
        """Keep values satisfying ``fn``, else ``default`` (reference:
        RichFeature.filter/filterNot)."""
        return map_values(
            self,
            lambda v: v if (v is not None and fn(v)) else default,
            self.ftype,
        )

    def parse_phone(self: Feature, region: str = "US") -> Feature:
        """Normalize a phone number to digits-with-country-code, None when
        invalid (reference: RichPhoneFeature.parsePhone via
        libphonenumber)."""
        from .ops.text_analysis import parse_phone as _pp
        from .types.feature_types import Phone as _P

        return map_values(self, lambda v: _pp(v, region), _P)

    def to_date_list(self: Feature) -> Feature:
        """Wrap a Date in a single-element DateList (reference:
        RichDateFeature.toDateList:54)."""
        from .types.feature_types import DateList as _DL

        return map_values(
            self, lambda v: () if v is None else (v,), _DL
        )

    def to_multi_pick_list(self: Feature) -> Feature:
        """Set-valued MultiPickList: a scalar Text becomes its 0/1-element
        set (the reference receiver, RichTextFeature.toMultiPickList:58);
        a TextList becomes its distinct-token set.  Strings must NOT be
        iterated - frozenset('red') would char-split silently."""
        from .types.feature_types import MultiPickList as _MPL

        def _to_set(v):
            if v is None:
                return frozenset()
            if isinstance(v, str):
                return frozenset((v,))
            return frozenset(v)

        return map_values(self, _to_set, _MPL)

    def to_unit_circle(self: Feature, period: str = "HourOfDay") -> Feature:
        """(sin, cos) encoding of a date's position in ``period``
        (reference: RichDateFeature.toUnitCircle via
        DateToUnitCircleTransformer)."""
        from .ops.dates import DateVectorizer

        return DateVectorizer(periods=(period,), track_nulls=False) \
            .set_input(self).get_output()

    F.fill_missing_with_mean = fill_missing_with_mean
    F.z_normalize = z_normalize
    F.pivot = pivot
    F.tokenize = tokenize_f
    F.sanity_check = sanity_check
    F.map_values = map_values
    F.vectorize = vectorize
    F.smart_vectorize = smart_vectorize
    F.alias = alias
    F.bucketize = bucketize
    F.auto_bucketize = auto_bucketize
    F.scale = scale
    F.descale = descale
    F.to_percentile = to_percentile
    F.to_isotonic_calibrated = to_isotonic_calibrated
    F.indexed = indexed
    F.deindexed = deindexed
    F.to_ngram_similarity = to_ngram_similarity
    F.detect_languages = detect_languages
    F.recognize_entities = recognize_entities
    F.text_len = text_len
    F.to_email_domain = to_email_domain
    F.to_email_prefix = to_email_prefix
    F.to_domain = to_domain
    F.to_protocol = to_protocol
    F.is_valid_url = is_valid_url
    F.is_valid_phone = is_valid_phone
    F.detect_mime_types = detect_mime_types
    F.jaccard_similarity = jaccard_similarity
    F.combine = combine
    F.drop_indices_by = drop_indices_by
    F.filter_map = filter_map
    F.to_occur = to_occur
    F.tf = tf
    F.idf = idf
    F.tfidf = tfidf
    F.count_vec = count_vec
    F.lda = lda
    F.word2vec = word2vec
    F.remove_stop_words = remove_stop_words
    F.tokenize_regex = tokenize_regex
    F.exists = exists
    F.replace_with = replace_with
    F.filter_values = filter_values
    F.parse_phone = parse_phone
    F.to_unit_circle = to_unit_circle
    F.to_date_list = to_date_list
    F.to_multi_pick_list = to_multi_pick_list


_patch_feature()

__all__ = ["transmogrify"]
