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

Every method of the JAX package's DSL is on ``Feature``.  A method whose
stage is not ported yet raises ``NotImplementedError`` naming its ROADMAP
item: the text, date, geolocation, map and collection stages (item 2) and
LDA and word2vec (item 8).
"""
from __future__ import annotations

from typing import Sequence, Union

import numpy as np

from .features.feature import Feature
from .ops.categorical import OneHotVectorizer
from .ops.scalers import FillMissingWithMean, OpScalarStandardScaler
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
#: item that brings them
UNPORTED = {
    # item 2: text, date, geolocation, map and collection stages
    "tokenize": 2, "smart_vectorize": 2, "scale": 2, "descale": 2,
    "to_isotonic_calibrated": 2, "indexed": 2, "deindexed": 2,
    "to_ngram_similarity": 2, "detect_languages": 2,
    "recognize_entities": 2, "text_len": 2, "to_email_domain": 2,
    "to_domain": 2, "is_valid_phone": 2, "detect_mime_types": 2,
    "jaccard_similarity": 2, "filter_map": 2, "to_occur": 2, "tf": 2,
    "idf": 2, "tfidf": 2, "count_vec": 2, "remove_stop_words": 2,
    "parse_phone": 2, "to_unit_circle": 2,
    # item 8: the unsupervised families
    "lda": 8, "word2vec": 8,
}


def _not_ported(name: str, item: int):
    def method(self: Feature, *args, **kw):
        raise NotImplementedError(
            f"Feature.{name} is not ported to the torch package yet "
            f"(ROADMAP.md queue 1, item {item})"
        )

    method.__name__ = name
    return method


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
        RichNumericFeature.vectorize:325, RichTextFeature.vectorize:130).
        Map, geolocation, date, text-list and free-text features raise:
        their vectorizers come with item 2."""
        from .ops.numeric import (
            BinaryVectorizer,
            IntegralVectorizer,
            RealNNVectorizer,
            RealVectorizer,
        )

        t = self.ftype
        # the dispatch order of the JAX package's (Date is an Integral,
        # DateList and Geolocation are lists)
        if issubclass(t, (ft.OPMap, ft.Geolocation, ft.DateList, ft.Date)):
            raise NotImplementedError(
                f"vectorize of {t.__name__} is not ported to the torch "
                "package yet (ROADMAP.md queue 1, item 2)"
            )
        if issubclass(t, ft.Binary):
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
            stage = OneHotVectorizer(**kw)
        elif issubclass(t, (ft.TextList, ft.Text)):
            raise NotImplementedError(
                f"vectorize of {t.__name__} is not ported to the torch "
                "package yet (ROADMAP.md queue 1, item 2)"
            )
        elif issubclass(t, ft.OPVector):
            return self.combine(*others) if others else self
        else:
            raise TypeError(f"no default vectorizer for {t.__name__}")
        return stage.set_input(self, *others).get_output()

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

    def to_percentile(self: Feature, buckets: int = 100) -> Feature:
        from .ops.scalers import PercentileCalibrator

        return (
            PercentileCalibrator(buckets=buckets).set_input(self).get_output()
        )

    # -- row functions over map_values (reference: RichTextFeature,
    # RichFeature exists/filter/replaceWith, RichDateFeature.toDateList) ---
    def to_email_prefix(self: Feature) -> Feature:
        return map_values(
            self,
            lambda v: (v.split("@", 1)[0] if v and "@" in v else None),
            ft.Text,
        )

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

    def tokenize_regex(self: Feature, pattern: str,
                       to_lowercase: bool = True) -> Feature:
        """Split on a regex (reference: RichTextFeature.tokenizeRegex)."""
        import re as _re

        rx = _re.compile(pattern)

        def _split(v):
            if not v:
                return ()
            toks = [t for t in rx.split(v) if t]
            return tuple(t.lower() for t in toks) if to_lowercase else tuple(toks)

        return map_values(self, _split, ft.TextList)

    def exists(self: Feature, fn) -> Feature:
        """True where the (non-missing) value satisfies ``fn``
        (reference: RichFeature.exists)."""
        return map_values(
            self, lambda v: bool(v is not None and fn(v)), ft.Binary
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

    def to_date_list(self: Feature) -> Feature:
        """Wrap a Date in a single-element DateList (reference:
        RichDateFeature.toDateList:54)."""
        return map_values(
            self, lambda v: () if v is None else (v,), ft.DateList
        )

    def to_multi_pick_list(self: Feature) -> Feature:
        """Set-valued MultiPickList: a scalar Text becomes its 0/1-element
        set (the reference receiver, RichTextFeature.toMultiPickList:58);
        a TextList becomes its distinct-token set.  Strings must NOT be
        iterated - frozenset('red') would char-split silently."""

        def _to_set(v):
            if v is None:
                return frozenset()
            if isinstance(v, str):
                return frozenset((v,))
            return frozenset(v)

        return map_values(self, _to_set, ft.MultiPickList)

    # -- vector enrichments (reference: RichVectorFeature) -------------------
    def combine(self: Feature, *others: Feature) -> Feature:
        """(reference: RichVectorFeature.combine)"""
        from .ops.combiner import VectorsCombiner

        return VectorsCombiner().set_input(self, *others).get_output()

    def drop_indices_by(self: Feature, predicate) -> Feature:
        from .ops.combiner import DropIndicesByTransformer

        return (
            DropIndicesByTransformer(predicate).set_input(self).get_output()
        )

    F.fill_missing_with_mean = fill_missing_with_mean
    F.z_normalize = z_normalize
    F.pivot = pivot
    F.sanity_check = sanity_check
    F.map_values = map_values
    F.vectorize = vectorize
    F.alias = alias
    F.bucketize = bucketize
    F.auto_bucketize = auto_bucketize
    F.to_percentile = to_percentile
    F.to_email_prefix = to_email_prefix
    F.to_protocol = to_protocol
    F.is_valid_url = is_valid_url
    F.tokenize_regex = tokenize_regex
    F.exists = exists
    F.replace_with = replace_with
    F.filter_values = filter_values
    F.to_date_list = to_date_list
    F.to_multi_pick_list = to_multi_pick_list
    F.combine = combine
    F.drop_indices_by = drop_indices_by
    for name, item in UNPORTED.items():
        setattr(F, name, _not_ported(name, item))


_patch_feature()

__all__ = ["transmogrify"]
