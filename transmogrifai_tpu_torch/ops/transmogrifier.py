"""Transmogrifier: automated feature engineering dispatch.

Counterpart of the reference Transmogrifier (reference: core/.../impl/
feature/Transmogrifier.scala:52-87 defaults, :101-330 type dispatch):
group features by their most-specific handled type, apply that type's
default vectorizer to the whole group (one sequence stage per type), and
combine all resulting vectors into a single OPVector feature.

Defaults mirror TransmogrifierDefaults: topK=20, minSupport=10, 512 hash
dims, maxCategoricalCardinality=30, trackNulls=true, circular date reps.

This package vectorizes the groups in ``PORTED_GROUPS``.  The date, text,
list, geolocation and map vectorizers come with the rest of the vectorizer
slice (ROADMAP.md queue 1, item 2); asking for them raises
``NotImplementedError``.  With ``label``, the real and integral groups
also auto-bucketize against it, one single-feature tree per column
(``ops/bucketizers.py``), as the JAX package does.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence, Type

from ..features.feature import Feature
from ..types import feature_types as ft
from .bucketizers import DecisionTreeNumericBucketizer
from .categorical import OneHotVectorizer
from .combiner import VectorsCombiner
from .numeric import (
    BinaryVectorizer,
    IntegralVectorizer,
    RealNNVectorizer,
    RealVectorizer,
)


@dataclass
class TransmogrifierDefaults:
    """(reference: Transmogrifier.scala:52-87)"""

    top_k: int = 20
    min_support: int = 10
    hash_dims: int = 512
    max_categorical_cardinality: int = 30
    track_nulls: bool = True
    clean_text: bool = True
    date_periods: tuple = ("HourOfDay", "DayOfWeek", "DayOfMonth", "WeekOfYear")
    date_list_pivot: str = "SinceLast"  # DateListDefault, Transmogrifier.scala:57
    # None = capture fit-time now (TransmogrifierDefaults.ReferenceDate);
    # pin it for reproducible retrains / golden outputs
    reference_date_ms: Optional[float] = None
    min_info_gain: float = 0.01  # label-aware auto-bucketize threshold


DEFAULTS = TransmogrifierDefaults()

#: groups whose vectorizers this package has
PORTED_GROUPS = ("real", "realnn", "integral", "binary", "pivot", "vector")

# most-specific-first dispatch table: feature type -> group key
_PIVOT_TYPES = (ft.PickList, ft.MultiPickList)
_SMART_TEXT_TYPES = (
    ft.Text, ft.TextArea, ft.ComboBox, ft.Email, ft.URL, ft.Phone, ft.ID,
    ft.Base64, ft.Country, ft.State, ft.City, ft.Street, ft.PostalCode,
)


def _group_key(t: Type[ft.FeatureType]) -> str:
    if issubclass(t, ft.OPMap):
        return f"map:{t.__name__}"
    if issubclass(t, _PIVOT_TYPES):
        return "pivot"
    if issubclass(t, ft.Date):  # before Integral (Date subclasses Integral)
        return "date"
    if issubclass(t, ft.RealNN):
        return "realnn"
    if issubclass(t, ft.Binary):
        return "binary"
    if issubclass(t, ft.Integral):
        return "integral"
    if issubclass(t, ft.Real):
        return "real"
    if issubclass(t, _SMART_TEXT_TYPES):
        return "smarttext"
    if issubclass(t, ft.DateList):  # before TextList (both are OPLists)
        return "datelist"
    if issubclass(t, ft.TextList):
        return "textlist"
    if issubclass(t, ft.Geolocation):
        return "geo"
    if issubclass(t, ft.OPVector):
        return "vector"
    raise TypeError(f"Transmogrifier cannot handle feature type {t.__name__}")


def transmogrify(
    features: Sequence[Feature],
    defaults: TransmogrifierDefaults = DEFAULTS,
    label: Optional[Feature] = None,
) -> Feature:
    """Seq[Feature].transmogrify() (reference: Transmogrifier.transmogrify
    via dsl/RichFeaturesCollection.scala:69).  With ``label``, scalar
    numerics ALSO auto-bucketize against it - per-feature decision-tree
    splits kept only when informative (reference:
    Transmogrifier.scala:155,175 passing label through
    RichNumericFeature.vectorize:339-347)."""
    if not features:
        raise ValueError("transmogrify needs at least one feature")
    groups: dict[str, list[Feature]] = {}
    for f in features:
        key = _group_key(f.ftype)
        if key not in PORTED_GROUPS:
            raise NotImplementedError(
                f"the {key!r} vectorizer group (feature {f.name!r} of type "
                f"{f.ftype.__name__}) is not ported to the torch package yet "
                "(ROADMAP.md queue 1, item 2)"
            )
        groups.setdefault(key, []).append(f)
    # deterministic group order (reference sorts type-groups,
    # Transmogrifier.scala:113)
    vector_features: list[Feature] = []
    for key in sorted(groups):
        feats = sorted(groups[key], key=lambda f: f.name)
        if key == "vector":
            vector_features.extend(feats)
            continue
        stage = _stage_for(key, defaults)
        vector_features.append(stage.set_input(*feats).get_output())
        if label is not None and key in ("real", "integral"):
            for f in feats:
                # filled vectorizer already tracks nulls (trackNulls=false
                # in the reference's bucketize branch)
                buck = DecisionTreeNumericBucketizer(
                    min_info_gain=defaults.min_info_gain, track_nulls=False
                )
                vector_features.append(
                    buck.set_input(label, f).get_output()
                )
    if len(vector_features) == 1:
        out = vector_features[0]
        if out.ftype is ft.OPVector and len(features) > 1:
            return out
    return VectorsCombiner().set_input(*vector_features).get_output()


def _stage_for(key: str, d: TransmogrifierDefaults):
    if key == "pivot":
        return OneHotVectorizer(
            top_k=d.top_k, min_support=d.min_support,
            track_nulls=d.track_nulls, clean_text=d.clean_text,
        )
    if key == "realnn":
        return RealNNVectorizer()
    if key == "binary":
        return BinaryVectorizer(track_nulls=d.track_nulls)
    if key == "integral":
        return IntegralVectorizer(track_nulls=d.track_nulls)
    if key == "real":
        return RealVectorizer(track_nulls=d.track_nulls)
    raise KeyError(key)
