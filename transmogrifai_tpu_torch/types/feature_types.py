"""Feature type system.

Columnar re-design of the reference FeatureType hierarchy
(reference: features/src/main/scala/com/salesforce/op/features/types/FeatureType.scala:44,
Numerics.scala, Text.scala, Lists.scala, Sets.scala, Maps.scala, Geolocation.scala).

In the reference every value is an ``Option``-wrapped scalar object per row.
Here we keep the *type lattice* (45 types, nullability, categorical/text/
numeric traits) as lightweight Python classes used purely as static tags on
symbolic features, while the *data* lives in columnar arrays with validity
masks (see ``types/columns.py``).  The tags drive:

* Transmogrifier dispatch (which default vectorizer handles a feature),
* FeatureBuilder schema inference,
* runtime column validation.

Class attributes:
  ``kind``        - storage kind ('numeric' | 'text' | 'vector' | 'textlist' |
                    'datelist' | 'multipicklist' | 'geolocation' | 'map' | 'prediction')
  ``non_nullable``- mirrors the reference ``NonNullable`` trait
  ``is_categorical`` - mirrors the ``Categorical`` trait (PickList/ComboBox/...)
  ``value_type``  - for map types, the scalar type of the map's values
"""
from __future__ import annotations

from typing import Optional, Type


class FeatureType:
    """Root of the type lattice (abstract; instances are never created)."""

    kind: str = "abstract"
    non_nullable: bool = False
    is_categorical: bool = False
    value_type: Optional[Type["FeatureType"]] = None

    def __init__(self) -> None:  # pragma: no cover
        raise TypeError("FeatureType subclasses are static tags; do not instantiate")

    @classmethod
    def type_name(cls) -> str:
        return cls.__name__


# --------------------------------------------------------------------------
# Numerics (reference: types/OPNumeric.scala:39, types/Numerics.scala:40-150)
# --------------------------------------------------------------------------
class OPNumeric(FeatureType):
    kind = "numeric"


class Real(OPNumeric):
    pass


class RealNN(Real):
    non_nullable = True


class Binary(OPNumeric):
    is_categorical = True


class Integral(OPNumeric):
    pass


class Percent(Real):
    pass


class Currency(Real):
    pass


class Date(Integral):
    pass


class DateTime(Date):
    pass


# --------------------------------------------------------------------------
# Text (reference: types/Text.scala:48-301)
# --------------------------------------------------------------------------
class Text(FeatureType):
    kind = "text"


class Email(Text):
    pass


class Base64(Text):
    pass


class Phone(Text):
    pass


class ID(Text):
    pass


class URL(Text):
    pass


class TextArea(Text):
    pass


class PickList(Text):
    is_categorical = True


class ComboBox(Text):
    pass


class Country(Text):
    pass


class State(Text):
    pass


class PostalCode(Text):
    pass


class City(Text):
    pass


class Street(Text):
    pass


# --------------------------------------------------------------------------
# Collections (reference: types/OPVector.scala:41, Lists.scala, Sets.scala,
# Geolocation.scala:47)
# --------------------------------------------------------------------------
class OPCollection(FeatureType):
    kind = "collection"


class OPList(OPCollection):
    pass


class OPVector(OPCollection):
    kind = "vector"
    non_nullable = True


class TextList(OPList):
    kind = "textlist"


class DateList(OPList):
    kind = "datelist"


class DateTimeList(DateList):
    kind = "datelist"


class OPSet(OPCollection):
    pass


class MultiPickList(OPSet):
    kind = "multipicklist"
    is_categorical = True


class Geolocation(OPList):
    kind = "geolocation"


# --------------------------------------------------------------------------
# Maps (reference: types/OPMap.scala:38, types/Maps.scala:40-357)
# --------------------------------------------------------------------------
class OPMap(FeatureType):
    kind = "map"


def _map_type(name: str, value: Type[FeatureType]) -> Type[OPMap]:
    return type(name, (OPMap,), {"value_type": value, "kind": "map"})


TextMap = _map_type("TextMap", Text)
EmailMap = _map_type("EmailMap", Email)
Base64Map = _map_type("Base64Map", Base64)
PhoneMap = _map_type("PhoneMap", Phone)
IDMap = _map_type("IDMap", ID)
URLMap = _map_type("URLMap", URL)
TextAreaMap = _map_type("TextAreaMap", TextArea)
PickListMap = _map_type("PickListMap", PickList)
ComboBoxMap = _map_type("ComboBoxMap", ComboBox)
CountryMap = _map_type("CountryMap", Country)
StateMap = _map_type("StateMap", State)
PostalCodeMap = _map_type("PostalCodeMap", PostalCode)
CityMap = _map_type("CityMap", City)
StreetMap = _map_type("StreetMap", Street)
RealMap = _map_type("RealMap", Real)
IntegralMap = _map_type("IntegralMap", Integral)
BinaryMap = _map_type("BinaryMap", Binary)
CurrencyMap = _map_type("CurrencyMap", Currency)
PercentMap = _map_type("PercentMap", Percent)
DateMap = _map_type("DateMap", Date)
DateTimeMap = _map_type("DateTimeMap", DateTime)
MultiPickListMap = _map_type("MultiPickListMap", MultiPickList)
GeolocationMap = _map_type("GeolocationMap", Geolocation)


class Prediction(RealMap):
    """Model output map with reserved keys prediction/probability/rawPrediction
    (reference: types/Maps.scala:302-357).  Stored columnar as dense arrays."""

    kind = "prediction"
    non_nullable = True

    KEY_PREDICTION = "prediction"
    KEY_RAW = "rawPrediction"
    KEY_PROB = "probability"


# --------------------------------------------------------------------------
# Registry + helpers
# --------------------------------------------------------------------------
_ALL_TYPES: dict[str, Type[FeatureType]] = {}


def _register(cls: Type[FeatureType]) -> None:
    _ALL_TYPES[cls.__name__] = cls


for _cls in list(globals().values()):
    if isinstance(_cls, type) and issubclass(_cls, FeatureType):
        _register(_cls)


def feature_type_by_name(name: str) -> Type[FeatureType]:
    try:
        return _ALL_TYPES[name]
    except KeyError:
        raise KeyError(f"Unknown feature type: {name!r}") from None


def all_feature_types() -> dict[str, Type[FeatureType]]:
    return dict(_ALL_TYPES)


def is_subtype(a: Type[FeatureType], b: Type[FeatureType]) -> bool:
    return issubclass(a, b)
