"""The torch package's geolocation stages (``ops/geo.py``) against the JAX
package's: ``geographic_midpoint`` (the mean of unit vectors) and
``GeolocationVectorizer`` (each geolocation's latitude, longitude and
accuracy, a null filled with the fitted midpoint or a constant, and a null
indicator), values and metadata bit-equal."""
import numpy as np
import pytest

from torch_parity import PORT, REF, assert_features_match, assert_same, mod


@pytest.mark.parametrize("case", ["random", "antipodes", "one", "empty",
                                  "poles", "dateline"])
def test_geographic_midpoint(case):
    rng = np.random.RandomState(5)
    pts = {
        "random": np.stack([rng.uniform(-90, 90, 300),
                            rng.uniform(-180, 180, 300),
                            rng.randint(1, 10, 300)], axis=1),
        "antipodes": np.array([[0.0, 0.0, 1.0], [0.0, 180.0, 3.0]]),
        "one": np.array([[37.77, -122.42, 5.0]]),
        "empty": np.zeros((0, 3)),
        "poles": np.array([[90.0, 10.0, 1.0], [-90.0, 10.0, 1.0],
                           [89.9, -170.0, 2.0]]),
        "dateline": np.array([[10.0, 179.5, 1.0], [10.0, -179.5, 2.0]]),
    }[case]
    want = mod(REF, "ops.geo").geographic_midpoint(pts)
    got = mod(PORT, "ops.geo").geographic_midpoint(pts)
    assert_same(got, want)


def _geo_features(pkg: str) -> list:
    mod(pkg, "dsl")
    geo = mod(pkg, "ops.geo")
    fb = mod(pkg, "features.feature_builder").FeatureBuilder
    g = fb.Geolocation("f_geolocation").as_predictor()
    return [
        geo.GeolocationVectorizer().set_input(g).get_output(),
        geo.GeolocationVectorizer(track_nulls=False).set_input(g).get_output(),
        geo.GeolocationVectorizer(fill_with_constant=True,
                                  fill_value=(1.5, -2.5, 3.0))
        .set_input(g).get_output(),
        geo.GeolocationVectorizer(fill_with_constant=True)
        .set_input(g).get_output(),
        g.vectorize(),
    ]


def test_geolocation_vectorizer_matches_reference():
    got = assert_features_match(_geo_features, n=500)
    values = got[0][2]
    assert values.shape == (500, 4)
    nulls = values[:, 3] == 1.0
    assert nulls.any() and (~nulls).any()


def test_fill_value_must_be_a_triple():
    with pytest.raises(ValueError, match="fill_value"):
        mod(PORT, "ops.geo").GeolocationVectorizer(fill_value=(1.0, 2.0))
