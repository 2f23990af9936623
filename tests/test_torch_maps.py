"""The torch package's map stages (``ops/maps.py`` and the numeric-map
bucketizer of ``ops/bucketizers.py``) against the JAX package's:
``MapVectorizer`` over every value type through its per-key routes
(numeric, pivot, hashed text, dates, geolocation), ``transmogrify``'s map
groups, ``TextMapLenEstimator`` and ``TextMapNullEstimator``, values and
metadata (names, groupings, indicator values) bit-equal; and
``DecisionTreeNumericMapBucketizer``'s per-key splits (each key's tree
grown on the CPU here, its column binned by K2's plain version)."""
import numpy as np
import pytest

from torch_parity import (
    LATTICE_TYPES, PORT, REF, assert_features_match, mod,
)

MAP_TYPES = [t for t in LATTICE_TYPES if t.endswith("Map")]
N = 400


def _keyed_data(pkg: str):
    """Maps whose keys need cleaning (' a', 'a ' and 'a' are one key) and
    whose text values have few distinct values (pivoted per key)."""
    rng = np.random.RandomState(9)
    ftm = mod(pkg, "types.feature_types")
    cols = mod(pkg, "types.columns")
    keys = [" a", "a ", "b", "c", " d "]
    words = ["Red", "blue ", "GREEN", None]
    text, real = [], []
    for _ in range(N):
        t, r = {}, {}
        for k in keys:
            if rng.rand() < 0.5:
                t[k] = words[rng.randint(len(words))]
            if rng.rand() < 0.5:
                r[k] = float(np.round(rng.randn() * 3, 2))
        text.append({k: v for k, v in t.items() if v is not None})
        real.append(r)
    label = (rng.rand(N) < 0.4).astype(np.float64)
    return mod(pkg, "types.dataset").Dataset({
        "pm": cols.column_from_list(text, ftm.PickListMap),
        "tm": cols.column_from_list(text, ftm.TextMap),
        "rm": cols.column_from_list(real, ftm.RealMap),
        "label": cols.NumericColumn(label, np.ones(N, bool), ftm.RealNN),
    })


def _lattice_map_features(pkg: str) -> list:
    mod(pkg, "dsl")
    maps = mod(pkg, "ops.maps")
    fb = mod(pkg, "features.feature_builder").FeatureBuilder
    feats = {t: getattr(fb, t)(f"f_{t.lower()}").as_predictor()
             for t in MAP_TYPES}
    tm = mod(pkg, "ops.transmogrifier")
    out = [maps.MapVectorizer().set_input(f).get_output()
           for f in feats.values()]
    out += [
        maps.MapVectorizer(top_k=2, min_support=1, track_nulls=False,
                           clean_text=False, max_cardinality=5, hash_dims=16,
                           date_periods=("DayOfYear",))
        .set_input(feats["TextMap"], feats["DateMap"]).get_output(),
        maps.MapVectorizer(allow_keys=["k1", "k3"]).set_input(
            feats["RealMap"]).get_output(),
        maps.MapVectorizer(block_keys=[" k2 "]).set_input(
            feats["IntegralMap"]).get_output(),
        maps.TextMapLenEstimator().set_input(feats["TextMap"]).get_output(),
        maps.TextMapNullEstimator().set_input(
            feats["TextMap"], feats["PickListMap"]).get_output(),
        tm.transmogrify(list(feats.values()), defaults=tm.TransmogrifierDefaults(
            reference_date_ms=1.5e12)),
        feats["BinaryMap"].vectorize(),
    ]
    return out


def test_map_vectorizers_on_every_value_type():
    got = assert_features_match(_lattice_map_features, n=N)
    # the hashed text map: 512 columns and its null indicator
    text_metas = got[MAP_TYPES.index("TextMap")][4]
    assert sum(m[4] is not None and m[4].startswith("hash_")
               for m in text_metas) == 512


def _keyed_features(pkg: str) -> list:
    maps = mod(pkg, "ops.maps")
    fb = mod(pkg, "features.feature_builder").FeatureBuilder
    pm, tm = fb.PickListMap("pm").as_predictor(), fb.TextMap("tm").as_predictor()
    rm = fb.RealMap("rm").as_predictor()
    return [maps.MapVectorizer().set_input(pm, tm, rm).get_output(),
            maps.MapVectorizer(clean_keys=False).set_input(pm, rm).get_output(),
            maps.MapVectorizer(allow_keys=[" a"]).set_input(tm).get_output(),
            maps.TextMapLenEstimator(clean_keys=False).set_input(tm)
            .get_output(),
            maps.TextMapNullEstimator().set_input(tm).get_output()]


def test_map_key_cleaning_and_column_order():
    got = assert_features_match(_keyed_features, data=_keyed_data)
    groupings = [m[2] for m in got[0][4]]
    # ' a' and 'a ' clean to 'a'; ' d ' to 'd'; keys in sorted order
    assert sorted(set(g for g in groupings if g)) == ["a", "b", "c", "d"]


def _bucketizer_features(pkg: str) -> list:
    fb = mod(pkg, "features.feature_builder").FeatureBuilder
    label = fb.RealNN("label").as_response()
    kw = {"device": "cpu"} if pkg == PORT else {}
    b = mod(pkg, "ops.bucketizers")
    out = []
    for name, t in (("rm", "RealMap"), ("f_realmap", "RealMap"),
                    ("f_integralmap", "IntegralMap")):
        f = getattr(fb, t)(name).as_predictor()
        out.append((b.DecisionTreeNumericMapBucketizer(**kw), f))
    out.append((b.DecisionTreeNumericMapBucketizer(
        max_depth=2, min_info_gain=0.0, track_nulls=False, clean_keys=False,
        **kw), fb.RealMap("rm").as_predictor()))
    return [est.set_input(label, f).get_output() for est, f in out]


@pytest.mark.parametrize("which", [0, 1, 2, 3])
def test_numeric_map_bucketizer(which):
    def build(pkg):
        return [_bucketizer_features(pkg)[which]]

    if which in (1, 2):
        got = assert_features_match(build, n=N)
    else:
        got = assert_features_match(build, data=_keyed_data)
    metas = got[0][4]
    assert metas, "no columns"
    if which == 3:
        # min_info_gain 0: every key splits
        assert all(m[3] != "NullIndicatorValue" for m in metas)


def test_map_bucketizer_splits_and_metadata():
    """The fitted splits by key, as the JAX package's."""
    outs = []
    for pkg in (REF, PORT):
        mod(pkg, "utils.uid").reset_uids()
        data = _keyed_data(pkg)
        feats = _bucketizer_features(pkg)
        from torch_parity import workflow

        model = workflow(pkg, feats[0], data).set_result_features(
            feats[0], feats[3]).train()
        outs.append([s.metadata for s in model.stages
                     if type(s).__name__ ==
                     "DecisionTreeNumericMapBucketizerModel"])
    assert outs[1] == outs[0]
    assert any(outs[1][0]["should_split_by_key"].values())
