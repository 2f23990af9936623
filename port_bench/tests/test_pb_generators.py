"""Each configuration's generator against its own file: column types,
cardinalities, skew, ranges and the label rate, at the file's full row
count, and the seed's determinism."""
from __future__ import annotations

import numpy as np
import pytest

from pb_helpers import ROOT
from port_bench.harness import datagen

CONFIGS = ["higgs", "airlines"]
SEED = 2**31 + 12345  # larger than 32 signed bits hold


@pytest.fixture(scope="module", params=CONFIGS)
def made(request):
    cfg = datagen.load_json(ROOT / "port_bench" / "configs"
                            / f"{request.param}.json")
    return cfg, datagen.generate(cfg, SEED, 0)


def test_rows_and_label_rate(made):
    cfg, data = made
    y = data[cfg["label"]["name"]].values
    assert len(y) == cfg["rows"]
    assert set(np.unique(y)) == {0.0, 1.0}
    assert abs(y.mean() - cfg["label"]["positive_rate"]) < 0.006


def test_every_column_is_stated_and_typed(made):
    cfg, data = made
    names = [c["name"] for c in cfg["columns"]] + [cfg["label"]["name"]]
    assert sorted(data) == sorted(names)
    for spec in cfg["columns"]:
        col = data[spec["name"]]
        assert col.type == spec["type"]
        assert col.mask.all()  # no missing values, as both files assume
        if spec["type"] == "PickList":
            assert col.values.dtype == object
        else:
            assert np.isfinite(col.values).all()
        if spec["type"] == "Integral":
            assert np.array_equal(col.values, np.round(col.values))


def test_cardinalities_and_skew(made):
    cfg, data = made
    for spec in cfg["columns"]:
        v = data[spec["name"]].values
        if spec["law"] in ("zipf", "categorical"):
            k = len(spec["levels"]) if "levels" in spec else spec["n_levels"]
            _, counts = np.unique(v.astype(str), return_counts=True)
            assert len(counts) == k
            share = np.sort(counts)[::-1] / counts.sum()
            if spec["law"] == "zipf":
                w = 1.0 / np.arange(1, k + 1) ** spec["exponent"]
                w /= w.sum()
                # a column drawn to differ from another moves its clashing
                # rows to the next level, which flattens the head a little
                tol = 0.04 if "differ_from" in spec else 0.01
                assert abs(share[0] - w[0]) < tol
                assert abs(share[:20].sum() - w[:20].sum()) < 2 * tol
        elif spec["law"] == "discrete":
            assert set(np.unique(v)) <= set(spec["values"])
        if "clip" in spec:
            assert v.min() >= spec["clip"][0] and v.max() <= spec["clip"][1]


def test_airports_differ_and_flights_follow_the_carrier():
    cfg = datagen.load_json(ROOT / "port_bench/configs/airlines.json")
    data = datagen.generate(cfg, 7, 0, rows=50_000)
    assert (data["AirportFrom"].values != data["AirportTo"].values).all()
    air, fl = data["Airline"].values, data["Flight"].values
    for a in np.unique(air.astype(str))[:5]:
        f = fl[air == a]
        assert f.max() - f.min() < 7814


def test_the_seed_decides_the_rows():
    cfg = datagen.load_json(ROOT / "port_bench/configs/higgs.json")
    a = datagen.generate(cfg, SEED, 0, rows=2000)
    b = datagen.generate(cfg, SEED, 0, rows=2000)
    c = datagen.generate(cfg, SEED, 1, rows=2000)
    d = datagen.generate(cfg, SEED + 1, 0, rows=2000)
    for name in a:
        assert np.array_equal(a[name].values, b[name].values)
    assert not np.array_equal(a["m_bb"].values, c["m_bb"].values)
    assert not np.array_equal(a["m_bb"].values, d["m_bb"].values)


def test_trees_have_signal_the_linear_part_less():
    """The planted label: the mass bumps make it non-monotone in m_bb."""
    cfg = datagen.load_json(ROOT / "port_bench/configs/higgs.json")
    data = datagen.generate(cfg, 3, 0, rows=100_000)
    y, m = data["class"].values, data["m_bb"].values
    mid = (m > 0.8) & (m < 1.2)
    far = (m < 0.5) | (m > 1.8)
    assert y[mid].mean() - y[far].mean() > 0.1
