"""The torch package's testkit (``testkit/random_data.py``) against the JAX
package's: every generator draws the same values from the same seed, draw
for draw; ``random_dataset`` gives the same columns; the corrupted CSV,
the shifted records and ``InfiniteStream`` are the same."""
import numpy as np
import pytest

from torch_parity import (
    LATTICE_TYPES, PORT, REF, assert_same, column_state, lattice_dataset, mod,
)

N = 400


def _generators(pkg: str) -> dict:
    """Every generator class and factory of ``pkg``'s testkit, seeded."""
    rd = mod(pkg, "testkit.random_data")
    return {
        "real normal": rd.RandomReal(seed=3),
        "real uniform": rd.RandomReal.uniform(-2.0, 5.0, seed=4),
        "real poisson": rd.RandomReal.poisson(3.5, seed=5),
        "real empty": rd.RandomReal(seed=6, probability_of_empty=0.3),
        "integral": rd.RandomIntegral(-5, 40, seed=7, probability_of_empty=0.2),
        "binary": rd.RandomBinary(0.3, seed=8, probability_of_empty=0.1),
        "words": rd.RandomText.words(seed=9, n_words=4),
        "pick": rd.RandomText.picklists(["a", "b", "c"], seed=10)
        .with_probability_of_empty(0.25),
        "emails": rd.RandomText.emails("corp.org", seed=11),
        "urls": rd.RandomText.urls(seed=12),
        "phones": rd.RandomText.phones(seed=13),
        "ids": rd.RandomText.ids(seed=14),
        "list": rd.RandomList(rd.RandomIntegral(seed=15,
                                                probability_of_empty=0.3),
                              min_len=1, max_len=4, seed=16),
        "set": rd.RandomSet(rd.RandomText.picklists(["x", "y", "z"], seed=17),
                            seed=18),
        "map": rd.RandomMap(rd.RandomReal(seed=19, probability_of_empty=0.2),
                            ["k1", "k2"], seed=20, probability_of_empty=0.1),
        "vector": rd.RandomVector(5, seed=21),
        "date": rd.RandomDate(seed=22, probability_of_empty=0.1),
        "geo": rd.RandomGeolocation(seed=23, probability_of_empty=0.1),
        "multipick": rd.RandomMultiPickList(["p", "q", "r", "s"], max_len=4,
                                            seed=24),
    }


@pytest.mark.parametrize("name", sorted(_generators(REF)))
def test_generators_draw_for_draw(name):
    want = _generators(REF)[name].limit(N)
    got = _generators(PORT)[name].limit(N)
    assert_same(got, want, name)
    # the stream goes on alike after the first draws
    assert_same(_generators(PORT)[name].limit(2 * N)[N:],
                _generators(REF)[name].limit(2 * N)[N:], name)


@pytest.mark.parametrize("type_name", LATTICE_TYPES + ("RealNN", "OPVector"))
def test_default_generator_of_every_type(type_name):
    outs = []
    for pkg in (REF, PORT):
        rd = mod(pkg, "testkit.random_data")
        t = getattr(mod(pkg, "types.feature_types"), type_name)
        gen = rd.default_generator(t, seed=31, probability_of_empty=0.1)
        outs.append((type(gen).__name__, gen.limit(N)))
    assert_same(outs[1], outs[0], type_name)


def test_random_dataset_and_the_lattice():
    want = lattice_dataset(REF, N)
    got = lattice_dataset(PORT, N)
    assert got.column_names() == want.column_names()
    assert len(got.column_names()) == len(LATTICE_TYPES) + 1
    for c in want.column_names():
        assert_same(column_state(got[c]), column_state(want[c]), c)
    label = np.asarray(got["label"].values)
    assert 0.2 < label.mean() < 0.8


def test_infinite_stream_continues_its_streams():
    outs = []
    for pkg in (REF, PORT):
        rd = mod(pkg, "testkit.random_data")
        ftm = mod(pkg, "types.feature_types")
        stream = rd.InfiniteStream({
            "t": (rd.RandomText.words(seed=40).with_probability_of_empty(0.2),
                  ftm.Text),
            "r": (rd.RandomReal(seed=41, probability_of_empty=0.2), ftm.Real),
        }, batch_size=50)
        batches = stream.take(3) + [next(iter(stream))]
        outs.append([[column_state(b[c]) for c in ("t", "r")]
                     for b in batches])
    assert_same(outs[1], outs[0])


def test_corrupted_csv_and_shifted_records(tmp_path):
    outs = []
    for pkg in (REF, PORT):
        rd = mod(pkg, "testkit.random_data")
        path = tmp_path / f"{pkg}.csv"
        truth = rd.write_corrupted_csv(str(path), n_rows=300, n_type_flips=7,
                                       n_truncated=4, seed=5)
        records = [{"a": 1.5, "b": None, "c": "x", "d": True},
                   {"a": None, "b": 2, "c": 3.0}, {"c": "y"}]
        shifted = (rd.shift_records(records, "a", delta=2.0, scale=3.0),
                   rd.shift_records(records, "b", scale=-1.0),
                   rd.shift_records(records, "d", delta=1.0))
        outs.append((truth, path.read_text(), shifted))
    assert_same(outs[1], outs[0])
    with pytest.raises(ValueError, match="more corrupted rows"):
        mod(PORT, "testkit.random_data").write_corrupted_csv(
            str(tmp_path / "x.csv"), n_rows=3, n_type_flips=3, n_truncated=1)
