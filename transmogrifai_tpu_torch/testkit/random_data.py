"""Seeded random feature-data generators.

Counterpart of the reference testkit (reference: testkit/src/main/scala/
com/salesforce/op/testkit/ - RandomReal.scala:45-110 uniform/normal/
poisson, RandomText, RandomBinary, RandomIntegral, RandomList/Map/Set/
Vector, ProbabilityOfEmpty mixin, RandomData joiner, InfiniteStream):
deterministic generators of typed feature columns for tests and synthetic
benchmarks.
"""
from __future__ import annotations

import itertools
import string
from typing import Any, Iterator, Optional, Sequence, Type

import numpy as np

from ..types import feature_types as ft
from ..types.columns import column_from_list
from ..types.dataset import Dataset


class RandomGenerator:
    """Infinite seeded stream of optional values (ProbabilityOfEmpty
    semantics: each draw is None with probability_of_empty)."""

    def __init__(self, seed: int = 42, probability_of_empty: float = 0.0):
        self.rng = np.random.RandomState(seed)
        self.probability_of_empty = probability_of_empty

    def with_probability_of_empty(self, p: float) -> "RandomGenerator":
        self.probability_of_empty = p
        return self

    def _value(self) -> Any:  # pragma: no cover - abstract
        raise NotImplementedError

    def __iter__(self) -> Iterator[Any]:
        while True:
            yield self.next()

    def next(self) -> Any:
        if self.probability_of_empty and self.rng.rand() < self.probability_of_empty:
            return None
        return self._value()

    def limit(self, n: int) -> list:
        return [self.next() for _ in range(n)]


class RandomReal(RandomGenerator):
    """(reference: RandomReal.scala:45-110)"""

    def __init__(self, dist: str = "normal", a: float = 0.0, b: float = 1.0,
                 seed: int = 42, probability_of_empty: float = 0.0) -> None:
        super().__init__(seed, probability_of_empty)
        self.dist, self.a, self.b = dist, a, b

    @staticmethod
    def uniform(low=0.0, high=1.0, seed=42) -> "RandomReal":
        return RandomReal("uniform", low, high, seed)

    @staticmethod
    def normal(mean=0.0, sigma=1.0, seed=42) -> "RandomReal":
        return RandomReal("normal", mean, sigma, seed)

    @staticmethod
    def poisson(mean=1.0, seed=42) -> "RandomReal":
        return RandomReal("poisson", mean, 0.0, seed)

    def _value(self) -> float:
        if self.dist == "uniform":
            return float(self.rng.uniform(self.a, self.b))
        if self.dist == "poisson":
            return float(self.rng.poisson(self.a))
        return float(self.rng.normal(self.a, self.b))


class RandomIntegral(RandomGenerator):
    def __init__(self, low: int = 0, high: int = 100, seed: int = 42,
                 probability_of_empty: float = 0.0) -> None:
        super().__init__(seed, probability_of_empty)
        self.low, self.high = low, high

    def _value(self) -> int:
        return int(self.rng.randint(self.low, self.high))


class RandomBinary(RandomGenerator):
    def __init__(self, probability_of_true: float = 0.5, seed: int = 42,
                 probability_of_empty: float = 0.0) -> None:
        super().__init__(seed, probability_of_empty)
        self.p = probability_of_true

    def _value(self) -> bool:
        return bool(self.rng.rand() < self.p)


class RandomText(RandomGenerator):
    """(reference: RandomText.scala - words / picklists / emails / urls...)"""

    def __init__(self, kind: str = "words", domain: Sequence[str] = (),
                 seed: int = 42, probability_of_empty: float = 0.0,
                 n_words: int = 3, word_len: int = 8) -> None:
        super().__init__(seed, probability_of_empty)
        self.kind = kind
        self.domain = list(domain)
        self.n_words = n_words
        self.word_len = word_len

    @staticmethod
    def words(seed=42, n_words=3) -> "RandomText":
        return RandomText("words", seed=seed, n_words=n_words)

    @staticmethod
    def picklists(domain: Sequence[str], seed=42) -> "RandomText":
        return RandomText("pick", domain=domain, seed=seed)

    @staticmethod
    def emails(domain: str = "example.com", seed=42) -> "RandomText":
        return RandomText("email", domain=[domain], seed=seed)

    @staticmethod
    def urls(seed=42) -> "RandomText":
        return RandomText("url", seed=seed)

    @staticmethod
    def phones(seed=42) -> "RandomText":
        return RandomText("phone", seed=seed)

    @staticmethod
    def ids(seed=42) -> "RandomText":
        return RandomText("id", seed=seed)

    def _word(self) -> str:
        letters = string.ascii_lowercase
        n = self.rng.randint(3, self.word_len + 1)
        return "".join(letters[self.rng.randint(26)] for _ in range(n))

    def _value(self) -> str:
        if self.kind == "pick":
            return self.domain[self.rng.randint(len(self.domain))]
        if self.kind == "email":
            return f"{self._word()}@{self.domain[0]}"
        if self.kind == "url":
            return f"https://{self._word()}.com/{self._word()}"
        if self.kind == "phone":
            return f"{self.rng.randint(200,999)}-{self.rng.randint(200,999)}-{self.rng.randint(1000,9999)}"
        if self.kind == "id":
            return f"id_{self.rng.randint(10**8):08d}"
        return " ".join(self._word() for _ in range(self.n_words))


class RandomList(RandomGenerator):
    def __init__(self, element: RandomGenerator, min_len=0, max_len=5,
                 seed: int = 42, probability_of_empty: float = 0.0) -> None:
        super().__init__(seed, probability_of_empty)
        self.element = element
        self.min_len, self.max_len = min_len, max_len

    def _value(self) -> list:
        n = self.rng.randint(self.min_len, self.max_len + 1)
        return [v for v in (self.element.next() for _ in range(n)) if v is not None]


class RandomSet(RandomList):
    def _value(self) -> frozenset:
        return frozenset(super()._value())


class RandomMap(RandomGenerator):
    def __init__(self, value_gen: RandomGenerator, keys: Sequence[str],
                 seed: int = 42, probability_of_empty: float = 0.0) -> None:
        super().__init__(seed, probability_of_empty)
        self.value_gen = value_gen
        self.keys = list(keys)

    def _value(self) -> dict:
        out = {}
        for k in self.keys:
            if self.rng.rand() < 0.7:
                v = self.value_gen.next()
                if v is not None:
                    out[k] = v
        return out


class RandomVector(RandomGenerator):
    def __init__(self, dim: int, seed: int = 42) -> None:
        super().__init__(seed, 0.0)
        self.dim = dim

    def _value(self) -> list:
        return self.rng.randn(self.dim).tolist()


class RandomDate(RandomGenerator):
    """Epoch-millis dates (reference: RandomIntegral.dates)."""

    def __init__(self, start_ms: int = 1_400_000_000_000,
                 span_ms: int = 100_000_000_000, seed: int = 42,
                 probability_of_empty: float = 0.0) -> None:
        super().__init__(seed, probability_of_empty)
        self.start_ms, self.span_ms = start_ms, span_ms

    def _value(self) -> int:
        # explicit int64: the default randint dtype is np.int_ which is
        # 32-bit on some platforms and cannot hold a 1e11 span
        return self.start_ms + int(
            self.rng.randint(0, self.span_ms, dtype=np.int64)
        )


class RandomGeolocation(RandomGenerator):
    def _value(self) -> tuple:
        return (
            float(self.rng.uniform(-60, 60)),
            float(self.rng.uniform(-180, 180)),
            float(self.rng.randint(1, 10)),
        )


class RandomMultiPickList(RandomGenerator):
    def __init__(self, domain: Sequence[str], min_len=0, max_len=3,
                 seed: int = 42, probability_of_empty: float = 0.0) -> None:
        super().__init__(seed, probability_of_empty)
        self.domain = list(domain)
        self.min_len, self.max_len = min_len, max_len

    def _value(self) -> frozenset:
        k = self.rng.randint(self.min_len, self.max_len + 1)
        return frozenset(
            self.domain[self.rng.randint(len(self.domain))] for _ in range(k)
        )


def default_generator(
    t: Type[ft.FeatureType], seed: int = 42, probability_of_empty: float = 0.0
) -> RandomGenerator:
    """A sensible generator for any feature type - the glue that lets
    stress tests sweep the whole type lattice (reference: the testkit's
    per-type Random* companions)."""
    p = probability_of_empty
    if issubclass(t, ft.OPMap):
        vt = t.value_type or ft.Text
        return RandomMap(default_generator(vt, seed + 1), ["k1", "k2", "k3"],
                         seed=seed, probability_of_empty=p)
    if issubclass(t, ft.Binary):
        return RandomBinary(seed=seed, probability_of_empty=p)
    if issubclass(t, ft.Date):
        return RandomDate(seed=seed, probability_of_empty=p)
    if issubclass(t, ft.Integral):
        return RandomIntegral(seed=seed, probability_of_empty=p)
    if issubclass(t, ft.Real):
        return RandomReal(seed=seed,
                          probability_of_empty=0.0 if t.non_nullable else p)
    if issubclass(t, ft.PickList) or issubclass(t, ft.ComboBox):
        return RandomText.picklists(
            ["red", "green", "blue"], seed=seed
        ).with_probability_of_empty(p)
    if issubclass(t, ft.Email):
        return RandomText.emails(seed=seed).with_probability_of_empty(p)
    if issubclass(t, ft.Phone):
        return RandomText.phones(seed=seed).with_probability_of_empty(p)
    if issubclass(t, ft.URL):
        return RandomText.urls(seed=seed).with_probability_of_empty(p)
    if issubclass(t, ft.ID):
        return RandomText.ids(seed=seed).with_probability_of_empty(p)
    if issubclass(t, ft.Text):
        return RandomText.words(seed=seed).with_probability_of_empty(p)
    if issubclass(t, ft.MultiPickList):
        return RandomMultiPickList(["a", "b", "c", "d"], seed=seed,
                                   probability_of_empty=p)
    if issubclass(t, ft.Geolocation):
        return RandomGeolocation(seed=seed, probability_of_empty=p)
    if issubclass(t, ft.TextList):
        return RandomList(RandomText.words(seed=seed + 1), seed=seed,
                          probability_of_empty=p)
    if issubclass(t, ft.DateList):
        return RandomList(RandomDate(seed=seed + 1), max_len=3, seed=seed,
                          probability_of_empty=p)
    if issubclass(t, ft.OPVector):
        return RandomVector(4, seed=seed)
    raise TypeError(f"no default generator for {t.__name__}")


def random_dataset(
    generators: dict[str, tuple[RandomGenerator, Type[ft.FeatureType]]],
    n: int,
) -> Dataset:
    """RandomData joiner analog (reference: RandomData.scala): draw n rows
    from each named generator into one columnar Dataset."""
    return Dataset(
        {
            name: column_from_list(gen.limit(n), t)
            for name, (gen, t) in generators.items()
        }
    )


def write_corrupted_csv(
    path: str,
    n_rows: int = 500,
    n_type_flips: int = 5,
    n_truncated: int = 3,
    seed: int = 7,
) -> dict:
    """Deterministic corrupted-CSV generator for the data-plane drills
    (shared by tests/test_data_plane.py and ``bench.py --data-faults``).

    Writes a mixed numeric/text file (columns ``y``, ``a``, ``c``) with
    ``n_type_flips`` rows whose numeric cell ``a`` holds junk text and
    ``n_truncated`` rows missing their trailing fields.  Returns the
    ground truth a quarantine ingest must reproduce EXACTLY::

        {"n_rows", "columns", "type_flip_rows", "truncated_rows",
         "bad_rows", "good_rows"}
    """
    rng = np.random.RandomState(seed)
    n_bad = n_type_flips + n_truncated
    if n_bad > n_rows:
        raise ValueError("more corrupted rows than rows")
    bad = rng.choice(n_rows, size=n_bad, replace=False)
    flip_rows = sorted(int(i) for i in bad[:n_type_flips])
    trunc_rows = sorted(int(i) for i in bad[n_type_flips:])
    flips, truncs = set(flip_rows), set(trunc_rows)
    cats = ("u", "v", "w")
    with open(path, "w", newline="") as f:
        f.write("y,a,c\n")
        for i in range(n_rows):
            y = i % 2
            a = rng.randn()
            c = cats[i % 3]
            if i in flips:
                f.write(f"{y},not-a-number-{i},{c}\n")
            elif i in truncs:
                f.write(f"{y}\n")
            else:
                f.write(f"{y},{a:.6f},{c}\n")
    return {
        "n_rows": n_rows,
        "columns": ["y", "a", "c"],
        "type_flip_rows": flip_rows,
        "truncated_rows": trunc_rows,
        "bad_rows": sorted(flips | truncs),
        "good_rows": n_rows - n_bad,
    }


def shift_records(records, feature: str, delta: float = 0.0,
                  scale: float = 1.0) -> list[dict]:
    """Distribution-shifted copies of serve records (drift-guard
    drills): numeric ``feature`` becomes ``value * scale + delta``,
    missing values stay missing, everything else is untouched - the
    batch stays schema-VALID, only its distribution moves."""
    out = []
    for r in records:
        r = dict(r)
        v = r.get(feature)
        if isinstance(v, (int, float)) and not isinstance(v, bool):
            r[feature] = v * scale + delta
        out.append(r)
    return out


class InfiniteStream:
    """Endless Dataset batches from named generators (reference:
    testkit InfiniteStream): drives streaming-score paths and soak tests.
    Deterministic: each batch continues the generators' seeded streams."""

    def __init__(
        self,
        generators: dict[str, tuple[RandomGenerator, Type[ft.FeatureType]]],
        batch_size: int = 100,
    ) -> None:
        self.generators = generators
        self.batch_size = batch_size

    def __iter__(self) -> Iterator[Dataset]:
        while True:
            yield self.next_batch()

    def next_batch(self) -> Dataset:
        return random_dataset(self.generators, self.batch_size)

    def take(self, n_batches: int) -> list[Dataset]:
        return [self.next_batch() for _ in range(n_batches)]
