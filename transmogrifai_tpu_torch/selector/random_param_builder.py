"""Random hyperparameter grids.

A copy of ``transmogrifai_tpu/selector/random_param_builder.py``
(counterpart of RandomParamBuilder; reference: core/.../impl/selector/
RandomParamBuilder.scala): sample N param maps from per-param
distributions - uniform/log-uniform ranges for floats, choice lists for
discrete values - with the same draws from the same seed.

Determinism contract (pinned in tests): the same
seed + the same specs yield the same candidate LIST, independent of how
many candidates any earlier ``build`` call drew - each ``build`` seeds
a fresh per-call stream from ``(seed, call index)`` instead of
continuing one shared stream.  Candidate ORDER is the winner tie-break
(``validate`` keeps the first of equal metrics, and successive-halving
preserves original grid order among survivors), so grids must
reproduce identically whether or not pruning reordered evaluation.
"""
from __future__ import annotations

from typing import Any, Sequence

import numpy as np


class RandomParamBuilder:
    def __init__(self, seed: int = 42) -> None:
        self._specs: list[tuple[str, str, Any]] = []
        self._seed = int(seed)
        self._calls = 0

    def uniform(self, name: str, low: float, high: float) -> "RandomParamBuilder":
        self._specs.append((name, "uniform", (low, high)))
        return self

    def log_uniform(self, name: str, low: float, high: float) -> "RandomParamBuilder":
        assert low > 0 and high > 0
        self._specs.append((name, "log", (low, high)))
        return self

    def choice(self, name: str, values: Sequence) -> "RandomParamBuilder":
        self._specs.append((name, "choice", list(values)))
        return self

    def int_uniform(self, name: str, low: int, high: int) -> "RandomParamBuilder":
        self._specs.append((name, "int", (low, high)))
        return self

    def build(self, n: int) -> list[dict]:
        """Sample ``n`` param maps.  Per-call child stream: the i-th
        ``build`` on a builder always consumes RandomState(seed + i *
        7919), so ``build(3)`` returns the same 3 candidates in the
        same order whether the previous call drew 3 or 300 - grid
        identity (and therefore winner tie-breaks) can never depend on
        unrelated sampling history."""
        rng = np.random.RandomState(
            (self._seed + self._calls * 7919) % (2 ** 32)
        )
        self._calls += 1
        grids = []
        for _ in range(n):
            p = {}
            for name, kind, spec in self._specs:
                if kind == "uniform":
                    p[name] = float(rng.uniform(*spec))
                elif kind == "log":
                    lo, hi = np.log(spec[0]), np.log(spec[1])
                    p[name] = float(np.exp(rng.uniform(lo, hi)))
                elif kind == "int":
                    p[name] = int(rng.randint(spec[0], spec[1] + 1))
                else:
                    p[name] = spec[int(rng.randint(len(spec)))]
            grids.append(p)
        return grids
