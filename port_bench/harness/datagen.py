"""The one data generator: a deployment's rows from its configuration file.

A configuration (``configs/<name>.json``) lists its raw columns, each with a
``law`` and that law's parameters, and its label as a sum of ``terms`` on a
logit whose intercept is solved for the stated positive rate.  Everything
that fixes the data's structure (the level effects, each carrier's flight
range, the airport codes) is drawn from the file's ``structure_seed``; the
rows themselves are drawn from the run's seed and the data set's index in
the pool, so two data sets of one run share their law and differ in every
row.

The output is plain numpy and imports nothing of the program:
``{name: Raw}`` with float64 values and a presence mask for numeric
columns, and an object array of strings for categorical ones.
"""
from __future__ import annotations

import itertools
import json
import string
from dataclasses import dataclass
from typing import Optional

import numpy as np

NUMERIC_TYPES = ("Real", "RealNN", "Integral")
CATEGORICAL_TYPES = ("PickList",)


@dataclass
class Raw:
    """One raw column: ``values`` float64 (numeric) or object strings
    (categorical); ``mask`` True where present."""

    type: str
    values: np.ndarray
    mask: np.ndarray

    @property
    def numeric(self) -> bool:
        return self.type in NUMERIC_TYPES


def load_json(path) -> dict:
    with open(path) as f:
        return json.load(f)


def row_rng(seed: int, index: int) -> np.random.Generator:
    """The rows' generator of data set ``index`` of a run with ``seed``
    (any whole number: taken modulo 2**64)."""
    return np.random.default_rng([int(seed) % (1 << 64), int(index)])


def _codes(rng: np.random.Generator, n: int) -> list[str]:
    """``n`` distinct three-letter codes in a seeded order."""
    pool = ["".join(t) for t in itertools.product(string.ascii_uppercase,
                                                   repeat=3)]
    pick = rng.choice(len(pool), size=n, replace=False)
    return [pool[i] for i in pick]


def _levels(spec: dict, srng: np.random.Generator) -> list[str]:
    if "levels" in spec:
        return list(spec["levels"])
    return _codes(srng, int(spec["n_levels"]))


def _finish(spec: dict, v: np.ndarray) -> np.ndarray:
    if "clip" in spec:
        v = np.clip(v, *spec["clip"])
    if "round" in spec:
        step = float(spec["round"])
        v = np.round(v / step) * step
    if spec["type"] == "Integral":
        v = np.round(v)
    return v.astype(np.float64)


class Structure:
    """What the configuration's ``structure_seed`` fixes: categorical
    levels, each level's parameters and the label terms' effects.  Drawn
    in the file's column and term order, so a file always gives the same
    structure."""

    def __init__(self, config: dict) -> None:
        srng = np.random.default_rng(int(config["label"]["structure_seed"]))
        self.levels: dict[str, list[str]] = {}
        self.ranges: dict[str, np.ndarray] = {}
        for spec in config["columns"]:
            if spec["type"] in CATEGORICAL_TYPES:
                self.levels[spec["name"]] = _levels(spec, srng)
            if spec["law"] == "level_range":
                k = len(self.levels[spec["of"]])
                lo, hi = int(spec["low"]), int(spec["high"])
                span = int(spec["min_span"])
                starts = srng.integers(lo, hi - span, size=k)
                ends = np.minimum(hi, starts + span
                                  + srng.integers(0, hi - lo, size=k) // 4)
                self.ranges[spec["name"]] = np.stack([starts, ends], 1)
        self.effects: list[np.ndarray] = []
        for term in config["label"]["terms"]:
            kind = term["kind"]
            scale = float(term.get("scale", 0.0))
            if kind == "level_effect":
                n = len(self.levels.get(term["col"], ())) or 64
                self.effects.append(srng.normal(0.0, scale, n))
            elif kind == "level_x_bins":
                n = len(self.levels[term["cols"][0]])
                self.effects.append(
                    srng.normal(0.0, scale, (n, len(term["edges"]) + 1)))
            elif kind == "pair_effect":
                a, b = (len(self.levels[c]) for c in term["cols"])
                self.effects.append(srng.normal(0.0, scale, (a, b)))
            else:
                self.effects.append(np.zeros(0))


def _column(spec: dict, structure: Structure, rng: np.random.Generator,
            n: int, latents: dict, codes: dict):
    """Values of one column (and, for a categorical one, its level codes)."""
    law = spec["law"]
    name = spec["name"]
    if law in ("zipf", "categorical"):
        levels = structure.levels[name]
        k = len(levels)
        if law == "zipf":
            p = 1.0 / np.arange(1, k + 1) ** float(spec["exponent"])
        else:
            p = np.asarray(spec["probs"], np.float64)
        c = rng.choice(k, size=n, p=p / p.sum())
        if "differ_from" in spec:
            same = c == codes[spec["differ_from"]]
            c[same] = (c[same] + 1) % k
        codes[name] = c
        return np.asarray(levels, dtype=object)[c]
    z = rng.standard_normal(n)
    if "latent" in spec:
        rho = float(spec["rho"])
        lat = latents.setdefault(spec["latent"], rng.standard_normal(n))
        z = rho * lat + np.sqrt(1.0 - rho * rho) * z
    if law == "lognormal":
        v = np.exp(float(spec["mu"]) + float(spec["sigma"]) * z)
    elif law == "normal":
        v = float(spec["mean"]) + float(spec["sd"]) * z
    elif law == "uniform":
        v = rng.uniform(float(spec["low"]), float(spec["high"]), n)
    elif law == "discrete":
        vals = np.asarray(spec["values"], np.float64)
        p = np.asarray(spec["probs"], np.float64)
        v = vals[rng.choice(len(vals), size=n, p=p / p.sum())]
    elif law == "mixture":
        comps = np.asarray(spec["components"], np.float64)
        which = rng.choice(len(comps), size=n, p=comps[:, 0] / comps[:, 0].sum())
        v = comps[which, 1] + comps[which, 2] * z
    elif law == "level_range":
        r = structure.ranges[name][codes[spec["of"]]]
        v = r[:, 0] + np.floor(rng.random(n) * (r[:, 1] - r[:, 0]))
    else:
        raise ValueError(f"unknown law {law!r} for column {name!r}")
    return _finish(spec, v)


def _standard(x: np.ndarray) -> np.ndarray:
    sd = x.std()
    return (x - x.mean()) / (sd if sd > 0 else 1.0)


def _transform(x: np.ndarray, how: str) -> np.ndarray:
    if how == "log":
        return np.log(np.maximum(x, 1e-6))
    return x


def _level_index(col: np.ndarray, structure: Structure, name: str):
    """Level codes of a column: its categorical codes, or the rank of each
    distinct value of a numeric column."""
    if name in structure.levels:
        lookup = {v: i for i, v in enumerate(structure.levels[name])}
        return np.fromiter((lookup[v] for v in col), np.int64, len(col))
    _, inv = np.unique(col, return_inverse=True)
    return inv


def label_logit(config: dict, structure: Structure, cols: dict,
                codes: dict) -> np.ndarray:
    """The label's logit before its intercept: the sum of the terms."""
    n = len(next(iter(cols.values())))
    s = np.zeros(n)
    for term, eff in zip(config["label"]["terms"], structure.effects):
        kind = term["kind"]
        if kind == "linear":
            x = _transform(cols[term["col"]], term.get("transform", "none"))
            s += float(term["coef"]) * _standard(x)
        elif kind == "bump":
            x = cols[term["col"]]
            s += float(term["coef"]) * np.exp(
                -((x - float(term["center"])) / float(term["width"])) ** 2)
        elif kind == "product":
            a, b = (_standard(_transform(cols[c],
                                         term.get("transform", "none")))
                    for c in term["cols"])
            s += float(term["coef"]) * a * b
        elif kind == "level_effect":
            c = codes.get(term["col"])
            if c is None:
                c = _level_index(cols[term["col"]], structure, term["col"])
            s += eff[np.minimum(c, len(eff) - 1)]
        elif kind == "level_x_bins":
            lvl, num = term["cols"]
            bins = np.searchsorted(np.asarray(term["edges"], np.float64),
                                   cols[num], side="right")
            s += eff[codes[lvl], bins]
        elif kind == "pair_effect":
            a, b = term["cols"]
            s += eff[codes[a], codes[b]]
        else:
            raise ValueError(f"unknown label term {kind!r}")
    return s


def intercept_for(s: np.ndarray, rate: float) -> float:
    """The intercept b with mean(sigmoid(b + s)) = rate (bisection)."""
    lo, hi = -30.0, 30.0
    for _ in range(80):
        mid = 0.5 * (lo + hi)
        if np.mean(1.0 / (1.0 + np.exp(-(mid + s)))) < rate:
            lo = mid
        else:
            hi = mid
    return 0.5 * (lo + hi)


def generate(config: dict, seed: int, index: int,
             rows: Optional[int] = None) -> dict[str, Raw]:
    """Data set ``index`` of the pool of a run with ``seed``: every raw
    column of ``config`` and its label, ``rows`` rows (the file's count by
    default)."""
    n = int(rows if rows is not None else config["rows"])
    structure = Structure(config)
    rng = row_rng(seed, index)
    latents: dict = {}
    codes: dict = {}
    cols: dict = {}
    out: dict[str, Raw] = {}
    for spec in config["columns"]:
        v = _column(spec, structure, rng, n, latents, codes)
        cols[spec["name"]] = v
        out[spec["name"]] = Raw(spec["type"], v, np.ones(n, dtype=bool))
    s = label_logit(config, structure, cols, codes)
    lab = config["label"]
    b = intercept_for(s, float(lab["positive_rate"]))
    y = (rng.random(n) < 1.0 / (1.0 + np.exp(-(b + s)))).astype(np.float64)
    out[lab["name"]] = Raw(lab["type"], y, np.ones(n, dtype=bool))
    return out
