"""Large-scale synthetic binary-classification benchmark data.

Counterpart of the reference's 10M-row generator (reference: test-data/
DataGeneration.sc - perturbed Passenger-like records: age/height/weight
numerics, gender categorical, free-text description, dates, boolean label).
Vectorized numpy generation (no per-row python), an optional free-text
column, and a direct-to-design-matrix path for device benchmarks.  The JAX
package's on-device generator is not ported: its draws come from
``jax.random`` and would not match these host draws anyway.
"""
from __future__ import annotations

import numpy as np

from ..types import feature_types as ft
from ..types.columns import NumericColumn, TextColumn
from ..types.dataset import Dataset
from ..types.vector_metadata import VectorColumnMeta, VectorMetadata

_GENDERS = np.array(["male", "female", "other"])

# -- planted ground truth -----------------------------------------------------
# The label is Bernoulli(sigmoid(f + 0.5*eps)) with
#   f = 0.03*(age-45) - 0.02*(height-170) + {female: +1.2, else: -0.4}
# The 0.5*eps gaussian is unobservable label noise; the Bayes-optimal score
# over the OBSERVED features (age mean-imputed at 10% missingness) is
# monotone in f_obs, giving an analytically-pinned ceiling, estimated by
# 5x4M-draw Monte Carlo (std 3e-4):
BAYES_AUROC_OBSERVED = 0.7493


_WORDS = np.array(
    "travel cabin deck ticket luxury economy family solo crew port starboard "
    "breakfast dinner storm calm ocean liner voyage captain steward".split()
)


def synthetic_passengers(
    n: int, seed: int = 42, with_text: bool = True
) -> Dataset:
    """Columnar synthetic dataset (DataGeneration.sc schema analog)."""
    rng = np.random.RandomState(seed)
    age = rng.randint(1, 90, size=n).astype(np.float64)
    age_mask = rng.rand(n) > 0.1
    height = rng.normal(170, 15, size=n)
    weight = rng.normal(70, 12, size=n) + 0.3 * (height - 170)
    gender = _GENDERS[rng.randint(0, 3, size=n)]
    boarded = rng.randint(1_400_000_000_000, 1_500_000_000_000, size=n).astype(
        np.float64
    )
    # label depends on age/gender/height with noise
    logit = (
        0.03 * (age - 45)
        - 0.02 * (height - 170)
        + np.where(gender == "female", 1.2, -0.4)
        + 0.5 * rng.randn(n)
    )
    survived = (rng.rand(n) < 1 / (1 + np.exp(-logit))).astype(np.float64)

    cols = {
        "age": NumericColumn(np.where(age_mask, age, 0.0), age_mask, ft.Real),
        "height": NumericColumn(height, np.ones(n, bool), ft.Real),
        "weight": NumericColumn(weight, np.ones(n, bool), ft.Real),
        "gender": TextColumn(gender.astype(object), ft.PickList),
        "boarded": NumericColumn(boarded, np.ones(n, bool), ft.Date),
        "survived": NumericColumn(survived, np.ones(n, bool), ft.RealNN),
    }
    if with_text:
        k = rng.randint(3, 8, size=n)
        # vectorized: sample a [n, 8] word table, join per row
        words = _WORDS[rng.randint(0, len(_WORDS), size=(n, 8))]
        desc = np.array(
            [" ".join(words[i, : k[i]]) for i in range(n)], dtype=object
        )
        cols["description"] = TextColumn(desc, ft.Text)
    return Dataset(cols)


def synthetic_design_matrix(
    n: int,
    seed: int = 42,
    text_dims: int = 32,
    dtype=np.float32,
) -> tuple[np.ndarray, np.ndarray, VectorMetadata]:
    """Directly build the (X, y, metadata) the heavy stages consume -
    the shape the workflow's vectorizers would produce, generated at numpy
    speed for device benchmarking."""
    rng = np.random.RandomState(seed)
    ds = synthetic_passengers(n, seed=seed, with_text=False)
    age = ds["age"]
    blocks = [
        np.where(age.mask, age.values, age.values[age.mask].mean())[:, None],
        (~age.mask).astype(np.float64)[:, None],
        ds["height"].values[:, None],
        ds["weight"].values[:, None],
    ]
    gender = ds["gender"].values
    for g in _GENDERS:
        blocks.append((gender == g).astype(np.float64)[:, None])
    # hashed pseudo-text block: random small-vocab counts
    if text_dims:
        counts = rng.poisson(0.15, size=(n, text_dims)).astype(np.float64)
        blocks.append(counts)
    X = np.concatenate(blocks, axis=1).astype(dtype)
    y = np.asarray(ds["survived"].values, dtype=np.float64)
    return X, y, _design_matrix_metas(text_dims)


def _design_matrix_metas(text_dims: int) -> VectorMetadata:
    metas = [
        VectorColumnMeta("age", "Real"),
        VectorColumnMeta("age", "Real", grouping="age",
                         indicator_value="NullIndicatorValue"),
        VectorColumnMeta("height", "Real"),
        VectorColumnMeta("weight", "Real"),
    ]
    for g in _GENDERS:
        metas.append(
            VectorColumnMeta("gender", "PickList", grouping="gender",
                             indicator_value=str(g))
        )
    metas.extend(
        VectorColumnMeta("description", "Text", descriptor_value=f"hash_{j}")
        for j in range(text_dims)
    )
    return VectorMetadata("features", tuple(metas)).reindexed()
