"""Large-scale synthetic benchmark data: binary, multiclass and regression.

Counterpart of the reference's 10M-row generator (reference: test-data/
DataGeneration.sc - perturbed Passenger-like records: age/height/weight
numerics, gender categorical, free-text description, dates, boolean label).
Vectorized numpy generation (no per-row python), an optional free-text
column, and a direct-to-design-matrix path for device benchmarks.  The JAX
package's on-device generator is not ported: its draws come from
``jax.random`` and would not match these host draws anyway.

Neither package has a multiclass or regression generator of its own:
``synthetic_passengers_labelled`` adds a planted three-class label and a
planted continuous response, both from ``survived``'s latent, with their
ceilings over the observed columns.
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


def _passengers(n: int, seed: int, with_text: bool):
    """(columns, latent): the passenger columns and the planted noisy
    latent ``f + 0.5*eps`` behind ``survived``, drawn in one order."""
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
    return cols, logit


def synthetic_passengers(
    n: int, seed: int = 42, with_text: bool = True
) -> Dataset:
    """Columnar synthetic dataset (DataGeneration.sc schema analog)."""
    return Dataset(_passengers(n, seed, with_text)[0])


# -- planted multiclass and regression labels ----------------------------------
# Both rest on the latent L = f + 0.5*eps of ``survived`` above:
#   tier     = the tercile of L that the row falls in (0.0, 1.0 or 2.0), cut at
#              the population terciles of L;
#   response = L + RESPONSE_NOISE_SD * nu, nu a standard gaussian drawn after
#              the passenger columns from RandomState((seed, 1)).
# Their ceilings over the OBSERVED columns (age missing on 10% of rows, the
# 0.5*eps term unobservable; ``planted_label_ceilings`` computes them):
# L | observed is N(f, 0.25) where age is seen and a mixture over the
# uniform age 1..89 where it is not, so
#   BAYES_F1_OBSERVED  - weighted F1 (OpMultiClassificationEvaluator) of the
#                        most-probable-tier rule, by quadrature;
#   BEST_RMSE_OBSERVED - sqrt(0.25 + 0.1 * 0.0009 * 660 + 0.5^2), the RMSE of
#                        E[response | observed], linear in the mean-imputed
#                        age, its null indicator, height and gender;
#   BEST_R2_OBSERVED   - 1 - that MSE over Var(response).
RESPONSE_NOISE_SD = 0.5
LATENT_TERCILES = (-0.4546534217, 0.6481404947)
BAYES_F1_OBSERVED = 0.7511
BEST_RMSE_OBSERVED = 0.747930
BEST_R2_OBSERVED = 0.680870


def _latent_parts():
    """The latent's structure: the age effects 0.03*(a - 45) over a in
    1..89 (uniform), the gender effects with their probabilities, and the
    variance of the height effect plus the noise."""
    age_fx = 0.03 * (np.arange(1, 90) - 45.0)
    gender_fx = np.array([1.2, -0.4])
    gender_p = np.array([1.0, 2.0]) / 3.0
    return age_fx, gender_fx, gender_p, (0.02 * 15.0) ** 2 + 0.25


def planted_label_ceilings(grid: int = 8001) -> dict:
    """The planted labels' constants from the latent's distribution: the
    population terciles of L (bisection on its exact CDF), the F1 of the
    most probable tier given the observed columns (quadrature over the
    height effect on ``grid`` points, exact sums over age, gender and age
    missingness), and the best RMSE and R2 of the response."""
    from math import erf, sqrt

    ncdf = np.vectorize(lambda x: 0.5 * (1.0 + erf(x / sqrt(2.0))))
    age_fx, gender_fx, gender_p, var_rest = _latent_parts()

    def cdf(t: float) -> float:
        m = age_fx[:, None] + gender_fx[None, :]
        return float((ncdf((t - m) / sqrt(var_rest)).mean(axis=0)
                      * gender_p).sum())

    def solve(q: float) -> float:
        lo, hi = -10.0, 10.0
        for _ in range(100):
            mid = 0.5 * (lo + hi)
            lo, hi = (mid, hi) if cdf(mid) < q else (lo, mid)
        return 0.5 * (lo + hi)

    t1, t2 = solve(1.0 / 3.0), solve(2.0 / 3.0)

    def tier_probs(mean: np.ndarray) -> np.ndarray:
        """P(tier | L ~ N(mean, 0.25)) [..., 3]."""
        c1 = ncdf((t1 - mean) / 0.5)
        c2 = ncdf((t2 - mean) / 0.5)
        return np.stack([c1, c2 - c1, 1.0 - c2], axis=-1)

    # the height effect u ~ N(0, 0.09) on a quadrature grid
    sd_u = 0.02 * 15.0
    u = np.linspace(-8 * sd_u, 8 * sd_u, grid)
    pu = np.exp(-0.5 * (u / sd_u) ** 2)
    pu /= pu.sum()
    joint = np.zeros((3, 3))  # [predicted, true]
    for g, pg in zip(gender_fx, gender_p):
        # age seen (90%): the posterior is a function of f alone
        f = age_fx[:, None] + g + u[None, :]              # [89, grid]
        post = tier_probs(f)
        pred = post.argmax(axis=-1)
        w = 0.9 * pg * pu[None, :] / len(age_fx)
        for i in range(3):
            joint[i] += ((pred == i)[..., None] * post * w[..., None]).sum(
                axis=(0, 1))
        # age missing (10%): average the posterior over the uniform age
        post_m = tier_probs(age_fx[:, None] + g + u[None, :]).mean(axis=0)
        pred_m = post_m.argmax(axis=-1)
        for i in range(3):
            joint[i] += ((pred_m == i)[:, None] * post_m
                         * (0.1 * pg * pu)[:, None]).sum(axis=0)
    tp = np.diag(joint)
    weights = joint.sum(axis=0)                            # true shares
    precision = float((tp / joint.sum(axis=1) * weights).sum())
    recall = float((tp / weights * weights).sum())
    f1 = 2 * precision * recall / (precision + recall)
    var_age = float(age_fx.var())                          # 0.0009 * 660
    mse = 0.25 + 0.1 * var_age + RESPONSE_NOISE_SD**2
    var_g = float((gender_p * gender_fx**2).sum()
                  - (gender_p * gender_fx).sum() ** 2)
    var_response = var_age + var_g + var_rest + RESPONSE_NOISE_SD**2
    return {"terciles": (t1, t2), "bayes_f1": f1,
            "best_rmse": float(np.sqrt(mse)),
            "best_r2": 1.0 - mse / var_response}


def synthetic_passengers_labelled(
    n: int, seed: int = 42, with_text: bool = True
) -> Dataset:
    """``synthetic_passengers(n, seed, with_text)``, its columns bit-equal,
    with two more labels of the same latent (see the constants above):
    ``tier`` (RealNN, three classes) and ``response`` (RealNN, continuous).
    The planted ceilings over the observed columns: weighted F1
    ``BAYES_F1_OBSERVED`` for ``tier``; RMSE ``BEST_RMSE_OBSERVED`` and R2
    ``BEST_R2_OBSERVED`` for ``response``."""
    cols, latent = _passengers(n, seed, with_text)
    tier = np.searchsorted(np.asarray(LATENT_TERCILES), latent).astype(
        np.float64)
    noise = np.random.RandomState((seed, 1)).randn(n)
    response = latent + RESPONSE_NOISE_SD * noise
    ones = np.ones(n, bool)
    cols["tier"] = NumericColumn(tier, ones, ft.RealNN)
    cols["response"] = NumericColumn(response, ones, ft.RealNN)
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
