"""Large-scale synthetic benchmark data: binary, multiclass and regression.

Counterpart of the reference's 10M-row generator (reference: test-data/
DataGeneration.sc - perturbed Passenger-like records: age/height/weight
numerics, gender categorical, free-text description, dates, boolean label).
Vectorized numpy generation (no per-row python), an optional free-text
column, and a direct-to-design-matrix path for device benchmarks, on the
host (``synthetic_design_matrix``) or generated on the card
(``synthetic_design_matrix_device``, torch's generator: the same
distribution and metadata, not the same draws).

Neither package has a multiclass or regression generator of its own:
``synthetic_passengers_labelled`` adds a planted three-class label and a
planted continuous response, both from ``survived``'s latent, with their
ceilings over the observed columns.
"""
from __future__ import annotations

import numpy as np
import torch

from ..types import feature_types as ft
from ..types.columns import NumericColumn, TextColumn
from ..types.dataset import Dataset
from ..types.vector_metadata import VectorColumnMeta, VectorMetadata
from ..utils.device import resolve_device

_GENDERS = np.array(["male", "female", "other"])

# -- planted ground truth -----------------------------------------------------
# The label is Bernoulli(sigmoid(f + 0.5*eps)) with
#   f = 0.03*(age-45) - 0.02*(height-170) + {female: +1.2, else: -0.4}
# The 0.5*eps gaussian is unobservable label noise; the Bayes-optimal score
# over the OBSERVED features (age mean-imputed at 10% missingness) is
# monotone in f_obs, giving an analytically-pinned ceiling, estimated by
# 5x4M-draw Monte Carlo (std 3e-4):
BAYES_AUROC_OBSERVED = 0.7493
# logistic fits see coefficients attenuated by the eps convolution
# (~ 1/sqrt(1 + (0.5/1.7)^2) ~ 0.96) plus imputation bias on age; the
# recovery gates below use ratio windows that cover it
PLANTED = {
    "age": 0.03,
    "height": -0.02,
    "female_vs_male": 1.6,   # +1.2 - (-0.4)
    "other_vs_male": 0.0,
    "weight": 0.0,           # pure correlated nuisance (0.3*height noise)
}


def planted_truth_report(beta, meta, auroc: float) -> dict:
    """Recovery report for a raw-scale linear/logistic coefficient vector
    fitted on synthetic_design_matrix output: planted-vs-learned
    coefficients and the gap to the observable Bayes AuROC.  ``ok`` is the
    scale path's correctness gate: it turns a run at scale from 'runs'
    into 'correct'."""
    names = meta.column_names()
    idx = {n.rsplit("_", 1)[0]: i for i, n in enumerate(names)}
    beta = np.asarray(beta, np.float64)
    age = float(beta[idx["age"]])
    height = float(beta[idx["height"]])
    fm = float(beta[idx["gender_female"]] - beta[idx["gender_male"]])
    om = float(beta[idx["gender_other"]] - beta[idx["gender_male"]])
    weight = float(beta[idx["weight"]])
    gap = BAYES_AUROC_OBSERVED - float(auroc)
    ok = (
        0.024 <= age <= 0.033
        and -0.023 <= height <= -0.015
        and 1.30 <= fm <= 1.70
        and abs(om) <= 0.08
        and abs(weight) <= 0.006
        and abs(gap) <= 0.012
    )
    return {
        "age_coef": round(age, 5),
        "height_coef": round(height, 5),
        "female_vs_male": round(fm, 4),
        "other_vs_male": round(om, 4),
        "weight_coef": round(weight, 5),
        "bayes_auroc": BAYES_AUROC_OBSERVED,
        "auroc_gap": round(gap, 4),
        "ok": bool(ok),
    }


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


#: the README example's CSV columns and the passenger columns they hold:
#: ``fare`` holds ``height``, so the planted latent (age, height, gender)
#: stays whole and the AuROC ceiling above still holds
README_CSV_COLUMNS = (("survived", "survived"), ("sex", "gender"),
                      ("age", "age"), ("fare", "height"))


def write_readme_csv(path: str, n: int, seed: int = 42) -> str:
    """Write ``synthetic_passengers(n, seed, with_text=False)`` as a CSV
    with a header under the README example's column names
    (``README_CSV_COLUMNS``): a missing age is an empty cell, integral
    values are written as integers and heights by their shortest
    round-trip repr, so either CSV route reads back the generated values.
    Returns ``path``."""
    cols = _passengers(n, seed, with_text=False)[0]
    survived = cols["survived"].values.astype(np.int64)
    gender = cols["gender"].values
    age = cols["age"]
    ages = [str(int(a)) if m else ""
            for a, m in zip(age.values.tolist(), age.mask.tolist())]
    heights = cols["height"].values.tolist()
    lines = [",".join(name for name, _ in README_CSV_COLUMNS)]
    lines += [f"{s},{g},{a},{h!r}" for s, g, a, h
              in zip(survived.tolist(), gender.tolist(), ages, heights)]
    with open(path, "w", newline="") as f:
        f.write("\n".join(lines) + "\n")
    return path


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


def synthetic_design_matrix_device(
    n: int, seed: int = 42, text_dims: int = 32, device="cuda"
):
    """Same schema as synthetic_design_matrix but generated ON THE DEVICE
    from a seeded ``torch.Generator`` there: at 10M rows the host path
    would ship a ~1.5 GB design matrix over the bus before a single fit;
    here only the [n] label vector crosses (SURVEY §7 'hard parts: 10M-row
    ingest').  Returns (X [n, 7 + text_dims] float32 on ``device``, y [n]
    float64 numpy, metadata); the draws are torch's, so X matches the
    host generator in distribution, not value.  The default device is the
    card and raises without CUDA."""
    dev = resolve_device(device)
    g = torch.Generator(device=dev)
    g.manual_seed(seed)

    def uniform():
        return torch.rand(n, generator=g, device=dev)

    def normal():
        return torch.randn(n, generator=g, device=dev)

    age = torch.randint(1, 90, (n,), generator=g, device=dev).to(torch.float32)
    age_present = uniform() > 0.1
    height = 170.0 + 15.0 * normal()
    weight = 70.0 + 12.0 * normal() + 0.3 * (height - 170.0)
    gidx = torch.randint(0, 3, (n,), generator=g, device=dev)  # 1 = "female"
    logit = (0.03 * (age - 45.0) - 0.02 * (height - 170.0)
             + torch.where(gidx == 1, 1.2, -0.4) + 0.5 * normal())
    y = uniform() < torch.sigmoid(logit)
    present = age_present.to(torch.float32)
    age_mean = ((age * present).sum(dtype=torch.float64)
                / present.sum(dtype=torch.float64).clamp(min=1.0))
    X = torch.empty((n, 7 + text_dims), dtype=torch.float32, device=dev)
    X[:, 0] = torch.where(age_present, age, age_mean.to(torch.float32))
    X[:, 1] = 1.0 - present
    X[:, 2] = height
    X[:, 3] = weight
    for j in range(3):
        X[:, 4 + j] = (gidx == j).to(torch.float32)
    if text_dims:
        rates = torch.full((n, text_dims), 0.15, dtype=torch.float32,
                           device=dev)
        X[:, 7:] = torch.poisson(rates, generator=g)
    return X, y.cpu().numpy().astype(np.float64), _design_matrix_metas(
        text_dims)
