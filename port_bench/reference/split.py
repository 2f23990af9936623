"""The holdout and the folds (TransmogrifAI's Splitter and
OpCrossValidation with label-stratified folds), from their seeds."""
from __future__ import annotations

import numpy as np


def holdout(n: int, fraction: float, seed: int):
    """(train rows, holdout rows), each sorted: a seeded permutation's
    first floor(n * fraction) rows are held out."""
    perm = np.random.RandomState(seed).permutation(n)
    n_test = int(np.floor(n * fraction))
    return np.sort(perm[n_test:]), np.sort(perm[:n_test])


def stratified_folds(y: np.ndarray, k: int, seed: int) -> np.ndarray:
    """[k, n] bool, True where the row is in the fold's train split: each
    label class's rows dealt round-robin after a seeded permutation, the
    classes in ascending order."""
    rng = np.random.RandomState(seed)
    fold_of = np.empty(len(y), dtype=np.int64)
    for c in np.unique(y):
        idx = np.nonzero(y == c)[0]
        perm = rng.permutation(len(idx))
        fold_of[idx[perm]] = np.arange(len(idx)) % k
    return np.stack([fold_of != f for f in range(k)])


def balance_weights(y: np.ndarray, sample_fraction: float,
                    max_training_sample: int = 1_000_000) -> np.ndarray:
    """DataBalancer's sample weights: the minority class up-weighted to
    ``sample_fraction`` when it is rarer, then everything scaled down to
    ``max_training_sample`` rows."""
    n = len(y)
    pos = float((y == 1).sum())
    neg = float(n - pos)
    small, big = (pos, neg) if pos <= neg else (neg, pos)
    small_label = 1.0 if pos <= neg else 0.0
    w = np.ones(n)
    if small > 0 and small / max(n, 1) < sample_fraction:
        w = np.where(y == small_label,
                     sample_fraction * big / ((1.0 - sample_fraction) * small),
                     1.0)
    if w.sum() > max_training_sample:
        w = w * (max_training_sample / w.sum())
    return w
