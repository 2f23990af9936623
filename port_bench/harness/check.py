"""The comparison that decides ``correct``: what one sampled train of the
window produced against the plain reference's train of the same data.

Four numbers, each held to its own limit (``limits/<cell>.json``):

* ``design_gap``: the vectorizers' design matrix of the training rows,
  the largest |program - reference| / (1 + |reference|); 1 more for each
  column whose (parent, group, indicator) differs.
* ``sanity_gap``: the SanityChecker over the columns the reference keeps
  by variance, the largest of the correlation gap, the variance's and the
  mean's relative gaps; 1 more for each column kept on one side only.
* ``selection_gap``: the largest gap of a fold's AuROC between the
  program and the reference over every candidate the reference computed
  (every linear one, the program's winner and tree points drawn from the
  seed), and the winner's regret: how far the reference's mean for the
  program's winner lies below the reference's best mean.
* ``holdout_gap``: the winner's holdout scores, the mean |program -
  reference| over the holdout rows.
"""
from __future__ import annotations

import numpy as np

from port_bench.reference import constants as K

NUMBERS = ("design_gap", "sanity_gap", "selection_gap", "holdout_gap")


def design_gap(prog, ref) -> float:
    cols_p, cols_r = list(prog.columns), list(ref.columns)
    if cols_p != cols_r:
        diff = sum(a != b for a, b in zip(cols_p, cols_r))
        return 1.0 + diff + abs(len(cols_p) - len(cols_r))
    if prog.design.shape != ref.design.shape:
        return 1.0 + abs(prog.design.shape[0] - ref.design.shape[0])
    worst = 0.0
    step = max(1, (1 << 24) // max(1, prog.design.shape[1]))
    for i in range(0, prog.design.shape[0], step):
        p = np.asarray(prog.design[i:i + step], np.float64)
        r = np.asarray(ref.design[i:i + step], np.float64)
        worst = max(worst, float((np.abs(p - r) / (1.0 + np.abs(r))).max()))
    return worst


def sanity_gap(prog, ref) -> float:
    kp, kr = set(prog.keep), set(ref.keep)
    mismatch = float(len(kp ^ kr))
    rv = ref.stats["variance"]
    if len(prog.stats["variance"]) != len(rv):
        return 1.0 + mismatch
    cols = np.nonzero(rv >= K.MIN_VARIANCE)[0]
    worst = 0.0
    for key in ("corr", "variance", "mean"):
        p = prog.stats[key][cols]
        r = ref.stats[key][cols]
        fin = np.isfinite(r)
        if (np.isfinite(p) != fin).any():
            worst = max(worst, 1.0)
        if key == "corr":
            gap = np.abs(p[fin] - r[fin])
        elif key == "variance":
            gap = np.abs(p[fin] - r[fin]) / np.maximum(r[fin], 1e-300)
        else:
            gap = np.abs(p[fin] - r[fin]) / np.sqrt(rv[cols][fin])
        if gap.size:
            worst = max(worst, float(gap.max()))
    return worst + mismatch


def _key(c) -> tuple:
    return c["family"], tuple(sorted(c["params"].items()))


def selection_gap(prog, ref) -> float:
    have = {_key(c): c for c in prog.candidates}
    worst = 0.0
    means = {}
    for c in ref.candidates:
        means[_key(c)] = float(np.mean(c["folds"]))
        p = have.get(_key(c))
        if p is None or len(p["folds"]) != len(c["folds"]):
            worst = max(worst, 1.0)
            continue
        worst = max(worst, float(np.max(np.abs(np.asarray(p["folds"])
                                               - np.asarray(c["folds"])))))
    win = (prog.winner[0], tuple(sorted(prog.winner[1].items())))
    if win not in means:
        return max(worst, 1.0)
    regret = max(means.values()) - means[win]
    return max(worst, regret)


def holdout_gap(prog, ref) -> float:
    p, r = np.asarray(prog.holdout_scores), np.asarray(ref.holdout_scores)
    if p.shape != r.shape:
        return 1.0
    return float(np.mean(np.abs(p - r)))


def numbers(prog, ref) -> dict:
    return {"design_gap": design_gap(prog, ref),
            "sanity_gap": sanity_gap(prog, ref),
            "selection_gap": selection_gap(prog, ref),
            "holdout_gap": holdout_gap(prog, ref)}


def judge(values: dict, limits) -> tuple[bool, dict]:
    """(correct, {number: {"value", "limit"}}): every number at or under
    its limit; a cell without limits is never correct."""
    out = {}
    ok = limits is not None
    for k in NUMBERS:
        lim = None if limits is None else limits.get(k, {}).get("limit")
        v = values.get(k)
        out[k] = {"value": v, "limit": lim}
        if lim is None or v is None or not np.isfinite(v) or v > lim:
            ok = False
    return ok, out


def tree_points(mix: dict, winner: tuple, seed: int) -> list:
    """The tree family's grid points the reference computes: the
    program's winner when it is one, and ``sampled_tree_candidates``
    others drawn from the seed."""
    from port_bench.reference.pipeline import grid

    fam = next((f for f in mix["selector"]["families"]
                if f["model_type"] == "OpGBTClassifier"), None)
    if fam is None:
        return []
    points = grid(fam)
    chosen = []
    if winner[0] == fam["model_type"]:
        chosen = [i for i, p in enumerate(points) if p == winner[1]]
    others = [i for i in range(len(points)) if i not in chosen]
    k = min(int(mix["check"]["sampled_tree_candidates"]), len(others))
    rng = np.random.default_rng([int(seed) % (1 << 64), 2])
    chosen += sorted(int(i) for i in rng.choice(others, size=k, replace=False))
    return chosen
