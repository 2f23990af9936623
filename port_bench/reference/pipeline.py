"""One train() of a cell, worked out again from the raw columns.

``run`` returns what the check compares, in the form the harness takes
from the program: the training rows' design matrix and its columns, the
SanityChecker's statistics and kept columns, the fold metrics of the
candidates it was asked to compute, its own best of those, and the named
winner's scores on the holdout rows.  ``dtype`` is the precision of the
statistics, the fits and the stored design matrix (float64 for the
reference; the control asks for a lower one).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from itertools import product
from typing import Optional

import numpy as np
import torch

from . import constants as K
from . import linear, rank, sanity, split, trees
from .vectorize import Vectorizer


@dataclass
class RawColumn:
    type: str
    values: np.ndarray
    mask: np.ndarray

    @property
    def numeric(self) -> bool:
        return self.type in ("Real", "RealNN", "Integral")


def take(raw: dict, rows: np.ndarray) -> dict:
    return {k: RawColumn(r.type, r.values[rows], r.mask[rows])
            for k, r in raw.items()}


def grid(family: dict) -> list:
    """A family's grid points: the product of the mix's axes in file
    order, each point with the family's fixed params."""
    axes = family["grid"]
    keys = list(axes)
    return [dict(zip(keys, v), **family.get("fixed", {}))
            for v in product(*(axes[k] for k in keys))]


@dataclass
class Result:
    design: np.ndarray
    columns: list
    keep: list
    stats: dict
    candidates: list            # family, params, folds, mode
    best: tuple                 # (family, params) of the best computed
    winner: tuple               # the candidate whose holdout was scored
    holdout_scores: np.ndarray
    meta: dict = field(default_factory=dict)


def _stored(design: np.ndarray, dtype: torch.dtype) -> np.ndarray:
    """The design matrix as the program stores it: float32, or the
    control's lower precision."""
    x32 = design.astype(np.float32)
    if dtype in (torch.float64, torch.float32):
        return x32
    return torch.as_tensor(x32).to(dtype).to(torch.float32).numpy()


class _Fitter:
    """The selector's candidates on one design matrix, in ``dtype``."""

    def __init__(self, X: np.ndarray, y: np.ndarray, w: np.ndarray,
                 device, dtype) -> None:
        self.Xnp = X
        self.y = y
        self.dev = device
        self.dt = dtype
        self.X = torch.as_tensor(X, dtype=torch.float64,
                                 device=device).to(dtype)
        self.yt = torch.as_tensor(y, dtype=dtype, device=device)
        self.w = torch.as_tensor(w, dtype=dtype, device=device)
        self._bins = None

    def bins(self):
        if self._bins is None:
            edges = trees.sampled_edges(self.Xnp.astype(np.float64),
                                        K.GBT_MAX_BINS, K.EDGE_SAMPLE_CAP,
                                        K.EDGE_SEED)
            x32 = torch.as_tensor(self.Xnp.astype(np.float32),
                                  device=self.dev)
            self._bins = (edges, trees.to_bins(x32, edges))
        return self._bins

    def fit(self, family: str, params: dict, wmask: np.ndarray):
        wt = self.w * torch.as_tensor(wmask, dtype=self.dt, device=self.dev)
        if family == "OpLogisticRegression":
            beta, b0 = linear.fit(self.X, self.yt, wt,
                                  float(params["reg_param"]),
                                  float(params["elastic_net_param"]))
            return ("lr", beta, b0)
        if family == "OpGBTClassifier":
            edges, bins = self.bins()
            depth = trees.max_depth_for(
                int(params["max_depth"]), len(self.y), K.GBT_MIN_INSTANCES,
                bins.shape[1], K.GBT_MAX_BINS, 4)
            f0, heaps = trees.boost(
                bins, self.yt, wt, int(params["num_trees"]), depth,
                K.GBT_MAX_BINS, K.GBT_STEP, float(K.GBT_MIN_INSTANCES),
                float(params["min_info_gain"]))
            return ("gbt", edges, f0, heaps, depth)
        raise ValueError(f"the reference has no family {family!r}")

    def margin(self, model, X: np.ndarray) -> np.ndarray:
        """Decision margins of the rows of X (float64 on the host)."""
        if model[0] == "lr":
            _, beta, b0 = model
            Xt = torch.as_tensor(X, dtype=torch.float64,
                                 device=self.dev).to(self.dt)
            return linear.margin(Xt, beta, b0).double().cpu().numpy()
        _, edges, f0, heaps, depth = model
        b = trees.to_bins(torch.as_tensor(X.astype(np.float32),
                                          device=self.dev), edges)
        return trees.boost_margin(b, f0, heaps, depth,
                                  K.GBT_STEP).double().cpu().numpy()


def _prob(m: np.ndarray) -> np.ndarray:
    return 1.0 / (1.0 + np.exp(-m))


def run(config: dict, mix: dict, raw: dict, device,
        dtype: torch.dtype = torch.float64,
        tree_points: Optional[list] = None,
        winner: Optional[tuple] = None,
        card_rank_rule: bool = True) -> Result:
    """The reference's train() of ``raw`` (the generator's columns).

    ``tree_points``: indices of the tree family's grid points to compute
    (all when None); every point of the other families is computed.
    ``winner``: the (family, params) whose refit scores the holdout (the
    best computed when None).  ``card_rank_rule``: the run is on a card,
    so the linear family's AuROC takes 1 024 score bins from 100 000
    training rows up."""
    sel = mix["selector"]
    label = config["label"]["name"]
    n = len(raw[label].values)
    frac = float(sel["splitter"]["reserve_test_fraction"])
    tr, ho = split.holdout(n, frac, K.SPLIT_SEED)
    raw_tr, raw_ho = take(raw, tr), take(raw, ho)
    y = raw_tr[label].values.astype(np.float64)
    feats = {k: v for k, v in raw_tr.items() if k != label}

    vec = Vectorizer(config, feats, y, device)
    design = _stored(vec.transform(feats), dtype)
    Xs = torch.as_tensor(design, dtype=torch.float64, device=device).to(dtype)
    stats, keep = sanity.check(Xs, y, vec.columns)
    del Xs
    X = design[:, keep].astype(np.float64)
    w = split.balance_weights(y, float(sel["splitter"]["sample_fraction"]))
    folds = split.stratified_folds(y, int(sel["num_folds"]), int(sel["seed"]))
    fitter = _Fitter(X, y, w, device, dtype)

    cands = []
    best = None
    for fam in sel["families"]:
        points = grid(fam)
        todo = range(len(points))
        if fam["model_type"] == "OpGBTClassifier" and tree_points is not None:
            todo = sorted(set(tree_points))
        approx = (card_rank_rule and fam["model_type"] == "OpLogisticRegression"
                  and len(y) >= K.APPROX_RANK_MIN_ROWS)
        fam_best = None
        for j in todo:
            p = points[j]
            fold_m = []
            for f in range(folds.shape[0]):
                model = fitter.fit(fam["model_type"], p, folds[f])
                if approx:
                    m = fitter.margin(model, X)
                    fold_m.append(rank.binned_auroc(y, m, ~folds[f],
                                                    K.RANK_BINS))
                else:
                    val = ~folds[f]
                    m = fitter.margin(model, X[val])
                    fold_m.append(rank.auroc(y[val], _prob(m)))
            cands.append({"family": fam["model_type"], "params": p,
                          "folds": fold_m,
                          "mode": "approx" if approx else "exact"})
            mean = float(np.mean(fold_m))
            if fam_best is None or mean > fam_best[0]:
                fam_best = (mean, fam["model_type"], p)
        if fam_best is not None and (best is None or fam_best[0] > best[0]):
            best = fam_best
    chosen = winner if winner is not None else (best[1], best[2])
    model = fitter.fit(chosen[0], chosen[1], np.ones(len(y), dtype=bool))
    Xh = _stored(vec.transform({k: v for k, v in raw_ho.items()
                                if k != label}), dtype)[:, keep]
    scores = _prob(fitter.margin(model, Xh.astype(np.float64)))
    return Result(design=design, columns=vec.columns, keep=keep, stats=stats,
                  candidates=cands, best=(best[1], best[2]), winner=chosen,
                  holdout_scores=scores,
                  meta={"n_train": len(y), "n_holdout": len(ho),
                        "width": design.shape[1], "kept": len(keep)})
