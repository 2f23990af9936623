"""Successive-halving decisions for model selection.

Host copy of ``transmogrifai_tpu/autotune/pruning.py``.

The DECISION half of the budget-ladder seam: the selector
(``selector/validator.py``) executes rung fits and full-CV fits - this
module owns the policy: whether pruning is worth attempting (cost-model
predictions of the exhaustive vs pruned spend), which candidates
survive the rung (interim eval scores with deterministic, original-
index tie-breaks), and the decision-trail report recorded in selection
metadata and the obs plane.

Budget invariant (pinned by the tests): a pruned selection never
evaluates more candidate-fold fits than the exhaustive sweep.  With
``g`` candidates over ``k`` folds the exhaustive budget is ``g*k``
fits; a pruned run spends ``g`` rung fits plus ``s*k`` survivor fits,
so the survivor count is clamped to ``s <= g*(k-1)/k``.  Every
degrade-to-exhaustive decision happens BEFORE any rung fit runs, so a
degraded run spends exactly the exhaustive budget, never more.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Optional

from .cost_model import CostModel, candidate_features, key_for_fit

__all__ = [
    "AutotuneConfig",
    "CandidateInfo",
    "PruningPlan",
    "fit_budget",
    "plan_pruning",
    "select_survivors",
]


@dataclass
class AutotuneConfig:
    """Selector-side autotune knobs (the runner's ``autotune`` custom
    params build one of these and install it on the validator)."""

    cost_model: CostModel
    #: rung-0 row budget: candidates first fit on this many rows
    rung_rows: int = 250_000
    #: train share of the rung subsample (rest is the interim eval set)
    rung_train_fraction: float = 0.75
    #: share of candidates surviving to the full-CV rung
    keep_fraction: float = 0.5
    #: never prune below this many survivors
    min_keep: int = 2
    #: below this many rows the rung is not meaningfully cheaper than
    #: the full fit - run exhaustively
    min_rows: int = 20_000
    #: predicted exhaustive/pruned speedup required to commit to the
    #: ladder (the cost model's go/no-go call, made BEFORE any rung fit)
    min_predicted_speedup: float = 1.1
    #: cold cost model (any candidate family unpredictable) degrades to
    #: the exhaustive path; False trusts interim scores alone
    require_cost_model: bool = True
    #: where the versioned cost-model artifact lives (runner-owned)
    model_path: Optional[str] = None


@dataclass
class CandidateInfo:
    """One grid point's rung trail entry."""

    index: int  # global candidate index in original evaluation order
    est_index: int  # which (estimator, grid) pair it belongs to
    grid_index: int  # position inside that estimator's grid
    family: str
    params: dict
    params_hash: str
    predicted_fit_ms: Optional[float] = None  # per full-data fold fit
    predicted_rung_ms: Optional[float] = None
    rung_wall_ms: Optional[float] = None
    interim_metric: Optional[float] = None
    rung_error: Optional[str] = None
    kept: bool = False

    def to_json(self) -> dict:
        return {
            "index": self.index,
            "family": self.family,
            "params": dict(self.params),
            "params_hash": self.params_hash,
            "predicted_fit_ms": _r(self.predicted_fit_ms),
            "predicted_rung_ms": _r(self.predicted_rung_ms),
            "rung_wall_ms": _r(self.rung_wall_ms),
            "interim_metric": _r(self.interim_metric, 9),
            "rung_error": self.rung_error,
            "kept": self.kept,
        }


def _r(v: Optional[float], nd: int = 3) -> Optional[float]:
    return None if v is None else round(float(v), nd)


def fit_budget(g_total: int, k: int) -> int:
    """Candidate-fold fits the exhaustive sweep spends (the floor)."""
    return int(g_total) * int(k)


@dataclass
class PruningPlan:
    """Outcome of the go/no-go decision plus (when pruning) the rung
    roster.  ``mode`` is ``"pruned"`` or ``"exhaustive"``; in
    exhaustive mode ``reason`` says why (the cold-start satellite)."""

    mode: str
    reason: Optional[str]
    k: int
    g_total: int
    candidates: list = field(default_factory=list)  # CandidateInfo
    rung_rows: int = 0
    survivor_budget: int = 0
    predicted_exhaustive_ms: Optional[float] = None
    predicted_pruned_ms: Optional[float] = None

    @property
    def pruning(self) -> bool:
        return self.mode == "pruned"

    def report(self) -> dict:
        kept = sum(1 for c in self.candidates if c.kept)
        fits_rung = self.g_total if self.pruning else 0
        fits_full = (kept * self.k) if self.pruning \
            else self.g_total * self.k
        speedup = None
        if self.predicted_exhaustive_ms and self.predicted_pruned_ms:
            speedup = self.predicted_exhaustive_ms / max(
                self.predicted_pruned_ms, 1e-9)
        return {
            "mode": self.mode,
            "reason": self.reason,
            "folds": self.k,
            "candidates_total": self.g_total,
            "candidates_pruned": (self.g_total - kept) if self.pruning
            else 0,
            "survivors": kept if self.pruning else self.g_total,
            "survivor_budget": self.survivor_budget,
            "rung_rows": self.rung_rows if self.pruning else 0,
            "fits": {
                "rung": fits_rung,
                "full": fits_full,
                "total": fits_rung + fits_full,
                "exhaustive": fit_budget(self.g_total, self.k),
            },
            "predicted_exhaustive_ms": _r(self.predicted_exhaustive_ms),
            "predicted_pruned_ms": _r(self.predicted_pruned_ms),
            "predicted_speedup": _r(speedup),
            "rungs": [c.to_json() for c in self.candidates]
            if self.pruning else [],
        }


def plan_pruning(
    cfg: AutotuneConfig,
    candidates: list,
    n_rows: int,
    n_features: int,
    k: int,
    class_balance: float = 0.5,
) -> PruningPlan:
    """The go/no-go call, made BEFORE any rung fit so a degraded run
    costs exactly the exhaustive budget.  ``candidates`` is the full
    CandidateInfo roster (rung results not yet filled).  Commits to the
    ladder only when (a) there is fit budget for a rung at all, (b) the
    cost model can predict every candidate family, and (c) the
    predicted exhaustive/pruned speedup clears the bar."""
    g = len(candidates)
    plan = PruningPlan(mode="exhaustive", reason=None, k=k, g_total=g)
    if g < 2:
        plan.reason = "single_candidate"
        return plan
    if k < 2:
        # one fold: g rung fits + s*1 full fits can never undercut g*1
        plan.reason = "too_few_folds"
        return plan
    if n_rows < max(cfg.min_rows, 2 * 1):
        plan.reason = "too_few_rows"
        return plan
    rung_rows = int(min(cfg.rung_rows, n_rows // 2))
    if rung_rows < 64:
        plan.reason = "too_few_rows"
        return plan
    survivor_budget = min(
        max(int(math.ceil(cfg.keep_fraction * g)), cfg.min_keep),
        (g * (k - 1)) // k,
    )
    if (survivor_budget < max(cfg.min_keep, 1)
            or survivor_budget >= g):
        # the fits-floor clamp may undercut min_keep on tiny grids
        # (g=2, k=3 -> budget 1 < min_keep 2): honor the min_keep
        # contract by degrading to exhaustive, never by keeping fewer
        plan.reason = "no_fit_budget"
        return plan
    cm = cfg.cost_model
    cold: list[str] = []
    pred_full_total = 0.0
    pred_rung_total = 0.0
    for c in candidates:
        feats_full = candidate_features(
            n_rows, n_features, c.params, class_balance)
        feats_rung = candidate_features(
            rung_rows, n_features, c.params, class_balance)
        key = key_for_fit(c.family)
        c.predicted_fit_ms = cm.predict_wall_ms(key, feats_full)
        c.predicted_rung_ms = cm.predict_wall_ms(key, feats_rung)
        if c.predicted_fit_ms is None:
            if c.family not in cold:
                cold.append(c.family)
        else:
            pred_full_total += c.predicted_fit_ms * k
            pred_rung_total += c.predicted_rung_ms or 0.0
    if cold:
        if cfg.require_cost_model:
            # the cold-start contract: no observations -> exhaustive,
            # with the families that need training named in the reason
            plan.reason = "cost_model_cold:" + ",".join(sorted(cold))
            return plan
    else:
        # cost model speaks for every family: predicted pruned spend =
        # rung + the survivor budget's share of the full spend
        pred_pruned = pred_rung_total + pred_full_total * (
            survivor_budget / g)
        plan.predicted_exhaustive_ms = pred_full_total
        plan.predicted_pruned_ms = pred_pruned
        if pred_full_total > 0 and (
                pred_full_total / max(pred_pruned, 1e-9)
                < cfg.min_predicted_speedup):
            plan.reason = "predicted_savings_too_small"
            return plan
    plan.mode = "pruned"
    plan.rung_rows = rung_rows
    plan.survivor_budget = survivor_budget
    plan.candidates = candidates
    return plan


def select_survivors(plan: PruningPlan, larger_better: bool) -> list:
    """Rank rung results and mark survivors; returns kept candidate
    indices.  DETERMINISTIC tie-breaks: equal interim metrics rank by
    ORIGINAL candidate index, so a winner tie resolves identically with
    autotune on and off (the RandomParamBuilder determinism contract).
    A candidate whose rung fit errored ranks last but is never treated
    as evaluated."""

    def rank_key(c: CandidateInfo):
        m = c.interim_metric
        if m is None or m != m:
            return (1, 0.0, c.index)  # failed/NaN rung: rank last
        return (0, -m if larger_better else m, c.index)

    ranked = sorted(plan.candidates, key=rank_key)
    for pos, c in enumerate(ranked):
        c.kept = pos < plan.survivor_budget
    return [c.index for c in plan.candidates if c.kept]
