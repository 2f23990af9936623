"""Fused training programs: one fold x grid dispatch per family.

Counterpart of ``transmogrifai_tpu/local/fused_train.py``.  The
kernel-at-a-time dispatch in ``selector/validator.py`` fits a family's
fold x grid batch, brings the betas (or heaps) to the host, and then, per
candidate and fold, sends the fold's validation rows back to the device to
score them and takes the scores to the host evaluator.  Here one family's
dispatch keeps every intermediate on the validator's device:

* the FIT - the family's whole fold x grid fit: the batched Newton with
  the bitwise fixed-point exit (``packed_newton.newton_fixed_point``:
  the same betas as the fixed-length loop, the wasted tail iterations
  left out), or the grid x fold tree fit of ``trees.fused_tree_plan``.
  The [B, n] fold-weight block it takes is built for the call and dropped
  as soon as the fit has returned (the JAX package donates it); the
  shared design matrix is only read.
* the SCORES - each fold's validation rows gathered once on the device
  (for trees: their bins, gathered from the one K2 binning of the plan),
  then each candidate's own predict math on them, op for op the
  kernel-at-a-time path's, so the scores are its scores bit for bit.
* the METRICS - the whole [k, g] metric matrix at once: exact rank
  metrics (one int64 bit-pattern sort a candidate, tie-grouped trapezoid
  AuROC and step-area AuPR, float64 sums whose every term is a
  half-integer below 2^53, so the sums are exact and match the host
  evaluator to the final division) or the float64 regression metrics.

Only the metric matrix and the betas come back to the host.

The approx mode (the validator's 1024-bin device metrics) reuses the
kernel-at-a-time arm's own ``_margins_kernel`` and ``masked_rank_metrics``
on the fit's device betas: bit-equal by construction.

No compile cache: eager torch has no trace or compile step to skip, so
the JAX package's ``TrainExecutableCache``, its program registry and its
use of jax's persistent compilation cache have no twin.  The trail keeps
their shape: each family reports ``cache: "none"`` and ``trace_ms``,
``compile_ms`` and ``load_ms`` of 0.0, and the top-level ``cache``
counts stay 0; ``cache_dir`` is accepted and unused.

64-bit sort keys: the JAX package sorts uint64 keys
``(valid << 63) | (ord62 << 1) | label``.  Here the same key is an int64
with the top bit flipped, so that signed order is the JAX package's
unsigned order (torch's uint64 has partial operator support).
"""
from __future__ import annotations

import os
import time
from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np
import torch


class FusedTrainError(Exception):
    """A family's fold x grid dispatch cannot take the fused path;
    ``reason`` is the short fallback reason the validator records."""

    def __init__(self, reason: str, detail: str = "") -> None:
        super().__init__(detail or reason)
        self.reason = reason


# ---------------------------------------------------------------------------
# Exact device rank / regression metrics
# ---------------------------------------------------------------------------
_INT64_MIN = -(1 << 63)


def _ord62(scores: torch.Tensor) -> torch.Tensor:
    """Order-preserving 62-bit integer keys (int64, in [0, 2^62)) for a
    [B, m] score block: the JAX package's ``_ord62``.

    float32 scores map losslessly (their 32 ordered bits << 30).  float64
    scores keep their top 62 ordered pattern bits: only values within 4
    consecutive float64 patterns collide, which exact ties never are."""
    if scores.dtype == torch.float64:
        bits = scores.view(torch.int64)
        # sign 0: pattern | 2^63, then >> 2; sign 1: ~pattern >> 2
        return torch.where(bits >= 0, (bits >> 2) + (1 << 61), (~bits) >> 2)
    bits = scores.to(torch.float32).view(torch.int32).to(torch.int64)
    u = bits & 0xFFFFFFFF
    ordered = torch.where(u >> 31 == 0, u | 0x80000000, (~u) & 0xFFFFFFFF)
    return ordered << 30


def exact_rank_metrics(scores: torch.Tensor, yb: torch.Tensor,
                       okb: torch.Tensor):
    """Exact AuROC and AuPR per candidate row, on the scores' device.

    scores [B, m] (float32 or float64, higher = more positive), yb [B, m]
    float64 labels in {0, 1}, okb [B, m] bool validity (False = gather
    padding).  One int64 sort a row: key = ord62 << 1 | label, with the
    top bit set on invalid rows, so they sink below every valid row; one
    pass of cumulative sums over the descending order gives the
    tie-grouped trapezoid AuROC and the step-area AuPR - the group-end
    formulas of the host evaluator's ``_roc_pr_areas``, term for term in
    float64.  Returns (auroc [B], aupr [B]) float64.

    -0.0 and 0.0 are one tie group, as in the host evaluator (its groups
    split where ``np.diff`` of the sorted scores is nonzero); the JAX
    package's keys split them by their bit patterns."""
    B, m = scores.shape
    scores = torch.where(scores == 0, torch.zeros_like(scores), scores)
    key = (_ord62(scores) << 1) | yb.to(torch.int64)
    key = torch.where(okb, key, key | _INT64_MIN)
    skey = torch.flip(torch.sort(key, dim=1).values, dims=(1,))  # descending
    valid = (skey >= 0).to(torch.float64)
    yy = (skey & 1).to(torch.float64)
    gkey = skey >> 1  # score bits and validity: the tie groups
    tp = torch.cumsum(yy * valid, dim=1)
    fp = torch.cumsum((1.0 - yy) * valid, dim=1)
    iota = torch.arange(m, dtype=torch.int64, device=scores.device)
    neq_prev = gkey[:, 1:] != gkey[:, :-1]
    ones = torch.ones((B, 1), dtype=torch.bool, device=scores.device)
    is_start = torch.cat([ones, neq_prev], dim=1)
    is_end = torch.cat([neq_prev, ones], dim=1)
    start_idx = torch.cummax(
        torch.where(is_start, iota[None, :], torch.zeros_like(iota)[None, :]),
        dim=1).values
    prev = torch.clamp(start_idx - 1, min=0)
    has_prev = start_idx > 0
    tp_prev = torch.where(has_prev, torch.gather(tp, 1, prev),
                          torch.zeros_like(tp))
    fp_prev = torch.where(has_prev, torch.gather(fp, 1, prev),
                          torch.zeros_like(fp))
    hp = tp - tp_prev
    hn = fp - fp_prev
    P = tp[:, -1]
    N = fp[:, -1]
    endw = (is_end & (valid > 0)).to(torch.float64)
    auroc = ((endw * hn * (tp_prev + 0.5 * hp)).sum(dim=1)
             / torch.clamp(P * N, min=1e-12))
    prec = tp / torch.clamp(tp + fp, min=1e-12)
    aupr = (endw * hp * prec).sum(dim=1) / torch.clamp(P, min=1e-12)
    has_both = (P > 0) & (N > 0)
    zero = torch.zeros_like(auroc)
    return torch.where(has_both, auroc, zero), torch.where(has_both, aupr, zero)


def regression_metrics(pred: torch.Tensor, yb: torch.Tensor,
                       okb: torch.Tensor, metric_name: str) -> torch.Tensor:
    """Per-candidate regression metric over gathered validation rows: the
    float64 mirror of ``evaluators/regression.OpRegressionEvaluator`` on
    (pred [B, m], yb [B, m]), padding masked by ``okb``."""
    okd = okb.to(torch.float64)
    cnt = torch.clamp(okd.sum(dim=1), min=1.0)
    err = (yb - pred.to(torch.float64)) * okd
    sse = (err * err).sum(dim=1)
    if metric_name == "MeanSquaredError":
        return sse / cnt
    if metric_name == "RootMeanSquaredError":
        return torch.sqrt(sse / cnt)
    if metric_name == "MeanAbsoluteError":
        return err.abs().sum(dim=1) / cnt
    if metric_name == "R2":
        ymean = (yb * okd).sum(dim=1, keepdim=True) / cnt[:, None]
        ss_tot = (((yb - ymean) ** 2) * okd).sum(dim=1)
        return torch.where(ss_tot > 0, 1.0 - sse / ss_tot,
                           torch.zeros_like(ss_tot))
    raise FusedTrainError("metric_unsupported", metric_name)


SUPPORTED_RANK_METRICS = ("AuROC", "AuPR")
SUPPORTED_REGRESSION_METRICS = (
    "RootMeanSquaredError", "MeanSquaredError", "MeanAbsoluteError", "R2",
)


def metric_kind(evaluator) -> Optional[tuple]:
    """(kind, metric_name) when the evaluator's default metric has an exact
    device implementation here, else None.  An exact TYPE match: a
    subclass may override ``evaluate_arrays``, and the fused metrics must
    mirror the implementation they claim parity with."""
    from ..evaluators.binary import OpBinaryClassificationEvaluator
    from ..evaluators.regression import OpRegressionEvaluator

    name = getattr(evaluator, "metric_name", None)
    if (type(evaluator) is OpBinaryClassificationEvaluator
            and name in SUPPORTED_RANK_METRICS):
        return ("rank", name)
    if (type(evaluator) is OpRegressionEvaluator
            and name in SUPPORTED_REGRESSION_METRICS):
        return ("regression", name)
    return None


def val_gather_plan(masks: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Per-fold validation-row index arrays from [k, n] train masks,
    padded to the widest fold: (val_idx [k, m] int32, val_ok [k, m]
    bool).  Padding indexes row 0 with ok=False - gathered but masked."""
    k = masks.shape[0]
    idxs = [np.nonzero(~masks[f])[0] for f in range(k)]
    m = max((len(i) for i in idxs), default=0)
    if m == 0:
        raise FusedTrainError("no_validation_rows")
    val_idx = np.zeros((k, m), np.int32)
    val_ok = np.zeros((k, m), bool)
    for f, i in enumerate(idxs):
        val_idx[f, : len(i)] = i
        val_ok[f, : len(i)] = True
    return val_idx, val_ok


def tree_fits_cap(depth: int, n: int, d: int, max_bins: int,
                  n_stats: int) -> int:
    """The most tree fits one fused tree plan may take
    (``tree_kernel.fits_per_dispatch``, the JAX package's rule) under its
    knobs: ``TX_TREE_FITS_PER_DISPATCH`` sets the cap,
    ``TX_TREE_DISPATCH_BUDGET_S`` the budget in the rule's seconds."""
    from ..models.tree_kernel import fits_per_dispatch

    return fits_per_dispatch(
        depth, n, d, max_bins, n_stats,
        budget_s=float(os.environ.get("TX_TREE_DISPATCH_BUDGET_S", "30")),
        override=int(os.environ.get("TX_TREE_FITS_PER_DISPATCH", "0")))


@dataclass
class FusedDispatchResult:
    """What one fused family dispatch hands back to the validator."""

    metrics: np.ndarray  # [k, g] float64, metric per (fold, candidate)
    betas: Optional[np.ndarray]
    b0s: Optional[np.ndarray]
    report: dict


def _count_dispatch() -> None:
    from ..obs.metrics import metrics_registry

    metrics_registry().counter(
        "train_fused.dispatches",
        help="family fold x grid dispatches that ran as fused programs",
    ).inc()


def _report(mode: str, n: int, d: int, k: int, g: int, t0: float) -> dict:
    """The family's trail entry, in the JAX package's shape (no cache)."""
    return {"backend": "fused", "cache": "none", "trace_ms": 0.0,
            "compile_ms": 0.0, "load_ms": 0.0,
            "exec_ms": round((time.perf_counter() - t0) * 1e3, 3),
            "mode": mode, "bucket": f"n={n},d={d},k={k},g={g}"}


def _padded(scores: torch.Tensor, m: int) -> torch.Tensor:
    return torch.nn.functional.pad(scores, (0, m - scores.shape[0]))


def _metric_matrix(scores: torch.Tensor, y_folds: torch.Tensor,
                   val_ok: torch.Tensor, g: int, mkind: str,
                   mname: str) -> np.ndarray:
    """The [k, g] metric matrix from fold-major stacked scores [k*g, m]:
    the only result that leaves the device."""
    k = scores.shape[0] // g
    yb = y_folds.repeat_interleave(g, dim=0)  # [k*g, m]
    okb = val_ok.repeat_interleave(g, dim=0)
    if mkind == "rank":
        auroc, aupr = exact_rank_metrics(scores, yb, okb)
        vals = auroc if mname == "AuROC" else aupr
    else:
        vals = regression_metrics(scores, yb, okb, mname)
    return vals.reshape(k, g).to(torch.float64).cpu().numpy()


def _source_rows(src, idx: np.ndarray, dev: torch.device) -> torch.Tensor:
    """The rows ``idx`` of the validator's own X (a host array or a
    tensor) on ``dev``, in its float dtype (at least float32): the rows a
    host predict head reads."""
    if isinstance(src, torch.Tensor):
        rows = src[torch.as_tensor(idx, device=src.device)].to(dev)
        return rows.to(torch.promote_types(rows.dtype, torch.float32))
    rows = np.asarray(src)[idx]
    return torch.tensor(np.ascontiguousarray(
        rows, dtype=np.promote_types(rows.dtype, np.float32)), device=dev)


# ---------------------------------------------------------------------------
# Linear families
# ---------------------------------------------------------------------------
def run_linear(
    est,
    X,
    y: np.ndarray,
    masks: np.ndarray,
    w: np.ndarray,
    weights_given: bool,
    regs: np.ndarray,
    ens: np.ndarray,
    g: int,
    evaluator,
    mode: str,
    cache_dir: Optional[str] = None,
    x_source=None,
) -> FusedDispatchResult:
    """One fused dispatch for a batched linear family (LR, linear SVC,
    linear regression): the [k, g] metric matrix and the betas, or
    :class:`FusedTrainError` with the fallback reason.

    ``X`` is the validator's float32 design matrix on its device (a host
    array goes there first); it is never written.  ``x_source`` is the
    validator's own X, whose rows a family with ``fused_score_rows =
    "source"`` scores in their own dtype (the SVM's float64 margin head);
    default ``X``.  The
    [B, n] fold-weight block is built here and dropped once the fit has
    returned.  ``cache_dir`` is accepted and unused (no compile cache)."""
    kind = metric_kind(evaluator)
    if kind is None:
        raise FusedTrainError(
            "evaluator_unsupported", type(evaluator).__name__)
    mkind, mname = kind
    if mode == "approx" and mkind != "rank":
        raise FusedTrainError("approx_needs_rank_metric")
    if not hasattr(est, "fused_train_core"):
        raise FusedTrainError("family_unsupported", est.model_type)
    from ..models.logistic_regression import _f32

    if not isinstance(X, torch.Tensor):
        from ..utils.device import resolve_device

        X = _f32(X, resolve_device(est.device))
    dev = X.device
    k, n = masks.shape
    d = int(X.shape[1])
    core = est.fused_train_core(False)
    t0 = time.perf_counter()
    Xd = _f32(X, dev)
    y32 = torch.as_tensor(np.asarray(y), device=dev).to(torch.float32)
    trainj = torch.as_tensor(masks, device=dev).to(torch.float32)  # [k, n]
    if not weights_given:
        W = trainj.repeat_interleave(g, dim=0)
    else:
        wj = torch.as_tensor(w, device=dev).to(torch.float32)
        W = (trainj * wj[None, :]).repeat_interleave(g, dim=0)
    betas_d, b0s_d = core["fit"](Xd, y32, W, _f32(regs, dev), _f32(ens, dev))
    del W  # the fold-weight block: nothing reads it after the fit
    if mode == "approx":
        # the kernel-at-a-time approx arm's own kernels, fed the fit's
        # device betas: bit-equal to that arm by construction
        from ..evaluators.binary import masked_rank_metrics
        from ..selector.validator import _margins_kernel

        scores = _margins_kernel(Xd, betas_d.clone(), b0s_d.clone()).T
        vmask = (1.0 - trainj).repeat_interleave(g, dim=0)
        auroc_b, aupr_b = masked_rank_metrics(scores, y32, vmask)
        vals = auroc_b if mname == "AuROC" else aupr_b
        metrics = np.asarray(vals, np.float64).reshape(k, g)
    else:
        val_idx, val_ok = val_gather_plan(masks)
        m = val_idx.shape[1]
        counts = val_ok.sum(axis=1)
        score = core["score"]
        own_rows = getattr(est, "fused_score_rows", "float32") == "source"
        src = X if x_source is None else x_source
        rows = []
        for f in range(k):
            # the fold's validation rows, gathered once, at the shape the
            # kernel-at-a-time predict sees them (no padding rows in the
            # matmul); each candidate's beta and intercept a fresh copy,
            # laid out as that predict's own uploads are
            idx = val_idx[f, : counts[f]]
            Xv = (_source_rows(src, idx, dev) if own_rows
                  else Xd[torch.as_tensor(idx, device=dev)])
            for j in range(g):
                b = f * g + j
                s = score(Xv, betas_d[b].clone(), b0s_d[b].clone())
                rows.append(_padded(s, m))
        scores = torch.stack(rows)  # [k*g, m] fold-major
        y_folds = torch.as_tensor(np.asarray(y, np.float64)[val_idx],
                                  device=dev)
        metrics = _metric_matrix(scores, y_folds,
                                 torch.as_tensor(val_ok, device=dev), g,
                                 mkind, mname)
    out_betas = betas_d.cpu().numpy()
    out_b0s = b0s_d.cpu().numpy()
    report = _report(mode, n, d, k, g, t0)
    _count_dispatch()
    return FusedDispatchResult(metrics=metrics, betas=out_betas,
                               b0s=out_b0s, report=report)


# ---------------------------------------------------------------------------
# Tree families
# ---------------------------------------------------------------------------
def run_tree(
    est,
    X: np.ndarray,
    y: np.ndarray,
    masks: np.ndarray,
    W: np.ndarray,
    grid: Sequence[dict],
    evaluator,
    cache_dir: Optional[str] = None,
) -> FusedDispatchResult:
    """One fused dispatch for a tree family (random forest, GBT): the
    plan's whole grid x fold fit (heaps stay on the device), each
    candidate's traversal over the once-gathered validation bins, and the
    metric matrix.  Raises :class:`FusedTrainError` with the fallback
    reason (native backend, several shape groups, a chunked dispatch...).
    ``cache_dir`` is accepted and unused (no compile cache)."""
    kind = metric_kind(evaluator)
    if kind is None:
        raise FusedTrainError(
            "evaluator_unsupported", type(evaluator).__name__)
    mkind, mname = kind
    if not hasattr(est, "fused_tree_plan"):
        raise FusedTrainError("family_unsupported", est.model_type)
    try:
        plan = est.fused_tree_plan(X, y, W, list(grid))
    except ValueError as e:
        raise FusedTrainError(str(e) or "tree_plan_rejected") from e
    k, n = masks.shape
    G = len(grid)
    val_idx, val_ok = val_gather_plan(masks)
    m = val_idx.shape[1]
    counts = val_ok.sum(axis=1)
    arrays = plan["arrays"]
    bins_all = arrays[plan["bins_key"]]
    dev = bins_all.device
    t0 = time.perf_counter()
    state = plan["fit"](arrays)
    for name in plan["donate"]:
        # the per-call blocks (fold weights, bootstrap, stats): nothing
        # reads them after the fit
        del arrays[name]
    rows = []
    for f in range(k):
        # ONE validation-bins gather a fold (integer movement: exactly
        # the bins the kernel-at-a-time path's per-candidate binning of
        # the same rows gives), then each candidate's predict mirror
        bins_v = bins_all[torch.as_tensor(val_idx[f, : counts[f]],
                                          device=dev)]
        for gi in range(G):
            rows.append(_padded(plan["score"](state, bins_v, f, gi), m))
    scores = torch.stack(rows)
    y_folds = torch.as_tensor(np.asarray(y, np.float64)[val_idx], device=dev)
    metrics = _metric_matrix(scores, y_folds,
                             torch.as_tensor(val_ok, device=dev), G, mkind,
                             mname)
    report = _report("exact", n, int(X.shape[1]), k, G, t0)
    _count_dispatch()
    return FusedDispatchResult(metrics=metrics, betas=None, b0s=None,
                               report=report)
