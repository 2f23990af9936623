"""Cross-validation / train-validation split over array-level candidates.

Counterpart of ``transmogrifai_tpu/selector/validator.py`` (OpValidator /
OpCrossValidation / OpTrainValidationSplit; reference: core/.../impl/
tuning/OpValidator.scala:275-322, OpCrossValidation.scala:71-167,
OpTrainValidationSplit.scala).  Where the reference fans fold x
model-type training out on a JVM thread pool, here the fan-out is
ARRAY-BATCHED on the validator's ``device``: folds and grid points are a
leading axis of weight vectors.  Three routes, as in the JAX package:

* binary logistic-regression-style grids train the whole fold x grid
  batch as ONE batched Newton fit over the design matrix uploaded once
  (``fit_arrays_batched``), and score it either on the device with the
  1024-bin ``masked_rank_metrics`` (the approx mode) or on the host with
  the exact evaluator;
* estimators with ``fit_arrays_folds`` (the GBT) fit every grid point and
  fold over one shared binning (``fit_arrays_folds_grid``), scored on the
  host;
* anything else fits candidate by candidate.

The approx mode runs where the validator's device is CUDA and n >= 100 000
(the JAX package's rule is its TPU backend and the same n);
``TX_CV_RANK_METRICS=approx|exact`` overrides either way.

Not ported yet, each raising ``NotImplementedError`` with its ROADMAP.md
queue 1 item when asked for: the CV checkpoint and its heartbeat
(``checkpoint_path``, item 1), successive-halving ``autotune`` (item 12),
the fused training programs (``train_fused``, item 9), ``validate_stream``
(item 12).  The CV mesh and its guarded collectives are item 10: this
package fits on one device.  The ``cv.*`` trace spans come with the obs
modules (item 1).
"""
from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Optional, Sequence

import numpy as np
import torch

from ..evaluators.base import OpEvaluatorBase
from ..evaluators.binary import masked_rank_metrics
from ..models.base import PredictorEstimator
from ..types.columns import PredictionColumn
from ..utils.device import resolve_device

#: rows from which a CUDA validator scores LR-style grids by the device
#: rank metrics
APPROX_RANK_MIN_ROWS = 100_000


def _not_ported(what: str, item) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to the torch package yet "
        f"(ROADMAP.md queue 1, item {item})"
    )


def _margins_kernel(X: torch.Tensor, betas: torch.Tensor, b0s: torch.Tensor):
    """[n, d] @ [B, d]^T + [B] -> [n, B] decision margins for all
    candidates in one matmul (stays on the device)."""
    return X @ betas.T + b0s[None, :]


@dataclass
class ValidationResult:
    best_estimator: PredictorEstimator
    best_params: dict
    best_metric: float
    metric_name: str
    larger_better: bool
    all_results: list = field(default_factory=list)  # per (model, grid) dicts


def stratified_kfold_masks(
    y: np.ndarray, k: int, seed: int, stratify: bool
) -> np.ndarray:
    """[k, n] bool masks, True = row in the fold's TRAIN split.  Stratified
    per label class when requested (reference: OpCrossValidation.scala:161-167
    label-stratified kFold).  Bit-equal to the JAX package's."""
    n = len(y)
    if stratify:
        classes = np.unique(y)
        class_indices = {c: np.nonzero(y == c)[0] for c in classes}
        return _kfold_masks_from_indices(class_indices, n, k, seed)
    rng = np.random.RandomState(seed)
    fold_of = np.empty(n, dtype=np.int64)
    fold_of[rng.permutation(n)] = np.arange(n) % k
    return np.stack([fold_of != f for f in range(k)], axis=0)


def _kfold_masks_from_indices(
    class_indices: dict, n: int, k: int, seed: int
) -> np.ndarray:
    """Stratified fold masks from precomputed per-class row indices, the
    RNG consumed class by class in ascending order."""
    rng = np.random.RandomState(seed)
    fold_of = np.empty(n, dtype=np.int64)
    for c in sorted(class_indices):
        idx = np.asarray(class_indices[c])
        perm = rng.permutation(len(idx))
        fold_of[idx[perm]] = np.arange(len(idx)) % k
    return np.stack([fold_of != f for f in range(k)], axis=0)


def _lr_style_grid(grid: Sequence[dict]) -> bool:
    """Batched path applies when every grid key is a batched-fit scalar."""
    ok = {"reg_param", "elastic_net_param"}
    return all(set(p) <= ok for p in grid)


def _binary_labels(y) -> bool:
    """The batched LR kernel assumes y in {0,1}; multiclass labels must
    take the generic per-candidate path (a 3-class label through the
    binary batched kernel would silently fit sigmoid-on-{0,1,2})."""
    return len(np.unique(np.asarray(y))) <= 2


def lr_grid_scalars(est, grid: Sequence[dict]) -> tuple[np.ndarray, np.ndarray]:
    """Per-grid-point (regs, ens) for fit_arrays_batched, defaulting from
    the estimator's params - the single source of the batched-LR grid
    contract (shared by validate() and workflow-CV's per-fold path)."""
    regs = np.array(
        [p.get("reg_param", est.params.get("reg_param", 0.0)) for p in grid]
    )
    ens = np.array(
        [p.get("elastic_net_param", est.params.get("elastic_net_param", 0.0))
         for p in grid]
    )
    return regs, ens


class OpValidator:
    """Base validator.  ``device`` is where the batched fits and the device
    rank metrics run (``"cuda"`` by default); the model selector sets it,
    and its candidates', to its own."""

    def __init__(
        self,
        evaluator: OpEvaluatorBase,
        seed: int = 42,
        stratify: bool = False,
        checkpoint_path: Optional[str] = None,
        autotune=None,
        device: str = "cuda",
    ) -> None:
        if checkpoint_path is not None:
            raise _not_ported("the CV checkpoint (checkpoint_path)", 1)
        if autotune is not None:
            raise _not_ported("successive-halving autotune", 12)
        self.evaluator = evaluator
        self.seed = seed
        self.stratify = stratify
        self.device = str(device)
        #: the fused training programs: None or False take the
        #: kernel-at-a-time path, True raises (not ported)
        self.train_fused: Optional[bool] = None

    def train_masks(self, y: np.ndarray) -> np.ndarray:
        raise NotImplementedError

    def validate_stream(self, models, chunks, weights=None):
        raise _not_ported("validate_stream (chunk-streamed CV)", 12)

    def _metric_of(self, y: np.ndarray, pred, raw, prob) -> float:
        m = self.evaluator.evaluate_arrays(
            y, PredictionColumn(pred, raw, prob)
        )
        return self.evaluator.default_metric(m)

    def _approx_rank(self, n: int, dev: torch.device) -> bool:
        """Whether LR-style grids may use the 1024-bin device rank metrics:
        only where they save host-device transfers of the per-fold
        validation slices, on the card with enough rows; on the CPU - or
        small data, where near-tied candidates could flip on quantization -
        the exact host metrics.  TX_CV_RANK_METRICS=approx|exact
        overrides."""
        env = os.environ.get("TX_CV_RANK_METRICS", "").strip().lower()
        if env == "approx":
            return True
        if env == "exact":
            return False
        return dev.type == "cuda" and n >= APPROX_RANK_MIN_ROWS

    def validate(
        self,
        models: Sequence[tuple[PredictorEstimator, Sequence[dict]]],
        X: np.ndarray,
        y: np.ndarray,
        weights: Optional[np.ndarray] = None,
    ) -> ValidationResult:
        """Pick the best (estimator, param-map) by mean validation metric
        across folds (reference: OpValidator.validate:129 +
        OpCrossValidation fold aggregation :60,118-124)."""
        env = os.environ.get("TX_TRAIN_FUSED", "").strip().lower()
        if self.train_fused or env in ("1", "true", "on"):
            raise _not_ported("the fused training programs (train_fused)", 9)
        dev = resolve_device(self.device)
        n = len(y)
        w = np.ones(n) if weights is None else np.asarray(weights, dtype=np.float64)
        masks = self.train_masks(y)  # [k, n] True=train
        k = masks.shape[0]
        larger = self.evaluator.larger_better
        metric_name = getattr(self.evaluator, "metric_name", "")
        approx_rank = self._approx_rank(n, dev)
        Xh = np.asarray(X)
        # ONE float32 upload of the design matrix per validate call, shared
        # by every batched family; lazy, so host-only families never pay it
        _xdev: list = []

        def xdev() -> torch.Tensor:
            if not _xdev:
                _xdev.append(torch.tensor(
                    np.ascontiguousarray(Xh, dtype=np.float32), device=dev))
            return _xdev[0]

        # one np.unique scan per validate() at most, and only if some
        # classifier asks
        _ybin: list = []

        def labels_ok(est) -> bool:
            if not getattr(est, "batched_needs_binary_y", True):
                return True
            if not _ybin:
                _ybin.append(_binary_labels(y))
            return _ybin[0]

        all_results = []
        best = None  # (metric, estimator, params)
        for est, grid in models:
            grid = list(grid) or [{}]
            g = len(grid)
            batched = (hasattr(est, "fit_arrays_batched")
                       and _lr_style_grid(grid) and labels_ok(est))
            # only the batched-LR branch can use the device approximation;
            # tree and generic paths are exact on every device
            mode = ("approx" if approx_rank and batched
                    and metric_name in ("AuROC", "AuPR") else "exact")
            metrics = np.zeros((g, k))
            if batched:
                # ONE batched fit for the whole fold x grid batch: the
                # [B, n] per-candidate weights are tiled on the device
                # from the [k, n] fold masks, fold-major like the regs
                regs_g, ens_g = lr_grid_scalars(est, grid)
                regs = np.tile(regs_g, k)
                ens = np.tile(ens_g, k)
                Xj = xdev()
                trainj = torch.as_tensor(masks, device=dev).to(torch.float32)
                if weights is None:
                    Wj = trainj.repeat_interleave(g, dim=0)
                else:
                    wj = torch.as_tensor(w, device=dev).to(torch.float32)
                    Wj = (trainj * wj[None, :]).repeat_interleave(g, dim=0)
                y_fit = torch.as_tensor(np.asarray(y), device=dev).to(torch.float32)
                betas, b0s = est.fit_arrays_batched(Xj, y_fit, Wj, regs, ens)
                if mode == "approx":
                    # rank metrics on the device against the resident X: no
                    # per-fold validation slice leaves the card
                    scores = _margins_kernel(
                        Xj, torch.as_tensor(betas, device=dev),
                        torch.as_tensor(b0s, device=dev),
                    ).T  # [B, n]
                    vmask = (1.0 - trainj).repeat_interleave(g, dim=0)
                    auroc_b, aupr_b = masked_rank_metrics(scores, y_fit, vmask)
                    vals = auroc_b if metric_name == "AuROC" else aupr_b
                    metrics[:, :] = vals.reshape(k, g).T
                else:
                    for f in range(k):
                        val = ~masks[f]
                        yv = y[val]
                        for j in range(g):
                            b = f * g + j
                            pred, raw, prob = est.predict_arrays(
                                {"beta": betas[b], "intercept": b0s[b]},
                                Xh[val],
                            )
                            metrics[j, f] = self._metric_of(yv, pred, raw, prob)
            elif hasattr(est, "fit_arrays_folds"):
                # fold-batched path (trees): grid x folds over one shared
                # binning when the estimator batches whole grids, else one
                # fold fan-out per grid point
                W = masks.astype(np.float64) * w[None, :]
                grid_fold_params = (
                    est.fit_arrays_folds_grid(Xh, y, W, grid)
                    if hasattr(est, "fit_arrays_folds_grid") else None
                )
                for j, pmap in enumerate(grid):
                    cand = est.with_params(**pmap)
                    fold_params = (grid_fold_params[j]
                                   if grid_fold_params is not None
                                   else cand.fit_arrays_folds(Xh, y, W))
                    for f in range(k):
                        val = ~masks[f]
                        pred, raw, prob = cand.predict_arrays(
                            fold_params[f], Xh[val]
                        )
                        metrics[j, f] = self._metric_of(y[val], pred, raw, prob)
            else:
                for j, pmap in enumerate(grid):
                    cand = est.with_params(**pmap)
                    for f in range(k):
                        tr, val = masks[f], ~masks[f]
                        params = cand.fit_arrays(Xh[tr], y[tr], w[tr])
                        pred, raw, prob = cand.predict_arrays(params, Xh[val])
                        metrics[j, f] = self._metric_of(y[val], pred, raw, prob)
            mean_metrics = metrics.mean(axis=1)
            for j, pmap in enumerate(grid):
                all_results.append(
                    {
                        "model_type": est.model_type,
                        "model_uid": est.uid,
                        "params": dict(pmap),
                        "metric": float(mean_metrics[j]),
                        "fold_metrics": metrics[j].tolist(),
                        # which evaluator produced these numbers: "approx" =
                        # the 1024-bin device rank metrics, "exact" = host
                        "rank_metric_mode": mode,
                    }
                )
            j_best = int(np.argmax(mean_metrics) if larger else np.argmin(mean_metrics))
            cand_metric = float(mean_metrics[j_best])
            if best is None or (
                cand_metric > best[0] if larger else cand_metric < best[0]
            ):
                best = (cand_metric, est, dict(grid[j_best]))

        assert best is not None, "no models to validate"
        return ValidationResult(
            best_estimator=best[1].with_params(**best[2]),
            best_params=best[2],
            best_metric=best[0],
            metric_name=self.evaluator.metric_name,
            larger_better=larger,
            all_results=all_results,
        )


class OpCrossValidation(OpValidator):
    """(reference: OpCrossValidation.scala - numFolds default 3)"""

    def __init__(
        self,
        num_folds: int = 3,
        evaluator: Optional[OpEvaluatorBase] = None,
        seed: int = 42,
        stratify: bool = False,
        checkpoint_path: Optional[str] = None,
        autotune=None,
        device: str = "cuda",
    ) -> None:
        super().__init__(evaluator, seed, stratify, checkpoint_path,
                         autotune=autotune, device=device)
        self.num_folds = num_folds

    def train_masks(self, y: np.ndarray) -> np.ndarray:
        return stratified_kfold_masks(y, self.num_folds, self.seed, self.stratify)


class OpTrainValidationSplit(OpValidator):
    """(reference: OpTrainValidationSplit.scala - trainRatio default 0.75)"""

    def __init__(
        self,
        train_ratio: float = 0.75,
        evaluator: Optional[OpEvaluatorBase] = None,
        seed: int = 42,
        stratify: bool = False,
        checkpoint_path: Optional[str] = None,
        autotune=None,
        device: str = "cuda",
    ) -> None:
        super().__init__(evaluator, seed, stratify, checkpoint_path,
                         autotune=autotune, device=device)
        self.train_ratio = train_ratio

    def train_masks(self, y: np.ndarray) -> np.ndarray:
        n = len(y)
        rng = np.random.RandomState(self.seed)
        if self.stratify:
            mask = np.zeros(n, dtype=bool)
            for c in np.unique(y):
                idx = np.nonzero(y == c)[0]
                perm = rng.permutation(idx)
                mask[perm[: int(np.ceil(len(idx) * self.train_ratio))]] = True
        else:
            perm = rng.permutation(n)
            mask = np.zeros(n, dtype=bool)
            mask[perm[: int(np.ceil(n * self.train_ratio))]] = True
        return mask[None, :]
