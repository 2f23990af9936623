"""ModelSelector: automated model selection.

Counterpart of ``transmogrifai_tpu/selector/model_selector.py`` (reference:
core/.../impl/selector/ModelSelector.scala:74-197): an estimator over
(label RealNN, features OPVector) -> Prediction that

1. runs splitter preparation (rebalancing as sample weights, §splitters),
2. hands candidate estimators x hyperparameter grids to the validator,
   which fans folds x grid points out as batched fits on the device,
3. refits the winning candidate on the full prepared training data,
4. evaluates training (and, via has_test_eval, holdout) metrics with every
   registered evaluator,
5. writes a ModelSelectorSummary into stage metadata.

``device`` (``"cuda"`` by default; ``OpWorkflow`` sets it to its own)
reaches the validator and every candidate estimator before a fit.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from ..evaluators.base import OpEvaluatorBase
from ..models.base import PredictorEstimator, PredictorModel, _check_label_mask
from ..stages.base import Estimator
from ..types.columns import Column, NumericColumn, PredictionColumn, VectorColumn
from ..types.dataset import Dataset
from ..types.feature_types import OPVector, Prediction, RealNN
from ..utils.device import resolve_device
from .splitters import Splitter
from .validator import (
    OpValidator,
    ValidationResult,
    _binary_labels,
    _lr_style_grid,
    lr_grid_scalars,
)


class SelectedModel(PredictorModel):
    """Fitted best model (reference: SelectedModel in ModelSelector.scala).
    Adds holdout evaluation used by the workflow's test-eval hook."""

    def __init__(self, estimator, params, selector: "ModelSelector", **kw) -> None:
        super().__init__(estimator, params, **kw)
        self.selector = selector

    def evaluate_model(self, holdout: Dataset) -> dict:
        """(reference: FitStagesUtil.scala:266-268 HasTestEval path)"""
        label_f, vec_f = self.input_features
        y = np.asarray(holdout[label_f.name].values, dtype=np.float64)
        X = np.asarray(holdout[vec_f.name].values, dtype=np.float64)
        pred, raw, prob = self.estimator_ref.predict_arrays(self.model_params, X)
        pc = PredictionColumn(pred, raw, prob)
        out = {}
        for ev in self.selector.evaluators:
            m = ev.evaluate_arrays(y, pc)
            out[type(ev).__name__] = m.to_json()
        self.holdout_metrics = out
        md = self.metadata.get("model_selector_summary", {})
        md["holdout_metrics"] = _strip_curves(out)
        self.metadata["model_selector_summary"] = md
        return out


def _strip_curves(metrics: dict) -> dict:
    """Keep scalar metrics only in the summary blob."""
    clean = {}
    for ev_name, m in metrics.items():
        clean[ev_name] = {
            k: v for k, v in m.items() if isinstance(v, (int, float, str, bool))
        }
    return clean


class ModelSelector(Estimator):
    input_types = [RealNN, OPVector]
    output_type = Prediction
    is_model_selector = True
    has_test_eval = True

    def __init__(
        self,
        validator: OpValidator,
        models: Sequence[tuple[PredictorEstimator, Sequence[dict]]],
        splitter: Optional[Splitter] = None,
        evaluators: Sequence[OpEvaluatorBase] = (),
        device: str = "cuda",
        **kw,
    ) -> None:
        super().__init__(**kw)
        self.validator = validator
        self.models = list(models)
        self.splitter = splitter
        self.evaluators = list(evaluators)
        self.device = str(device)
        self.validation_result: Optional[ValidationResult] = None
        # workflow-level CV: when set, fit_model skips its own validation and
        # uses this result (reference: findBestEstimator,
        # ModelSelector.scala:113-123)
        self.best_override: Optional[ValidationResult] = None

    def _to_device(self) -> None:
        """Hand the selector's device to its validator and candidates."""
        resolve_device(self.device)
        self.validator.device = self.device
        for est, _ in self.models:
            est.device = self.device

    def _prepare(self, y: np.ndarray):
        """Splitter preparation: (weights, keep mask or None, summary)."""
        if self.splitter is None:
            return np.ones(len(y)), None, {}
        prepared = self.splitter.prepare(y)
        return prepared.weights, prepared.keep_mask, prepared.summary

    def find_best_estimator(
        self, ds: Dataset, during_stages: Sequence
    ) -> ValidationResult:
        """Workflow-level CV (reference: ModelSelector.findBestEstimator:
        113-123 -> OpValidator in-fold DAG refit :230-256): for each fold,
        refit every 'during' estimator (e.g. the SanityChecker) on the
        fold's train rows only, transform both splits with the fold-fitted
        stages, then score every candidate x grid on the fold's validation
        rows.  Eliminates leakage from label-aware upstream estimators."""
        from ..workflow.workflow import fit_and_transform_dag

        self._to_device()
        label_f, vec_f = self.input_features
        y_full = np.asarray(ds[label_f.name].values, dtype=np.float64)
        weights, keep, _ = self._prepare(y_full)
        if keep is not None:
            ds = ds.take(np.nonzero(keep)[0])
            y_full = y_full[keep]
            weights = weights[keep]

        masks = self.validator.train_masks(y_full)
        larger = self.validator.evaluator.larger_better
        non_selector = [s for s in during_stages if s is not self]
        results: dict[int, list[dict]] = {}
        for f in range(masks.shape[0]):
            tr_idx = np.nonzero(masks[f])[0]
            val_idx = np.nonzero(~masks[f])[0]
            fold_train, fold_val = ds.take(tr_idx), ds.take(val_idx)
            if non_selector:
                # copy the stages so the full-data refit stays clean
                stages = [s.copy() for s in non_selector]
                for orig, cp in zip(non_selector, stages):
                    cp.input_features = orig.input_features
                    cp._output = orig._output
                _, fold_train, fold_val = fit_and_transform_dag(
                    [[s] for s in stages], fold_train, fold_val,
                    device=self.device,
                )
            Xt = np.asarray(fold_train[vec_f.name].values, dtype=np.float64)
            yt = np.asarray(fold_train[label_f.name].values, dtype=np.float64)
            Xv = np.asarray(fold_val[vec_f.name].values, dtype=np.float64)
            yv = np.asarray(fold_val[label_f.name].values, dtype=np.float64)
            wt = weights[tr_idx]
            gi = 0
            for est, grid in self.models:
                grid = list(grid) or [{}]
                fold_params = self._fit_fold_candidates(est, grid, Xt, yt, wt)
                for pmap, params in zip(grid, fold_params):
                    cand = est.with_params(**pmap)
                    pred, raw, prob = cand.predict_arrays(params, Xv)
                    m = self.validator._metric_of(yv, pred, raw, prob)
                    results.setdefault(gi, []).append(
                        {"model_type": est.model_type, "est": est,
                         "params": dict(pmap), "metric": m}
                    )
                    gi += 1
        all_results = []
        best = None
        for gi, fold_results in results.items():
            mean_m = float(np.mean([r["metric"] for r in fold_results]))
            r0 = fold_results[0]
            all_results.append(
                {
                    "model_type": r0["model_type"],
                    "model_uid": r0["est"].uid,
                    "params": r0["params"],
                    "metric": mean_m,
                    "fold_metrics": [r["metric"] for r in fold_results],
                }
            )
            if best is None or (mean_m > best[0] if larger else mean_m < best[0]):
                best = (mean_m, r0["est"], r0["params"])
        result = ValidationResult(
            best_estimator=best[1].with_params(**best[2]),
            best_params=best[2],
            best_metric=best[0],
            metric_name=self.validator.evaluator.metric_name,
            larger_better=larger,
            all_results=all_results,
        )
        self.best_override = result
        return result

    @staticmethod
    def _fit_fold_candidates(est, grid, Xt, yt, wt) -> list:
        """Train one estimator's whole grid on one fold's train split with
        the SAME batched fits the plain validator uses (folds differ in
        data under workflow CV, so only the grid axis batches here):
        LR-style grids ride fit_arrays_batched, tree grids ride
        fit_arrays_folds_grid with a single fold row.  Falls back to
        per-candidate fits for estimators with no batched path."""
        g = len(grid)
        if (
            g > 1
            and hasattr(est, "fit_arrays_batched")
            and _lr_style_grid(grid)
            and (
                not getattr(est, "batched_needs_binary_y", True)
                or _binary_labels(yt)
            )
        ):
            # tile the [n] weight vector on the device: one transfer, not g
            # identical host copies
            W = torch.tensor(np.asarray(wt, np.float32),
                             device=resolve_device(est.device)).repeat(g, 1)
            regs, ens = lr_grid_scalars(est, grid)
            betas, b0s = est.fit_arrays_batched(Xt, yt, W, regs, ens)
            return [
                {"beta": betas[j], "intercept": float(b0s[j])}
                for j in range(g)
            ]
        if g > 1 and hasattr(est, "fit_arrays_folds_grid"):
            by_grid = est.fit_arrays_folds_grid(
                Xt, yt, np.asarray(wt, np.float64)[None, :], grid
            )
            return [by_grid[j][0] for j in range(g)]
        return [
            est.with_params(**pmap).fit_arrays(Xt, yt, wt) for pmap in grid
        ]

    def fit_model(self, cols: Sequence[Column], ds: Dataset):
        label, vec = cols
        assert isinstance(label, NumericColumn)
        assert isinstance(vec, VectorColumn)
        _check_label_mask(label, self)
        y = np.asarray(label.values, dtype=np.float64)
        X = np.asarray(vec.values, dtype=np.float64)
        if len(y) == 0:
            raise ValueError(
                "empty dataset (reference guard: ModelSelector.scala:148)"
            )
        self._to_device()
        weights, keep, splitter_summary = self._prepare(y)
        if keep is not None:
            X, y, weights = X[keep], y[keep], weights[keep]

        if self.best_override is not None:
            result = self.best_override
        else:
            result = self.validator.validate(self.models, X, y, weights)
        self.validation_result = result

        # refit best on full prepared train (reference:
        # ModelSelector.scala:159-160)
        best = result.best_estimator
        best_params = best.fit_arrays(X, y, weights)
        model = SelectedModel(best, best_params, self)

        # training-set evaluation with all evaluators
        pc = PredictionColumn(*best.predict_arrays(best_params, X))
        train_metrics = {
            type(ev).__name__: ev.evaluate_arrays(y, pc).to_json()
            for ev in self.evaluators
        }
        model.metadata = {
            "model_selector_summary": {
                "best_model_type": best.model_type,
                "best_model_uid": best.uid,
                "best_params": result.best_params,
                "validation_metric": {
                    "name": result.metric_name,
                    "value": result.best_metric,
                    "larger_better": result.larger_better,
                },
                "validation_results": result.all_results,
                "splitter_summary": splitter_summary,
                "train_metrics": _strip_curves(train_metrics),
                "n_rows": int(len(y)),
                "n_features": int(X.shape[1]),
            }
        }
        if result.autotune is not None:
            # the successive-halving decision trail: rungs, prunes,
            # predicted-vs-actual times - rides the stage metadata into
            # summary_json() and the saved summary.json
            model.metadata["model_selector_summary"]["autotune"] = (
                result.autotune
            )
        if result.train_fused is not None:
            # the fused-training trail: which families ran fused, and why
            # the others took the kernel-at-a-time path
            model.metadata["model_selector_summary"]["train_fused"] = (
                result.train_fused
            )
        self.metadata = model.metadata
        return model
