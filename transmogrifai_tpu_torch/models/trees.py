"""Tree-ensemble estimators: random forest, single tree, gradient boosting.

Counterparts of OpRandomForestClassifier / OpRandomForestRegressor /
OpDecisionTreeClassifier / OpDecisionTreeRegressor / OpGBTClassifier /
OpGBTRegressor / OpXGBoost* of ``transmogrifai_tpu/models/trees.py``
(reference: core/.../impl/classification/*.scala, impl/regression/*.scala,
xgboost4j dep core/build.gradle:27).  Training runs through the histogram
learner of ``tree_kernel.py`` on the estimator's ``device``; defaults
mirror the reference grids (maxDepth 5, numTrees 50, maxBins 32, impurity
gini/variance, featureSubsetStrategy auto = sqrt(d) classification / d/3
regression).

A fit uploads the design matrix to the device once, as float32, computes
the quantile edges on the host (a seeded row sample above 2^19 rows) and
bins on the device through kernel K2 (``parallel/kernels.bin_matrix``),
straight into the learner's device dtype (int8 when ``max_bins <= 127``:
the JAX package's ``_bins_cast`` is folded into the kernel).  Histograms,
split search, row routing and the GBT margins stay on the device; the
heaps come back as numpy, so ``model_params`` keep the JAX package's
layout and ``interop.load_reference_state`` carries them as they are.

``backend="auto"`` means the estimator's device.  Not ported yet, and
raising ``NotImplementedError`` with their ROADMAP.md queue 1 item: the
host C++ learner (``backend="native"``, item 1), per-node random feature
subsets (forests with ``feature_subset_p < 1``, item 6a: they need the
JAX package's threefry generator), the fold and grid fan-outs (item 5),
the fused-training plan (item 9) and the traceable scoring mirror
(item 7).
"""
from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch

from ..parallel.kernels import bin_matrix
from ..utils.device import resolve_device
from .base import PredictorEstimator
from .tree_kernel import (
    bin_data,
    bins_device_dtype,
    effective_max_depth,
    fit_forest,
    fit_gbt_folds,
    heap_impurity_importances,
    predict_forest,
    predict_forest_np,
    predict_forest_stats_np,
    predict_tree,
    quantile_bin_edges,
)


def _not_ported(what: str, item) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to the torch package yet "
        f"(ROADMAP.md queue 1, item {item})"
    )


def _check_backend(requested: str) -> None:
    """``"auto"`` (the estimator's device) is the one backend here."""
    if requested == "native":
        raise _not_ported("the host C++ tree learner (backend='native')", 1)
    if requested != "auto":
        raise ValueError(
            f"unknown tree backend {requested!r}: the torch package runs "
            "trees on the estimator's device (backend='auto')"
        )


_EDGE_SAMPLE_CAP = 1 << 19  # rows used for the quantile sketch on huge inputs


def _sampled_bin_edges(X, max_bins: int, seed: int) -> np.ndarray:
    """Quantile edges from a row subsample above the cap (the xgboost-hist /
    Spark findSplits approx-sketch move; exact quantiles below the cap)."""
    n = X.shape[0]
    if n <= _EDGE_SAMPLE_CAP:
        return quantile_bin_edges(X, max_bins)
    # with-replacement draw: O(cap) and statistically equivalent for a
    # quantile sketch (choice(replace=False) would build an O(n)
    # permutation)
    idx = np.random.RandomState(seed).randint(0, n, _EDGE_SAMPLE_CAP)
    return quantile_bin_edges(np.asarray(X[idx]), max_bins)


def _bin_for_backend(X: torch.Tensor, edges: np.ndarray, max_bins: int):
    """Bins [n, d] of the float32 tensor X in the learner's device dtype:
    kernel K2 for a CUDA tensor, its plain version for a CPU one (the
    wrapper's own rule; no fallback)."""
    e = torch.as_tensor(np.ascontiguousarray(edges, np.float32),
                        device=X.device)
    return bin_matrix(X, e, bins_device_dtype(max_bins))


def _f32(a, device: torch.device) -> torch.Tensor:
    """Host array -> contiguous float32 tensor on ``device`` (a copy: the
    input may be a read-only or column-major view)."""
    return torch.tensor(np.ascontiguousarray(a, dtype=np.float32),
                        device=device)


def _subset_fraction(strategy: str, d: int, is_classification: bool) -> float:
    if strategy == "all":
        return 1.0
    if strategy == "sqrt" or (strategy == "auto" and is_classification):
        return min(1.0, float(np.sqrt(d)) / d)
    if strategy == "onethird" or (strategy == "auto" and not is_classification):
        return 1.0 / 3.0
    return 1.0


def _heaps_np(heaps) -> tuple:
    return tuple(h.cpu().numpy() for h in heaps)


def _heaps_on(heaps, device: torch.device) -> tuple:
    # a copy: a loaded state's arrays may be read-only
    return tuple(torch.tensor(np.asarray(h), device=device) for h in heaps)


class _TreeEnsembleBase(PredictorEstimator):
    is_classification = True

    def __init__(
        self,
        num_trees: int = 50,
        max_depth: int = 5,
        max_bins: int = 32,
        min_instances_per_node: int = 1,
        min_info_gain: float = 0.0,
        subsampling_rate: float = 1.0,
        feature_subset_strategy: str = "auto",
        seed: int = 42,
        backend: str = "auto",
        depth_cap: str = "auto",
        device: str = "cuda",
        **kw,
    ) -> None:
        super().__init__(device=device, **kw)
        p = self.params
        p.setdefault("backend", backend)
        p.setdefault("num_trees", num_trees)
        p.setdefault("max_depth", max_depth)
        p.setdefault("max_bins", max_bins)
        p.setdefault("min_instances_per_node", min_instances_per_node)
        p.setdefault("min_info_gain", min_info_gain)
        p.setdefault("subsampling_rate", subsampling_rate)
        p.setdefault("feature_subset_strategy", feature_subset_strategy)
        p.setdefault("seed", seed)
        p.setdefault("depth_cap", depth_cap)  # "auto" | "off" (honor as-is)

    # -- shared helpers -----------------------------------------------------
    def _stats_rows(self, y: np.ndarray) -> tuple[np.ndarray, int, str, np.ndarray]:
        """Build per-row stat channels. Returns (stats [n, C], C, impurity,
        classes)."""
        if self.is_classification:
            classes = np.unique(y)
            onehot = (y[:, None] == classes[None, :]).astype(np.float32)
            stats = np.concatenate(
                [np.ones((len(y), 1), dtype=np.float32), onehot], axis=1
            )
            return stats, stats.shape[1], "gini", classes
        stats = np.stack(
            [np.ones_like(y), y, y * y], axis=1
        ).astype(np.float32)
        return stats, 3, "variance", np.array([])

    def _device_bins(self, X, edges) -> torch.Tensor:
        """Upload X once as float32 and bin it on the estimator's device."""
        _check_backend(str(self.params.get("backend", "auto")))
        dev = resolve_device(self.device)
        return _bin_for_backend(_f32(X, dev), edges, int(self.params["max_bins"]))

    def fit_arrays_folds(self, X, y, W):
        raise _not_ported("the tree CV fold fan-out", 5)

    def fit_arrays_folds_grid(self, X, y, W, grid):
        raise _not_ported("the tree CV grid fan-out", 5)

    def fused_tree_plan(self, X, y, W, grid):
        raise _not_ported("the fused tree-training plan", 9)

    def predict_arrays_xla(self, params: Any, X):
        raise _not_ported("the traceable tree scoring mirror", 7)


class _RandomForest(_TreeEnsembleBase):
    single_tree = False

    def _forest_inputs(self, X, y):
        n, d = X.shape
        p = self.params
        edges = _sampled_bin_edges(X, int(p["max_bins"]), int(p["seed"]))
        stats, C, imp, classes = self._stats_rows(y)
        T = 1 if self.single_tree else int(p["num_trees"])
        rng = np.random.RandomState(p["seed"])
        if self.single_tree:
            boot = np.ones((1, n), dtype=np.float32)
            subset_p = 1.0
        else:
            boot = rng.poisson(
                p["subsampling_rate"], size=(T, n)
            ).astype(np.float32)
            subset_p = _subset_fraction(
                p["feature_subset_strategy"], d, self.is_classification
            )
        if subset_p < 1.0:
            raise _not_ported(
                f"per-node random feature subsets (feature_subset_strategy="
                f"{p['feature_subset_strategy']!r} keeps {subset_p:.3g} of "
                "the features; 'all' is ported)", "6a",
            )
        feat_masks = np.ones((T, d), dtype=bool)
        depth = effective_max_depth(
            int(p["max_depth"]), n, float(p["min_instances_per_node"]),
            d, int(p["max_bins"]), C, cap=str(p.get("depth_cap", "auto")),
        )
        return edges, stats, C, imp, classes, boot, feat_masks, depth

    def fit_arrays(self, X, y, w=None) -> Any:
        n, d = X.shape
        p = self.params
        w = np.ones(n, dtype=np.float32) if w is None else np.asarray(w, np.float32)
        (edges, stats, C, imp, classes, boot, feat_masks,
         depth) = self._forest_inputs(X, y)
        bins = self._device_bins(X, edges)
        dev = bins.device
        heaps = fit_forest(
            bins, _f32(stats, dev), _f32(w, dev), _f32(boot, dev),
            torch.as_tensor(feat_masks, device=dev),
            max_depth=depth, max_bins=int(p["max_bins"]),
            impurity_kind=imp, n_stats=C,
            min_instances_per_node=float(p["min_instances_per_node"]),
            min_info_gain=float(p["min_info_gain"]),
        )
        return {
            "edges": edges,
            "heaps": _heaps_np(heaps),
            "classes": classes,
            "max_depth": depth,
        }

    def predict_arrays(self, params: Any, X: np.ndarray):
        bins = self._device_bins(X, params["edges"])
        out = predict_forest(
            bins, _heaps_on(params["heaps"], bins.device),
            max_depth=params["max_depth"],
        ).cpu().numpy()
        if self.is_classification:
            prob = out  # [n, K] mean class distributions
            classes = params["classes"]
            pred = classes[np.argmax(prob, axis=1)]
            return pred.astype(np.float64), prob, prob
        return out[:, 0].astype(np.float64), None, None

    def predict_arrays_np(self, params: Any, X: np.ndarray):
        # the host serving route: searchsorted binning and the vectorized
        # all-trees numpy walk (the C++ walk comes with the native bridge)
        bins = bin_data(np.asarray(X, np.float32), params["edges"])
        out = predict_forest_np(bins, params["heaps"], params["max_depth"])
        if self.is_classification:
            classes = params["classes"]
            pred = classes[np.argmax(out, axis=1)]
            return pred.astype(np.float64), out, out
        return out[:, 0].astype(np.float64), None, None

    def contributions(self, params: Any) -> Optional[np.ndarray]:
        """Impurity-decrease feature importances recovered from the stored
        heaps (Spark featureImportances contract; reference:
        ModelInsights.scala:435-525)."""
        return heap_impurity_importances(
            params["heaps"],
            int(params["edges"].shape[0]),
            "gini" if self.is_classification else "variance",
        )


class OpRandomForestClassifier(_RandomForest):
    model_type = "OpRandomForestClassifier"
    is_classification = True


class OpRandomForestRegressor(_RandomForest):
    model_type = "OpRandomForestRegressor"
    is_classification = False


class OpDecisionTreeClassifier(_RandomForest):
    model_type = "OpDecisionTreeClassifier"
    is_classification = True
    single_tree = True


class OpDecisionTreeRegressor(_RandomForest):
    model_type = "OpDecisionTreeRegressor"
    is_classification = False
    single_tree = True


class _GBT(_TreeEnsembleBase):
    """Gradient boosting with regression trees on the loss gradient
    (reference: OpGBTClassifier/OpGBTRegressor; MLlib GradientBoostedTrees
    semantics - logistic loss for classification, squared for regression,
    stepSize default 0.1, numTrees default 20)."""

    def __init__(self, num_trees: int = 20, step_size: float = 0.1, **kw) -> None:
        super().__init__(num_trees=num_trees, **kw)
        self.params.setdefault("step_size", step_size)

    def _check_labels(self, y) -> None:
        """Logistic-loss boosting is binary (Spark: 'GBTClassifier
        currently only supports binary classification'); regressors take
        any y."""
        if self.is_classification:
            self._check_binary_labels(
                y,
                hint=" (use OpRandomForestClassifier / "
                "OpDecisionTreeClassifier for multiclass)",
            )

    def fit_arrays(self, X, y, w=None) -> Any:
        self._check_labels(y)
        n, d = X.shape
        p = self.params
        w = np.ones(n, dtype=np.float32) if w is None else np.asarray(w, np.float32)
        edges = _sampled_bin_edges(X, int(p["max_bins"]), int(p["seed"]))
        bins = self._device_bins(X, edges)
        dev = bins.device
        lr = float(p["step_size"])
        max_depth = effective_max_depth(
            int(p["max_depth"]), n, float(p["min_instances_per_node"]),
            d, int(p["max_bins"]), 4, cap=str(p.get("depth_cap", "auto")),
        )
        # one-fold ride through the boosting loop: the channel semantics
        # live in one place ([w, wg, wgg, wh] stats, Friedman variance
        # impurity, Newton leaf sum(wg)/sum(wh))
        f0s, heaps = fit_gbt_folds(
            bins, _f32(y, dev), _f32(w, dev)[None, :],
            num_trees=int(p["num_trees"]), max_depth=max_depth,
            max_bins=int(p["max_bins"]),
            is_classification=self.is_classification,
            step_size=lr,
            min_instances_per_node=float(p["min_instances_per_node"]),
            min_info_gain=float(p["min_info_gain"]),
        )
        return {
            "edges": edges,
            "heaps": _heaps_np(h[0] for h in heaps),
            "f0": float(f0s[0]),
            "max_depth": max_depth,
            "step_size": lr,
        }

    def _head(self, F: np.ndarray):
        if self.is_classification:
            p1 = 1.0 / (1.0 + np.exp(-F))
            prob = np.stack([1.0 - p1, p1], axis=1)
            raw = np.stack([-F, F], axis=1)
            return (p1 > 0.5).astype(np.float64), raw, prob
        return F, None, None

    def predict_arrays(self, params: Any, X: np.ndarray):
        bins = self._device_bins(X, params["edges"])
        hf, ht, hl, hv = _heaps_on(params["heaps"], bins.device)
        max_depth = params["max_depth"]
        contribs = []
        for t in range(hf.shape[0]):
            out = predict_tree(bins, hf[t], ht[t], hl[t], hv[t], max_depth)
            contribs.append(out[:, 1] / torch.clamp(out[:, 3], min=1e-12))
        F = params["f0"] + params["step_size"] * torch.stack(contribs).sum(dim=0)
        return self._head(F.cpu().numpy().astype(np.float64))

    def predict_arrays_np(self, params: Any, X: np.ndarray):
        # batch-first host serving route: the vectorized traversal walks
        # all T trees as one [T, n] frontier
        bins = bin_data(np.asarray(X, np.float32), params["edges"])
        stats = predict_forest_stats_np(bins, params["heaps"],
                                        params["max_depth"])  # [T, n, 4]
        # f64 accumulation: batch-of-1 and batch-of-N sum in one order
        contrib = (
            stats[..., 1].astype(np.float64)
            / np.maximum(stats[..., 3], 1e-12)
        )
        F = params["f0"] + params["step_size"] * contrib.sum(axis=0)
        return self._head(F)

    def contributions(self, params: Any) -> Optional[np.ndarray]:
        """Impurity-decrease importances on the gradient-variance channels
        (Friedman gain) from the stored heaps - same contract as the
        forest path."""
        return heap_impurity_importances(
            params["heaps"], int(params["edges"].shape[0]), "variance"
        )


class OpGBTClassifier(_GBT):
    model_type = "OpGBTClassifier"
    is_classification = True


class OpGBTRegressor(_GBT):
    model_type = "OpGBTRegressor"
    is_classification = False


class OpXGBoostClassifier(OpGBTClassifier):
    """Hist-mode XGBoost-equivalent params surface (reference: core/src/main/
    scala/ml/dmlc/xgboost4j/.../XGBoostParams.scala shim); same boosted-tree
    learner with XGBoost-flavored names and defaults (eta 0.3, numRound,
    gamma -> min split gain, minChildWeight -> min instances)."""

    model_type = "OpXGBoostClassifier"

    def __init__(self, num_round: int = 100, eta: float = 0.3,
                 gamma: float = 0.0, min_child_weight: float = 1.0,
                 **kw) -> None:
        kw.setdefault("max_depth", 6)
        kw.setdefault("min_info_gain", gamma)
        kw.setdefault("min_instances_per_node", min_child_weight)
        super().__init__(num_trees=num_round, step_size=eta, **kw)


class OpXGBoostRegressor(OpGBTRegressor):
    model_type = "OpXGBoostRegressor"

    def __init__(self, num_round: int = 100, eta: float = 0.3,
                 gamma: float = 0.0, min_child_weight: float = 1.0,
                 **kw) -> None:
        kw.setdefault("max_depth", 6)
        kw.setdefault("min_info_gain", gamma)
        kw.setdefault("min_instances_per_node", min_child_weight)
        super().__init__(num_trees=num_round, step_size=eta, **kw)
