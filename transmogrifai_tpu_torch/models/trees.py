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

``backend="auto"`` means the estimator's device.  The forests' per-node
random feature subsets come from the port's threefry generator
(``utils/threefry.py``), bit for bit the JAX package's, so a forest grows
the JAX package's trees.  The GBT and forest fold and grid fan-outs
(``fit_arrays_folds``, ``fit_arrays_folds_grid``) serve the model
selector's cross-validation.

Serving has two routes.  ``predict_arrays_np`` is the JAX package's host
route: the C++ flat-heap walk of ``native/txtrees.cpp`` through the port's
own library build, else the vectorized all-trees numpy walk.
``predict_arrays_torch`` is the device-fused program's: kernel K2 bins
the float32 batch, then every tree walks at once as one [T, n] gather
frontier over nodes packed into one int32 each (``_forest_stats_torch``),
and the trees add in tree order (``seq_sum``) before the numpy route's
head arithmetic.

``backend="native"`` trains on the host C++ histogram learner of
``native/txtrees.cpp`` (``native_trees.fit_forest``, ``fit_gbt``) over
host bins, as the JAX package's native backend does, one fold at a time;
its models score like any other (K2 on the device).

With a product ``data`` mesh (``parallel.mesh.data_mesh_or_none``: a
process group of two or more ranks) the torch learner's fold and grid
fits shard their rows (``_tree_cv_mesh``, ``_shard_fold_inputs``): the
edges, the Poisson bootstrap and the subset masks are drawn over the
global rows as a single process draws them, then each rank bins its own
row block with K2 and fits on it, every level's histogram combined over
the ranks (``tree_kernel``'s ``rows`` reducer).  Every rank gets the
same heaps.

``fused_tree_plan`` is the fused training programs' seam
(``local/fused_train.py``): the host prep of ``fit_arrays_folds_grid``
(the edges, the Poisson bootstrap, the per-tree seeds and their subset
masks), the bins from K2, and the grid x fold fit and per-candidate
predict mirrors over device tensors.
"""
from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch

from ..obs import trace as _obs_trace
from ..parallel.distributed import RowReducer
from ..parallel.kernels import bin_matrix
from ..parallel.mesh import data_mesh_or_none, row_block
from ..utils.device import resolve_device
from . import native_trees
from .base import PredictorEstimator
from .tree_kernel import (
    bin_data,
    bins_device_dtype,
    effective_max_depth,
    fit_forest_folds_grid,
    fit_gbt_folds_grid,
    forest_mean_scale,
    heap_impurity_importances,
    node_subset_masks,
    predict_forest,
    predict_forest_np,
    predict_forest_stats_np,
    predict_tree,
    quantile_bin_edges,
    seq_sum,
)


def _check_backend(requested: str) -> str:
    """``"auto"`` trains on the estimator's device, ``"native"`` on the
    host C++ learner, which must be built (no quiet fall back to the
    device learner)."""
    if requested == "native":
        if not native_trees.available():
            raise RuntimeError(
                "backend='native' needs the host C++ tree learner, but the "
                "native library (utils/native.py) is not available")
        return requested
    if requested != "auto":
        raise ValueError(
            f"unknown tree backend {requested!r}: 'auto' (the estimator's "
            "device) or 'native' (the host C++ learner)"
        )
    return requested


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


def _bin_block(X: torch.Tensor, edges: np.ndarray, max_bins: int):
    """:func:`_bin_for_backend` of one rank's row block; a rank with no
    rows gets an empty bins tensor (the kernel takes n >= 1)."""
    if X.shape[0] == 0:
        return torch.empty(tuple(X.shape), dtype=bins_device_dtype(max_bins),
                           device=X.device)
    return _bin_for_backend(X, edges, max_bins)


def _tree_cv_mesh():
    """The product ``data`` mesh of the tree fold fits, or None."""
    return data_mesh_or_none()


def _shard_fold_inputs(mesh, n: int, row_major=(), fold_major=()):
    """This rank's rows of the fold-fit inputs: ``row_major`` arrays ([n,
    ...]: X, y, stat channels) cut on their first axis, ``fold_major``
    ones ([F, n]: fold weights, bootstrap) on their second, with the row
    reducer of the mesh.  Without a mesh they pass through whole with no
    reducer.  The inputs are the replicated host arrays every rank holds,
    drawn over the global rows."""
    if mesh is None:
        return list(row_major), list(fold_major), None
    lo, hi = row_block(n, mesh)
    return ([a[lo:hi] for a in row_major], [a[:, lo:hi] for a in fold_major],
            RowReducer(mesh, n_rows=n))


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


def _grid_scalars(cands, *params) -> dict:
    """A fused plan's per-grid-point scalars, each (param, array name) as a
    host float64 array: the exact values ``fit_arrays_folds_grid`` passes
    its grid cores."""
    return {name: np.asarray([float(c.params[p]) for c in cands], np.float64)
            for p, name in params}


def _heaps_np(heaps) -> tuple:
    return tuple(h.cpu().numpy() for h in heaps)


def _heaps_on(heaps, device: torch.device) -> tuple:
    # a copy: a loaded state's arrays may be read-only
    return tuple(torch.tensor(np.asarray(h), device=device) for h in heaps)


#: packed-node field widths (_forest_stats_torch): feature 20 bits,
#: threshold bin 11 bits, leaf flag in the int32 sign bit
_PACK_F_BITS = 20
_PACK_T_BITS = 11


def _walk_params(params: dict, device: torch.device) -> dict:
    """The tree heaps of ``params`` as ``_forest_stats_torch`` walks them
    on ``device``: each node's (feature, threshold bin, leaf) packed into
    one int32 when the fields fit (packed in int64 on the host, then
    viewed as int32, so the leaf flag lands in the sign bit), else the
    three flat heaps; the leaf stats flat [T * M, C]; and the edges as
    K2 takes them."""
    hf, ht, hl, hv = (np.asarray(h) for h in params["heaps"])
    if hf.ndim == 1:  # a single tree: add the tree axis
        hf, ht, hl, hv = hf[None], ht[None], hl[None], hv[None]
    T, M = hf.shape
    edges = np.ascontiguousarray(params["edges"], np.float32)
    out = {
        "edges": torch.tensor(edges, device=device),
        "bins_dtype": bins_device_dtype(edges.shape[1] + 1),
        "max_depth": int(params["max_depth"]),
        "T": T, "M": M,
        "hv": torch.tensor(np.ascontiguousarray(hv.reshape(T * M, -1)),
                           device=device),
    }
    if hf.max(initial=0) < (1 << _PACK_F_BITS) and \
            ht.max(initial=0) < (1 << _PACK_T_BITS):
        packed = (hf.astype(np.int64)
                  | (ht.astype(np.int64) << _PACK_F_BITS)
                  | (hl.astype(np.int64) << 31))
        out["packed"] = torch.tensor(
            packed.astype(np.uint32).view(np.int32).ravel(), device=device)
    else:
        out["heaps"] = tuple(
            torch.tensor(np.ascontiguousarray(a).ravel(), device=device)
            for a in (hf.astype(np.int64), ht.astype(np.int64), hl))
    return out


def _forest_stats_torch(bins: torch.Tensor, wp: dict) -> torch.Tensor:
    """Torch mirror of ``tree_kernel.predict_forest_stats_np``: every
    tree's flat heap walks as one [T, n] gather frontier -> raw leaf stats
    [T, n, C], ``max_depth`` gather steps with the numpy walk's index
    arithmetic, so the gathered stats are bit-equal to it.  With packed
    nodes a level is one flat gather of the node word and one of the row's
    bin; the sign bit marks a leaf."""
    T, M = wp["T"], wp["M"]
    n, d = bins.shape
    dev = bins.device
    idx = torch.zeros((T, n), dtype=torch.int64, device=dev)
    base = (torch.arange(T, dtype=torch.int64, device=dev) * M)[:, None]
    binsf = bins.reshape(-1)
    rowoff = (torch.arange(n, dtype=torch.int64, device=dev) * d)[None, :]
    packed = wp.get("packed")
    if packed is not None:
        f_mask = (1 << _PACK_F_BITS) - 1
        for _ in range(wp["max_depth"]):
            p = packed[base + idx]
            f = (p & f_mask).to(torch.int64)
            thr = (p & 0x7FFFFFFF) >> _PACK_F_BITS
            row_bin = binsf[rowoff + f]
            nxt = idx * 2 + 1 + (row_bin > thr).to(torch.int64)
            idx = torch.where(p < 0, idx, nxt)  # sign bit = leaf
    else:
        hff, htf, hlf = wp["heaps"]
        for _ in range(wp["max_depth"]):
            g = base + idx
            row_bin = binsf[rowoff + hff[g]]
            nxt = idx * 2 + 1 + (row_bin > htf[g]).to(torch.int64)
            idx = torch.where(hlf[g], idx, nxt)
    return wp["hv"][base + idx]


def _device_bins_for_walk(X: torch.Tensor, wp: dict) -> torch.Tensor:
    """The served batch's bins: kernel K2 for a CUDA tensor, its plain
    version for a CPU one (the wrapper's own rule; no fallback)."""
    return bin_matrix(X.to(torch.float32).contiguous(), wp["edges"],
                      wp["bins_dtype"])


class _TreeEnsembleBase(PredictorEstimator):
    is_classification = True
    # fused serving (local/): predict_arrays_np is one flat-heap native or
    # numpy batch call over host params - pure and closable; the float32
    # binning front end makes a float32 feed bit-identical
    lowerable = True
    predict_f32_exact = True

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

    def torch_params(self, params: Any, device: torch.device) -> dict:
        out = _walk_params(params, device)
        if "classes" in params:
            out["classes"] = torch.tensor(
                np.asarray(params["classes"], np.float64), device=device)
        for k in ("f0", "step_size"):
            if k in params:
                out[k] = float(params[k])
        return out


class _RandomForest(_TreeEnsembleBase):
    single_tree = False

    def _forest_inputs(self, X, y):
        """Host inputs of a forest fit, drawn as the JAX package draws them:
        the edges, the stat channels, the Poisson bootstrap and then, from
        the same ``RandomState``, one int32 seed per tree whose threefry
        key picks the tree's per-node feature subsets."""
        n, d = X.shape
        p = self.params
        stats, C, imp, classes = self._stats_rows(y)
        depth = self._forest_key(n, d, C)[0]
        with _obs_trace.span("tree.edges", depth=depth, n=n, d=d):
            edges = _sampled_bin_edges(X, int(p["max_bins"]), int(p["seed"]))
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
        feat_masks = np.ones((T, d), dtype=bool)
        seed_ints = rng.randint(0, 2**31 - 1, size=T)
        node_masks = node_subset_masks(seed_ints, subset_p, depth, d)
        return (edges, stats, C, imp, classes, boot, feat_masks, node_masks,
                depth)

    def _forest_key(self, n: int, d: int, n_stats: int) -> tuple:
        """What a forest fit's shapes and draws depend on, beyond min
        instances and min info gain: the JAX package's grouping key."""
        p = self.params
        depth = effective_max_depth(
            int(p["max_depth"]), n, float(p["min_instances_per_node"]),
            d, int(p["max_bins"]), n_stats,
            cap=str(p.get("depth_cap", "auto")),
        )
        return (depth, int(p["max_bins"]), int(p["num_trees"]),
                str(p["feature_subset_strategy"]), int(p["seed"]),
                float(p["subsampling_rate"]))

    def fit_arrays(self, X, y, w=None) -> Any:
        n = X.shape[0]
        w = np.ones(n, dtype=np.float32) if w is None else np.asarray(w, np.float32)
        return self.fit_arrays_folds(X, y, w[None, :])[0]

    def fit_arrays_folds(self, X, y, W) -> list:
        """CV fan-out: the folds (weight rows of W [F, n]) share one
        binning, bootstrap and set of subset masks.  Returns one param dict
        per fold."""
        return self.fit_arrays_folds_grid(X, y, W, [{}])[0]

    def fit_arrays_folds_grid(self, X, y, W, grid) -> list:
        """Whole-grid forest CV: grid points sharing the JAX package's
        grouping key (effective depth, bins, trees, subset strategy, seed,
        subsampling rate) form a group that bins once (K2), draws its
        bootstrap and subset masks once and fits as one grid x fold fan-out
        over its min instances and min info gains.  Returns, per grid
        point, one param dict per fold."""
        if _check_backend(str(self.params.get("backend", "auto"))) == "native":
            return [self.with_params(**pmap)._fit_native_folds(X, y, W)
                    for pmap in grid]
        n, d = X.shape
        cands = [self.with_params(**pmap) for pmap in grid]
        n_stats = (len(np.unique(y)) + 1) if self.is_classification else 3
        groups: dict[tuple, list[int]] = {}
        for j, cand in enumerate(cands):
            groups.setdefault(cand._forest_key(n, d, n_stats), []).append(j)
        dev = resolve_device(self.device)
        mesh = _tree_cv_mesh()
        # one upload of X and the fold weights for every group (this
        # rank's rows of them on a mesh)
        (X_r,), (W_r,), rows = _shard_fold_inputs(mesh, n, (X,), (W,))
        X_d, W_d = _f32(X_r, dev), _f32(W_r, dev)
        results: list = [None] * len(grid)
        for key, js in groups.items():
            rep = cands[js[0]]
            (edges, stats, C, imp, classes, boot, feat_masks, node_masks,
             depth) = rep._forest_inputs(X, y)
            (stats,), (boot,), _ = _shard_fold_inputs(
                mesh, n, (stats,), (boot,))
            with _obs_trace.span("tree.bin", depth=depth, n=n, d=d):
                bins = _bin_block(X_d, edges, key[1])
            heaps = fit_forest_folds_grid(
                bins, _f32(stats, dev), W_d, _f32(boot, dev),
                torch.as_tensor(feat_masks, device=dev),
                [float(cands[j].params["min_instances_per_node"]) for j in js],
                [float(cands[j].params["min_info_gain"]) for j in js],
                max_depth=depth, max_bins=key[1], impurity_kind=imp,
                n_stats=C,
                node_masks=(None if node_masks is None
                            else torch.as_tensor(node_masks, device=dev)),
                rows=rows,
            )
            with _obs_trace.span("tree.fetch", depth=depth, n=n, d=d):
                heaps = _heaps_np(heaps)  # [G', F, T, ...]
            for gi, j in enumerate(js):
                results[j] = [
                    {
                        "edges": edges,
                        "heaps": tuple(h[gi][f] for h in heaps),
                        "classes": classes,
                        "max_depth": depth,
                    }
                    for f in range(W_d.shape[0])
                ]
        return results

    def _fit_native_folds(self, X, y, W) -> list:
        """The host C++ learner, one fold (weight row of W) at a time, on
        the JAX package's inputs: host bins, the Poisson bootstrap and the
        per-tree seeds from one ``RandomState``."""
        n, d = X.shape
        p = self.params
        edges = _sampled_bin_edges(X, int(p["max_bins"]), int(p["seed"]))
        bins = bin_data(np.asarray(X, np.float32), edges)
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
        feat_masks = np.ones((T, d), dtype=bool)
        seed_ints = rng.randint(0, 2**31 - 1, size=T)
        depth = self._forest_key(n, d, C)[0]
        out = []
        for w in np.asarray(W, np.float32):
            heaps = native_trees.fit_forest(
                bins, stats, w, boot, feat_masks,
                seed_ints.astype(np.uint64),
                max_depth=depth, max_bins=int(p["max_bins"]),
                impurity_kind=imp,
                min_instances_per_node=float(p["min_instances_per_node"]),
                min_info_gain=float(p["min_info_gain"]),
                feature_subset_p=float(subset_p),
            )
            out.append({"edges": edges, "heaps": heaps, "classes": classes,
                        "max_depth": depth})
        return out

    def fused_tree_plan(self, X, y, W, grid) -> dict:
        """The fused training seam (``local/fused_train.run_tree``): the
        host prep and K2 binning of ``fit_arrays_folds_grid`` for the one
        shape group, its grid x fold fit over device tensors, and the
        predict mirror per (grid point, fold) - ``predict_arrays``' own
        ``predict_forest`` over gathered bins, so the scores are the
        kernel-at-a-time path's bit for bit.  Raises ``ValueError`` naming
        the JAX package's fallback reason when the grid cannot take one
        fused dispatch: ``native_backend``, ``grid_shape_groups`` (more
        than one static-shape group), ``dispatch_chunked`` (past
        ``tree_kernel.fits_per_dispatch``) or ``single_class``."""
        from ..local.fused_train import tree_fits_cap

        n, d = X.shape
        if _check_backend(str(self.params.get("backend", "auto"))) == "native":
            raise ValueError("native_backend")
        cands = [self.with_params(**pmap) for pmap in grid]
        n_stats = (len(np.unique(y)) + 1) if self.is_classification else 3
        if len({c._forest_key(n, d, n_stats) for c in cands}) > 1:
            raise ValueError("grid_shape_groups")
        (edges, stats, C, imp, classes, boot, feat_masks, node_masks,
         depth) = cands[0]._forest_inputs(X, y)
        max_bins = int(cands[0].params["max_bins"])
        G, F, T = len(grid), len(W), boot.shape[0]
        if G * F * T > tree_fits_cap(depth, n, d, max_bins, C):
            raise ValueError("dispatch_chunked")
        if self.is_classification and len(classes) < 2:
            raise ValueError("single_class")
        dev = resolve_device(self.device)
        arrays = {
            "bins": _bin_for_backend(_f32(X, dev), edges, max_bins),
            "stats": _f32(stats, dev),
            "w_rows": _f32(W, dev),
            "boot": _f32(boot, dev),
            "feat_masks": torch.as_tensor(feat_masks, device=dev),
            # the per-node subset masks stand in for the JAX package's
            # per-tree threefry keys
            "node_masks": (None if node_masks is None
                           else torch.as_tensor(node_masks, device=dev)),
            **_grid_scalars(cands, ("min_instances_per_node", "minipn_g"),
                            ("min_info_gain", "minig_g")),
        }
        is_classification = self.is_classification

        def fit(a):
            return fit_forest_folds_grid(
                a["bins"], a["stats"], a["w_rows"], a["boot"],
                a["feat_masks"], a["minipn_g"].tolist(),
                a["minig_g"].tolist(), max_depth=depth, max_bins=max_bins,
                impurity_kind=imp, n_stats=C, node_masks=a["node_masks"])

        def score(state, bins_v, f, gi):
            out = predict_forest(bins_v, tuple(h[gi, f] for h in state),
                                 max_depth=depth)
            return out[:, 1] if is_classification else out[:, 0]

        return {
            "arrays": arrays,
            "donate": ("stats", "w_rows", "boot"),
            "bins_key": "bins",
            "fit": fit,
            "n_state": 4,
            "score": score,
            "sig": ("forest", depth, max_bins, G, F, T, C, imp,
                    is_classification),
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
        # the host serving route: one flat-heap C++ call per batch when
        # the native library is built, else the vectorized all-trees
        # numpy walk; both are batch-first
        bins = bin_data(np.asarray(X, np.float32), params["edges"])
        out = native_trees.predict_forest(
            bins, params["heaps"], params["max_depth"]
        )
        if out is None:
            out = predict_forest_np(bins, params["heaps"],
                                    params["max_depth"])
        if self.is_classification:
            classes = params["classes"]
            pred = classes[np.argmax(out, axis=1)]
            return pred.astype(np.float64), out, out
        return out[:, 0].astype(np.float64), None, None

    def predict_arrays_torch(self, params: dict, X: torch.Tensor):
        """Torch mirror of ``predict_arrays_np`` over float32 ``X`` and
        ``torch_params``: K2 binning, the all-trees gather walk, then the
        normalized leaf stats added in tree order and scaled by float32
        1/T (``tree_kernel.forest_mean_scale``), as ``predict_forest``, the
        numpy walk and the C++ host walk do it."""
        stats = _forest_stats_torch(_device_bins_for_walk(X, params), params)
        w = torch.clamp(stats[..., 0:1], min=1e-12)
        normed = stats[..., 1:] / w
        out = (seq_sum(list(normed.unbind(0)))
               * forest_mean_scale(stats.shape[0]))
        if self.is_classification:
            pred = params["classes"][torch.argmax(out, dim=1)]
            return pred, out, out
        return out[:, 0].to(torch.float64), None, None

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
        n = X.shape[0]
        w = np.ones(n, dtype=np.float32) if w is None else np.asarray(w, np.float32)
        # one-fold ride through the fold fan-out: the channel semantics
        # live in one place ([w, wg, wgg, wh] stats, Friedman variance
        # impurity, Newton leaf sum(wg)/sum(wh))
        return self.fit_arrays_folds(X, y, w[None, :])[0]

    def _gbt_depth(self, n: int, d: int) -> int:
        p = self.params
        return effective_max_depth(
            int(p["max_depth"]), n, float(p["min_instances_per_node"]),
            d, int(p["max_bins"]), 4, cap=str(p.get("depth_cap", "auto")),
        )

    def fit_arrays_folds(self, X, y, W) -> list:
        """CV fan-out: the folds (weight rows of W [F, n]) share one
        binning and one upload of the design matrix - a grid of this
        estimator's own params.  Returns one param dict per fold."""
        return self.fit_arrays_folds_grid(X, y, W, [{}])[0]

    def fit_arrays_folds_grid(self, X, y, W, grid) -> list:
        """Whole-grid GBT CV: grid points sharing the static shapes
        (effective depth, max_bins, num_trees, seed) form a group that
        bins once (K2) and fits as one grid x fold fan-out over its step
        sizes, min instances and min info gains.  Returns, per grid point,
        one param dict per fold."""
        self._check_labels(y)
        if _check_backend(str(self.params.get("backend", "auto"))) == "native":
            return self._fit_native_grid(X, y, W, grid)
        n, d = X.shape
        cands = [self.with_params(**pmap) for pmap in grid]
        groups: dict[tuple, list[int]] = {}
        for j, cand in enumerate(cands):
            p = cand.params
            key = (cand._gbt_depth(n, d), int(p["max_bins"]),
                   int(p["num_trees"]), int(p["seed"]))
            groups.setdefault(key, []).append(j)
        dev = resolve_device(self.device)
        mesh = _tree_cv_mesh()
        # one upload of X, y and the fold weights for every group (this
        # rank's rows of them on a mesh); only the bins differ between
        # groups, through the edges
        (X_r, y_r), (W_r,), rows = _shard_fold_inputs(mesh, n, (X, y), (W,))
        X_d, y_d, W_d = _f32(X_r, dev), _f32(y_r, dev), _f32(W_r, dev)
        edges_cache: dict[tuple, np.ndarray] = {}
        results: list = [None] * len(grid)
        for (depth, max_bins, num_trees, seed), js in groups.items():
            if (max_bins, seed) not in edges_cache:
                with _obs_trace.span("tree.edges", depth=depth, n=n, d=d):
                    edges_cache[max_bins, seed] = _sampled_bin_edges(
                        X, max_bins, seed)
            edges = edges_cache[max_bins, seed]
            with _obs_trace.span("tree.bin", depth=depth, n=n, d=d):
                bins = _bin_block(X_d, edges, max_bins)
            f0s, heaps = fit_gbt_folds_grid(
                bins, y_d, W_d,
                [float(cands[j].params["step_size"]) for j in js],
                [float(cands[j].params["min_instances_per_node"]) for j in js],
                [float(cands[j].params["min_info_gain"]) for j in js],
                num_trees=num_trees, max_depth=depth, max_bins=max_bins,
                is_classification=self.is_classification, rows=rows,
            )
            with _obs_trace.span("tree.fetch", depth=depth, n=n, d=d):
                f0s, heaps = f0s.cpu().numpy(), _heaps_np(heaps)  # [G', F], ...
            for gi, j in enumerate(js):
                results[j] = [
                    {
                        "edges": edges,
                        "heaps": tuple(h[gi][f] for h in heaps),
                        "f0": float(f0s[gi][f]),
                        "max_depth": depth,
                        "step_size": float(cands[j].params["step_size"]),
                    }
                    for f in range(W_d.shape[0])
                ]
        return results

    def fused_tree_plan(self, X, y, W, grid) -> dict:
        """The fused training seam for boosted trees (the contract of
        ``_RandomForest.fused_tree_plan``): one grid x fold boosting fit
        and ``predict_arrays``' tree-order contribution sum per (grid
        point, fold), with its head on the device in float64."""
        from ..local.fused_train import tree_fits_cap

        self._check_labels(y)
        n, d = X.shape
        if _check_backend(str(self.params.get("backend", "auto"))) == "native":
            raise ValueError("native_backend")
        cands = [self.with_params(**pmap) for pmap in grid]
        keys = {(c._gbt_depth(n, d), int(c.params["max_bins"]),
                 int(c.params["num_trees"]), int(c.params["seed"]))
                for c in cands}
        if len(keys) > 1:
            raise ValueError("grid_shape_groups")
        depth, max_bins, num_trees, seed = next(iter(keys))
        G, F = len(grid), len(W)
        if G * F * num_trees > tree_fits_cap(depth, n, d, max_bins, 4):
            raise ValueError("dispatch_chunked")
        dev = resolve_device(self.device)
        edges = _sampled_bin_edges(X, max_bins, seed)
        arrays = {
            "bins": _bin_for_backend(_f32(X, dev), edges, max_bins),
            "y32": _f32(y, dev),
            "w_rows": _f32(W, dev),
            **_grid_scalars(cands, ("step_size", "step_g"),
                            ("min_instances_per_node", "minipn_g"),
                            ("min_info_gain", "minig_g")),
        }
        steps = arrays["step_g"].tolist()
        is_classification = self.is_classification

        def fit(a):
            f0s, heaps = fit_gbt_folds_grid(
                a["bins"], a["y32"], a["w_rows"], a["step_g"].tolist(),
                a["minipn_g"].tolist(), a["minig_g"].tolist(),
                num_trees=num_trees, max_depth=depth, max_bins=max_bins,
                is_classification=is_classification)
            return (f0s,) + tuple(heaps)

        def score(state, bins_v, f, gi):
            f0s, hf, ht, hl, hv = state
            contribs = []
            for t in range(num_trees):
                out = predict_tree(bins_v, hf[gi, f, t], ht[gi, f, t],
                                   hl[gi, f, t], hv[gi, f, t], depth)
                contribs.append(out[:, 1] / torch.clamp(out[:, 3], min=1e-12))
            Fm = (f0s[gi, f] + steps[gi] * seq_sum(contribs)).to(torch.float64)
            if is_classification:
                return 1.0 / (1.0 + torch.exp(-Fm))
            return Fm

        return {
            "arrays": arrays,
            "donate": ("w_rows",),
            "bins_key": "bins",
            "fit": fit,
            "n_state": 5,
            "score": score,
            "sig": ("gbt", depth, max_bins, G, F, num_trees,
                    is_classification),
        }

    def _fit_native_grid(self, X, y, W, grid) -> list:
        """The host C++ boosting learner (``tx_fit_gbt_hist``) for every
        grid point and fold, over one host binning per (max_bins, seed):
        the JAX package's ``_fit_native`` - the same initial margin, loss
        and Newton leaf values as the device learner."""
        W = np.asarray(W, np.float32)
        y32 = np.asarray(y, np.float32)
        n, d = X.shape
        binned: dict[tuple, tuple] = {}
        results = []
        for pmap in grid:
            p = self.with_params(**pmap).params
            key = (int(p["max_bins"]), int(p["seed"]))
            if key not in binned:
                edges = _sampled_bin_edges(X, *key)
                binned[key] = (edges, bin_data(np.asarray(X, np.float32),
                                               edges))
            edges, bins = binned[key]
            depth = self.with_params(**pmap)._gbt_depth(n, d)
            folds = []
            for w in W:
                wsum = max(float(w.sum()), 1e-12)
                if self.is_classification:
                    pbar = float(np.clip((w * y32).sum() / wsum, 1e-6,
                                         1 - 1e-6))
                    f0 = float(np.log(pbar / (1.0 - pbar)))
                else:
                    f0 = float((w * y32).sum() / wsum)
                heaps = native_trees.fit_gbt(
                    bins, y32, w,
                    num_trees=int(p["num_trees"]), max_depth=depth,
                    max_bins=int(p["max_bins"]),
                    is_classification=self.is_classification,
                    step_size=float(p["step_size"]), f0=f0,
                    min_instances_per_node=float(p["min_instances_per_node"]),
                    min_info_gain=float(p["min_info_gain"]),
                )
                folds.append({"edges": edges, "heaps": heaps, "f0": f0,
                              "max_depth": depth,
                              "step_size": float(p["step_size"])})
            results.append(folds)
        return results

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
        F = params["f0"] + params["step_size"] * seq_sum(contribs)
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

    def predict_arrays_torch(self, params: dict, X: torch.Tensor):
        """Torch mirror of ``predict_arrays_np``: K2 binning, the gather
        walk, the float64 leaf contributions added in tree order, then
        the logistic head (``exp`` may differ from numpy's by an ULP)."""
        stats = _forest_stats_torch(_device_bins_for_walk(X, params), params)
        contrib = (stats[..., 1].to(torch.float64)
                   / torch.clamp(stats[..., 3], min=1e-12).to(torch.float64))
        F = params["f0"] + params["step_size"] * seq_sum(
            list(contrib.unbind(0)))
        if self.is_classification:
            p1 = 1.0 / (1.0 + torch.exp(-F))
            prob = torch.stack([1.0 - p1, p1], dim=1)
            raw = torch.stack([-F, F], dim=1)
            return (p1 > 0.5).to(torch.float64), raw, prob
        return F, None, None

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
