"""Python bridge to the native C++ histogram tree learner and its scoring.

Counterpart of ``transmogrifai_tpu/models/native_trees.py``: the host
learner (``fit_forest``, ``fit_gbt``: ``tx_fit_forest_hist``,
``tx_fit_gbt_hist``), the flat-heap forest walk
(``tx_predict_forest_hist``) and the host binning (``tx_bin_data``) of
``native/txtrees.cpp``, through the port's own build of the library
(``utils/native.py``).  The learner emits the same flat-heap layout as the
device learner of ``tree_kernel.py``, so scoring, serialization and LOCO
do not depend on which one fitted a model; ``backend="native"`` of the
tree families trains on it.  The walk and the binning are the host
serving route (``predict_arrays_np``).  Each returns None when the shared
library is unavailable.
"""
from __future__ import annotations

import weakref
from typing import Optional

import numpy as np

from ..utils import native


def available() -> bool:
    return native.has_tree_symbols()


def fit_forest(
    bins: np.ndarray,       # [n, d] int32
    stats_row: np.ndarray,  # [n, C] float32
    w_row: np.ndarray,      # [n] float32
    boot_w: np.ndarray,     # [T, n] float32
    feat_masks: np.ndarray, # [T, d] bool
    seeds: np.ndarray,      # [T] uint64
    max_depth: int,
    max_bins: int,
    impurity_kind: str,
    min_instances_per_node: float = 1.0,
    min_info_gain: float = 0.0,
    feature_subset_p: float = 1.0,
    n_threads: int = 0,
) -> Optional[tuple]:
    lib = native.get_lib()
    if lib is None or not hasattr(lib, "tx_fit_forest_hist"):
        return None
    bins = np.ascontiguousarray(bins, dtype=np.int32)
    stats_row = np.ascontiguousarray(stats_row, dtype=np.float32)
    w_row = np.ascontiguousarray(w_row, dtype=np.float32)
    boot_w = np.ascontiguousarray(boot_w, dtype=np.float32)
    masks = np.ascontiguousarray(feat_masks, dtype=np.uint8)
    seeds = np.ascontiguousarray(seeds, dtype=np.uint64)
    n, d = bins.shape
    T = boot_w.shape[0]
    C = stats_row.shape[1]
    M = 2 ** (max_depth + 1) - 1
    hf = np.zeros((T, M), dtype=np.int32)
    ht = np.zeros((T, M), dtype=np.int32)
    hl = np.zeros((T, M), dtype=np.uint8)
    hv = np.zeros((T, M, C), dtype=np.float32)
    lib.tx_fit_forest_hist(
        bins.ctypes.data, stats_row.ctypes.data, w_row.ctypes.data,
        boot_w.ctypes.data, masks.ctypes.data, seeds.ctypes.data,
        np.int64(n), np.int32(d), np.int32(T),
        np.int32(max_depth), np.int32(max_bins), np.int32(C),
        np.int32(1 if impurity_kind == "variance" else 0),
        float(min_instances_per_node), float(min_info_gain),
        float(feature_subset_p), np.int32(n_threads),
        hf.ctypes.data, ht.ctypes.data, hl.ctypes.data, hv.ctypes.data,
    )
    return hf, ht, hl.astype(bool), hv


def fit_gbt(
    bins: np.ndarray,   # [n, d] int32
    y: np.ndarray,      # [n] float32
    w_row: np.ndarray,  # [n] float32
    num_trees: int,
    max_depth: int,
    max_bins: int,
    is_classification: bool,
    step_size: float,
    f0: float,
    min_instances_per_node: float = 1.0,
    min_info_gain: float = 0.0,
) -> Optional[tuple]:
    lib = native.get_lib()
    if lib is None or not hasattr(lib, "tx_fit_gbt_hist"):
        return None
    bins = np.ascontiguousarray(bins, dtype=np.int32)
    y = np.ascontiguousarray(y, dtype=np.float32)
    w_row = np.ascontiguousarray(w_row, dtype=np.float32)
    n, d = bins.shape
    C = 4
    M = 2 ** (max_depth + 1) - 1
    hf = np.zeros((num_trees, M), dtype=np.int32)
    ht = np.zeros((num_trees, M), dtype=np.int32)
    hl = np.zeros((num_trees, M), dtype=np.uint8)
    hv = np.zeros((num_trees, M, C), dtype=np.float32)
    F = np.zeros((n,), dtype=np.float32)
    lib.tx_fit_gbt_hist(
        bins.ctypes.data, y.ctypes.data, w_row.ctypes.data,
        np.int64(n), np.int32(d), np.int32(num_trees),
        np.int32(max_depth), np.int32(max_bins),
        np.int32(1 if is_classification else 0),
        float(step_size), float(f0),
        float(min_instances_per_node), float(min_info_gain),
        hf.ctypes.data, ht.ctypes.data, hl.ctypes.data, hv.ctypes.data,
        F.ctypes.data,
    )
    return hf, ht, hl.astype(bool), hv


#: fitted-heap arrays -> lib-ready contiguous arrays.  Per-batch
#: serving calls predict with the SAME fitted heaps every time; the
#: bool->uint8 astype alone copied ~T*M bytes per call.  Keyed by the
#: id of the bool leaf-mask (the one member the prepared copies never
#: alias), verified by weakrefs to all four members so a recycled id
#: can never serve another forest's arrays; a finalizer on the mask
#: evicts the entry when the fitted model is collected, so superseded
#: generations under hot-swap serving don't stay pinned.  Bounded as
#: belt-and-braces like the other serving memos.
_PREPARED_HEAPS: dict = {}
#: id(leaf-mask) -> weakref.finalize, kept across cache eviction so a
#: long-lived forest churning through a full cache registers exactly
#: ONE finalizer, not one per re-insertion
_HEAP_FINALIZERS: dict = {}
_MAX_PREPARED_HEAPS = 32


def _evict_prepared(key: int) -> None:
    _PREPARED_HEAPS.pop(key, None)
    _HEAP_FINALIZERS.pop(key, None)


def _prepared(heaps: tuple) -> tuple:
    hf, ht, hl, hv = heaps
    key = id(hl)
    hit = _PREPARED_HEAPS.get(key)
    if hit is not None and all(
        r() is a for r, a in zip(hit[0], heaps)
    ):
        return hit[1]
    prep = (
        np.ascontiguousarray(hf, dtype=np.int32),
        np.ascontiguousarray(ht, dtype=np.int32),
        np.ascontiguousarray(hl, dtype=np.uint8),
        np.ascontiguousarray(hv, dtype=np.float32),
    )
    try:
        refs = tuple(weakref.ref(a) for a in heaps)
    except TypeError:
        # non-ndarray heap members (python-fallback fits): no memo,
        # the per-call copies are the price of the fallback path
        return prep
    if len(_PREPARED_HEAPS) >= _MAX_PREPARED_HEAPS:
        # one-out-one-in (FIFO), not clear(): a full cache under
        # round-robin traffic must not throw away every OTHER model's
        # prepared arrays on each insert
        _PREPARED_HEAPS.pop(next(iter(_PREPARED_HEAPS)))
    _PREPARED_HEAPS[key] = (refs, prep)
    fin = _HEAP_FINALIZERS.get(key)
    if fin is None or fin.peek() is None or fin.peek()[0] is not hl:
        _HEAP_FINALIZERS[key] = weakref.finalize(
            hl, _evict_prepared, key
        )
    return prep


def predict_forest(
    bins: np.ndarray, heaps: tuple, max_depth: int
) -> Optional[np.ndarray]:
    """Mean normalized per-tree outputs [n, C-1] (same contract as
    tree_kernel.predict_forest), computed host-side."""
    lib = native.get_lib()
    if lib is None or not hasattr(lib, "tx_predict_forest_hist"):
        return None
    bins = np.ascontiguousarray(bins, dtype=np.int32)
    hf, ht, hl8, hv = _prepared(heaps)
    n, d = bins.shape
    T, M, C = hv.shape
    out = np.zeros((n, C - 1), dtype=np.float32)
    lib.tx_predict_forest_hist(
        bins.ctypes.data, hf.ctypes.data, ht.ctypes.data, hl8.ctypes.data,
        hv.ctypes.data, np.int64(n), np.int32(d), np.int32(T),
        np.int32(max_depth), np.int32(C), out.ctypes.data,
    )
    return out


def bin_data(X: np.ndarray, edges: np.ndarray) -> Optional[np.ndarray]:
    lib = native.get_lib()
    if lib is None or not hasattr(lib, "tx_bin_data"):
        return None
    X = np.ascontiguousarray(X, dtype=np.float32)
    edges = np.ascontiguousarray(edges, dtype=np.float32)
    n, d = X.shape
    out = np.empty((n, d), dtype=np.int32)
    lib.tx_bin_data(
        X.ctypes.data, edges.ctypes.data, np.int64(n), np.int32(d),
        np.int32(edges.shape[1]), out.ctypes.data,
    )
    return out
