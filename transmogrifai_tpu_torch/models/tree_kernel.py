"""Histogram-based decision-tree learning in torch.

Counterpart of ``transmogrifai_tpu/models/tree_kernel.py`` (the
reference's Spark MLlib RandomForest/GBT histogram aggregation and the
xgboost-hist path):

* features are pre-binned into ``max_bins`` quantile bins [n, d] (kernel
  K2, ``parallel/kernels.bin_matrix``, on the card) and every level's
  histogram is ONE segment sum over all (row, feature) pairs on the
  device;
* trees grow LEVEL-WISE: level l has exactly 2^l node slots (empty nodes
  produce zero histograms and become leaves), a Python loop over levels
  of torch ops on the bins' device, with no host sync inside a fit;
* a forest is a loop over per-tree bootstrap weights; gradient boosting a
  loop over sequential tree fits carrying the margin on the device;
* trees are stored as flat binary heaps (feature, threshold-bin, is_leaf,
  leaf value per node) - prediction is max_depth gather steps over rows.

Histograms are deterministic: every segment sum adds its rows in a fixed
order.  On the card ``index_add_`` would use float atomics; there it is
``index_put_(accumulate=True)``, a stable sort of the segment ids followed
by an in-order sum of each run of equal ids.  That sum is serial within a
run, so the segment ids also carry their chunk of at least
``_HIST_CHUNK_ROWS`` rows: every run is at most one chunk long, the runs
spread over the card, and the per-chunk partial histograms add up in
chunk order.  Deep levels take longer chunks, ``L * B / 8`` rows (L nodes,
B bins), so that a level's ``[chunks, L*d*B, C]`` partials hold at most 8
times its ``[rows*d, C]`` stat rows: with 2048-row chunks at every level a
depth-12 level zeroed and summed partials 2^12 * 32 / 2048 = 64 times that
size.  A longer chunk allows a longer serial run (a node whose rows all
fall in one bin): a chunk of ``L * B`` rows made runs of up to 2^17 rows at
depth 12 and the run sums the card's largest cost; the factor 8 is between
the two.  On the CPU it is ``index_add_`` over the same chunked ids,
which adds in row order on any number of threads (``index_put_`` there
does not), so the CPU's partials are the card's.  The same inputs give
the same bits from run to run.

On the CPU a level builds only its occupied nodes (``_level_nodes``):
a deep level of a small fit holds far fewer rows than its 2^l slots, so
this takes the CPU fits' cost from the slots to the rows.  The card
keeps the full level.  The heaps are the same bits either way; the
conditions are in ``_occupied_only``.

A forest's trees draw per-node random feature subsets: at each level
the split search of every node sees only the features of its row of a
Bernoulli mask that the JAX package draws from its threefry generator
(``jax.random.bernoulli(fold_in(key, level), p, (L, d))``).  The masks
depend on the tree's key and the level alone, so ``node_subset_masks``
computes them on the host (``utils/threefry.py``, bit for bit the JAX
package's) once for every tree of a fit, and the level loop reads its
rows from the device.

The GBT and forest fold and grid cores (``fit_gbt_folds``,
``fit_gbt_folds_grid``, ``fit_forest_folds``, ``fit_forest_folds_grid``)
serve the model selector's cross-validation: folds and grid points run
one after another, each fold a one-fold fit.  The two grid functions are
also the grid cores of the fused training plans (``trees.fused_tree_plan``;
the JAX package's ``_fit_forest_folds_grid_core`` and
``gbt_grid_scan_core``): eager torch has no jit wrapper to split them
from, so the plans call them as they are and get the same heaps.
``fits_per_dispatch`` is the JAX package's routing rule for those plans
(see its docstring; ``local/fused_train.tree_fits_cap`` applies its
``TX_TREE_*`` knobs).

On a mesh every fit function takes ``rows``, the row reducer of the
mesh's data group (``parallel.distributed.RowReducer``; None, the
default, is a single-device fit): each rank holds its own block of the
binned rows, and each level's histogram and each GBT fold's initial
margin are combined over the ranks.  A histogram keeps its fixed in-rank
order and the ranks' partials add in rank order (an all-gather, then the
sum), so the same inputs give the same bits from run to run.  Split
choice, the subset masks and the leaf values then come from combined
values alone, the same on every rank; at integer weights (gini counts,
bootstrap draws) the heaps equal a single-device fit's bit for bit.  Not here: the TPU watchdog chunking of device
programs, the TPU-sized scatter cap and the int8 opt-out switch.
"""
from __future__ import annotations

import numpy as np
import torch

from ..utils.threefry import bernoulli, fold_in, prng_key

#: the fewest rows of one partial histogram (a level of L nodes and B bins
#: takes chunks of max(2048, L * B / _HIST_PARTIAL_RATIO) rows): a fit on
#: at most this many rows adds each bin's rows in plain row order, as the
#: JAX package's scatter does
_HIST_CHUNK_ROWS = 2048
#: a level's chunk partials hold at most this many times its stat rows
_HIST_PARTIAL_RATIO = 8
#: the memory bound of a level's histogram: its rows go in blocks of at
#: most this many (row, feature) pairs whose [chunks, L*d*B, C] partials
#: hold at most this many floats.  A block's working set is the int64
#: segment ids, the [pairs, C] float32 stat rows and the sort's copies of
#: both - about 1.5 GB at C = 4 - so a 10M-row fit stays well inside the
#: card.
_HIST_BLOCK_ELEMS = 1 << 25


def _tree_fit_work(depth: int, n: int, d: int, max_bins: int,
                   n_stats: int) -> float:
    """Work units of ONE tree fit in the JAX package's routing rule: the
    per-level (row, feature) scatter plus the split search, which grows
    with the node count."""
    scatter = (depth + 1.0) * float(n) * d * (n_stats + 1.0)
    split = (2.0 ** depth) * d * max_bins * (6.0 * n_stats + 3.0)
    return scatter + split


def fits_per_dispatch(depth: int, n: int, d: int, max_bins: int,
                      n_stats: int, budget_s: float = 30.0,
                      override: int = 0) -> int:
    """How many tree fits may share one fused dispatch: the JAX package's
    rule, copied so that a fused tree plan refuses the same grids
    (``dispatch_chunked``) and both packages' trails give the same
    reasons.  The JAX package chunks its device programs on the host to
    stay under a runtime watchdog of its accelerator; its constants (a
    ``budget_s`` of 30 s at 2e9 work units a second) were set there and
    say nothing about a CUDA card, which has no such watchdog.
    ``override`` > 0 is the cap itself.  The ``TX_TREE_*`` knobs that set
    both are read by ``local/fused_train.tree_fits_cap``, not here."""
    if override > 0:
        return override
    rate = 2.0e9
    per_fit = _tree_fit_work(depth, n, d, max_bins, n_stats)
    return max(1, int(budget_s * rate / max(per_fit, 1.0)))


def quantile_bin_edges(X: np.ndarray, max_bins: int) -> np.ndarray:
    """Per-feature quantile edges [d, max_bins-1] (host, once per fit).
    Duplicate edges are allowed (empty bins); searchsorted keeps order."""
    qs = np.linspace(0.0, 1.0, max_bins + 1)[1:-1]
    edges = np.quantile(X, qs, axis=0).T  # [d, max_bins-1]
    return np.asarray(edges, dtype=np.float32)


def bin_data(X: np.ndarray, edges: np.ndarray) -> np.ndarray:
    """Assign bins [n, d] int32 on the host via per-feature searchsorted
    (side='left'); the C++ routine of ``native/txtrees.cpp``
    (``tx_bin_data``, the same lower bound, NaN after every non-NaN edge)
    when the port's native library is built, as in the JAX package."""
    X = np.asarray(X, np.float32)
    from . import native_trees

    out = native_trees.bin_data(X, edges)
    if out is not None:
        return out
    n, d = X.shape
    out = np.empty((n, d), dtype=np.int32)
    for j in range(d):
        out[:, j] = np.searchsorted(edges[j], X[:, j], side="left")
    return out


def bins_device_dtype(max_bins: int) -> torch.dtype:
    """Device dtype for the binned matrix: int8 when every bin id fits
    (max_bins <= 127; searchsorted can emit max_bins-1 itself for
    right-of-last-edge values) - the [n, d] bins read recurs in every
    level of every tree, and int8 carries it at 1/4 the bytes."""
    return torch.int8 if max_bins <= 127 else torch.int32


def _hist_chunk_rows(L: int, B: int) -> int:
    """Rows of one partial histogram at a level of L nodes and B bins, the
    same on every device (see the module docstring)."""
    return max(_HIST_CHUNK_ROWS, L * B // _HIST_PARTIAL_RATIO)


def _level_hist(bins, node_of_row, stats_w, L: int, B: int, rows=None,
                n_nodes=None):
    """Per-level histogram [L, d, B, C] by one segment sum over all
    (row, feature) pairs - segment id = ((node * d) + j) * B + bin - in a
    fixed order on every device (see the module docstring): each chunk of
    ``_hist_chunk_rows(L, B)`` rows in row order, the chunk partials
    in chunk order, and the blocks that ``_HIST_BLOCK_ELEMS`` bounds in
    block order.  The card and the CPU chunk alike, so both add the same
    partials.  ``rows``: the mesh's row reducer, which adds the ranks'
    histograms in rank order (an empty block contributes zeros).
    ``n_nodes``: build only this many nodes, ``node_of_row`` indexing
    them, with the chunks and blocks of the full level of ``L``."""
    n, d = bins.shape
    C = stats_w.shape[1]
    S = L * d * B
    S_out = S if n_nodes is None else n_nodes * d * B
    chunk = _hist_chunk_rows(L, B)
    chunks_per_block = max(1, _HIST_BLOCK_ELEMS // (S * C))
    block = max(1, min(_HIST_BLOCK_ELEMS // d, chunks_per_block * chunk))
    cols = torch.arange(d, device=bins.device)
    hist = None
    for i in range(0, n, block):
        nr, bb, sw = (t[i: i + block] for t in (node_of_row, bins, stats_w))
        nrows = nr.shape[0]
        K = -(-nrows // chunk)
        chunk_base = torch.arange(nrows, device=bins.device) // chunk * S_out
        seg = (chunk_base[:, None] + (nr[:, None] * d + cols[None, :]) * B
               + bb.long()).reshape(-1)
        flat = sw[:, None, :].expand(nrows, d, C).reshape(-1, C)
        part = torch.zeros((K * S_out, C), dtype=sw.dtype, device=sw.device)
        if sw.device.type == "cpu":
            part.index_add_(0, seg, flat)
        else:
            part.index_put_((seg,), flat, accumulate=True)
        part = part[:S_out] if K == 1 else part.view(K, S_out, C).sum(dim=0)
        hist = part if hist is None else hist + part
    if hist is None:
        hist = torch.zeros((S_out, C), dtype=stats_w.dtype,
                           device=stats_w.device)
    if rows is not None:
        hist = rows.sum_ranked(hist)
    return hist.reshape(S_out // (d * B), d, B, C)


def _impurity(stats: torch.Tensor, kind: str):
    """Per-node impurity*weight and node weight from stat channels.

    stats [..., C]: C = 3 (w, wy, wyy) for variance; C = 1+K (w, wc...) for
    gini.  Returns (weighted_impurity [...], w [...])."""
    w = stats[..., 0]
    safe_w = torch.clamp(w, min=1e-12)
    if kind == "variance":
        mean = stats[..., 1] / safe_w
        imp = stats[..., 2] / safe_w - mean**2
    else:  # gini
        p = stats[..., 1:] / safe_w[..., None]
        imp = 1.0 - (p * p).sum(dim=-1)
    return imp * w, w


def _occupied_only(dev: torch.device, rows, min_instances_per_node) -> bool:
    """Whether ``fit_tree`` builds only each level's occupied nodes (the
    nodes that hold a row) instead of the full level - a second path of
    the learner, kept for the CPU's deep fits on few rows (ROADMAP.md
    lists it, under the level histogram, as a fork to retire).

    The occupied nodes' histograms, split searches and heap entries are
    the full level's: ``_level_hist`` sizes its chunks and blocks from
    the full level and adds the same rows in the same order.  An empty
    slot is right only because ``fit_tree`` initialises its heap to what
    the full level writes there when ``min_instances_per_node`` is
    positive: zero statistics, so no split is valid - feature 0,
    threshold ``max_bins``, a leaf, value 0.  A change to those initial
    values breaks it (``test_torch_tree_kernel.py`` holds both paths
    equal).  Not on the card, where finding the occupied nodes syncs
    with the host at every level, nor under a mesh row reducer, whose
    ranks hold different occupied nodes."""
    return dev.type == "cpu" and rows is None and min_instances_per_node > 0


def _level_nodes(node_of_row: torch.Tensor, L: int, occupied_only: bool):
    """The nodes a level builds: ``(local, slots, n_nodes)`` - each row's
    index among them, their heap slots and their count."""
    base = L - 1  # heap offset of this level
    if not occupied_only:
        return node_of_row, slice(base, base + L), L
    occ, local = torch.unique(node_of_row, return_inverse=True)
    return local, base + occ, int(occ.shape[0])


def fit_tree(
    bins: torch.Tensor,        # [n, d] int8 or int32
    stats_row: torch.Tensor,   # [n, C] per-row stat channels (already weighted)
    w_row: torch.Tensor,       # [n] sample weights (0 = row not in this fit)
    feat_mask: torch.Tensor,   # [d] bool - feature subset for this tree
    max_depth: int,
    max_bins: int,
    impurity_kind: str,
    n_stats: int,
    min_instances_per_node: float = 1.0,
    min_info_gain: float = 0.0,
    node_mask: torch.Tensor | None = None,  # [2^max_depth - 1, d] bool
    rows=None,
):
    """Grow one tree on the bins' device; returns heap tensors there:
    feature [M] int32, thr_bin [M] int32, is_leaf [M] bool, value [M, C].
    M = 2^(max_depth+1) - 1; node children of i are 2i+1 / 2i+2.

    ``node_mask`` holds the features each internal node's split search
    may use, row i for heap node i (``node_subset_masks``: the JAX
    package's ``rng_key`` and ``feature_subset_p < 1``); None lets every
    node use ``feat_mask``.  ``rows``: the mesh's row reducer when
    ``bins`` holds one rank's rows (see the module docstring)."""
    n, d = bins.shape
    C = n_stats
    M = 2 ** (max_depth + 1) - 1
    B = max_bins
    dev = bins.device

    heap_feature = torch.zeros((M,), dtype=torch.int32, device=dev)
    heap_thr = torch.full((M,), B, dtype=torch.int32, device=dev)  # all left
    heap_leaf = torch.ones((M,), dtype=torch.bool, device=dev)
    heap_value = torch.zeros((M, C), dtype=stats_row.dtype, device=dev)

    node_of_row = torch.zeros((n,), dtype=torch.int64, device=dev)
    stats_w = stats_row * w_row[:, None]  # [n, C]
    occupied_only = _occupied_only(dev, rows, min_instances_per_node)

    for level in range(max_depth + 1):
        L = 2**level
        local, slots, n_nodes = _level_nodes(node_of_row, L, occupied_only)
        # ---- histograms: one segment sum over all (row, feature) pairs --
        hist = _level_hist(bins, local, stats_w, L, B, rows,
                           n_nodes=n_nodes)

        node_stats = hist[:, 0, :, :].sum(dim=1)  # [nodes, C] per node
        node_imp, node_w = _impurity(node_stats, impurity_kind)
        heap_value[slots] = node_stats

        if level == max_depth:
            break

        # ---- split search -----------------------------------------------
        left = torch.cumsum(hist, dim=2)            # [L, d, B, C]
        total = node_stats[:, None, None, :]
        right = total - left
        left_imp, left_w = _impurity(left, impurity_kind)
        right_imp, right_w = _impurity(right, impurity_kind)
        gain = (node_imp[:, None, None] - left_imp - right_imp) / torch.clamp(
            node_w[:, None, None], min=1e-12
        )
        level_mask = feat_mask[None, :]
        if node_mask is not None:
            level_mask = level_mask & node_mask[slots]
        valid = (
            level_mask[:, :, None]
            & (left_w >= min_instances_per_node)
            & (right_w >= min_instances_per_node)
        )
        gain = torch.where(valid, gain, torch.full_like(gain, -torch.inf))
        flat_gain = gain.reshape(n_nodes, d * B)
        # torch.argmax, like jnp.argmax, takes the first maximum
        best_flat = torch.argmax(flat_gain, dim=1)                 # [L]
        best_gain = torch.gather(flat_gain, 1, best_flat[:, None])[:, 0]
        best_feat = torch.div(best_flat, B, rounding_mode="floor")
        best_bin = best_flat % B

        splittable = (best_gain >= min_info_gain) & torch.isfinite(best_gain)
        zero = torch.zeros_like(best_feat)
        # an indexed store does not cast as a sliced one does
        heap_feature[slots] = torch.where(
            splittable, best_feat, zero).to(torch.int32)
        heap_thr[slots] = torch.where(
            splittable, best_bin, torch.full_like(best_bin, B)).to(torch.int32)
        heap_leaf[slots] = ~splittable

        # ---- route rows -------------------------------------------------
        row_feat = best_feat[local]                        # [n]
        row_bin = torch.gather(bins, 1, row_feat[:, None])[:, 0].long()
        row_split = splittable[local]
        go_right = row_split & (row_bin > best_bin[local])
        # rows under an already-leaf node keep going "left" into a shadow
        # child that inherits the parent stats -> harmless (prediction
        # stops at the first is_leaf node on the path)
        node_of_row = node_of_row * 2 + go_right.long()

    return heap_feature, heap_thr, heap_leaf, heap_value


def predict_tree(
    bins: torch.Tensor,        # [n, d]
    heap_feature: torch.Tensor,
    heap_thr: torch.Tensor,
    heap_leaf: torch.Tensor,
    heap_value: torch.Tensor,  # [M, C]
    max_depth: int,
):
    """Traverse: n rows x max_depth gathers -> node stats [n, C]."""
    n = bins.shape[0]
    idx = torch.zeros((n,), dtype=torch.int64, device=bins.device)
    for _ in range(max_depth):
        f = heap_feature[idx].long()
        t = heap_thr[idx]
        leaf = heap_leaf[idx]
        row_bin = torch.gather(bins, 1, f[:, None])[:, 0]
        nxt = idx * 2 + 1 + (row_bin.long() > t.long()).long()
        idx = torch.where(leaf, idx, nxt)
    return heap_value[idx]


def _stack_heaps(heaps: list) -> tuple:
    """Per-tree heap tuples -> one tuple of [T, ...] tensors."""
    return tuple(torch.stack([h[i] for h in heaps]) for i in range(4))


def node_subset_masks(seed_ints, subset_p: float, max_depth: int,
                      d: int) -> np.ndarray | None:
    """Per-node feature subsets of a forest's trees, [T, 2^max_depth - 1,
    d] bool on the host, row i for heap node i; None when ``subset_p`` keeps
    every feature.  Tree t's key is ``PRNGKey(seed_ints[t])`` and the nodes
    of level l draw ``bernoulli(fold_in(key, l), float32(subset_p), (2^l,
    d))``, as the JAX package's ``fit_tree`` does (a Bernoulli(k/d) draw
    standing in for Spark's choose-k-of-d per node)."""
    if subset_p >= 1.0:
        return None
    keys = prng_key(np.asarray(seed_ints))                 # [T, 2]
    out = np.empty((keys.shape[0], 2 ** max_depth - 1, d), dtype=bool)
    for level in range(max_depth):
        L = 2 ** level
        out[:, L - 1: 2 * L - 1] = bernoulli(
            fold_in(keys, level), subset_p, (L, d))
    return out


def fit_forest(
    bins, stats_row, w_row, boot_w, feat_masks,
    max_depth: int, max_bins: int, impurity_kind: str, n_stats: int,
    min_instances_per_node: float = 1.0,
    min_info_gain: float = 0.0,
    node_masks: torch.Tensor | None = None,
    rows=None,
):
    """Forest fit: trees one after another through the same level
    histograms (the JAX package's ``lax.map``); boot_w [T, n] bootstrap
    weights, feat_masks [T, d], node_masks [T, 2^max_depth - 1, d] or
    None.  Returns heaps with a leading [T] axis.

    A row whose weight in a tree is 0 (out of the fold, or not drawn by
    the bootstrap: together ~58% of the rows of a CV fit) adds nothing to
    any histogram, so each tree grows on its weighted rows alone: the
    same tree from fewer (row, feature) pairs a level.  Gini counts are
    integers and sum exactly in any order; the variance channels add in
    another order than over all rows, on every device alike."""
    heaps = []
    for t in range(boot_w.shape[0]):
        w = w_row * boot_w[t]
        keep = torch.nonzero(w > 0).squeeze(1)
        heaps.append(fit_tree(
            bins[keep], stats_row[keep], w[keep], feat_masks[t],
            max_depth, max_bins, impurity_kind, n_stats,
            min_instances_per_node, min_info_gain,
            None if node_masks is None else node_masks[t], rows,
        ))
    return _stack_heaps(heaps)


def fit_forest_folds(
    bins, stats_row, w_rows,  # w_rows [F, n]: one weight vector per fold
    boot_w, feat_masks,
    max_depth: int, max_bins: int, impurity_kind: str, n_stats: int,
    min_instances_per_node: float = 1.0,
    min_info_gain: float = 0.0,
    node_masks: torch.Tensor | None = None,
    rows=None,
):
    """Forest CV fan-out: the folds ride the weight axis over one shared
    binning, bootstrap and set of subset masks, one fold after another
    (the JAX package's fold ``vmap``), each fold's trees those of a
    one-fold fit.  Returns heaps with leading [F, T]."""
    return _stack_heaps([
        fit_forest(bins, stats_row, w_rows[f], boot_w, feat_masks,
                   max_depth, max_bins, impurity_kind, n_stats,
                   min_instances_per_node, min_info_gain, node_masks, rows)
        for f in range(w_rows.shape[0])
    ])


def fit_forest_folds_grid(
    bins, stats_row, w_rows, boot_w, feat_masks,
    min_instances_g, min_info_gain_g,  # [G] per-grid-point scalars
    max_depth: int, max_bins: int, impurity_kind: str, n_stats: int,
    node_masks: torch.Tensor | None = None,
    rows=None,
):
    """Grid x fold forest fan-out: grid points sharing the static shapes
    (depth, bins, trees, subset strategy, seed, subsampling rate) differ
    only in min instances and min info gain, and each runs
    :func:`fit_forest_folds`, one after another (the JAX package's
    ``lax.map``; its host chunking keeps TPU programs under the runtime
    watchdog, which this card does not need).  Returns heaps with leading
    [G, F, T]."""
    return _stack_heaps([
        fit_forest_folds(bins, stats_row, w_rows, boot_w, feat_masks,
                         max_depth, max_bins, impurity_kind, n_stats,
                         float(mi), float(mg), node_masks, rows)
        for mi, mg in zip(min_instances_g, min_info_gain_g)
    ])


def _gbt_f0(y, w_rows, is_classification: bool, rows=None):
    """Per-fold initial margin [F] (weighted base rate / mean), its sums
    combined over the mesh's ranks when ``rows`` is given."""
    wsum, wy = w_rows.sum(dim=1), (w_rows * y[None, :]).sum(dim=1)
    if rows is not None:
        wsum, wy = rows.sum(wsum, wy)
    wsum = torch.clamp(wsum, min=1e-12)
    ybar = wy / wsum
    if is_classification:
        pbar = torch.clamp(ybar, 1e-6, 1 - 1e-6)
        return torch.log(pbar / (1.0 - pbar))
    return ybar


def _gbt_boost(
    bins, y, w, num_trees: int, max_depth: int, max_bins: int,
    is_classification: bool, step_size: float,
    min_instances_per_node: float, min_info_gain: float, rows=None,
):
    """One fold's boosting: a Python loop over trees carrying the margin
    on the device.  Its initial margin comes from its own [1, n] weight
    row, so a fold of a fan-out computes exactly what a one-fold fit
    does.  Returns (f0 [1], heaps with leading [T])."""
    n, d = bins.shape
    f0 = _gbt_f0(y, w[None, :], is_classification, rows)
    feat_mask = torch.ones((d,), dtype=torch.bool, device=bins.device)
    F = f0[0].expand(n)
    heaps = []
    for _ in range(num_trees):
        if is_classification:
            pr = torch.sigmoid(F)
            g = y - pr
            h = torch.clamp(pr * (1.0 - pr), min=1e-6)
        else:
            g = y - F
            h = torch.ones_like(g)
        stats = torch.stack([torch.ones_like(g), g, g * g, h], dim=1)
        heap = fit_tree(
            bins, stats, w, feat_mask,
            max_depth, max_bins, "variance", 4,
            min_instances_per_node, min_info_gain, rows=rows,
        )
        out = predict_tree(bins, *heap, max_depth)
        leaf_val = out[:, 1] / torch.clamp(out[:, 3], min=1e-12)
        F = F + step_size * leaf_val
        heaps.append(heap)
    return f0, _stack_heaps(heaps)


def fit_gbt_folds(
    bins, y, w_rows,           # w_rows [F, n]: one weight vector per fold
    num_trees: int, max_depth: int, max_bins: int, is_classification: bool,
    step_size: float, min_instances_per_node: float, min_info_gain: float,
    rows=None,
):
    """GBT CV fan-out with [w, wg, wgg, wh] stat channels (Friedman
    variance impurity, Newton leaf sum(wg)/sum(wh)): the folds ride the
    weight axis over one shared binning, one fold after another (the JAX
    package's fold ``vmap``), each fold's trees those of a one-fold fit.
    Returns (f0 [F], heaps with leading [F, T])."""
    fits = [
        _gbt_boost(bins, y, w_rows[f], num_trees, max_depth, max_bins,
                   is_classification, step_size, min_instances_per_node,
                   min_info_gain, rows)
        for f in range(w_rows.shape[0])
    ]
    f0s = torch.cat([f0 for f0, _ in fits])
    return f0s, _stack_heaps([heaps for _, heaps in fits])


def fit_gbt_folds_grid(
    bins, y, w_rows,
    step_g, min_instances_g, min_info_gain_g,  # [G] per-grid-point scalars
    num_trees: int, max_depth: int, max_bins: int, is_classification: bool,
    rows=None,
):
    """Grid x fold GBT fan-out: grid points sharing the static shapes
    (trees, depth, bins) differ only in step size, min instances and min
    info gain, and each runs :func:`fit_gbt_folds`, one after another (the
    JAX package's ``lax.map``).  Its host chunking over grid points and
    boosting segments keeps TPU programs under the runtime watchdog, and
    no memory bound of this card needs it: one tree's level histograms
    are the working set, as in a single fit.  Returns (f0 [G, F], heaps
    with leading [G, F, T])."""
    fits = [
        fit_gbt_folds(bins, y, w_rows, num_trees, max_depth, max_bins,
                      is_classification, float(ss), float(mi), float(mg),
                      rows)
        for ss, mi, mg in zip(step_g, min_instances_g, min_info_gain_g)
    ]
    f0s = torch.stack([f0 for f0, _ in fits])
    return f0s, _stack_heaps([heaps for _, heaps in fits])


def effective_max_depth(
    max_depth: int,
    n_rows: int,
    min_instances_per_node: float,
    n_features: int | None = None,
    max_bins: int | None = None,
    n_stats: int | None = None,
    cap: str = "auto",
) -> int:
    """Depth cap - default-on, overridable with ``cap="off"``.

    Two provably-lossless bounds (no expressible tree is excluded):

    * support: every split keeps >= min_instances rows in each child, so a
      root-to-leaf path peels off at least min_instances rows per level -
      no leaf sits deeper than n / min_instances.
    * memory: cap depth so the split search's working set (hist, its
      cumsum and the right-side complement, 3 x [2^l, d, bins, C], plus
      3 x [2^l, d, bins] impurity and gain arrays) stays under 4 GiB, the
      JAX package's default budget, so both packages grow the same depth.
      Split search stops a level short of the deepest, so a budget
      fitting 2^l nodes admits depth l+1.
    """
    md = max(1, int(max_depth))
    if cap == "off":
        return md
    m = max(float(min_instances_per_node), 1.0)
    support_cap = int(max(n_rows, 2) // m)
    caps = [md, max(1, support_cap)]
    if n_features and max_bins and n_stats:
        budget = float(1 << 32)
        per_node = 4.0 * n_features * max_bins * (3.0 * n_stats + 3.0)
        caps.append(int(np.floor(np.log2(max(budget / per_node, 2.0)))) + 1)
    return max(1, min(caps))


def _impurity_np(stats: np.ndarray, kind: str) -> np.ndarray:
    """Weighted impurity per node from stored heap stats (numpy mirror of
    _impurity): stats [..., C] with channel 0 = node weight."""
    w = stats[..., 0]
    safe_w = np.maximum(w, 1e-12)
    if kind == "variance":
        mean = stats[..., 1] / safe_w
        imp = stats[..., 2] / safe_w - mean**2
    else:  # gini
        p = stats[..., 1:] / safe_w[..., None]
        imp = 1.0 - (p * p).sum(axis=-1)
    return imp * w


def heap_impurity_importances(
    heaps: tuple, d: int, impurity_kind: str
) -> np.ndarray:
    """Impurity-decrease feature importances computed from stored heaps.

    The flat heap keeps full node stats at EVERY slot (heap_value), so the
    weighted impurity decrease of internal node i is
    imp_w(i) - imp_w(2i+1) - imp_w(2i+2).  Aggregation follows Spark's
    featureImportances contract (reference: ModelInsights.scala:435-525):
    accumulate gain x node-weight per split feature, normalize per tree,
    average over trees, normalize.
    """
    hf, ht, hl, hv = (np.asarray(h) for h in heaps)
    if hf.ndim == 1:  # single tree -> add tree axis
        hf, ht, hl, hv = hf[None], ht[None], hl[None], hv[None]
    T, M = hf.shape
    n_inner = (M - 1) // 2  # nodes with children inside the heap
    imp = _impurity_np(hv, impurity_kind)            # [T, M]
    parents = np.arange(n_inner)
    decrease = (
        imp[:, parents]
        - imp[:, 2 * parents + 1]
        - imp[:, 2 * parents + 2]
    )
    # Reachability gate: rows under an already-leaf node keep flowing into
    # a "shadow" left child that inherits the parent's stats; only splits
    # on the real tree may contribute.
    reach = np.zeros((T, M), dtype=bool)
    reach[:, 0] = True
    for i in range(n_inner):
        ok = reach[:, i] & ~hl[:, i]
        reach[:, 2 * i + 1] |= ok
        reach[:, 2 * i + 2] |= ok
    internal = (~hl[:, :n_inner]) & reach[:, :n_inner]
    contrib = np.where(internal, np.maximum(decrease, 0.0), 0.0)  # [T, n_inner]
    per_tree = np.zeros((T, d))
    feats = np.clip(hf[:, :n_inner], 0, d - 1)
    for t in range(T):
        np.add.at(per_tree[t], feats[t][internal[t]], contrib[t][internal[t]])
    totals = per_tree.sum(axis=1, keepdims=True)
    normed = np.divide(
        per_tree, totals, out=np.zeros_like(per_tree), where=totals > 0
    )
    mean = normed.mean(axis=0)
    s = mean.sum()
    return mean / s if s > 0 else mean


def predict_forest_stats_np(bins, heaps, max_depth: int):
    """Vectorized numpy traversal of EVERY tree at once -> raw leaf stats
    [T, n, C]: all T trees walk as one [T, n] index frontier, max_depth x
    ~6 vectorized ops in total (the host serving route)."""
    hf, ht, hl, hv = (np.asarray(h) for h in heaps)
    n = bins.shape[0]
    T = hf.shape[0]
    rows = np.arange(n)[None, :]          # [1, n] broadcast over trees
    trees = np.arange(T)[:, None]         # [T, 1] broadcast over rows
    idx = np.zeros((T, n), dtype=np.int64)
    for _ in range(max_depth):
        f = hf[trees, idx]                # [T, n] split feature per node
        thr = ht[trees, idx]
        leaf = hl[trees, idx]
        row_bin = bins[rows, f]           # [T, n] gather bins[j, f[t, j]]
        nxt = idx * 2 + 1 + (row_bin > thr).astype(np.int64)
        idx = np.where(leaf, idx, nxt)
    return hv[trees, idx]                 # [T, n, C]


def forest_mean_scale(n_trees: int) -> float:
    """The forest mean's float32 1/T: the tree-order sum is multiplied by
    it on every route (the C++ host walk, numpy, torch on the CPU and on
    the card).  torch divides by a scalar exactly on the CPU but multiplies
    by its reciprocal on CUDA, and jax's ``mean`` multiplies, so ``/ T``
    would give other bits on one device than on the other."""
    return float(np.float32(1.0) / np.float32(n_trees))


def predict_forest_np(bins, heaps, max_depth: int):
    """Numpy mirror of predict_forest: mean normalized per-tree stats
    [n, C-1] via the vectorized all-trees traversal (numpy's axis-0 sum
    adds the trees in tree order, as ``seq_sum`` does)."""
    stats = predict_forest_stats_np(bins, heaps, max_depth)
    w = np.maximum(stats[..., 0:1], 1e-12)
    normed = stats[..., 1:] / w
    return normed.sum(axis=0) * normed.dtype.type(
        forest_mean_scale(normed.shape[0]))


def seq_sum(parts):
    """Sum of same-shape tensors added one after another, in list order.
    A reduction over a stacked tree axis adds in an order that can differ
    from row to row (a vectorized body and its tail on the CPU) and from
    device to device; this order is every row's and every device's, and
    numpy's axis-0 sum over the host route's [T, n, ...] stats."""
    acc = parts[0]
    for p in parts[1:]:
        acc = acc + p
    return acc


def predict_forest(bins, heaps, max_depth: int):
    """Average normalized per-tree outputs [n, C-1] on the bins' device;
    heaps are [T, ...] tensors there.  The trees add in tree order
    (``seq_sum``) and the sum is scaled by ``forest_mean_scale``: rows with
    the same leaves get the same bits, on every device."""
    hf, ht, hl, hv = heaps
    per_tree = []
    for t in range(hf.shape[0]):
        out = predict_tree(bins, hf[t], ht[t], hl[t], hv[t], max_depth)
        w = torch.clamp(out[:, 0:1], min=1e-12)
        per_tree.append(out[:, 1:] / w)  # normalized stats (probs or mean)
    return seq_sum(per_tree) * forest_mean_scale(len(per_tree))
