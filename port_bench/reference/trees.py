"""Histogram trees, written plainly: quantile edges, bins, one tree grown
level by level, and logistic-loss gradient boosting.

A tree of depth D is a heap of 2^(D+1) - 1 nodes (children of i at 2i+1
and 2i+2).  Every level builds each node's histogram of its rows' stat
channels per (feature, bin), and splits the node at the (feature, bin)
of the largest impurity gain - the first one on ties, in feature then bin
order - when both sides keep ``min_instances`` weight and the gain is at
least ``min_info_gain``; a row goes right when its bin is above the split
bin.  A node that does not split is a leaf, and its rows stay under it.
The gini impurity reads channels (w, w*onehot...), the variance impurity
(w, w*g, w*g*g): Friedman's gain for boosting, whose leaf value is
sum(w*g) / sum(w*h) from a fourth channel.

The statistics are held in ``dt`` (float64 for the reference; the
control computes them in a lower precision).
"""
from __future__ import annotations

import numpy as np
import torch


def quantile_edges(X: np.ndarray, max_bins: int) -> np.ndarray:
    """[d, max_bins - 1] float32: each column's quantiles at
    1/max_bins, ..., (max_bins - 1)/max_bins (linear interpolation)."""
    qs = np.linspace(0.0, 1.0, max_bins + 1)[1:-1]
    return np.asarray(np.quantile(X, qs, axis=0).T, dtype=np.float32)


def sampled_edges(X: np.ndarray, max_bins: int, cap: int, seed: int):
    """Edges from all rows up to ``cap`` rows, else from ``cap`` rows drawn
    with replacement from a seeded generator."""
    n = X.shape[0]
    if n <= cap:
        return quantile_edges(X, max_bins)
    idx = np.random.RandomState(seed).randint(0, n, cap)
    return quantile_edges(np.asarray(X[idx]), max_bins)


def to_bins(x32: torch.Tensor, edges: np.ndarray) -> torch.Tensor:
    """[n, d] int64: how many of the column's edges lie strictly below
    each float32 value."""
    e = torch.as_tensor(edges, device=x32.device)
    out = torch.empty(x32.shape, dtype=torch.int64, device=x32.device)
    for j in range(x32.shape[1]):
        out[:, j] = torch.searchsorted(e[j].contiguous(),
                                       x32[:, j].contiguous(), right=False)
    return out


def _impurity(s: torch.Tensor, kind: str):
    w = s[..., 0]
    safe = torch.clamp(w, min=1e-12)
    if kind == "variance":
        mean = s[..., 1] / safe
        imp = s[..., 2] / safe - mean * mean
    else:
        p = s[..., 1:] / safe[..., None]
        imp = 1.0 - (p * p).sum(dim=-1)
    return imp * w, w


#: (row, feature) pairs a histogram adds in one block
_BLOCK = 1 << 24


def _histogram(bins, node, stats, L: int, B: int) -> torch.Tensor:
    """[L, d, B, C]: each node's sum of its rows' stats per (feature,
    bin)."""
    n, d = bins.shape
    C = stats.shape[1]
    hist = torch.zeros((L * d * B, C), dtype=stats.dtype, device=bins.device)
    cols = torch.arange(d, device=bins.device)
    rows = max(1, _BLOCK // max(d, 1))
    for i in range(0, n, rows):
        seg = ((node[i:i + rows, None] * d + cols[None, :]) * B
               + bins[i:i + rows]).reshape(-1)
        vals = stats[i:i + rows, None, :].expand(-1, d, C).reshape(-1, C)
        hist.index_add_(0, seg, vals)
    return hist.reshape(L, d, B, C)


def fit_tree(bins: torch.Tensor, stats: torch.Tensor, depth: int, B: int,
             kind: str, min_instances: float, min_info_gain: float):
    """One tree on the rows of ``bins`` [n, d] with stat channels
    ``stats`` [n, C] (already weighted).  Returns the heap (feature,
    threshold bin, is_leaf, node stats)."""
    n, d = bins.shape
    C = stats.shape[1]
    dev = bins.device
    M = 2 ** (depth + 1) - 1
    feat = torch.zeros(M, dtype=torch.int64, device=dev)
    thr = torch.full((M,), B, dtype=torch.int64, device=dev)
    leaf = torch.ones(M, dtype=torch.bool, device=dev)
    value = torch.zeros((M, C), dtype=stats.dtype, device=dev)
    node = torch.zeros(n, dtype=torch.int64, device=dev)
    for level in range(depth + 1):
        L = 2 ** level
        base = L - 1
        hist = _histogram(bins, node, stats, L, B)
        tot = hist[:, 0].sum(dim=1)                      # [L, C]
        value[base:base + L] = tot
        if level == depth:
            break
        left = torch.cumsum(hist, dim=2)
        right = tot[:, None, None, :] - left
        imp_n, w_n = _impurity(tot, kind)
        imp_l, w_l = _impurity(left, kind)
        imp_r, w_r = _impurity(right, kind)
        gain = (imp_n[:, None, None] - imp_l - imp_r) / torch.clamp(
            w_n[:, None, None], min=1e-12)
        ok = (w_l >= min_instances) & (w_r >= min_instances)
        gain = torch.where(ok, gain, torch.full_like(gain, -torch.inf))
        flat = gain.reshape(L, d * B)
        best = torch.argmax(flat, dim=1)
        bgain = flat.gather(1, best[:, None])[:, 0]
        bfeat, bbin = best // B, best % B
        split = (bgain >= min_info_gain) & torch.isfinite(bgain)
        feat[base:base + L] = torch.where(split, bfeat, 0)
        thr[base:base + L] = torch.where(split, bbin,
                                         torch.full_like(bbin, B))
        leaf[base:base + L] = ~split
        rb = bins.gather(1, bfeat[node][:, None])[:, 0]
        right_go = split[node] & (rb > bbin[node])
        node = node * 2 + right_go.long()
    return feat, thr, leaf, value


def walk(bins: torch.Tensor, heap, depth: int) -> torch.Tensor:
    """Each row's node stats at the leaf it reaches: [n, C]."""
    feat, thr, leaf, value = heap
    idx = torch.zeros(bins.shape[0], dtype=torch.int64, device=bins.device)
    for _ in range(depth):
        rb = bins.gather(1, feat[idx][:, None])[:, 0]
        nxt = idx * 2 + 1 + (rb > thr[idx]).long()
        idx = torch.where(leaf[idx], idx, nxt)
    return value[idx]


def split_points(heap, edges_row: np.ndarray) -> list:
    """The thresholds of a one-feature tree's split nodes, sorted, each
    once."""
    feat, thr, leaf, _ = (h.cpu().numpy() for h in heap)
    out = {float(edges_row[t]) for t, lf in zip(thr, leaf)
           if not lf and t < len(edges_row)}
    return sorted(out)


def max_depth_for(depth: int, n: int, min_instances: float, d: int,
                  B: int, C: int) -> int:
    """The GBT's depth limit: no deeper than n / min_instances, and no
    deeper than the split search's [2^l, d, B, C] working set allows in
    4 GiB."""
    m = max(float(min_instances), 1.0)
    caps = [max(1, int(depth)), max(1, int(max(n, 2) // m))]
    per_node = 4.0 * d * B * (3.0 * C + 3.0)
    caps.append(int(np.floor(np.log2(max(float(1 << 32) / per_node,
                                         2.0)))) + 1)
    return max(1, min(caps))


def boost(bins: torch.Tensor, y: torch.Tensor, w: torch.Tensor,
          trees: int, depth: int, B: int, step: float,
          min_instances: float, min_info_gain: float):
    """Logistic-loss boosting on the rows with weight: the initial margin
    is the weighted base rate's log-odds, each tree fits the gradient
    y - p with curvature p(1 - p).  Returns (f0, heaps)."""
    keep = torch.nonzero(w > 0).squeeze(1)
    bk, yk, wk = bins[keep], y[keep], w[keep]
    ybar = (wk * yk).sum() / torch.clamp(wk.sum(), min=1e-12)
    pbar = torch.clamp(ybar, 1e-6, 1 - 1e-6)
    f0 = torch.log(pbar / (1.0 - pbar))
    F = f0.expand(len(keep)).clone()
    heaps = []
    for _ in range(trees):
        p = torch.sigmoid(F)
        g = yk - p
        h = torch.clamp(p * (1.0 - p), min=1e-6)
        stats = torch.stack([torch.ones_like(g), g, g * g, h], 1) * wk[:, None]
        heap = fit_tree(bk, stats, depth, B, "variance", min_instances,
                        min_info_gain)
        out = walk(bk, heap, depth)
        F = F + step * (out[:, 1] / torch.clamp(out[:, 3], min=1e-12))
        heaps.append(heap)
    return f0, heaps


def boost_margin(bins: torch.Tensor, f0, heaps, depth: int,
                 step: float) -> torch.Tensor:
    """f0 + step * (the trees' leaf values, added tree by tree)."""
    total = None
    for heap in heaps:
        out = walk(bins, heap, depth)
        v = out[:, 1] / torch.clamp(out[:, 3], min=1e-12)
        total = v if total is None else total + v
    return f0 + step * total
