"""models/tree_kernel.py of the torch package against the JAX package's.

The same bins and stat channels, made from a seed with numpy, go through
both packages' ``fit_tree`` and ``predict_tree`` on the CPU.  Heap
structure (``feature``, ``thr_bin``, ``is_leaf``) must be identical; gini
channels are integer counts in float32 and must be exact; variance
channels agree within rtol 1e-5, atol 1e-5 (float32 sums in another
order).  ``effective_max_depth`` and ``heap_impurity_importances`` must be
equal.
"""
import numpy as np
import pytest
import torch

from torch_parity import compare_trees
from transmogrifai_tpu.models import tree_kernel as ref
from transmogrifai_tpu_torch.models import tree_kernel as port

N, D, B = 1500, 12, 16


def _inputs(kind: str, C: int, seed: int):
    rng = np.random.RandomState(seed)
    x = rng.randn(N, D).astype(np.float32)
    bins = ref.bin_data(x, ref.quantile_bin_edges(x, B))
    w = rng.rand(N).astype(np.float32) + 0.5
    score = x[:, 0] - 0.8 * x[:, 3] + 0.5 * x[:, 7] * x[:, 1]
    if kind == "gini":
        K = C - 1
        cut = np.quantile(score, np.linspace(0, 1, K + 1)[1:-1])
        y = np.searchsorted(cut, score + 0.3 * rng.randn(N))
        stats = np.concatenate(
            [np.ones((N, 1)), np.eye(K)[y]], axis=1).astype(np.float32)
        w = np.ones(N, np.float32)  # counts stay integers: exact channels
    else:
        y = (score + 0.2 * rng.randn(N)).astype(np.float32)
        chans = [np.ones(N), y, y * y, 0.5 + rng.rand(N)][:C]
        stats = np.stack(chans, axis=1).astype(np.float32)
    return bins, stats, w


def _fit_both(bins, stats, w, depth, kind, C, minipn, minig):
    mask = np.ones(D, bool)
    want = ref.fit_tree(bins, stats, w, mask, depth, B, kind, C, minipn, minig)
    got = port.fit_tree(
        torch.from_numpy(bins).to(torch.int8), torch.from_numpy(stats),
        torch.from_numpy(w), torch.from_numpy(mask), depth, B, kind, C,
        minipn, minig,
    )
    return ([np.asarray(h) for h in want], [h.numpy() for h in got])


CASES = [
    ("gini", 3, 4, 1.0, 0.0),
    ("gini", 3, 5, 25.0, 0.002),
    ("variance", 3, 4, 1.0, 0.0),
    ("variance", 4, 5, 40.0, 0.01),
]


@pytest.mark.parametrize("kind,C,depth,minipn,minig", CASES)
def test_fit_and_predict_tree_match_reference(kind, C, depth, minipn, minig):
    bins, stats, w = _inputs(kind, C, seed=C + depth)
    want, got = _fit_both(bins, stats, w, depth, kind, C, minipn, minig)
    for i in range(3):  # feature, thr_bin, is_leaf
        np.testing.assert_array_equal(got[i], want[i])
    assert got[0].dtype == np.int32 and got[2].dtype == bool
    assert not got[2].all() and got[2].any()  # a real, partial tree
    if kind == "gini":
        np.testing.assert_array_equal(got[3], want[3])
    else:
        np.testing.assert_allclose(got[3], want[3], rtol=1e-5, atol=1e-5)

    want_p = np.asarray(ref.predict_tree(bins, *want, max_depth=depth))
    got_p = port.predict_tree(
        torch.from_numpy(bins), *(torch.from_numpy(h) for h in got), depth
    ).numpy()
    np.testing.assert_allclose(got_p, want_p, rtol=1e-5, atol=1e-5)
    # the host walk agrees with the device-style walk
    np.testing.assert_array_equal(
        port.predict_forest_stats_np(bins, [h[None] for h in got], depth)[0],
        got_p,
    )
    imp = "gini" if kind == "gini" else "variance"
    np.testing.assert_allclose(
        port.heap_impurity_importances(got, D, imp),
        ref.heap_impurity_importances(want, D, imp), rtol=1e-6, atol=1e-9,
    )


def test_chunked_histogram_matches_one_shot(monkeypatch):
    """Row blocks of the level histogram add up to the one-shot scatter
    (gini counts: exact)."""
    bins, stats, w = _inputs("gini", 3, seed=5)
    b = torch.from_numpy(bins)
    node = torch.from_numpy(np.random.RandomState(1).randint(0, 4, N))
    sw = torch.from_numpy(stats)
    one = port._level_hist(b, node, sw, 4, B)
    monkeypatch.setattr(port, "_HIST_BLOCK_ELEMS", 7 * D + 3)  # 7-row blocks
    chunked = port._level_hist(b, node, sw, 4, B)
    assert torch.equal(one, chunked)
    assert float(one[..., 0].sum()) == N * D


@pytest.mark.parametrize("chunk,block_elems",
                         [(1 << 13, 1 << 26), (5, 1 << 26), (5, 3 * 4 * 60)])
def test_occupied_nodes_histogram_is_the_full_levels(monkeypatch, chunk,
                                                     block_elems):
    """The CPU's occupied-node histogram (``n_nodes``: a level of 64
    slots, 3 of them holding rows) is the full level's rows of those
    nodes bit for bit, on non-integer stats, however its rows go into
    chunks and blocks; the empty slots of the full level are zeros."""
    rng = np.random.RandomState(3)
    n, d, L, B = 3000, 4, 64, 32
    bins = torch.from_numpy(rng.randint(0, B, (n, d)).astype(np.int8))
    node = torch.from_numpy(rng.choice([3, 17, 40], n))
    sw = torch.from_numpy(rng.rand(n, 3).astype(np.float32))
    monkeypatch.setattr(port, "_HIST_CHUNK_ROWS", chunk)
    monkeypatch.setattr(port, "_HIST_BLOCK_ELEMS", block_elems)
    full = port._level_hist(bins, node, sw, L, B)
    occ, local = torch.unique(node, return_inverse=True)
    compact = port._level_hist(bins, local, sw, L, B, n_nodes=len(occ))
    assert torch.equal(compact, full[occ])
    empty = torch.ones(L, dtype=torch.bool)
    empty[occ] = False
    assert not full[empty].any()


@pytest.mark.parametrize("kind,C,minipn", [("gini", 3, 1.0),
                                           ("variance", 3, 2.0)])
def test_deep_tree_on_few_rows_matches_reference(kind, C, minipn):
    """Depth 9 over 60 rows, where a deep level's slots are mostly empty
    and the CPU builds only the occupied ones: the heap equals the JAX
    package's full-level heap (gini exactly, variance within 1e-5)."""
    bins, stats, w = _inputs(kind, C, seed=11)
    bins, stats, w = bins[:60], stats[:60], w[:60]
    mask = np.ones(D, bool)
    want = [np.asarray(h) for h in ref.fit_tree(
        bins, stats, w, mask, 9, B, kind, C, minipn, 0.0)]
    got = [h.numpy() for h in port.fit_tree(
        torch.from_numpy(bins).to(torch.int8), torch.from_numpy(stats),
        torch.from_numpy(w), torch.from_numpy(mask), 9, B, kind, C,
        minipn, 0.0)]
    for i in range(3):
        np.testing.assert_array_equal(got[i], want[i])
    assert not got[2][:7].all()  # it split
    if kind == "gini":
        np.testing.assert_array_equal(got[3], want[3])
    else:
        np.testing.assert_allclose(got[3], want[3], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("kind,C,minipn,minig,masked", [
    ("gini", 3, 1.0, 0.0, False), ("gini", 3, 3.0, 0.01, True),
    ("variance", 4, 1.0, 0.0, False), ("variance", 3, 2.0, 0.0, True)])
def test_occupied_only_fit_equals_the_full_level(monkeypatch, kind, C,
                                                 minipn, minig, masked):
    """The CPU's occupied-node path and the full level give the same heap
    bits, empty slots included, at a depth where most slots are empty
    (with and without per-node feature masks).  An empty slot keeps the
    heap's initial entry, so this fails if ``fit_tree``'s initial
    ``heap_feature``/``heap_thr``/``heap_leaf``/``heap_value`` stop being
    what the full level writes there."""
    bins, stats, w = _inputs(kind, C, seed=5)
    bins, stats, w = bins[:90], stats[:90], w[:90]
    depth = 8
    node_mask = None
    if masked:
        rng = np.random.RandomState(2)
        node_mask = torch.from_numpy(rng.rand(2**depth - 1, D) < 0.6)
    args = (torch.from_numpy(bins).to(torch.int8), torch.from_numpy(stats),
            torch.from_numpy(w), torch.ones(D, dtype=torch.bool), depth, B,
            kind, C, minipn, minig, node_mask)
    assert port._occupied_only(torch.device("cpu"), None, minipn)
    occupied = port.fit_tree(*args)
    monkeypatch.setattr(port, "_occupied_only", lambda *a: False)
    full = port.fit_tree(*args)
    leaf = full[2].numpy()
    assert not leaf[:7].all() and leaf[2**depth - 1:].sum() > 100
    for a, b in zip(occupied, full):
        assert a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.parametrize("dev,rows,minipn,want", [
    ("cpu", None, 1.0, True), ("cpu", None, 0.0, False),
    ("cpu", object(), 1.0, False), ("cuda", None, 1.0, False)])
def test_occupied_only_is_the_cpus_alone(dev, rows, minipn, want):
    """The occupied-node path is taken on the CPU with no mesh reducer
    and a positive ``min_instances_per_node``, and nowhere else: the
    card and a mesh keep the full level, and at 0 an empty slot's full-
    level entry would not be the heap's initial one."""
    assert port._occupied_only(torch.device(dev), rows, minipn) is want


@pytest.mark.parametrize(
    "chunk,block_elems",
    [(1 << 13, 1 << 26), (5, 1 << 26), (5, 3 * 4 * 600)],
)
def test_card_segment_sum_matches_serial(monkeypatch, chunk, block_elems):
    """The level histogram's chunked segment sum (on integer counts, where
    any order is exact) equals the serial one, however its rows go into
    chunks and blocks."""
    rng = np.random.RandomState(2)
    n, d, L, B = 5000, 3, 8, 25
    bins = torch.from_numpy(rng.randint(0, B, (n, d)).astype(np.int8))
    node = torch.from_numpy(rng.randint(0, L, n))
    sw = torch.from_numpy(rng.randint(0, 5, (n, 3)).astype(np.float32))
    seg = (node[:, None] * d + torch.arange(d)) * B + bins.long()
    serial = torch.zeros((L * d * B, 3)).index_add_(
        0, seg.reshape(-1), sw[:, None, :].expand(n, d, 3).reshape(-1, 3))
    monkeypatch.setattr(port, "_HIST_CHUNK_ROWS", chunk)
    monkeypatch.setattr(port, "_HIST_BLOCK_ELEMS", block_elems)
    assert torch.equal(port._level_hist(bins, node, sw, L, B),
                       serial.reshape(L, d, B, 3))


@pytest.mark.parametrize("L,B,n", [(1, 32, 5000), (512, 32, 5000),
                                   (1024, 32, 9000), (512, 255, 20000)])
def test_deep_level_chunks_grow_with_the_level(L, B, n):
    """A level of L nodes and B bins sums chunks of max(2048, L*B/8) rows -
    the same rule on every device - so its partials hold at most 8 times
    its stat rows; on integer counts the chunked sum equals the serial
    one."""
    chunk = port._hist_chunk_rows(L, B)
    assert chunk == max(2048, L * B // 8)
    d = 2
    assert -(-n // chunk) * L * d * B <= 8 * (n + chunk) * d
    rng = np.random.RandomState(L)
    bins = torch.from_numpy(rng.randint(0, B, (n, d)).astype(np.int32))
    node = torch.from_numpy(rng.randint(0, L, n))
    sw = torch.from_numpy(rng.randint(0, 5, (n, 4)).astype(np.float32))
    seg = (node[:, None] * d + torch.arange(d)) * B + bins.long()
    serial = torch.zeros((L * d * B, 4)).index_add_(
        0, seg.reshape(-1), sw[:, None, :].expand(n, d, 4).reshape(-1, 4))
    assert torch.equal(port._level_hist(bins, node, sw, L, B),
                       serial.reshape(L, d, B, 4))


@pytest.mark.parametrize(
    "args",
    [(5, 1000, 1.0), (12, 891, 1.0), (12, 100, 30.0), (30, 10**6, 1.0),
     (8, 5000, 1.0, 39, 32, 4), (20, 10**6, 1.0, 512, 255, 4),
     (20, 10**6, 1.0, 2000, 255, 3), (6, 50, 1.0, 11, 32, 3)],
)
def test_effective_max_depth_matches_reference(args):
    assert port.effective_max_depth(*args) == ref.effective_max_depth(*args)
    assert port.effective_max_depth(*args, cap="off") == \
        ref.effective_max_depth(*args, cap="off")


def test_quantile_edges_and_host_bins_match_reference():
    rng = np.random.RandomState(3)
    x = rng.randn(700, 9).astype(np.float64)
    for mb in (8, 32, 255):
        e = port.quantile_bin_edges(x, mb)
        np.testing.assert_array_equal(e, ref.quantile_bin_edges(x, mb))
        np.testing.assert_array_equal(port.bin_data(x, e), ref.bin_data(x, e))
    assert port.bins_device_dtype(127) == torch.int8
    assert port.bins_device_dtype(128) == torch.int32


def test_forest_and_gbt_loops_match_reference():
    """fit_forest (bootstrap weights, gini) and the one-fold boosting loop
    against the reference's lax.map / lax.scan cores."""
    bins, stats, w = _inputs("gini", 3, seed=11)
    rng = np.random.RandomState(4)
    boot = rng.poisson(1.0, size=(3, N)).astype(np.float32)
    masks = np.ones((3, D), bool)
    keys = np.zeros((3, 2), np.uint32)
    want = ref.fit_forest(bins, stats, w, boot, masks, keys, 4, B, "gini", 3)
    got = port.fit_forest(
        torch.from_numpy(bins), torch.from_numpy(stats), torch.from_numpy(w),
        torch.from_numpy(boot), torch.from_numpy(masks), 4, B, "gini", 3,
    )
    # tree 1 holds an exact tie (ROADMAP.md queue 3): at heap node 11 two
    # splits leave children of the same class counts, (4, 27) and (2, 277),
    # on different rows; the float32 gains differ in the last bit between
    # the packages, which pick different winners
    ties = [compare_trees([h[t] for h in got], [h[t] for h in want], bins, 4)
            for t in range(3)]
    assert [t[0] for t in ties] == [[], [11], []]
    tied_rows = ties[1][1]
    assert 0 < tied_rows.sum() < 0.3 * N
    np.testing.assert_allclose(
        port.predict_forest(torch.from_numpy(bins), got, 4).numpy()[~tied_rows],
        np.asarray(ref.predict_forest(bins, want, max_depth=4))[~tied_rows],
        rtol=1e-6, atol=1e-7,
    )

    y = (stats[:, 1] > 0).astype(np.float32)
    wr = np.ones((1, N), np.float32)
    f0_ref, h_ref = ref.fit_gbt_folds(bins, y, wr, 5, 3, B, True, 0.1, 1.0, 0.0)
    f0, h = port.fit_gbt_folds(
        torch.from_numpy(bins).to(torch.int8), torch.from_numpy(y),
        torch.from_numpy(wr), 5, 3, B, True, 0.1, 1.0, 0.0,
    )
    assert abs(float(f0[0]) - float(np.asarray(f0_ref)[0])) <= 1e-7
    for i in range(3):
        np.testing.assert_array_equal(h[i].numpy(), np.asarray(h_ref[i]))
    # gradient sums cancel towards 0 at the root, so the stats are held
    # as the Newton leaf values sum(wg) / sum(wh) that scoring reads
    hv, hv_ref = h[3].numpy(), np.asarray(h_ref[3])
    np.testing.assert_allclose(hv[..., [0, 3]], hv_ref[..., [0, 3]], rtol=1e-5)
    np.testing.assert_allclose(
        hv[..., 1] / np.maximum(hv[..., 3], 1e-12),
        hv_ref[..., 1] / np.maximum(hv_ref[..., 3], 1e-12),
        rtol=1e-4, atol=1e-5,
    )
    # the fold fan-out: each fold grows the trees of the reference's fold
    # vmap over the same bins
    w2 = np.stack([np.ones(N, np.float32),
                   (np.arange(N) % 3 > 0).astype(np.float32)])
    f0_ref2, h_ref2 = ref.fit_gbt_folds(bins, y, w2, 2, 3, B, True, 0.1, 1.0, 0.0)
    f02, h2 = port.fit_gbt_folds(
        torch.from_numpy(bins).to(torch.int8), torch.from_numpy(y),
        torch.from_numpy(w2), 2, 3, B, True, 0.1, 1.0, 0.0,
    )
    np.testing.assert_allclose(f02.numpy(), np.asarray(f0_ref2), atol=1e-7)
    for i in range(3):
        np.testing.assert_array_equal(h2[i].numpy(), np.asarray(h_ref2[i]))
