"""The torch package's CUDA kernels on the card, against their plain torch
versions.  A hand-written kernel has no CPU mode, so every test here is
marked ``gpu`` and skips without a CUDA device.  This file imports neither
jax nor the JAX package, so it also runs where only torch is installed:

    python -m pytest --noconftest -m gpu tests/test_torch_kernels_gpu.py

Tolerances: sums rtol 3e-5, atol 3e-3 (the JAX package's Pallas test
tolerance; both sides sum float32 in different orders), min/max exact and
NaN-equal; bins exactly equal.  The tree learner's histograms must be
bit-identical from run to run on the card.
"""
import numpy as np
import pytest
import torch

from transmogrifai_tpu_torch.parallel import kernels as tk

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: a hand-written kernel has no CPU mode")
    return torch.device("cuda", 0)


def _inputs(n, d, seed, device, nan_col=None):
    rng = np.random.RandomState(seed)
    x = (rng.randn(n, d) * 3.0 + 1.0).astype(np.float32)
    if nan_col is not None:
        x[::7, nan_col] = np.nan
    y = rng.rand(n).astype(np.float32)
    return torch.from_numpy(x).to(device), torch.from_numpy(y).to(device)


@pytest.mark.parametrize(
    "n,d,nan_col",
    [(1, 1, None), (100, 7, None), (513, 129, None), (1000, 37, 5),
     (70_001, 11, None)],
)
def test_fused_moments_kernel_matches_plain(cuda, n, d, nan_col):
    x, y = _inputs(n, d, n + d, cuda, nan_col)
    before = tk.fused_moments.launches
    got = tk.fused_moments(x, y)
    assert tk.fused_moments.launches == before + 1
    want = tk.fused_moments_plain(x, y)
    for k, (a, b) in enumerate(zip(got, want)):
        a, b = a.cpu().double().numpy(), b.cpu().double().numpy()
        if k < 5:
            np.testing.assert_allclose(a, b, rtol=3e-5, atol=3e-3)
        else:
            np.testing.assert_array_equal(a, b)


def _nan_equal(a, b):
    return bool(((a == b) | (a.isnan() & b.isnan())).all())


def _assert_moments_match(got, want):
    for k, (a, b) in enumerate(zip(got, want)):
        a, b = a.cpu().double().numpy(), b.cpu().double().numpy()
        if k < 5:
            np.testing.assert_allclose(a, b, rtol=3e-5, atol=3e-3)
        else:
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize(
    "n,d,off",
    [(1, 1, 0), (1, 39, 0), (17, 4, 1), (33, 9, 3), (4097, 39, 1),
     (70_001, 1, 3), (70_001, 9, 0), (70_001, 11, 1), (257, 257, 1),
     (129, 1100, 3), (1_000_003, 15, 0)],
)
def test_fused_moments_kernel_redesign_cases(cuda, n, d, off):
    """One row, rows just past a multiple of 16, more than 2^16 rows, d on
    either side of the block's 256 lanes, and row-offset views x[off:],
    y[off:] that start off 16-byte alignment."""
    x, y = _inputs(n + off, d, 7 * n + d, cuda, d // 2 if d > 2 else None)
    _assert_moments_match(tk.fused_moments(x[off:], y[off:]),
                          tk.fused_moments_plain(x[off:], y[off:]))


@pytest.mark.parametrize("n", [1, 4097, 300_007, (1 << 20) + 3])
def test_fused_moments_kernel_is_deterministic(cuda, n):
    """Bit-identical from run to run, whichever block finishes last."""
    x, y = _inputs(n, 39, 1, cuda, nan_col=3)
    first = [t.clone() for t in tk.fused_moments(x, y)]
    for _ in range(3):
        again = tk.fused_moments(x, y)
        assert all(_nan_equal(a, b) for a, b in zip(first, again))


def test_fused_moments_kernel_blocks_without_a_tile(cuda):
    """A matrix of fewer tiles than the persistent grid has blocks: the
    blocks left without a tile still count in, their identity partials
    change nothing."""
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    for n, d in ((100, 9), (1000, 39), (3, 1)):
        assert -(-n * d // 4096) < sms
        x, y = _inputs(n, d, n, cuda, nan_col=0)
        _assert_moments_match(tk.fused_moments(x, y),
                              tk.fused_moments_plain(x, y))


def test_fused_moments_kernel_leaves_its_counter_at_zero(cuda):
    """The one-launch combine counts blocks on a counter that the last
    block resets: after each call it is 0, so the next call on the stream
    combines again (two calls in a row agree)."""
    x, y = _inputs(200_003, 11, 5, cuda)
    first = tk.fused_moments(x, y)
    stream = torch.cuda.current_stream().cuda_stream
    counter = tk._counters[(cuda.index, stream)]
    torch.cuda.synchronize()
    assert int(counter.item()) == 0
    second = tk.fused_moments(x, y)
    torch.cuda.synchronize()
    assert int(counter.item()) == 0
    assert all(torch.equal(a, b) for a, b in zip(first, second))


def test_fused_moments_kernel_rejects_bad_input(cuda):
    x, y = _inputs(64, 8, 2, cuda)
    with pytest.raises(ValueError, match="contiguous"):
        tk.fused_moments(x.t().contiguous().t(), y)
    with pytest.raises(ValueError, match="on"):
        tk.fused_moments(x, y.cpu())


def _bin_inputs(n, d, n_edges, seed, device):
    rng = np.random.RandomState(seed)
    x = (rng.randn(n, d) * 2.0).astype(np.float32)
    x[::13, d // 2] = np.nan
    edges = np.sort(rng.randn(d, n_edges), axis=1).astype(np.float32)
    if d > 2:
        edges[d - 1] = np.nan  # an all-NaN edge row
        edges[0, n_edges // 2:] = np.nan  # NaN edges at the tail
    return torch.from_numpy(x).to(device), torch.from_numpy(edges).to(device)


@pytest.mark.parametrize(
    "n,d,n_edges,dtype",
    [(1, 1, 31, torch.int8), (513, 129, 31, torch.int8),
     (1000, 37, 254, torch.int32), (70_001, 39, 31, torch.int8),
     (300, 5, 0, torch.int32), (257, 1100, 63, torch.int32)],
)
def test_bin_matrix_kernel_matches_plain(cuda, n, d, n_edges, dtype):
    x, edges = _bin_inputs(n, d, n_edges, n + d, cuda)
    before = tk.bin_matrix.launches
    got = tk.bin_matrix(x, edges, dtype)
    assert tk.bin_matrix.launches == before + 1
    want = tk.bin_matrix_plain(x, edges, dtype)
    assert got.dtype == dtype
    assert torch.equal(got, want)
    assert torch.equal(tk.bin_matrix(x, edges, dtype), got)


def _special_edges(x, edges):
    """The CPU tests' edge rows the binary search must not take, or must
    take exactly (tests/test_torch_bin_matrix.py), on card tensors."""
    x, e = x.clone(), edges.clone()
    d, n_edges = e.shape
    for j in range(d):
        kind = j % 5
        if kind == 0:
            e[j] = e[j].flip(0)
        elif kind == 1:
            e[j, n_edges // 2] = float("nan")
        elif kind == 2:
            e[j, 3:9] = e[j, 3]
        elif kind == 3:
            e[j, :3] = torch.tensor([-float("inf"), -0.0, 0.0])
            e[j] = torch.sort(e[j]).values
        else:
            e[j, -1] = float("inf")
    x[::3, d // 3] = -0.0
    x[1::3, d // 3] = 0.0
    x[::4, (2 * d) // 3] = float("inf")
    x[1::4, (2 * d) // 3] = -float("inf")
    return x, e.contiguous()


@pytest.mark.parametrize("kind", ["sorted", "special"])
@pytest.mark.parametrize(
    "n,d,off",
    [(1, 1, 0), (17, 4, 1), (33, 9, 3), (4097, 39, 1), (70_001, 1, 3),
     (257, 257, 0), (17, 1100, 1), (1_000_003, 9, 2)],
)
def test_bin_matrix_kernel_redesign_cases(cuda, n, d, off, kind):
    """One row, rows just past a multiple of 16, more than 2^16 rows, one
    column, rows wider than the block's lanes, row-offset views x[off:],
    and edge rows that are unsorted, duplicated, NaN inside, +-inf, -0.0:
    bins equal to the plain version in both dtypes, twice."""
    x, edges = _bin_inputs(n + off, d, 31, 3 * n + d, cuda)
    if kind == "special":
        x, edges = _special_edges(x, edges)
    for dtype in (torch.int8, torch.int32):
        got = tk.bin_matrix(x[off:], edges, dtype)
        assert torch.equal(got, tk.bin_matrix_plain(x[off:], edges, dtype))
        assert torch.equal(tk.bin_matrix(x[off:], edges, dtype), got)


def test_bin_matrix_kernel_blocks_without_a_tile(cuda):
    """Fewer 16 KB tiles than the persistent grid has blocks."""
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    for n, d in ((100, 9), (5000, 39), (3, 1)):
        assert -(-n * d // 4096) < sms
        x, edges = _bin_inputs(n, d, 31, n, cuda)
        assert torch.equal(tk.bin_matrix(x, edges, torch.int8),
                           tk.bin_matrix_plain(x, edges, torch.int8))


def test_bin_matrix_kernel_edge_tables_shrink_and_grow(cuda):
    """Launches whose staged edge tables take more, then less, then more
    shared memory again: the kernel's opt-in is its largest, so a smaller
    plan never refuses a later larger one."""
    for d in (3, 9, 5, 39, 9, 129):
        x, edges = _bin_inputs(4099, d, 31, d, cuda)
        assert torch.equal(tk.bin_matrix(x, edges, torch.int32),
                           tk.bin_matrix_plain(x, edges, torch.int32))


def test_bin_matrix_kernel_rejects_bad_input(cuda):
    x, edges = _bin_inputs(64, 8, 31, 2, cuda)
    with pytest.raises(ValueError, match="contiguous"):
        tk.bin_matrix(x.t().contiguous().t(), edges, torch.int8)
    with pytest.raises(ValueError, match="on"):
        tk.bin_matrix(x, edges.cpu(), torch.int8)


def test_bin_matrix_kernel_plans_its_grid(cuda):
    """The C entry tiles columns to fit their edges in shared memory, and
    refuses without launching an edge row that fits no tile."""
    x, edges = _bin_inputs(2000, 1024, 254, 4, cuda)
    assert torch.equal(tk.bin_matrix(x, edges, torch.int32),
                       tk.bin_matrix_plain(x, edges, torch.int32))
    x, edges = _bin_inputs(10, 3, 20000, 5, cuda)
    before = tk.bin_matrix.launches
    with pytest.raises(ValueError, match="shared memory"):
        tk.bin_matrix(x, edges, torch.int32)
    assert tk.bin_matrix.launches == before


def test_tree_fit_is_deterministic_on_the_card(cuda):
    from transmogrifai_tpu_torch.models.tree_kernel import fit_gbt_folds

    x, edges = _bin_inputs(200_003, 24, 31, 3, cuda)
    bins = tk.bin_matrix(x.nan_to_num(), edges[:, :7].contiguous(), torch.int8)
    y = (x[:, 0].nan_to_num() > 0.1).float()
    w = torch.ones((1, x.shape[0]), device=cuda)
    runs = [fit_gbt_folds(bins, y, w, 3, 5, 32, True, 0.1, 1.0, 0.0)
            for _ in range(2)]
    for a, b in zip(runs[0][1], runs[1][1]):
        assert torch.equal(a, b)


# -- the model selector's device work -----------------------------------------

def _lr_batch_inputs(n, d, seed):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, d) * np.linspace(0.5, 3.0, d) + np.linspace(-1.0, 4.0, d)
    y = ((X - X.mean(0)) @ np.linspace(1.0, -0.5, d) / 2 + rng.randn(n) > 0)
    folds = np.arange(n) % 3
    W = np.repeat(np.stack([folds != f for f in range(3)]), 8, axis=0)
    regs = np.tile([0.001, 0.001, 0.01, 0.01, 0.1, 0.1, 0.2, 0.2], 3)
    ens = np.tile([0.1, 0.5], 12)
    return X, y.astype(np.float64), W.astype(np.float64), regs, ens


def test_batched_lr_on_the_card_matches_the_cpu(cuda):
    """The 24-candidate fold x grid fit on the card against the CPU:
    float32 sums in other orders, so rtol 1e-4, atol 1e-5 (the LR slice's
    card-against-CPU tolerance)."""
    from transmogrifai_tpu_torch.models.logistic_regression import (
        OpLogisticRegression,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    X, y, W, regs, ens = _lr_batch_inputs(50_000, 11, 3)
    got = OpLogisticRegression(device="cuda").fit_arrays_batched(X, y, W, regs, ens)
    want = OpLogisticRegression(device="cpu").fit_arrays_batched(X, y, W, regs, ens)
    for g, w in zip(got, want):
        assert np.isfinite(g).all()
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-5)


def test_masked_rank_metrics_on_the_card_match_the_cpu(cuda):
    """The bins hold integer counts, exact in any order on the card; only
    the float64 areas over them may round apart."""
    from transmogrifai_tpu_torch.evaluators.binary import masked_rank_metrics

    rng = np.random.RandomState(5)
    B, n = 24, 300_001
    y = torch.from_numpy((rng.rand(n) < 0.4).astype(np.float32))
    scores = torch.from_numpy(
        (rng.randn(B, n) + 1.1 * y.numpy()[None, :]).astype(np.float32))
    vmask = torch.from_numpy((rng.rand(B, n) < 0.33).astype(np.float32))
    got = masked_rank_metrics(scores.to(cuda), y.to(cuda), vmask.to(cuda))
    want = masked_rank_metrics(scores, y, vmask)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-12)


def test_gbt_grid_heaps_are_deterministic_on_the_card(cuda):
    from transmogrifai_tpu_torch.models.trees import OpGBTClassifier

    X, y, W, _, _ = _lr_batch_inputs(120_000, 9, 4)
    W = W[::8]  # the three fold masks
    grid = [{"max_depth": d, "num_trees": 3, "min_info_gain": g}
            for d in (3, 8) for g in (0.001, 0.01)]
    est = OpGBTClassifier(device="cuda")
    runs = [est.fit_arrays_folds_grid(X, y, W, grid) for _ in range(2)]
    for a_grid, b_grid in zip(*runs):
        for a, b in zip(a_grid, b_grid):
            assert a["f0"] == b["f0"]
            for ha, hb in zip(a["heaps"], b["heaps"]):
                np.testing.assert_array_equal(ha, hb)


def test_forest_grid_on_the_card_matches_the_cpu(cuda):
    """A small forest fold x grid fit with per-node feature subsets on the
    card against the CPU (gini counts are integers, exact in any order:
    the heaps equal node for node but for exact split ties, ROADMAP.md
    queue 3), and bit-identical across two card runs."""
    from torch_parity import compare_trees
    from transmogrifai_tpu_torch.models.tree_kernel import bin_data
    from transmogrifai_tpu_torch.models.trees import OpRandomForestClassifier

    X, y, W, _, _ = _lr_batch_inputs(60_000, 9, 6)
    W = W[::8]  # the three fold masks
    grid = [{"max_depth": d, "num_trees": 4, "min_info_gain": g,
             "min_instances_per_node": 10}
            for d in (3, 8) for g in (0.001, 0.01)]
    runs = [OpRandomForestClassifier(device="cuda").fit_arrays_folds_grid(
        X, y, W, grid) for _ in range(2)]
    cpu = OpRandomForestClassifier(device="cpu").fit_arrays_folds_grid(
        X, y, W, grid)
    ties = 0
    for a_grid, b_grid, c_grid in zip(*runs, cpu):
        for a, b, c in zip(a_grid, b_grid, c_grid):
            for ha, hb in zip(a["heaps"], b["heaps"]):
                np.testing.assert_array_equal(ha, hb)
            bins = bin_data(X.astype(np.float32), a["edges"])
            for t in range(a["heaps"][0].shape[0]):
                ties += len(compare_trees([h[t] for h in a["heaps"]],
                                          [h[t] for h in c["heaps"]],
                                          bins, a["max_depth"])[0])
    assert ties <= 4, ties


def test_batched_svc_on_the_card_matches_the_cpu(cuda):
    """The 24-candidate linear SVM fold x grid fit on the card against the
    CPU: rtol 1e-4, atol 1e-5, as the batched LR."""
    from transmogrifai_tpu_torch.models.linear_svc import OpLinearSVC

    torch.backends.cuda.matmul.allow_tf32 = False
    X, y, W, regs, ens = _lr_batch_inputs(50_000, 11, 7)
    got = OpLinearSVC(device="cuda").fit_arrays_batched(X, y, W, regs, ens)
    want = OpLinearSVC(device="cpu").fit_arrays_batched(X, y, W, regs, ens)
    for g, w in zip(got, want):
        assert np.isfinite(g).all()
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-5)


def test_softmax_folds_on_the_card_match_the_cpu(cuda):
    """The 3-fold softmax Newton (K = 3, reg > 0) on the card against the
    CPU: betas within rtol 1e-4, atol 1e-5, intercepts centred across
    classes (never penalized, so fixed only up to a common shift) within
    1e-5, probabilities within 1e-4."""
    from transmogrifai_tpu_torch.models.logistic_regression import (
        OpLogisticRegression,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    X, y, W, _, _ = _lr_batch_inputs(50_000, 11, 8)
    y3 = y + (X[:, 1] > 0.8)  # a third class
    W = W[::8]  # the three fold masks
    kw = dict(reg_param=0.01, elastic_net_param=0.1)
    got = OpLogisticRegression(device="cuda", **kw).fit_arrays_folds(X, y3, W)
    est = OpLogisticRegression(device="cpu", **kw)
    want = est.fit_arrays_folds(X, y3, W)
    for g, w in zip(got, want):
        assert g["family"] == "multinomial" and np.isfinite(g["betas"]).all()
        np.testing.assert_allclose(g["betas"], w["betas"], rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(g["intercepts"] - g["intercepts"].mean(),
                                   w["intercepts"] - w["intercepts"].mean(),
                                   rtol=0, atol=1e-5)
        np.testing.assert_allclose(est.predict_arrays(g, X)[2],
                                   est.predict_arrays(w, X)[2],
                                   rtol=0, atol=1e-4)


def test_batched_linreg_on_the_card_matches_the_cpu(cuda):
    """The 24-candidate linear regression fold x grid fit on the card
    against the CPU: rtol 1e-4, atol 1e-5, as the batched LR."""
    from transmogrifai_tpu_torch.models.linear_regression import (
        OpLinearRegression,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    X, _, W, regs, ens = _lr_batch_inputs(50_000, 11, 9)
    y = X @ np.linspace(-1.0, 1.0, X.shape[1]) + 0.3
    got = OpLinearRegression(device="cuda").fit_arrays_batched(X, y, W, regs, ens)
    want = OpLinearRegression(device="cpu").fit_arrays_batched(X, y, W, regs, ens)
    for g, w in zip(got, want):
        assert np.isfinite(g).all()
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-5)
