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


@pytest.mark.parametrize("n,d", [(200_000, 539), (10_000, 4244)])
def test_fused_moments_kernel_at_wide_main_path_shapes(cuda, n, d):
    """The d > 256 route at the widths of the full-schema passenger design
    (a few numeric columns beside a 512-wide hashed text block) and of the
    type lattice: hash columns are small counts, most of them constant
    zero, and their sums, min, max and variance must come out exact."""
    rng = np.random.RandomState(d)
    x = np.zeros((n, d), np.float32)
    x[:, :20] = (rng.randn(n, 20) * 15.0 + 70.0).astype(np.float32)
    x[:, 20:26] = rng.randint(0, 2, (n, 6))
    words = 26 + rng.choice(d - 27, 20, replace=False)
    for _ in range(4):  # four words a row from a 20-word vocabulary
        x[np.arange(n), words[rng.randint(0, 20, n)]] += 1.0
    x[:, -1] = rng.rand(n) < 0.1
    xt = torch.from_numpy(x).to(cuda)
    yt = torch.from_numpy((rng.rand(n) < 0.4).astype(np.float32)).to(cuda)
    got = tk.fused_moments(xt, yt)
    _assert_moments_match(got, tk.fused_moments_plain(xt, yt))
    zero = np.setdiff1d(np.arange(26, d - 1), words)
    x_sum, x_sq, xy, _, _, x_min, x_max = (t.cpu().numpy() for t in got)
    for m in (x_sum, x_sq, xy, x_min, x_max):
        assert not m[zero].any()
    np.testing.assert_array_equal(x_sum[words], x[:, words].sum(0))
    np.testing.assert_array_equal(x_sq[words], (x[:, words] ** 2).sum(0))


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


# -- the README example --------------------------------------------------------

def test_readme_path_on_the_card_holds_both_kernels(cuda, tmp_path):
    """README.md's example on the card at 20k rows from a CSV: the reader
    takes the native route, train() launches K1 once and K2 for the GBT
    and forest depth groups and the 81 tree validation predictions, every
    call matches its plain version on the inputs the path gave it, and
    summary_pretty() names the winner."""
    import sys

    import transmogrifai_tpu_torch.dsl  # noqa: F401  feature operators
    from transmogrifai_tpu_torch import FeatureBuilder, OpWorkflow
    from transmogrifai_tpu_torch.examples.synthetic import write_readme_csv
    from transmogrifai_tpu_torch.ops.transmogrifier import transmogrify
    from transmogrifai_tpu_torch.readers.csv_reader import CSVReader
    from transmogrifai_tpu_torch.selector.factories import (
        BinaryClassificationModelSelector,
    )
    from transmogrifai_tpu_torch.types import feature_types as ft

    survived = FeatureBuilder(ft.RealNN, "survived").as_response()
    sex = FeatureBuilder(ft.PickList, "sex").as_predictor()
    age = FeatureBuilder(ft.Real, "age").as_predictor()
    fare = FeatureBuilder(ft.Real, "fare").as_predictor()
    normed_age = age.fill_missing_with_mean().z_normalize()
    features = transmogrify([sex, age, fare, normed_age])
    checked = survived.sanity_check(features, remove_bad_features=True)
    prediction = (
        BinaryClassificationModelSelector.with_cross_validation(num_folds=3)
        .set_input(survived, checked)
        .get_output()
    )
    reader = CSVReader(write_readme_csv(str(tmp_path / "t.csv"), 20_000))
    wf = OpWorkflow().set_result_features(prediction).set_reader(reader)

    # keep a copy of every wrapper call's arguments (each module of the
    # package that holds a wrapper by name gets a counting-neutral shim)
    seen = {w.__name__: [] for w in tk.WRAPPERS}
    patched = []
    for mod in list(sys.modules.values()):
        if mod is tk or not getattr(mod, "__name__", "").startswith(
                "transmogrifai_tpu_torch."):
            continue
        for w in tk.WRAPPERS:
            if getattr(mod, w.__name__, None) is w:
                def shim(*args, _w=w):
                    seen[_w.__name__].append(tuple(
                        a.clone() if isinstance(a, torch.Tensor) else a
                        for a in args))
                    return _w(*args)
                setattr(mod, w.__name__, shim)
                patched.append((mod, w))
    tk.reset_launches()
    try:
        model = wf.train()
    finally:
        for mod, w in patched:
            setattr(mod, w.__name__, w)
    assert reader.route == "native"
    assert tk.fused_moments.launches == len(seen["fused_moments"]) == 1
    assert tk.bin_matrix.launches == len(seen["bin_matrix"]) >= 3 + 3 + 27 + 54
    for x, y in seen["fused_moments"]:
        assert x.is_cuda
        _assert_moments_match(tk.fused_moments(x, y),
                              tk.fused_moments_plain(x, y))
    for x, edges, dtype in seen["bin_matrix"]:
        assert x.is_cuda
        assert torch.equal(tk.bin_matrix(x, edges, dtype),
                           tk.bin_matrix_plain(x, edges, dtype))
    summary = model.summary_pretty()
    (chosen,) = [s for s in model.stages
                 if type(s).__name__ == "SelectedModel"]
    best = chosen.metadata["model_selector_summary"]["best_model_type"]
    assert f"Selected model {best}" in summary


def test_torch_fused_forest_scores_on_card_through_k2(cuda, tmp_path,
                                                      monkeypatch):
    """The README front and a 20-tree forest, trained on the card, saved
    and loaded: the loaded model's torch-fused scorer runs on the card,
    launches K2 once per batch, and its rows equal the numpy-fused
    scorer's bit for bit on the C++ walk, and within a float32 ULP on the
    numpy walk (which divides the tree sum by T, not times float32 1/T)."""
    import transmogrifai_tpu_torch.dsl  # noqa: F401  feature operators
    from transmogrifai_tpu_torch import FeatureBuilder, OpWorkflow
    from transmogrifai_tpu_torch.examples.synthetic import write_readme_csv
    from transmogrifai_tpu_torch.models.trees import OpRandomForestClassifier
    from transmogrifai_tpu_torch.ops.transmogrifier import transmogrify
    from transmogrifai_tpu_torch.readers.csv_reader import CSVReader
    from transmogrifai_tpu_torch.types import feature_types as ft

    path = write_readme_csv(str(tmp_path / "t.csv"), 3000)

    def build():
        survived = FeatureBuilder(ft.RealNN, "survived").as_response()
        sex = FeatureBuilder(ft.PickList, "sex").as_predictor()
        age = FeatureBuilder(ft.Real, "age").as_predictor()
        fare = FeatureBuilder(ft.Real, "fare").as_predictor()
        vec = transmogrify([sex, age, fare,
                            age.fill_missing_with_mean().z_normalize()])
        checked = survived.sanity_check(vec, remove_bad_features=True)
        pred = OpRandomForestClassifier(num_trees=20, max_depth=8) \
            .set_input(survived, checked).get_output()
        return OpWorkflow().set_result_features(pred) \
            .set_reader(CSVReader(path))

    from transmogrifai_tpu_torch.workflow.workflow import OpWorkflowModel

    build().train().save(str(tmp_path / "m"))
    model = OpWorkflowModel.load(str(tmp_path / "m"), build())
    assert model.device == "cuda"
    reader = CSVReader(path)
    data = reader.generate_dataset(model.raw_features)
    names = [f.name for f in model.raw_features if not f.is_response]
    cols = [data[n].to_list() for n in names]
    records = [dict(zip(names, row)) for row in zip(*cols)][:777]
    fused = model.score_function(drift_policy=None)
    assert fused.fused_backend == "torch" and fused.fused_reason is None
    assert fused.fused.device.type == "cuda"
    npf = model.score_function(drift_policy=None, fused_backend="numpy")
    tk.reset_launches()
    batches = [records[i: i + 100] for i in range(0, len(records), 100)]
    got = [row for b in batches for row in fused.score_batch(b)]
    assert tk.bin_matrix.launches == len(batches)
    from torch_parity import assert_rows_close

    from transmogrifai_tpu_torch.models import native_trees

    assert got == [row for b in batches for row in npf.score_batch(b)]
    monkeypatch.setattr(native_trees, "predict_forest", lambda *a, **k: None)
    assert_rows_close(got, [row for b in batches for row in npf.score_batch(b)],
                      1, unit=np.float32)


# -- the remaining model families (GLM, MLP, LDA) and LOCO -----------------------

def _family_data(n=20_000, d=9, seed=5):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, d)
    z = X @ np.linspace(0.6, -0.4, d) * 0.5
    return X, z, rng


@pytest.mark.parametrize("family,kw", [
    ("gaussian", {}), ("poisson", {}), ("gamma", {}), ("binomial", {}),
    ("tweedie", {"link_power": 0.0}), ("tweedie", {"link_power": -0.5})])
def test_glm_on_the_card_matches_the_cpu(cuda, family, kw):
    """IRLS on the card against the CPU, folds batched: betas within rtol
    1e-4, atol 1e-5 (the CV means are held at rtol 1e-5 by chip_smoke.py)."""
    from transmogrifai_tpu_torch.models.glm import OpGeneralizedLinearRegression

    torch.backends.cuda.matmul.allow_tf32 = False
    X, z, rng = _family_data()
    mu = np.exp(z)
    y = {"gaussian": z + 0.3 * rng.randn(len(z)),
         "binomial": (rng.rand(len(z)) < 1 / (1 + np.exp(-z))).astype(float),
         "gamma": rng.gamma(2.0, mu / 2.0)}.get(family, rng.poisson(mu) * 1.0)
    W = (np.arange(len(y))[None, :] % 3 != np.arange(3)[:, None]).astype(float)
    got = OpGeneralizedLinearRegression(family=family, reg_param=0.01,
                                        device="cuda", **kw)
    want = OpGeneralizedLinearRegression(family=family, reg_param=0.01,
                                         device="cpu", **kw)
    for g, w in zip(got.fit_arrays_folds(X, y, W),
                    want.fit_arrays_folds(X, y, W)):
        assert np.isfinite(g["beta"]).all()
        np.testing.assert_allclose(g["beta"], w["beta"], rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(g["intercept"], w["intercept"], rtol=1e-4,
                                   atol=1e-5)


def test_mlp_on_the_card_matches_the_cpu(cuda):
    """Full-batch Adam on the card against the CPU, three folds batched.
    After 10 steps the layers and probabilities agree within 1e-5; after
    100 the probabilities within 2e-2 and each fold's AuROC within 1e-3:
    Adam turns the float32 sums' other order into sign-like steps where a
    gradient is near zero, and the two devices' weights part (on an H100,
    2e-3 to 8e-3 after 100 steps at 20k rows, as far apart as one device's
    row-chunked and unchunked fits)."""
    from transmogrifai_tpu_torch.evaluators.binary import _roc_pr_areas
    from transmogrifai_tpu_torch.models.mlp import (
        OpMultilayerPerceptronClassifier,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    X, z, rng = _family_data()
    y = (z + 0.5 * rng.randn(len(z)) > 0).astype(float)
    W = (np.arange(len(y))[None, :] % 3 != np.arange(3)[:, None]).astype(float)
    for steps, atol in ((10, 1e-5), (100, 2e-2)):
        kw = dict(hidden_layers=(10, 10), max_iter=steps)
        got = OpMultilayerPerceptronClassifier(device="cuda", **kw)
        want = OpMultilayerPerceptronClassifier(device="cpu", **kw)
        for f, (g, w) in enumerate(zip(got.fit_arrays_folds(X, y, W),
                                       want.fit_arrays_folds(X, y, W))):
            if steps == 10:
                for (Wg, bg), (Ww, bw) in zip(g["layers"], w["layers"]):
                    np.testing.assert_allclose(Wg, Ww, atol=atol)
                    np.testing.assert_allclose(bg, bw, atol=atol)
            val = W[f] == 0
            pg = got.predict_arrays(g, X[val])[2][:, 1]
            pw = want.predict_arrays(w, X[val])[2][:, 1]
            np.testing.assert_allclose(pg, pw, atol=atol)
            assert abs(_roc_pr_areas(y[val], pg)[0]
                       - _roc_pr_areas(y[val], pw)[0]) <= 1e-3


def test_lda_on_the_card_matches_the_cpu(cuda):
    """Variational EM on the card against the CPU: topics and inferred
    mixtures within rtol 1e-4."""
    from transmogrifai_tpu_torch.models import unsupervised as uns

    rng = np.random.RandomState(0)
    counts = rng.poisson(0.3, size=(2000, 200)).astype(np.float32)
    init = uns.initial_topics(42, 10, 200)
    got, want = (uns.lda_em_core(torch.tensor(counts, device=dev),
                                 torch.tensor(init, device=dev), 1.1, 1.01,
                                 iters=10).cpu().numpy()
                 for dev in (cuda, torch.device("cpu")))
    np.testing.assert_allclose(got, want, rtol=1e-4)


def test_loco_zero_out_passes_launch_k2_equal_to_plain(cuda):
    """RecordInsightsLOCO over a forest on the card: one K2 launch per
    zero-out pass plus the base pass, each equal to its plain version."""
    from transmogrifai_tpu_torch.features.feature_builder import FeatureBuilder
    from transmogrifai_tpu_torch.insights.loco import RecordInsightsLOCO
    from transmogrifai_tpu_torch.models.base import PredictorModel
    from transmogrifai_tpu_torch.models.trees import OpRandomForestClassifier
    from transmogrifai_tpu_torch.types.columns import VectorColumn
    from transmogrifai_tpu_torch.types.dataset import Dataset
    from transmogrifai_tpu_torch.types.vector_metadata import (
        VectorColumnMeta, VectorMetadata,
    )

    X, z, rng = _family_data(n=3000, d=7)
    y = (z + 0.5 * rng.randn(len(z)) > 0).astype(float)
    est = OpRandomForestClassifier(num_trees=5, max_depth=5, device="cuda")
    model = PredictorModel(est, est.fit_arrays(X, y))
    meta = VectorMetadata("vec", tuple(
        VectorColumnMeta("vec", "OPVector", descriptor_value=f"x{j}")
        for j in range(7))).reindexed()
    kept = []
    real = tk.bin_matrix

    def keep(x, e, dtype):
        kept.append((x.clone(), e.clone(), dtype))
        return real(x, e, dtype)

    import transmogrifai_tpu_torch.models.trees as trees_mod

    trees_mod.bin_matrix = keep
    try:
        stage = RecordInsightsLOCO(model, top_k=3)
        feat = stage.set_input(FeatureBuilder.OPVector("vec")
                               .as_predictor()).get_output()
        stage.transform(Dataset({"vec": VectorColumn(X.astype(np.float32),
                                                     meta)}))[feat.name]
    finally:
        trees_mod.bin_matrix = real
    assert len(kept) == 7 + 1
    for x, e, dtype in kept:
        assert torch.equal(tk.bin_matrix(x, e, dtype),
                           tk.bin_matrix_plain(x, e, dtype))


@pytest.mark.parametrize("chunk_bytes", [4096, 1 << 20])
def test_device_csv_ingest_on_the_card_equals_the_cpu_route(cuda, tmp_path,
                                                            chunk_bytes):
    """``DeviceCSVIngest`` through pinned copies on a side stream: X, mask
    and rows on the card bit-equal to the ``device="cpu"`` route, over
    many small chunks and one large one; a header-only file gives
    zero-row tensors on the card."""
    from transmogrifai_tpu_torch.examples.synthetic import write_readme_csv
    from transmogrifai_tpu_torch.readers.fast_csv import DeviceCSVIngest
    from transmogrifai_tpu_torch.types import feature_types as ft

    path = write_readme_csv(str(tmp_path / "p.csv"), 20_000)
    cols = ["survived", "age", "fare"]
    schema = {"survived": ft.RealNN, "age": ft.Real, "fare": ft.Real}
    got = DeviceCSVIngest(path, cols, schema, chunk_bytes=chunk_bytes,
                          device="cuda").to_device()
    want = DeviceCSVIngest(path, cols, schema, chunk_bytes=chunk_bytes,
                           device="cpu").to_device()
    assert got[0].device.type == got[1].device.type == "cuda"
    assert got[2] == want[2] == 20_000
    assert torch.equal(got[0].cpu(), want[0])
    assert torch.equal(got[1].cpu(), want[1])
    assert not bool(want[1][:, 1].all())          # ages are missing
    header = tmp_path / "h.csv"
    header.write_text("survived,age,fare\n")
    X, M, rows = DeviceCSVIngest(str(header), cols, schema).to_device()
    assert X.device.type == "cuda" and X.shape == (0, 3) and rows == 0


def test_device_design_matrix_is_made_on_the_card(cuda):
    """``synthetic_design_matrix_device`` on the card: X [n, 7 + text_dims]
    float32 there, y float64 on the host, the host generator's metadata,
    one gender a row, Poisson counts, seeded."""
    from transmogrifai_tpu_torch.examples import synthetic

    X, y, meta = synthetic.synthetic_design_matrix_device(100_000,
                                                          text_dims=8)
    assert X.device.type == "cuda" and X.dtype == torch.float32
    assert tuple(X.shape) == (100_000, 15)
    assert isinstance(y, np.ndarray) and y.dtype == np.float64
    host_meta = synthetic.synthetic_design_matrix(10, text_dims=8)[2]
    assert [c.column_name() for c in meta.columns] \
        == [c.column_name() for c in host_meta.columns]
    assert bool((X[:, 4:7].sum(dim=1) == 1).all())
    assert bool((X[:, 7:] == X[:, 7:].round()).all())
    assert abs(float(X[:, 7:].mean()) - 0.15) < 0.01
    X2, y2, _ = synthetic.synthetic_design_matrix_device(100_000, text_dims=8)
    assert torch.equal(X, X2) and np.array_equal(y, y2)


def test_fused_lr_training_on_the_card_equals_the_existing_path(cuda):
    """The fused training program of the LR grid on the card (the bitwise
    fixed-point Newton, the gathered-row scoring, the exact device rank
    metrics) against the kernel-at-a-time path on the card at 50k rows:
    betas bit-equal, fold metrics within 1e-9, the same winner."""
    from transmogrifai_tpu_torch.evaluators.binary import (
        OpBinaryClassificationEvaluator,
    )
    from transmogrifai_tpu_torch.examples.synthetic import (
        synthetic_design_matrix,
    )
    from transmogrifai_tpu_torch.local import fused_train
    from transmogrifai_tpu_torch.models.logistic_regression import (
        OpLogisticRegression,
    )
    from transmogrifai_tpu_torch.selector import validator as val
    from transmogrifai_tpu_torch.selector.factories import lr_grid

    torch.set_float32_matmul_precision("highest")
    X, y, _ = synthetic_design_matrix(50_000, text_dims=32, seed=0)
    X = np.asarray(X, np.float64)
    y = np.asarray(y)
    est, grid, ev = OpLogisticRegression(), lr_grid(), \
        OpBinaryClassificationEvaluator()
    runs = {}
    for fused in (False, True):
        cv = val.OpCrossValidation(num_folds=3, evaluator=ev, stratify=True)
        cv.train_fused = fused
        runs[fused] = cv.validate([(est, grid)], X, y)
    fam = runs[True].train_fused["families"]["OpLogisticRegression"]
    assert (fam["backend"], fam["mode"]) == ("fused", "exact")
    assert runs[True].best_params == runs[False].best_params
    for a, b in zip(runs[True].all_results, runs[False].all_results):
        assert np.abs(np.subtract(a["fold_metrics"],
                                  b["fold_metrics"])).max() <= 1e-9
    masks = val.stratified_kfold_masks(y, 3, 42, True)
    regs_g, ens_g = val.lr_grid_scalars(est, grid)
    regs, ens = np.tile(regs_g, 3), np.tile(ens_g, 3)
    Xd = torch.tensor(X, dtype=torch.float32, device=cuda)
    res = fused_train.run_linear(est, Xd, y, masks, np.ones(len(y)), False,
                                 regs, ens, len(grid), ev, "exact")
    W = torch.as_tensor(masks, device=cuda).to(torch.float32) \
        .repeat_interleave(len(grid), dim=0)
    betas, b0s = est.fit_arrays_batched(
        Xd, torch.tensor(y, dtype=torch.float32, device=cuda), W, regs, ens)
    np.testing.assert_array_equal(res.betas, betas)
    np.testing.assert_array_equal(res.b0s, b0s)
