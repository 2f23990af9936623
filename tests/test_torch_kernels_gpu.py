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


def test_fused_moments_kernel_is_deterministic(cuda):
    x, y = _inputs(300_007, 39, 1, cuda)
    first = [t.clone() for t in tk.fused_moments(x, y)]
    again = tk.fused_moments(x, y)
    assert all(torch.equal(a, b) for a, b in zip(first, again))


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
