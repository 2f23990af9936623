"""bin_matrix of the torch package against the JAX package's.

The torch package's ``bin_matrix`` runs its plain torch version on a CPU
tensor; here it is held against the JAX package's Pallas kernel in
interpret mode (``force_pallas=True``, as tests/test_pallas_kernels.py
runs it) and against ``np.searchsorted(side='left')``.  Bins are integers
and must be exactly equal, NaN values and NaN edges included, in both
output dtypes.  The CUDA kernel itself runs only on the card:
``chip_smoke.py`` and tests/test_torch_kernels_gpu.py hold it against the
same plain version.
"""
import numpy as np
import pytest
import torch

from transmogrifai_tpu.models.tree_kernel import quantile_bin_edges
from transmogrifai_tpu.parallel import pallas_kernels as pk
from transmogrifai_tpu_torch.parallel import kernels as tk

pytestmark = pytest.mark.skipif(not pk.HAS_PALLAS, reason="pallas unavailable")


def _inputs(n, d, max_bins, seed, nan_col=True):
    rng = np.random.RandomState(seed)
    x = (rng.randn(n, d) * 2.0).astype(np.float32)
    if nan_col:
        x[::13, d // 2] = np.nan  # NaN x ranks after every non-NaN edge
    edges = quantile_bin_edges(x, max_bins)  # the NaN column's are all NaN
    return x, edges


def _searchsorted(x, edges):
    return np.stack(
        [np.searchsorted(edges[j], x[:, j], side="left")
         for j in range(x.shape[1])], axis=1)


def _torch_bins(x, edges, dtype):
    return tk.bin_matrix(torch.from_numpy(x), torch.from_numpy(edges), dtype)


@pytest.mark.parametrize("n,d", [(200, 9), (600, 19), (513, 129)])
@pytest.mark.parametrize("max_bins", [16, 32, 255])
def test_bin_matrix_matches_pallas_and_searchsorted(n, d, max_bins):
    x, edges = _inputs(n, d, max_bins, seed=n + max_bins)
    assert np.isnan(edges[d // 2]).all()  # an all-NaN edge row
    want = np.asarray(pk.bin_matrix(x, edges, force_pallas=True))
    np.testing.assert_array_equal(want, _searchsorted(x, edges))
    dtype = torch.int8 if max_bins <= 127 else torch.int32
    got = _torch_bins(x, edges, dtype)
    assert got.dtype == dtype and tuple(got.shape) == (n, d)
    np.testing.assert_array_equal(got.numpy().astype(np.int32), want)
    np.testing.assert_array_equal(
        _torch_bins(x, edges, torch.int32).numpy(), want)


def test_bin_matrix_nan_values_and_edges():
    """NaN x with partly-NaN edge rows: the count of non-NaN edges."""
    rng = np.random.RandomState(9)
    x = rng.randn(300, 5).astype(np.float32)
    x[::4, :] = np.nan
    edges = np.sort(rng.randn(5, 31), axis=1).astype(np.float32)
    edges[1, 20:] = np.nan  # NaN edges sit at the tail, as np.sort puts them
    edges[3, :] = np.nan
    want = np.asarray(pk.bin_matrix(x, edges, force_pallas=True))
    got = _torch_bins(x, edges, torch.int8).numpy().astype(np.int32)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, _searchsorted(x, edges))
    assert set(got[::4, 1]) == {20} and set(got[:, 3]) == {0}


def _special_edges(x, edges):
    """Edge rows the kernel's binary search must not take, or must take
    exactly, cycling over the columns: reversed (unsorted), a NaN in the
    middle, duplicates, -inf/-0.0/0.0 at the front, +inf at the end; and
    x values +-0.0 and +-inf in the columns beside them."""
    x, edges = x.copy(), edges.copy()
    d, n_edges = edges.shape
    for j in range(d):
        row = edges[j]
        kind = j % 5
        if kind == 0:
            edges[j] = row[::-1]
        elif kind == 1:
            row[n_edges // 2] = np.nan
        elif kind == 2:
            row[3:9] = row[3]
        elif kind == 3:
            row[:3] = (-np.inf, -0.0, 0.0)
            edges[j] = np.sort(row)
        else:
            row[-1] = np.inf
    x[::3, d // 3] = -0.0
    x[1::3, d // 3] = 0.0
    x[::4, (2 * d) // 3] = np.inf
    x[1::4, (2 * d) // 3] = -np.inf
    return x, np.ascontiguousarray(edges)


@pytest.mark.parametrize("kind", ["quantile", "special"])
@pytest.mark.parametrize(
    "n,d,off",
    [(1, 1, 0), (17, 4, 1), (33, 9, 3), (4097, 39, 1), (70_001, 1, 3),
     (257, 257, 0), (17, 1100, 1)],
)
def test_bin_matrix_redesign_cases(n, d, off, kind):
    """The shapes and edge rows the kernel treats apart - one row, rows
    just past a multiple of 16, more than 2^16 rows, one column, rows
    wider than the block's lanes - on row-offset views x[off:] (a storage
    offset the kernel takes without copying)."""
    x, edges = _inputs(n + off, d, 32, seed=3 * n + d, nan_col=d > 2)
    if kind == "special":
        x, edges = _special_edges(x, edges)
    x = x[off:]
    want = np.asarray(pk.bin_matrix(x, edges, force_pallas=True))
    for dtype in (torch.int8, torch.int32):
        got = _torch_bins(x, edges, dtype)
        assert got.dtype == dtype and tuple(got.shape) == (n, d)
        np.testing.assert_array_equal(got.numpy().astype(np.int32), want)


def test_bin_matrix_chunked_plain_route(monkeypatch):
    """The plain version's row chunks (cap shrunk to force many) agree
    with the unchunked reference, as test_pallas_kernels'
    test_bin_matrix_jnp_fallback_chunked_parity holds the jnp fallback."""
    x, edges = _inputs(1000, 37, 32, seed=4)
    want = np.asarray(pk.bin_matrix(x, edges, force_pallas=False))
    monkeypatch.setattr(tk, "_BIN_CHUNK_ELEMS", 37 * 31 * 7)  # 7-row blocks
    got = _torch_bins(x, edges, torch.int32).numpy()
    np.testing.assert_array_equal(got, want)


def test_bin_matrix_rejects_bad_input():
    x, edges = _inputs(50, 4, 32, seed=1, nan_col=False)
    xt, et = torch.from_numpy(x), torch.from_numpy(edges)
    with pytest.raises(TypeError):
        tk.bin_matrix(xt.double(), et)
    with pytest.raises(ValueError, match="edges"):
        tk.bin_matrix(xt, et[:3])
    with pytest.raises(ValueError, match="n >= 1"):
        tk.bin_matrix(xt[:0], et)
    with pytest.raises(TypeError, match="int8 or int32"):
        tk.bin_matrix(xt, et, torch.int64)
    _, wide = _inputs(50, 4, 255, seed=1, nan_col=False)
    with pytest.raises(ValueError, match="126 edges"):
        tk.bin_matrix(xt, torch.from_numpy(wide), torch.int8)


def test_bin_matrix_on_another_device_raises():
    """A tensor on neither the CPU nor a CUDA card is refused: the plain
    version runs only for a CPU tensor."""
    x, edges = _inputs(50, 4, 32, seed=2, nan_col=False)
    xm = torch.from_numpy(x).to("meta")
    em = torch.from_numpy(edges).to("meta")
    with pytest.raises(ValueError, match="unsupported device"):
        tk.bin_matrix(xm, em, torch.int8)


def test_bin_matrix_on_route_launches_on_the_card_only():
    """The forced-route seam has no plain version: on a CPU tensor it
    raises, as the empty-launch floors do."""
    x = torch.zeros((4, 3))
    edges = torch.zeros((3, 5))
    with pytest.raises(ValueError, match="CUDA"):
        tk.bin_matrix_on_route(x, edges, torch.int8, "small")
