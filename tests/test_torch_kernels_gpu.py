"""The torch package's CUDA kernels on the card, against their plain torch
versions.  A hand-written kernel has no CPU mode, so every test here is
marked ``gpu`` and skips without a CUDA device.  This file imports neither
jax nor the JAX package, so it also runs where only torch is installed:

    python -m pytest --noconftest -m gpu tests/test_torch_kernels_gpu.py

Tolerances: sums rtol 3e-5, atol 3e-3 (the JAX package's Pallas test
tolerance; both sides sum float32 in different orders), min/max exact and
NaN-equal.
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
