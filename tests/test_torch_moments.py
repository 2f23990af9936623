"""fused_moments of the torch package against the JAX package's.

The torch package's ``fused_moments`` runs its plain torch version on a CPU
tensor; here it is held against the JAX package's Pallas kernel in
interpret mode (``force_pallas=True``, as tests/test_pallas_kernels.py
runs it).  Sums agree within rtol 3e-5, atol 3e-3 (both sum float32 in
different orders); min/max are exact, NaN included.  The CUDA kernel
itself runs only on the card: ``chip_smoke.py`` and
tests/test_torch_kernels_gpu.py hold it against the same plain version.
"""
import numpy as np
import pytest
import torch

from transmogrifai_tpu.parallel import pallas_kernels as pk
from transmogrifai_tpu_torch.parallel import kernels as tk

pytestmark = pytest.mark.skipif(not pk.HAS_PALLAS, reason="pallas unavailable")

RTOL, ATOL = 3e-5, 3e-3


def _inputs(n, d, seed, nan_col=None):
    rng = np.random.RandomState(seed)
    x = (rng.randn(n, d) * 3.0 + 1.0).astype(np.float32)
    y = rng.rand(n).astype(np.float32)
    if nan_col is not None:
        x[:: 7, nan_col] = np.nan
    return x, y


def _assert_moments_equal(got, want):
    got = [np.asarray(v, dtype=np.float64) for v in got]
    want = [np.asarray(v, dtype=np.float64) for v in want]
    assert len(got) == len(want) == 7
    for a, b in zip(got[:5], want[:5]):
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL)
    for a, b in zip(got[5:], want[5:]):
        np.testing.assert_array_equal(a, b)  # NaN-equal, exact


def _torch_moments(x, y):
    out = tk.fused_moments(torch.from_numpy(x), torch.from_numpy(y))
    return [v.numpy() for v in out]


@pytest.mark.parametrize(
    "n,d,nan_col",
    [(100, 7, None), (512, 128, None), (1000, 37, None), (513, 129, None),
     (1000, 37, 5)],
)
def test_fused_moments_matches_pallas(n, d, nan_col):
    x, y = _inputs(n, d, seed=n + d, nan_col=nan_col)
    want = pk.fused_moments(x, y, force_pallas=True)
    _assert_moments_equal(_torch_moments(x, y), want)


@pytest.mark.parametrize(
    "n,d,off",
    [(1, 1, 0), (1, 39, 0), (17, 4, 1), (33, 9, 3), (4097, 39, 1),
     (70_001, 1, 3), (70_001, 9, 0), (257, 257, 1), (129, 1100, 3),
     (1, 538, 0), (33, 4244, 1), (2049, 513, 3), (3, 512, 1)],
)
def test_fused_moments_redesign_cases(n, d, off):
    """The shapes the kernel treats apart - one row, rows just past a
    multiple of 16, more than 2^16 rows, d on either side of the block's
    256 lanes and of the wide route's column slabs (512 is two slabs of
    256, 513 three of 171, 538 three of 180, 4 244 seventeen of 250) - on
    row-offset views x[off:] (a storage offset the kernel takes without
    copying), with a NaN column where d allows."""
    x, y = _inputs(n + off, d, seed=7 * n + d, nan_col=d // 2 if d > 2 else None)
    x, y = x[off:], y[off:]
    want = pk.fused_moments(x, y, force_pallas=True)
    got = tk.fused_moments(torch.from_numpy(x), torch.from_numpy(y))
    assert got[0].shape == (d,)
    _assert_moments_equal([v.numpy() for v in got], want)


def test_fused_moments_chunked_combine(monkeypatch):
    """Above _CHUNK_ROWS both sides split the sweep and combine the
    partials in float64; the threshold is shrunk on both sides."""
    monkeypatch.setattr(pk, "_CHUNK_ROWS", 257)
    monkeypatch.setattr(tk, "_CHUNK_ROWS", 257)
    x, y = _inputs(1000, 13, seed=3, nan_col=4)
    want = pk.fused_moments(x, y, force_pallas=True)
    _assert_moments_equal(_torch_moments(x, y), want)


def test_fused_moments_shapes_and_types():
    x, y = _inputs(9, 3, seed=1)
    out = tk.fused_moments(torch.from_numpy(x), torch.from_numpy(y))
    assert [tuple(v.shape) for v in out] == [(3,)] * 3 + [()] * 2 + [(3,)] * 2
    assert all(v.dtype == torch.float32 for v in out)
    with pytest.raises(TypeError):
        tk.fused_moments(torch.from_numpy(x).double(), torch.from_numpy(y))
    with pytest.raises(ValueError):
        tk.fused_moments(torch.from_numpy(x), torch.from_numpy(y[:-1]))
    with pytest.raises(ValueError):
        tk.fused_moments(torch.zeros((0, 3)), torch.zeros(0))


class _ScratchEntry:
    """A stand-in for the moments C entry: it needs ``need`` (partial
    doubles, counters) and, like the entry, reports them without
    launching where the buffers it is given are shorter."""

    def __init__(self, need):
        self.need, self.calls, self.launches = need, 0, 0

    def tx_fused_moments(self, *args):
        self.calls += 1
        partial_doubles, n_counters = args[5], args[7]
        if partial_doubles < self.need[0] or n_counters < self.need[1]:
            args[10]._obj.value, args[11]._obj.value = self.need
            return tk._MOMENTS_ERR_SCRATCH
        self.launches += 1
        return 0


@pytest.mark.parametrize("needs,calls", [
    ([(70, 1)], [2]),
    ([(70, 1), (70, 1), (14, 1)], [2, 1, 1]),
    ([(7 * 300, 4), (70, 8), (7 * 400, 2)], [2, 2, 2]),
])
def test_moments_scratch_grows_to_the_plan_and_is_kept(monkeypatch, needs,
                                                       calls):
    """The wrapper keeps a stream's scratch and crosses into the C entry
    once a launch while the scratch is large enough; a launch that needs
    more is told so without launching, and the scratch grows (never
    shrinks) to the larger need before it launches once."""
    monkeypatch.setattr(tk, "_scratch", {})
    x, y = torch.zeros((4, 2)), torch.zeros(4)
    out = torch.empty(12)
    most = [0, 0]
    for need, want_calls in zip(needs, calls):
        lib = _ScratchEntry(need)
        assert tk._launch_moments(lib, x, y, out, stream=7) == 0
        assert (lib.calls, lib.launches) == (want_calls, 1)
        most = [max(most[0], need[0]), max(most[1], need[1])]
        partial, counter = tk._scratch[(x.device.index, 7)]
        assert (partial.numel(), counter.numel()) == tuple(most)
        assert partial.dtype == torch.float64 and not counter.any()


def test_library_path_covers_included_headers(tmp_path, monkeypatch):
    """A kernel's library is named by the hash of its source and of every
    csrc header the source includes, so that editing a header rebuilds
    every kernel that includes it."""
    for src in tk.CSRC.glob("*.cu*"):
        (tmp_path / src.name).write_bytes(src.read_bytes())
    monkeypatch.setattr(tk, "CSRC", tmp_path)
    names = [p.name for p in tk._sources("fused_moments")]
    assert names == ["fused_moments.cu", "tile_ring.cuh"]
    before = {k: tk._lib_path(k) for k in tk.KERNELS}
    header = tmp_path / "tile_ring.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    after = {k: tk._lib_path(k) for k in tk.KERNELS}
    assert all(before[k] != after[k] for k in tk.KERNELS)
    assert after == {k: tk._lib_path(k) for k in tk.KERNELS}  # stable
