"""The card's peaks and the hand kernels' least times.

Frozen copies of ``chip_smoke.py``'s ``moments_bound_ms`` and
``bin_bound_ms``: the bytes and operations that a call needs, counted from
its shapes (each input byte read once, each output byte written once), at
the published peaks of one NVIDIA H100 SXM (3.35 TB/s of HBM, 67 TFLOP/s
in float32 outside the tensor cores).  The bytes bound wins at every shape
the cells run.
"""
from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12


def moments_bound_ms(n: int, d: int) -> float:
    """K1 ``fused_moments``: read x [n, d] and y [n] once, write 5d + 2
    floats; 8 operations per element (3 multiply-adds counted as two
    each, 2 compares)."""
    bytes_ = 4 * n * (d + 1) + 4 * (5 * d + 2)
    ops = 8 * n * d
    return 1e3 * max(bytes_ / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S)


def bin_bound_ms(n: int, d: int, n_edges: int, out_bytes: int) -> float:
    """K2 ``bin_matrix``: read x [n, d] once, write the bins once, read the
    edges [d, n_edges]; n * d * n_edges compares."""
    bytes_ = 4 * n * d + out_bytes * n * d + 4 * d * n_edges
    return 1e3 * max(bytes_ / HBM_BYTES_PER_S,
                     n * d * n_edges / FP32_OPS_PER_S)


def is_k1_kernel(name: str) -> bool:
    """Device events of K1 (``csrc/fused_moments.cu``): its tile and slab
    kernels; the empty launch of ``*_floor`` is not K1's work."""
    return "moments_tiles_kernel" in name or "moments_slabs_kernel" in name


def is_k2_kernel(name: str) -> bool:
    """Device events of K2 (``csrc/bin_matrix.cu``): its ring, small and
    column-tile kernels."""
    return any(k in name for k in ("bin_tiles_kernel", "bin_small_kernel",
                                   "bin_coltile_kernel"))
