"""Newton iteration helpers shared by the linear-model kernels.

Counterpart of the loop and safety pieces of
``transmogrifai_tpu/models/packed_newton.py``: ``run_newton`` (its
fixed-length scan form), ``pd_jitter`` and ``guarded_step``, plus
``solve_pos``, the positive-definite solve the JAX package gets from
``jax.scipy.linalg.solve(..., assume_a="pos")``.

The batched helpers of the cross-validation fan-out are here too:
``guarded_step`` with a per-candidate ``axis``, ``_batched_diag``, and
``solve_pos`` over a leading batch axis, each candidate's NaN on its own.
So is the class-pair Gram of the softmax Hessian, ``_gram_2d``, with its
row-chunk budget ``_gram_chunk_rows`` (``TX_PACKED_GRAM_ELEMS``): plain
matmuls, as the JAX package computes them outside any Pallas kernel.
The JAX package's MXU-packed CV Gram (``lr_fit_batched_packed*``,
``use_packed``) is a TPU-only route - off the TPU it takes the vmap
route this package mirrors - and its bitwise fixed-point early exit
(``newton_fixed_point``) belongs to the fused training programs
(ROADMAP.md queue 1, item 9).
"""
from __future__ import annotations

import os

import torch


def _gram_chunk_rows(n: int, B: int, d: int) -> int:
    """Rows per Gram chunk: the [c, B*d] packed temporary stays within an
    element budget (``TX_PACKED_GRAM_ELEMS``, default 2^27 elements =
    512 MiB of float32), the JAX package's rule."""
    budget = int(os.environ.get("TX_PACKED_GRAM_ELEMS", 1 << 27))
    c = max(128, budget // max(B * d, 1))
    return min(n, c - (c % 8))


def _gram_2d(Xh: torch.Tensor, wt_nB: torch.Tensor) -> torch.Tensor:
    """Packed weighted Gram [d, B*d]: column b*d+j holds
    X^T diag(wt[:, b]) X[:, j].  ``Xh`` [n, d], ``wt_nB`` [n, B] in one
    float dtype.  Row-chunked so that the [c, B*d] packed temporary stays
    within ``_gram_chunk_rows``' budget; the chunks' partial Grams add in
    row order."""
    n, d = Xh.shape
    B = wt_nB.shape[1]
    c = _gram_chunk_rows(n, B, d)
    G = None
    for s in range(0, n, c):
        Xc, Wc = Xh[s:s + c], wt_nB[s:s + c]
        part = Xc.T @ (Wc[:, :, None] * Xc[:, None, :]).reshape(-1, B * d)
        G = part if G is None else G + part
    return G


def run_newton(step, init, length: int):
    """``carry = step(carry)`` for exactly ``length`` iterations: the
    JAX package's ``lax.scan`` of the step, as a Python loop.  The loop
    never reads a value back to the host, so on the card every iteration
    only enqueues work."""
    carry = init
    for _ in range(length):
        carry = step(carry)
    return carry


def pd_jitter(s_curv, dim: int, base: float = 1e-9):
    """PD-safety ridge for the Newton solves.  ``s_curv`` = trace(H)/dim,
    the mean curvature: the ridge is relative to it and grows with the
    matrix dimension (float32 Cholesky rounding ~eps*dim*||H||).  The JAX
    package's extra slack for a bf16 Gram is a TPU-only choice; the Gram
    here is float32."""
    return base + (1e-6 + 1.2e-7 * dim) * s_curv


def solve_pos(H: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Solve ``H x = g`` for a symmetric positive-definite ``H`` [..., d, d]
    and ``g`` [..., d] by Cholesky.  A factorisation that fails (H not PD)
    gives an all-NaN result for that system alone, as the JAX package's
    (vmapped) solve does, instead of raising as ``torch.linalg.cholesky``
    and ``torch.linalg.solve`` would; the check stays on the device, so the
    Newton loop never waits for the host."""
    L, info = torch.linalg.cholesky_ex(H)
    x = torch.cholesky_solve(g.unsqueeze(-1), L).squeeze(-1)
    ok = (info == 0).unsqueeze(-1)
    return torch.where(ok, x, torch.full_like(x, float("nan")))


def guarded_step(delta: torch.Tensor, g: torch.Tensor, axis=None) -> torch.Tensor:
    """A converged fit takes a ZERO step, and a non-finite solve must not
    poison the carry: entries of ``delta`` are kept only where the
    gradient is above float32 noise and the entry is finite.  ``axis``:
    the reduction axis of |g| for batched steps (None = one fit), so each
    candidate's convergence is its own."""
    if axis is None:
        ok = g.abs().max() > 1e-7
    else:
        ok = (g.abs().amax(dim=axis) > 1e-7)[:, None]
    return torch.where(ok & torch.isfinite(delta), delta, torch.zeros_like(delta))


def _batched_diag(v: torch.Tensor) -> torch.Tensor:
    """[B, d] -> [B, d, d] with v on the diagonals."""
    return torch.diag_embed(v)
