"""Newton iteration helpers shared by the linear-model kernels.

Counterpart of the loop and safety pieces of
``transmogrifai_tpu/models/packed_newton.py``: ``run_newton`` (its
fixed-length scan form), ``pd_jitter`` and ``guarded_step``, plus
``solve_pos``, the positive-definite solve the JAX package gets from
``jax.scipy.linalg.solve(..., assume_a="pos")``.

The MXU-packed batched Gram and the bitwise fixed-point early exit serve
the cross-validation fan-out and the fused training programs; they come
with the model-selector slice (ROADMAP.md queue 1, item 5).
"""
from __future__ import annotations

import torch


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
    """Solve ``H x = g`` for a symmetric positive-definite ``H`` by
    Cholesky.  A factorisation that fails (H not PD) gives an all-NaN
    result, as the JAX package's solve does, instead of raising as
    ``torch.linalg.cholesky`` and ``torch.linalg.solve`` would; the check
    stays on the device, so the Newton loop never waits for the host."""
    L, info = torch.linalg.cholesky_ex(H)
    x = torch.cholesky_solve(g[:, None], L)[:, 0]
    return torch.where(info == 0, x, torch.full_like(x, float("nan")))


def guarded_step(delta: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """A converged fit takes a ZERO step, and a non-finite solve must not
    poison the carry: entries of ``delta`` are kept only where the
    gradient is above float32 noise and the entry is finite."""
    ok = g.abs().max() > 1e-7
    return torch.where(ok & torch.isfinite(delta), delta, torch.zeros_like(delta))
