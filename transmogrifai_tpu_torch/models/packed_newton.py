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
route this package mirrors.  Its bitwise fixed-point early exit,
``newton_fixed_point`` (``run_newton(..., fixed_point=True)``), is the
fit loop of the fused training programs (``local/fused_train.py``).

On a mesh (``parallel/mesh.py``) the batched cores take a ``rows``
reducer (``parallel.distributed.RowReducer``): every reduction over rows
is one all-reduce over the data group, the identity without a mesh, and
the fixed-point exit all-reduces its "changed" flag so that every rank
leaves the loop at the same step.  :func:`fit_batched_sharded` cuts a
rank's rows and candidates and gathers the betas; the validator runs
such a fit under the collective watchdog (``parallel/resilience.py``),
which is the one guard of the route: the JAX package's second guard,
``run_packed_guarded``, wraps its MXU-packed mesh Gram
(``packed_weighted_gram``, ``lr_fit_batched_packed``), a TPU-only route
that stays unported.
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


def _leaves(carry) -> tuple:
    return tuple(carry) if isinstance(carry, (tuple, list)) else (carry,)


def _int_view(t: torch.Tensor) -> torch.Tensor:
    """The bit pattern of a float tensor as a same-width integer tensor."""
    return t.view({2: torch.int16, 4: torch.int32,
                   8: torch.int64}[t.element_size()])


def newton_fixed_point(step, init, length: int, rows=None):
    """Run ``carry = step(carry)`` until the carry reaches a BITWISE fixed
    point, or ``length`` iterations, whichever comes first.

    The output is identical to ``length`` iterations of the same step:
    the step is a deterministic function of its carry, so once
    ``step(c)`` equals ``c`` bit for bit every further iteration gives
    ``c`` again.  (``guarded_step`` zeroes the beta delta once the
    gradient is at float32 noise, and the intercept update stops moving
    ``b0`` once ``g0/h0`` is below half an ULP of it.)  A NaN anywhere
    in the carry never ends the loop (NaN != NaN), so a diverging fit
    runs the whole budget, as the fixed-length loop does.  The whole
    batch exits together, when every candidate has reached its fixed
    point: there is no per-candidate exit.

    Each test of the exit is a host read of one device flag: one sync
    per Newton step, as the JAX package's ``while_loop`` condition is
    one per step.  The fixed-length loop enqueues without a sync.  With a
    sharded ``rows`` reducer the "changed" flag is all-reduced (MAX) over
    the data group, so every rank exits at the same step even if one
    rank's carry were to differ."""
    carry = init
    for _ in range(length):
        new = step(carry)
        same = None
        for old_leaf, new_leaf in zip(_leaves(carry), _leaves(new)):
            eq = ((_int_view(old_leaf) == _int_view(new_leaf))
                  & (new_leaf == new_leaf)).all()
            same = eq if same is None else same & eq
        carry = new
        if rows is not None and rows.sharded:
            if not rows.any(~same):
                break
        elif bool(same):
            break
    return carry


def run_newton(step, init, length: int, fixed_point: bool = False,
               rows=None):
    """The one point of truth for the Newton loop: ``carry = step(carry)``
    for exactly ``length`` iterations (the JAX package's ``lax.scan`` of
    the step, as a Python loop that never reads a value back to the host,
    so on the card every iteration only enqueues work), or, with
    ``fixed_point``, :func:`newton_fixed_point`, whose carry is the same
    with the wasted tail iterations left out (``rows``: the fit's row
    reducer, for the flag's all-reduce)."""
    if fixed_point:
        return newton_fixed_point(step, init, length, rows)
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


def fit_batched_sharded(core, X, y, W, regs, ens, mesh, **kw):
    """A batched linear core (``lr_fit_batched_core``,
    ``svc_fit_batched_core``, ``linreg_fit_batched_core``) over ``mesh``
    (``('data',)`` or ``('replica', 'data')``).  ``X`` [n, d], ``y`` [n],
    ``W`` [B, n], ``regs``/``ens`` [B] are the replicated inputs every
    rank holds, as tensors on the rank's device.  This rank fits its
    ``replica`` block of the B candidates (fold-major, ``r | B``) on its
    ``data`` block of the rows, every reduction over rows all-reduced over
    its data group; the betas are then all-gathered over the replica
    group in candidate order.  Returns (betas [B, d], intercepts [B]),
    equal on every rank."""
    from ..parallel.distributed import (
        RowReducer, candidate_block, gather_candidates)
    from ..parallel.mesh import row_block

    lo, hi = row_block(X.shape[0], mesh)
    c_lo, c_hi = candidate_block(W.shape[0], mesh)
    beta, b0 = core(X[lo:hi], y[lo:hi], W[c_lo:c_hi, lo:hi],
                    regs[c_lo:c_hi], ens[c_lo:c_hi],
                    rows=RowReducer(mesh, n_rows=X.shape[0]), **kw)
    return gather_candidates(beta, mesh), gather_candidates(b0, mesh)


def fit_batched(core, args, mesh, **kw):
    """A batched linear fit of ``core`` over ``args`` (X, y, W, regs, ens:
    tensors on one device): the core itself without a mesh, and
    :func:`fit_batched_sharded` with one.  The collective watchdog that
    guards a mesh fit is the caller's (the validator's
    ``guarded_collective("validator.fit_arrays_batched", ...)``)."""
    if mesh is None:
        return core(*args, **kw)
    return fit_batched_sharded(core, *args, mesh, **kw)
