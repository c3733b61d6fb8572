"""Direct (pivoting) LCP solvers, batched: the reference-accuracy path.

Counterpart of `eggshell_tpu.ops.lcp_direct`: Murty's principal pivoting
and the Schur-complement mixed solver with fixed shapes.  The active set
is a boolean mask, and each pivot's sub-solve A(S,S) x_S = b_S is one
full-size masked linear system (identity outside S), solved by LU
(`torch.linalg.solve`) for every scenario at once.

Every function takes a leading scenario dimension: A (B, n, n), vectors
(B, n).  The JAX package vmaps a `while_loop`; here the loop runs while
any scenario is still pivoting, and a scenario's carry freezes once it is
done or out of pivots, so each scenario's x, w and pivot count are those
of a call on it alone.  Whether every scenario is done is read on the
host once a pivot, which is why a rollout under SolverKind.DIRECT is not
captured in a CUDA graph (`parallel.rollout.capture_refusal`).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from eggshell_tpu_torch.ops import lcp


class LcpInfo(NamedTuple):
    """What a solve did, each (B,): `converged` (an exact complementarity
    solution was found), `iterations` (pivots spent), `goodness` (the
    returned solution's total KKT violation, 0 when converged) and
    `fallback_used` (the returned x, w is the best-so-far iterate, only
    where not converged)."""

    converged: torch.Tensor
    iterations: torch.Tensor
    goodness: torch.Tensor
    fallback_used: torch.Tensor


def _goodness(x, w, S, side, lo, hi):
    """Sum of KKT violation magnitudes of each scenario (lower is better,
    0 = solved): free rows outside [lo, hi], pinned rows with w of the
    wrong sign."""
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    free_viol = torch.where(S, torch.clamp(lo - x, min=0) + torch.clamp(x - hi, min=0), zero)
    at_lo = ~S & (side == lo)
    at_hi = ~S & (side == hi)
    clamp_viol = (torch.where(at_lo, torch.clamp(-w, min=0), zero)
                  + torch.where(at_hi, torch.clamp(w, min=0), zero))
    return torch.sum(free_viol + clamp_viol, dim=-1)


def _masked_solve(A, rhs, S):
    """Solve A_SS x_S = rhs_S embedded at full size: rows and columns
    outside S are the identity, with zero rhs."""
    n = A.shape[-1]
    eye = torch.eye(n, dtype=A.dtype, device=A.device)
    M = torch.where(S[:, :, None] & S[:, None, :], A, eye)
    zero = torch.zeros((), dtype=A.dtype, device=A.device)
    return torch.linalg.solve(M, torch.where(S, rhs, zero)[..., None])[..., 0]


def _matvec(A, x):
    return torch.einsum("bij,bj->bi", A, x)


def default_max_iterations(n: int) -> int:
    """The reference's pivot budget, min(2^n, 1000), as the JAX package
    writes it: min(2^min(n, 10), 1000)."""
    return min(2 ** min(n, 10), 1000)


def murty_principal_pivot(A, b, lo, hi, max_iterations: Optional[int] = None,
                          return_info: bool = False):
    """Box-LCP principal pivoting of every scenario.  One offending index is
    flipped a pivot, the first in row order; the best-so-far iterate by
    goodness is returned where the budget runs out.  lo and hi (B, n).
    `max_iterations` None is `default_max_iterations(n)`.

    Returns (x, w, converged); with `return_info`, (x, w, LcpInfo)."""
    B, n = b.shape
    if max_iterations is None:
        max_iterations = default_max_iterations(n)
    dtype, dev = A.dtype, A.device
    zero = torch.zeros((), dtype=dtype, device=dev)
    idx = torch.arange(n, device=dev)

    def compute_xw(S, side):
        rhs = b - _matvec(A, torch.where(S, zero, side))
        x = torch.where(S, _masked_solve(A, rhs, S), side)
        return x, torch.where(S, zero, _matvec(A, x) - b)

    S = torch.ones((B, n), dtype=torch.bool, device=dev)
    side = lo.to(dtype).expand(B, n).clone()
    x = torch.zeros((B, n), dtype=dtype, device=dev)
    w = -b
    bx, bw = x, w
    bg = torch.full((B,), float("inf"), dtype=dtype, device=dev)
    iters = torch.zeros((B,), dtype=torch.int64, device=dev)
    done = torch.zeros((B,), dtype=torch.bool, device=dev)
    for _ in range(max_iterations):
        run = ~done & (iters < max_iterations)
        if not bool(run.any()):
            break
        xn, wn = compute_xw(S, side)
        g = _goodness(xn, wn, S, side, lo, hi)
        better = run & (g < bg)
        bx = torch.where(better[:, None], xn, bx)
        bw = torch.where(better[:, None], wn, bw)
        bg = torch.where(better, g, bg)
        pin_lo = S & (xn < lo)
        pin_hi = S & (xn > hi)
        viol = pin_lo | pin_hi | (~S & (side == lo) & (wn < 0)) | (~S & (side == hi) & (wn > 0))
        has = viol.any(dim=-1)
        first = torch.argmax(viol.to(torch.int8), dim=-1)
        onehot = (idx == first[:, None]) & has[:, None]
        flip = onehot & run[:, None]
        S = torch.where(flip, ~S, S)
        side = torch.where(flip & pin_lo, lo, torch.where(flip & pin_hi, hi, side))
        x = torch.where(run[:, None], xn, x)
        w = torch.where(run[:, None], wn, w)
        iters = iters + run.to(torch.int64)
        done = done | (run & ~has)
    # not converged: the last iterate or the best-so-far one, whichever is better
    xf, wf = compute_xw(S, side)
    gf = _goodness(xf, wf, S, side, lo, hi)
    last_better = gf < bg
    x_fb = torch.where(last_better[:, None], xf, bx)
    w_fb = torch.where(last_better[:, None], wf, bw)
    g_fb = torch.where(last_better, gf, bg)
    x = torch.where(done[:, None], x, x_fb)
    w = torch.where(done[:, None], w, w_fb)
    if not return_info:
        return x, w, done
    return x, w, LcpInfo(converged=done, iterations=iters,
                         goodness=torch.where(done, zero, g_fb), fallback_used=~done)


def mixed_constraints_solver(A, b, is_eq, lo, hi, max_iterations: Optional[int] = None,
                             return_info: bool = False):
    """Schur-complement mixed solver of every scenario: the equality rows E
    eliminated through a masked inverse (identity on the other rows), the
    box LCP of the Schur complement on the inequality rows I solved by
    `murty_principal_pivot`, then x_E back-substituted.  Returns
    (x, w, converged), or (x, w, LcpInfo) with `return_info`."""
    n = b.shape[-1]
    E = is_eq
    I = ~E
    zero = torch.zeros((), dtype=A.dtype, device=A.device)
    eye = torch.eye(n, dtype=A.dtype, device=A.device)

    def block(rows, cols):
        return rows[:, :, None] & cols[:, None, :]

    A_ee_full = torch.where(block(E, E), A, eye)
    A_ei = torch.where(block(E, I), A, zero)
    A_ie = torch.where(block(I, E), A, zero)
    A_ii = torch.where(block(I, I), A, zero)
    Aee_inv_Aei = torch.linalg.solve(A_ee_full, A_ei)
    Aee_inv_be = torch.linalg.solve(A_ee_full, torch.where(E, b, zero)[..., None])[..., 0]
    schur = torch.where(block(I, I), A_ii - A_ie @ Aee_inv_Aei, eye)
    rhs = torch.where(I, b - _matvec(A_ie, Aee_inv_be), zero)
    lo_i = torch.where(I, lo, torch.full_like(lo, -1.0))
    hi_i = torch.where(I, hi, torch.full_like(hi, 1.0))
    x_i, w_i, ok = murty_principal_pivot(schur, rhs, lo_i, hi_i, max_iterations=max_iterations,
                                         return_info=return_info)
    x_i = torch.where(I, x_i, zero)
    x_e = torch.linalg.solve(A_ee_full,
                             torch.where(E, b - _matvec(A_ei, x_i), zero)[..., None])[..., 0]
    x = torch.where(E, x_e, x_i)
    w = torch.where(E, zero, w_i)
    return x, w, ok


class _MixedImplicit(torch.autograd.Function):
    @staticmethod
    def forward(ctx, A, b, is_eq, lo, hi):
        x, _, _ = mixed_constraints_solver(A, b, is_eq, lo, hi)
        ctx.save_for_backward(A, b, is_eq, lo, hi, x)
        return x

    @staticmethod
    def backward(ctx, g):
        A, b, is_eq, lo, hi, x = ctx.saved_tensors
        gA, gb, glo, ghi = lcp.ift_adjoint(A, b, is_eq, lo, hi, x, g)
        return gA, gb, None, glo, ghi


def mixed_constraints_solver_implicit(A, b, is_eq, lo, hi):
    """`mixed_constraints_solver`'s x with a backward: the pivot loop is
    not differentiable, but at the solution the active set is fixed, so
    the backward is the IFT adjoint of `ops.lcp.ift_adjoint`.  Returns x
    only."""
    return _MixedImplicit.apply(A, b, is_eq, lo, hi)
