"""Projected splitting iterations for mixed LCPs, batched.

Counterpart of `eggshell_tpu.ops.lcp`.  Problem: A x = b + w with, per row, either an
equality (w = 0, x free) or box bounds lo <= x <= hi with
complementarity.  Every function takes a leading scenario dimension: A
(B, m, m), vectors (B, m), `couple` (B, m) int64 (-1 = not coupled), and
the JAX package's vmap over scenarios is that dimension written out.

- Jacobi (plain, heavy-ball, exact 3x3 block), fully parallel over rows;
- projected Gauss-Seidel (PGS) and backward SOR, a Python loop over rows
  with every scenario's row updated at once (the JAX package's XLA scan).
  No TPU kernel exists for these two, and none is written here.  Each row
  update builds a new x (`torch.where` on the row's column), so autograd
  can run backward through the sweeps;
- the implicit-function-theorem (IFT) backward: `ift_adjoint`, and the
  `torch.autograd.Function`s `solve_lcp_implicit` (the sweeps forward, one
  adjoint solve backward) and `adopt_lcp_solution` (a solution computed
  elsewhere, the fused chain's B6, adopted with the same backward).  The
  masked adjoint system is solved by LU (`torch.linalg.solve`) on every
  device, as the JAX package does on the CPU (on the TPU it takes
  Cholesky).
"""

from __future__ import annotations

from typing import Optional

import torch


def project(x, is_eq, lo, hi):
    """Clamp inequality rows to [lo, hi]; equality rows pass through."""
    return torch.where(is_eq, x, torch.minimum(torch.maximum(x, lo), hi))


def jacobi_momentum_sweep(A, b, diag, inv_diag, x, x_prev, is_eq, lo, hi,
                          omega: float, beta: float):
    """One under-relaxed heavy-ball projected Jacobi sweep,
    x <- proj((1 - omega) x + omega r D^-1 + beta (x - x_prev)) with
    r = b - A x + D x.  A (B, m, m), vectors (B, m).  Returns (x_new, x)."""
    ax = torch.einsum("bij,bj->bi", A, x)
    r = b - ax + diag * x
    xn = project((1.0 - omega) * x + omega * r * inv_diag + beta * (x - x_prev),
                 is_eq, lo, hi)
    return xn, x


def _matvec(A, x):
    return torch.einsum("bij,bj->bi", A, x)


def residual_error(A, b, x, is_eq, lo, hi):
    """Complementarity-aware residual of each scenario, (B,): the 2-norm
    of w = A x - b on equality rows plus the 2-norm of w on the inequality
    rows that violate complementarity (x at lo with w < 0, at hi with
    w > 0, or interior)."""
    w = _matvec(A, x) - b
    zero = torch.zeros((), dtype=w.dtype, device=w.device)
    eq_err = torch.linalg.vector_norm(torch.where(is_eq, w, zero), dim=-1)
    at_lo = ~is_eq & (x <= lo) & (w < 0)
    at_hi = ~is_eq & (x >= hi) & (w > 0)
    interior = ~is_eq & (x > lo) & (x < hi)
    ineq = torch.where(at_lo | at_hi | interior, w, zero)
    return eq_err + torch.linalg.vector_norm(ineq, dim=-1)


def _bounds(x, lo, hi, couple, mu: float):
    """Effective bounds: rows with couple >= 0 get Coulomb-pyramid bounds
    +-mu * max(x[couple], 0) (coupled to their contact's normal impulse);
    the others keep lo and hi."""
    if couple is None:
        return lo, hi
    coupled = couple >= 0
    xn = torch.gather(x, -1, torch.where(coupled, couple, torch.zeros_like(couple)))
    ncap = mu * torch.clamp(xn, min=0.0)
    return torch.where(coupled, -ncap, lo), torch.where(coupled, ncap, hi)


def _gs_sweep(A, b, x, is_eq, lo, hi, couple=None, mu: float = 0.0):
    """One projected Gauss-Seidel sweep: rows in order, each from the
    freshest x, x_i <- proj((b_i - A_i x + A_ii x_i) / A_ii)."""
    m = b.shape[-1]
    diag = torch.diagonal(A, dim1=-2, dim2=-1)
    col = torch.arange(m, device=x.device)
    for i in range(m):
        r = b[:, i] - torch.einsum("bj,bj->b", A[:, i], x) + diag[:, i] * x[:, i]
        lo_e, hi_e = _bounds(x, lo, hi, couple, mu)
        xi = project(r / diag[:, i], is_eq[:, i], lo_e[:, i], hi_e[:, i])
        x = torch.where(col == i, xi[:, None], x)
    return x


def _sor_sweep(A, b, x, is_eq, lo, hi, omega: float):
    """One backward projected SOR sweep, M = U + D / omega: rows last to
    first."""
    m = b.shape[-1]
    diag = torch.diagonal(A, dim1=-2, dim2=-1)
    k = 1.0 / omega
    col = torch.arange(m, device=x.device)
    for i in reversed(range(m)):
        d, xi = diag[:, i], x[:, i]
        r = b[:, i] - torch.einsum("bj,bj->b", A[:, i], x) + d * xi - (1.0 - k) * d * xi
        xi = project(r / (k * d), is_eq[:, i], lo[:, i], hi[:, i])
        x = torch.where(col == i, xi[:, None], x)
    return x


def _jacobi_sweep(A, b, x, is_eq, lo, hi, omega: float = 1.0, couple=None, mu: float = 0.0):
    """One under-relaxed projected Jacobi sweep,
    x <- proj((1 - omega) x + omega D^-1 (b - (A - D) x))."""
    diag = torch.diagonal(A, dim1=-2, dim2=-1)
    r = b - _matvec(A, x) + diag * x
    lo_e, hi_e = _bounds(x, lo, hi, couple, mu)
    return project((1.0 - omega) * x + omega * (r / diag), is_eq, lo_e, hi_e)


def block_rows(A, m3: int):
    """Bc (B, m3, 3): row 3k + r of the inverse of the 3x3 diagonal block k
    of A (B, m, m), m >= m3, m3 % 3 == 0, Bc[:, 3k + r, c] = inv(A_kk)[r, c],
    by the adjugate, with det replaced by 1 where |det| <= 1e-30.  These
    are the block-Jacobi kernels' expressions (csrc/block3.cuh)."""
    B = A.shape[0]
    K3 = m3 // 3
    blk = torch.diagonal(A[:, :m3, :m3].reshape(B, K3, 3, K3, 3), dim1=1, dim2=3)  # B,3,3,K3
    a = [[blk[:, r, c] for c in range(3)] for r in range(3)]
    det = (a[0][0] * (a[1][1] * a[2][2] - a[1][2] * a[2][1])
           - a[0][1] * (a[1][0] * a[2][2] - a[1][2] * a[2][0])
           + a[0][2] * (a[1][0] * a[2][1] - a[1][1] * a[2][0]))
    invdet = 1.0 / torch.where(det.abs() > 1e-30, det, torch.ones_like(det))
    adj = [[a[1][1] * a[2][2] - a[1][2] * a[2][1],
            a[0][2] * a[2][1] - a[0][1] * a[2][2],
            a[0][1] * a[1][2] - a[0][2] * a[1][1]],
           [a[1][2] * a[2][0] - a[1][0] * a[2][2],
            a[0][0] * a[2][2] - a[0][2] * a[2][0],
            a[0][2] * a[1][0] - a[0][0] * a[1][2]],
           [a[1][0] * a[2][1] - a[1][1] * a[2][0],
            a[0][1] * a[2][0] - a[0][0] * a[2][1],
            a[0][0] * a[1][1] - a[0][1] * a[1][0]]]
    rows = torch.stack([torch.stack([adj[r][c] * invdet for c in range(3)], -1)
                        for r in range(3)], -2)                       # (B, K3, 3, 3)
    return rows.reshape(B, m3, 3)


def block_update(A, b, x, Bc, inv_diag, m3: int):
    """y of one block-Jacobi sweep, in the kernels' expressions: rv = b - A x,
    then y_i = x_i + Bc_i0 rv_3k + Bc_i1 rv_3k+1 + Bc_i2 rv_3k+2 summed left
    to right on the m3 block rows (Bc of `block_rows`), and
    y_i = x_i + rv_i * inv_diag_i on the rows after them (if any)."""
    B = b.shape[0]
    rv = b - _matvec(A, x)
    rv3 = rv[:, :m3].reshape(B, m3 // 3, 3)

    def rep3(v):
        return v.repeat_interleave(3, dim=1)

    y = (x[:, :m3] + Bc[..., 0] * rep3(rv3[..., 0]) + Bc[..., 1] * rep3(rv3[..., 1])
         + Bc[..., 2] * rep3(rv3[..., 2]))
    if m3 == b.shape[1]:
        return y
    return torch.cat([y, x[:, m3:] + rv[:, m3:] * inv_diag[:, m3:]], dim=1)


def solve_lcp(A, b, is_eq, lo, hi, iters: int = 100, method: str = "pgs",
              check_tol: Optional[float] = None, omega: float = 1.5,
              jacobi_omega: float = 1.0, jacobi_beta: float = 0.0, x0=None, couple=None,
              mu: float = 0.0, jacobi_block: bool = False):
    """Iteratively solve the mixed LCP A x = b + w of every scenario.

    method in {"pgs", "jacobi", "sor"}; x0 defaults to b, projected on the
    static bounds.  "jacobi" is plain (under-relaxed by `jacobi_omega`),
    heavy-ball (`jacobi_beta`), or exact 3x3 block-Jacobi (`jacobi_block`,
    m % 3 == 0); `couple` and `mu` give tangent rows Coulomb-pyramid bounds
    (PGS and Jacobi; SOR ignores them, as the JAX package does).  Without
    `check_tol` exactly `iters` sweeps run; with it, each scenario stops
    after the sweep at which its `residual_error` is no longer above the
    tolerance (or after `iters` sweeps) and keeps that iterate.
    """
    x = b if x0 is None else x0
    x = project(x, is_eq, lo, hi)

    if method == "pgs":
        def sweep(xx, xp):
            return _gs_sweep(A, b, xx, is_eq, lo, hi, couple, mu), xx
    elif method == "jacobi":
        if jacobi_block:
            m = b.shape[-1]
            if m % 3:
                raise ValueError(f"block-Jacobi needs 3-row constraint blocks, got m = {m}")
            Bc = block_rows(A, m)

            def sweep(xx, xp):
                y = block_update(A, b, xx, Bc, None, m)
                lo_e, hi_e = _bounds(xx, lo, hi, couple, mu)
                xn = project((1.0 - jacobi_omega) * xx + jacobi_omega * y
                             + jacobi_beta * (xx - xp), is_eq, lo_e, hi_e)
                return xn, xx
        elif jacobi_beta:
            diag = torch.diagonal(A, dim1=-2, dim2=-1)

            def sweep(xx, xp):
                r = b - _matvec(A, xx) + diag * xx
                lo_e, hi_e = _bounds(xx, lo, hi, couple, mu)
                xn = project((1.0 - jacobi_omega) * xx + jacobi_omega * (r / diag)
                             + jacobi_beta * (xx - xp), is_eq, lo_e, hi_e)
                return xn, xx
        else:
            def sweep(xx, xp):
                return _jacobi_sweep(A, b, xx, is_eq, lo, hi, jacobi_omega, couple, mu), xx
    elif method == "sor":
        def sweep(xx, xp):
            return _sor_sweep(A, b, xx, is_eq, lo, hi, omega), xx
    else:
        raise ValueError(f"unknown method {method!r}")

    xp = x
    if check_tol is None:
        for _ in range(iters):
            x, xp = sweep(x, xp)
        return x

    done = ~(residual_error(A, b, x, is_eq, lo, hi) > check_tol)
    for _ in range(iters):
        if bool(done.all()):
            break
        xn, xpn = sweep(x, xp)
        keep = done[:, None]
        x, xp = torch.where(keep, x, xn), torch.where(keep, xp, xpn)
        done = done | ~(residual_error(A, b, x, is_eq, lo, hi) > check_tol)
    return x


def solve_lcp_batched(A, b, is_eq, lo, hi, **kw):
    """The JAX package's vmap of `solve_lcp` over scenarios: here
    `solve_lcp` itself, whose every argument already has the scenario
    dimension."""
    return solve_lcp(A, b, is_eq, lo, hi, **kw)


# ---------------------------------------------------------------------------
# Implicit differentiation


def ift_adjoint(A, b, is_eq, lo, hi, x, g, eps: float = 1e-8):
    """The implicit-function-theorem adjoint of the mixed box LCP at its
    solution x, for the output cotangent g: (gA, gb, glo, ghi).  At the
    solution the active set is fixed: the free rows (equalities, and x
    more than eps inside its bounds) solve a reduced linear system, whose
    transpose gives u in one masked LU solve; a row at lo (within eps) or
    else at hi passes g - A^T u to that bound.  Batched: A (B, m, m), the
    rest (B, m)."""
    free = is_eq | ((x > lo + eps) & (x < hi - eps))
    at_lo = ~free & (x <= lo + eps)
    at_hi = ~free & ~at_lo
    m = x.shape[-1]
    zero = torch.zeros((), dtype=A.dtype, device=A.device)
    eye = torch.eye(m, dtype=A.dtype, device=A.device)
    M = torch.where(free[:, :, None] & free[:, None, :], A, eye)
    u = torch.linalg.solve(M.transpose(-1, -2), torch.where(free, g, zero)[..., None])[..., 0]
    u = torch.where(free, u, zero)
    gA = -u[:, :, None] * x[:, None, :]
    gbound = g - torch.einsum("bji,bj->bi", A, u)
    return gA, u, torch.where(at_lo, gbound, zero), torch.where(at_hi, gbound, zero)


class _SolveLcpImplicit(torch.autograd.Function):
    @staticmethod
    def forward(ctx, A, b, is_eq, lo, hi, iters, method, jacobi_omega, active_eps, jacobi_beta,
                jacobi_block):
        x = solve_lcp(A, b, is_eq, lo, hi, iters=iters, method=method,
                      jacobi_omega=jacobi_omega, jacobi_beta=jacobi_beta,
                      jacobi_block=jacobi_block)
        ctx.save_for_backward(A, b, is_eq, lo, hi, x)
        ctx.active_eps = active_eps
        return x

    @staticmethod
    def backward(ctx, g):
        A, b, is_eq, lo, hi, x = ctx.saved_tensors
        gA, gb, glo, ghi = ift_adjoint(A, b, is_eq, lo, hi, x, g, eps=ctx.active_eps)
        return gA, gb, None, glo, ghi, None, None, None, None, None, None


def solve_lcp_implicit(A, b, is_eq, lo, hi, iters: int = 100, method: str = "pgs",
                       jacobi_omega: float = 1.0, active_eps: float = 1e-8,
                       jacobi_beta: float = 0.0, jacobi_block: bool = False):
    """`solve_lcp` (fixed sweeps) forward, `ift_adjoint` backward: one
    adjoint solve at the solution in place of reverse through every sweep,
    exact at convergence.  Clamped rows pass their gradient to lo or hi."""
    return _SolveLcpImplicit.apply(A, b, is_eq, lo, hi, iters, method, jacobi_omega,
                                   active_eps, jacobi_beta, jacobi_block)


class _AdoptLcpSolution(torch.autograd.Function):
    @staticmethod
    def forward(ctx, A, b, is_eq, lo, hi, x_saved):
        ctx.save_for_backward(A, b, is_eq, lo, hi, x_saved)
        return x_saved.clone()

    @staticmethod
    def backward(ctx, g):
        A, b, is_eq, lo, hi, x = ctx.saved_tensors
        gA, gb, glo, ghi = ift_adjoint(A, b, is_eq, lo, hi, x, g)
        return gA, gb, None, glo, ghi, torch.zeros_like(x)


def adopt_lcp_solution(A, b, is_eq, lo, hi, x_saved):
    """A solution computed elsewhere (the fused chain's B6) taken as the
    solution of (A, b, is_eq, lo, hi): forward returns x_saved's values, no
    sweep; backward is `ift_adjoint`.  x_saved gets a zero gradient."""
    return _AdoptLcpSolution.apply(A, b, is_eq, lo, hi, x_saved)
