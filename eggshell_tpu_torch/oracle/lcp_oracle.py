"""Slow-but-sure NumPy LCP solvers — the test-suite ground truth.

The port's own copy of `eggshell_tpu.oracle.lcp_oracle`, kept equal to it
(tests/test_torch_direct.py), so that nothing of the port imports the JAX
package.

Clean-room float64 re-derivation of the reference's direct solvers
(eggshell/lcp.cc:141-336 and the MATLAB prototypes eggshell/lcp/
murty_principal_pivot.m, mixed_constraints_solver.m), playing the same
role the MATLAB oracles play in the reference's tests.

Box LCP:  A x = b + w,  lo <= x <= hi, complementarity:
  x_i in (lo_i, hi_i) => w_i = 0
  x_i = lo_i          => w_i >= 0
  x_i = hi_i          => w_i <= 0
"""

from __future__ import annotations

import numpy as np


def murty_principal_pivot(A, b, lo=None, hi=None, max_iterations=None):
    """Murty's principal pivoting for the box LCP.

    Index set S = rows solved as equalities (x_S from A_SS x_S = b_S -
    A_S,~S x_~S); complement rows are pinned at lo or hi per the side
    array C.  One offending index is flipped per iteration (ref
    eggshell/lcp.cc:20-103 CheckMurtySolution, :157-274).

    Returns (x, w, converged).
    """
    A = np.asarray(A, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    n = b.shape[0]
    lo = np.zeros(n) if lo is None else np.broadcast_to(lo, (n,)).astype(float)
    hi = np.full(n, np.inf) if hi is None else np.broadcast_to(hi, (n,)).astype(float)

    if max_iterations is None:
        max_iterations = min(2**n, 1000)  # ref lcp.cc:168

    S = np.ones(n, dtype=bool)  # ref lcp.cc:176 — start with all-free
    side = lo.copy()            # pinned value for ~S rows (C array, ref :189)
    x = np.zeros(n)
    w = -b.copy()

    def solve_given_S():
        x = np.zeros(n)
        x[~S] = side[~S]
        if S.any():
            rhs = b[S] - A[np.ix_(S, ~S)] @ x[~S]
            x[S] = np.linalg.solve(A[np.ix_(S, S)], rhs)
        w = A @ x - b
        w[S] = 0.0
        return x, w

    def first_violation(x, w):
        """Return the first offending index and its fix, or None."""
        for i in range(n):
            if S[i]:
                if x[i] < lo[i]:
                    return ("pin", i, lo[i])
                if x[i] > hi[i]:
                    return ("pin", i, hi[i])
            else:
                if side[i] == lo[i] and w[i] < 0:
                    return ("free", i, None)
                if side[i] == hi[i] and w[i] > 0:
                    return ("free", i, None)
        return None

    best_x, best_w = x, w

    def goodness(x, w):
        # magnitude of bound violations (ref ComputeSolutionGoodness,
        # generalised to box bounds)
        xv = np.minimum(x - lo, 0).sum() + np.minimum(hi - x, 0).sum()
        wv = np.minimum(w, 0)[x <= lo].sum() + np.minimum(-w, 0)[x >= hi].sum()
        return xv + wv

    for _ in range(max_iterations):
        x, w = solve_given_S()
        v = first_violation(x, w)
        if v is None:
            return x, w, True
        kind, i, val = v
        if kind == "pin":
            S[i] = False
            side[i] = val
        else:
            S[i] = True
        if goodness(x, w) > goodness(best_x, best_w):
            best_x, best_w = x, w

    return best_x, best_w, False


def mixed_constraints_solver(A, b, is_eq, lo, hi):
    """Schur-complement mixed equality/LCP solver (ref lcp.cc:276-336).

    Equality rows E are eliminated: the LCP runs on the Schur complement
    A_II - A_IE A_EE^-1 A_EI, then x_E back-substitutes.
    Returns (x, w, converged); w is zero on equality rows.
    """
    A = np.asarray(A, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    E = np.asarray(is_eq, dtype=bool)
    I = ~E
    n = b.shape[0]
    lo = np.broadcast_to(lo, (n,)).astype(float)
    hi = np.broadcast_to(hi, (n,)).astype(float)

    if not I.any():
        x = np.linalg.solve(A, b)
        return x, np.zeros(n), True
    if not E.any():
        x_i, w_i, ok = murty_principal_pivot(A, b, lo, hi)
        return x_i, w_i, ok

    A_ee = A[np.ix_(E, E)]
    A_ei = A[np.ix_(E, I)]
    A_ie = A[np.ix_(I, E)]
    A_ii = A[np.ix_(I, I)]
    Aee_inv_Aei = np.linalg.solve(A_ee, A_ei)
    Aee_inv_be = np.linalg.solve(A_ee, b[E])
    lhs = A_ii - A_ie @ Aee_inv_Aei
    rhs = b[I] - A_ie @ Aee_inv_be

    x_i, w_i, ok = murty_principal_pivot(lhs, rhs, lo[I], hi[I])
    x_e = np.linalg.solve(A_ee, b[E] - A_ei @ x_i)

    x = np.zeros(n)
    x[E] = x_e
    x[I] = x_i
    w = np.zeros(n)
    w[I] = w_i
    return x, w, ok


def check_lcp_solution(A, b, x, w, is_eq, lo, hi, tol=1e-9):
    """KKT/complementarity certificate (mirrors the reference's batch
    solver certification, ref lcp.cc:412-528)."""
    A = np.asarray(A)
    b = np.asarray(b)
    if np.linalg.norm(A @ x - b - w) > tol * max(1.0, np.linalg.norm(b)):
        return False
    E = np.asarray(is_eq, dtype=bool)
    I = ~E
    if np.any(x[I] < lo[I] - tol) or np.any(x[I] > hi[I] + tol):
        return False
    at_lo = I & (np.abs(x - lo) <= tol)
    at_hi = I & (np.abs(x - hi) <= tol)
    interior = I & ~at_lo & ~at_hi
    if np.any(np.abs(w[interior]) > tol):
        return False
    if np.any(w[at_lo & ~at_hi] < -tol):
        return False
    if np.any(w[at_hi & ~at_lo] > tol):
        return False
    if np.any(np.abs(w[E]) > tol):
        return False
    return True
