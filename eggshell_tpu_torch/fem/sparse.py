"""Sparse linear algebra for the FEM tier, counterpart of
`eggshell_tpu.fem.sparse`.

The sparsity STRUCTURE (rows, cols) is host-side numpy; the VALUES are a
tensor, so assembly stays a differentiable function of the geometry and
the materials.  Every function takes optional leading batch axes on the
values and right-hand sides (a sweep's frequencies).

- `coo_matvec`, `coo_to_dense`, `coo_matmat`: duplicate triplets
  accumulate (`index_add_`; on the card it adds by atomics, so two calls
  agree within rounding, not in every bit).
- `sparse_solve_structured`: the JAX package's own host solve, SciPy's
  SuperLU (`scipy.sparse.linalg.splu`) in float64/complex128, as a
  `torch.autograd.Function`: the values and the right-hand side are copied
  to the host and the solution back; the backward solves the adjoint
  system with the same factor.  A batch is solved one system after
  another, as the JAX package's `pure_callback(vmap_method="sequential")`.
- `bicgstab_solve_structured`, `bicgstab_solve`: Jacobi-preconditioned
  BiCGStab on the device (the iteration of `jax.scipy.sparse.linalg.
  bicgstab`), its convergence test read on the host each iteration; the
  backward is a BiCGStab solve of the adjoint system.
- `lobpcg_generalized`, `shift_invert_modes`: the device eigensolvers,
  started from the same `np.random.default_rng(seed)` block as the JAX
  package's.
"""

from __future__ import annotations

import numpy as np
import torch


def _index(a, device) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a.to(device=device, dtype=torch.int64)
    return torch.as_tensor(np.asarray(a, np.int64), device=device)


def index_add(src: torch.Tensor, index: torch.Tensor, size: int) -> torch.Tensor:
    """out[..., i] = sum of src[..., t] over the t with index[t] = i, out of
    length `size` on the last axis.  Complex values are summed as their real
    and imaginary parts."""
    lead = src.shape[:-1]
    if src.is_complex():
        parts = torch.view_as_real(src)                       # (..., t, 2)
        out = parts.new_zeros(lead + (size, 2)).index_add(-2, index, parts)
        return torch.view_as_complex(out)
    return src.new_zeros(lead + (size,)).index_add(-1, index, src)


def coo_matvec(rows, cols, vals, x, num_rows: int):
    """y = A x for COO (rows, cols, vals); duplicate entries accumulate
    (triplet semantics).  vals (..., nnz), x (..., n)."""
    device = vals.device
    return index_add(vals * x[..., _index(cols, device)], _index(rows, device), num_rows)


def coo_to_dense(rows, cols, vals, num_rows: int):
    """Densify the triplets (duplicates accumulate), (..., n, n)."""
    device = vals.device
    flat = _index(rows, device) * num_rows + _index(cols, device)
    return index_add(vals, flat, num_rows * num_rows).reshape(
        vals.shape[:-1] + (num_rows, num_rows))


def coo_matmat(rows, cols, vals, X, num_rows: int):
    """Y = A X for COO triplets and a block of vectors X (n, k)."""
    device = vals.device
    contrib = vals[:, None] * X[_index(cols, device)]
    return index_add(contrib.transpose(0, 1), _index(rows, device), num_rows).transpose(0, 1)


class SparseStructure:
    """COO structure (rows, cols, num_rows), numpy int32 on the host, with
    its index tensors kept per device so repeated solves on one mesh copy
    them once."""

    def __init__(self, rows, cols, num_rows: int):
        self.rows = np.ascontiguousarray(np.asarray(rows, np.int32))
        self.cols = np.ascontiguousarray(np.asarray(cols, np.int32))
        self.num_rows = int(num_rows)
        self._key = hash((self.rows.tobytes(), self.cols.tobytes(), self.num_rows))
        self._on = {}

    def __hash__(self):
        return self._key

    def __eq__(self, other):
        return (isinstance(other, SparseStructure) and self.num_rows == other.num_rows
                and np.array_equal(self.rows, other.rows)
                and np.array_equal(self.cols, other.cols))

    def indices(self, device):
        """(rows, cols) as int64 tensors on `device`."""
        key = str(torch.device(device))
        if key not in self._on:
            self._on[key] = (_index(self.rows, device), _index(self.cols, device))
        return self._on[key]


def _broadcast_batch(vals, b):
    """Flattened batches of vals (..., nnz) and b (..., n) broadcast to one
    leading shape."""
    lead = torch.broadcast_shapes(vals.shape[:-1], b.shape[:-1])
    return (lead, vals.expand(lead + vals.shape[-1:]).reshape(-1, vals.shape[-1]),
            b.expand(lead + b.shape[-1:]).reshape(-1, b.shape[-1]))


def _vals_cotangent(rows, cols, vals, x, bbar):
    """The values' gradient of x = A^-1 b in PyTorch's convention for
    complex tensors: -bbar[rows] conj(x[cols]), bbar = A^-H g; summed over
    the batch axes that vals was broadcast along."""
    g = -bbar[..., rows] * x[..., cols].conj()
    if not vals.is_complex():
        g = g.real
    while g.dim() > vals.dim():
        g = g.sum(0)
    for ax, n in enumerate(vals.shape[:-1]):
        if n == 1:
            g = g.sum(ax, keepdim=True)
    return g


def _b_cotangent(b, bbar):
    g = bbar if b.is_complex() else bbar.real
    while g.dim() > b.dim():
        g = g.sum(0)
    for ax, n in enumerate(b.shape[:-1]):
        if n == 1:
            g = g.sum(ax, keepdim=True)
    return g


class _HostSplu(torch.autograd.Function):
    """x = A^-1 b by SciPy's SuperLU on the host, one system of the batch
    after another; backward: the adjoint solve with the same factors."""

    @staticmethod
    def forward(ctx, vals, b, structure):
        lead, V, Bm = _broadcast_batch(vals, b)
        hdtype = np.complex128 if (vals.is_complex() or b.is_complex()) else np.float64
        Vh = V.detach().cpu().numpy().astype(hdtype)
        Bh = Bm.detach().cpu().numpy().astype(hdtype)
        lus, xs = [], []
        for v, rhs in zip(Vh, Bh):
            lu = _splu(structure, v)
            lus.append(lu)
            xs.append(lu.solve(rhs))
        x = torch.as_tensor(np.stack(xs), device=b.device).to(b.dtype).reshape(
            lead + b.shape[-1:])
        ctx.lus, ctx.structure, ctx.lead = lus, structure, lead
        ctx.save_for_backward(vals, b, x)
        return x

    @staticmethod
    def backward(ctx, g):
        vals, b, x = ctx.saved_tensors
        gh = g.detach().reshape(-1, g.shape[-1]).cpu().numpy()
        bbar = np.stack([lu.solve(gi.astype(lu.U.dtype), trans="H")
                         for lu, gi in zip(ctx.lus, gh)])
        bbar = torch.as_tensor(bbar, device=g.device).reshape(ctx.lead + g.shape[-1:])
        bbar = bbar.to(x.dtype)
        rows, cols = ctx.structure.indices(g.device)
        gv = _vals_cotangent(rows, cols, vals, x, bbar) if ctx.needs_input_grad[0] else None
        gb = _b_cotangent(b, bbar).to(b.dtype) if ctx.needs_input_grad[1] else None
        return gv, gb, None


def _splu(structure: SparseStructure, v: np.ndarray):
    import scipy.sparse as sp
    import scipy.sparse.linalg as spla

    n = structure.num_rows
    A = sp.csc_matrix((v, (structure.rows, structure.cols)), shape=(n, n))
    return spla.splu(A)


def sparse_solve_structured(vals, b, structure: SparseStructure):
    """Solve A x = b with A given by `structure` and `vals` (duplicates
    accumulate) by the JAX package's own host solve, SciPy's SuperLU in
    float64/complex128; the solution comes back to b's device and dtype.
    Differentiable in vals and b: the backward solves A^H with the
    forward's factors, exact for any A (the JAX package's `symmetric` flag,
    which picks its transpose solve, has no counterpart)."""
    return _HostSplu.apply(vals, b, structure)


def sparse_solve(rows, cols, vals, b, num_rows: int):
    """`sparse_solve_structured` on (rows, cols, num_rows)."""
    return sparse_solve_structured(vals, b, SparseStructure(rows, cols, num_rows))


def _vdot(x, y):
    return torch.sum(x.conj() * y)


def _vdot_real(x, y):
    if x.is_complex():
        return torch.sum(x.real * y.real) + torch.sum(x.imag * y.imag)
    return torch.sum(x * y)


def _bicgstab(A, b, M, tol: float, maxiter: int):
    """The iteration of `jax.scipy.sparse.linalg.bicgstab` from x0 = 0
    (atol 0); the stopping test |r|^2 > tol^2 |b|^2 is read on the host
    each iteration."""
    atol2 = tol * tol * _vdot_real(b, b)
    x = torch.zeros_like(b)
    r = b - A(x)
    rhat, p, q = r, r, r
    one = torch.ones((), dtype=b.dtype, device=b.device)
    alpha = omega = rho = one
    k = 0
    while bool(_vdot_real(r, r) > atol2) and k < maxiter and k >= 0:
        rho_ = _vdot(rhat, r)
        beta = rho_ / rho * alpha / omega
        p = r + beta * (p - omega * q)
        phat = M(p)
        q = A(phat)
        alpha = rho_ / _vdot(rhat, q)
        s = r - alpha * q
        exit_early = _vdot_real(s, s) < atol2
        shat = M(s)
        t = A(shat)
        omega = _vdot(t, s) / _vdot(t, t)
        x = torch.where(exit_early, x + alpha * phat, x + alpha * phat + omega * shat)
        r = torch.where(exit_early, s, s - omega * t)
        rho = rho_
        if bool(rho_ == 0):
            k = -10
        elif bool((omega == 0) | (alpha == 0)):
            k = -11
        else:
            k += 1
    return x


def _jacobi_diag(rows, cols, vals, n):
    diag = index_add(torch.where(rows == cols, vals, torch.zeros_like(vals)), rows, n)
    return torch.where(diag.abs() > 0, diag, torch.ones_like(diag))


def _bicgstab_coo(rows, cols, vals, b, n, tol, maxiter):
    diag = _jacobi_diag(rows, cols, vals, n)
    return _bicgstab(lambda x: index_add(vals * x[cols], rows, n), b, lambda y: y / diag,
                     tol, maxiter)


class _Bicgstab(torch.autograd.Function):
    """x = A^-1 b by BiCGStab, one system of the batch after another;
    backward: BiCGStab on A^H (the conjugate values at (cols, rows))."""

    @staticmethod
    def forward(ctx, vals, b, rows, cols, n, tol, maxiter):
        lead, V, Bm = _broadcast_batch(vals, b)
        x = torch.stack([_bicgstab_coo(rows, cols, v, rhs, n, tol, maxiter)
                         for v, rhs in zip(V, Bm)]).reshape(lead + b.shape[-1:])
        ctx.args = (rows, cols, n, tol, maxiter, lead)
        ctx.save_for_backward(vals, b, x)
        return x

    @staticmethod
    def backward(ctx, g):
        vals, b, x = ctx.saved_tensors
        rows, cols, n, tol, maxiter, lead = ctx.args
        _, V, G = _broadcast_batch(vals, g)
        bbar = torch.stack([_bicgstab_coo(cols, rows, v.conj(), gi, n, tol, maxiter)
                            for v, gi in zip(V, G)]).reshape(lead + g.shape[-1:])
        gv = _vals_cotangent(rows, cols, vals, x, bbar) if ctx.needs_input_grad[0] else None
        gb = _b_cotangent(b, bbar) if ctx.needs_input_grad[1] else None
        return gv, gb, None, None, None, None, None


def bicgstab_solve_structured(vals, b, structure: SparseStructure, tol: float = 1e-8,
                              maxiter: int = 2000):
    """On-device driven solve: Jacobi-preconditioned BiCGStab on the COO
    matvec, no host solve; differentiable (the adjoint system solved by
    BiCGStab too)."""
    rows, cols = structure.indices(vals.device)
    return _Bicgstab.apply(vals, b, rows, cols, structure.num_rows, tol, maxiter)


def bicgstab_solve(rows, cols, vals, b, num_rows: int, tol=1e-8, maxiter=2000):
    """`bicgstab_solve_structured` on (rows, cols, num_rows)."""
    return _Bicgstab.apply(vals, b, _index(rows, vals.device), _index(cols, vals.device),
                           int(num_rows), tol, maxiter)


def _start_block(n, k, seed, like):
    """The eigensolvers' start block: np.random.default_rng(seed).normal,
    as the JAX package draws it."""
    return torch.as_tensor(np.random.default_rng(seed).normal(size=(n, k)),
                           device=like.device).to(like.dtype)


def _m_orthonormalize(S, Mmm):
    """eigh-based M-orthonormalization robust to rank-deficient blocks:
    (S V) w^-1/2 on the Gram eigenvalues w > 1e-10 max|w|, zero columns
    elsewhere; returns (block, good)."""
    G = S.T @ Mmm(S)
    G = 0.5 * (G + G.T)
    w, V = torch.linalg.eigh(G)
    good = w > 1e-10 * torch.max(w.abs())
    scale = torch.where(good, 1.0 / torch.sqrt(torch.where(good, w, torch.ones_like(w))),
                        torch.zeros_like(w))
    return (S @ V) * scale[None, :], good


def _values(v, device):
    if isinstance(v, torch.Tensor):
        return v.to(device)
    return torch.as_tensor(np.asarray(v), device=device)


def lobpcg_generalized(rows, cols, kvals, mvals, num_rows: int, num_modes: int,
                       iters: int = 120, seed: int = 0, cg_iters: int = 25, device="cuda"):
    """Smallest eigenpairs of K x = lambda M x from COO matvecs: block
    Rayleigh-Ritz on [X, W, P] (Knyazev's update), the residuals
    preconditioned by `cg_iters` fixed Jacobi-CG sweeps on K + sigma M,
    `iters` iterations, a guard block of max(2, num_modes // 2) columns.
    Returns (eigenvalues (num_modes,), eigenvectors (n, num_modes))."""
    kvals = _values(kvals, device)
    mvals = _values(mvals, device)
    rows_t, cols_t = _index(rows, kvals.device), _index(cols, kvals.device)
    n = int(num_rows)
    k = min(num_modes + max(2, num_modes // 2), max(n - 1, 1))
    ondiag = rows_t == cols_t
    diagK = index_add(torch.where(ondiag, kvals, torch.zeros_like(kvals)), rows_t, n)
    diagK = torch.where(diagK.abs() > 0, diagK, torch.ones_like(diagK))
    diagM = index_add(torch.where(ondiag, mvals, torch.zeros_like(mvals)), rows_t, n)

    def Kmm(X):
        return coo_matmat(rows_t, cols_t, kvals, X, n)

    def Mmm(X):
        return coo_matmat(rows_t, cols_t, mvals, X, n)

    sigma_pc = 1e-4 * torch.max(diagK.abs()) / torch.clamp(
        torch.max(diagM.abs()), min=torch.finfo(diagM.dtype).tiny)
    diagA = diagK + sigma_pc * diagM

    def Amm(X):
        return Kmm(X) + sigma_pc * Mmm(X)

    X, _ = _m_orthonormalize(_start_block(n, k, seed, kvals), Mmm)
    P = torch.zeros_like(X)

    def precond(R):
        x = torch.zeros_like(R)
        r = R
        p = r / diagA[:, None]
        rz = torch.sum(r * p, dim=0)
        zero = torch.zeros_like(rz)
        for _ in range(cg_iters):
            Kp = Amm(p)
            pKp = torch.sum(p * Kp, dim=0)
            alpha = torch.where(pKp > 0, rz / torch.where(pKp > 0, pKp, torch.ones_like(pKp)),
                                zero)
            x = x + p * alpha[None, :]
            r = r - Kp * alpha[None, :]
            z = r / diagA[:, None]
            rz_new = torch.sum(r * z, dim=0)
            beta = torch.where(rz > 0, rz_new / torch.where(rz > 0, rz, torch.ones_like(rz)),
                               zero)
            p = z + p * beta[None, :]
            rz = rz_new
        return x

    for _ in range(iters):
        KX = Kmm(X)
        theta = torch.sum(X * KX, dim=0)
        W = precond(KX - Mmm(X) * theta[None, :])
        S, good = _m_orthonormalize(torch.cat([X, W, P], dim=1), Mmm)
        A = S.T @ Kmm(S)
        A = 0.5 * (A + A.T)
        big = 1e30 * torch.max(torch.diagonal(A).abs()) + 1.0
        A = A + torch.diag(torch.where(good, torch.zeros_like(big), big))
        _, Y = torch.linalg.eigh(A)
        Yk = Y[:, :k]
        X, P = S @ Yk, S[:, k:] @ Yk[k:, :]
    theta = torch.sum(X * Kmm(X), dim=0) / torch.sum(X * Mmm(X), dim=0)
    order = torch.argsort(theta)
    return theta[order][:num_modes], X[:, order][:, :num_modes]


def shift_invert_modes(rows, cols, kvals, mvals, num_rows: int, num_modes: int,
                       iters: int = 20, seed: int = 0, sigma: float = None, guard: int = None,
                       device="cuda"):
    """Shift-invert subspace iteration on the device, the ARPACK
    shift-invert analog: each sweep applies (K - sigma M)^-1 M to the block
    by one multi-right-hand-side BCR solve (`fem.block_tridiag`, the
    bandwidth cut by RCM on the host), M-orthonormalizes and rotates by
    Rayleigh-Ritz on K.  sigma None is -1e-6 times the diagonal ratio
    max|K_ii| / max|M_ii| (an SPD factor even where K is singular).
    Returns (eigenvalues (num_modes,), eigenvectors (n, num_modes))."""
    from eggshell_tpu_torch.fem import block_tridiag as bt

    n = int(num_rows)
    k = num_modes + (max(4, num_modes) if guard is None else guard)
    k = min(k, max(n - 1, 1))
    kvals = _values(kvals, device)
    mvals = _values(mvals, device)
    if sigma is None:
        diag = np.asarray(rows) == np.asarray(cols)
        kh, mh = kvals.detach().cpu().numpy(), mvals.detach().cpu().numpy()
        scale = float(np.max(np.abs(kh[diag]))) / max(float(np.max(np.abs(mh[diag]))),
                                                      np.finfo(np.float64).tiny)
        sigma = -1e-6 * scale
    avals = kvals - sigma * mvals if sigma else kvals

    structure = bt.BlockTridiagStructure.auto(rows, cols, n)
    bands = bt.padded_bands(avals, structure)
    rows_t, cols_t = _index(rows, kvals.device), _index(cols, kvals.device)

    def Kmm(X):
        return coo_matmat(rows_t, cols_t, kvals, X, n)

    def Mmm(X):
        return coo_matmat(rows_t, cols_t, mvals, X, n)

    def inv_apply(X):                          # (n, k) -> (K - sigma M)^-1 X
        return bt.solve_columns(bands, X, structure)

    X, _ = _m_orthonormalize(_start_block(n, k, seed, kvals), Mmm)
    for _ in range(iters):
        Y, _ = _m_orthonormalize(inv_apply(Mmm(X)), Mmm)
        A = Y.T @ Kmm(Y)
        A = 0.5 * (A + A.T)
        _, V = torch.linalg.eigh(A)
        X = Y @ V
    theta = torch.sum(X * Kmm(X), dim=0) / torch.sum(X * Mmm(X), dim=0)
    order = torch.argsort(theta)
    return theta[order][:num_modes], X[:, order][:, :num_modes]
