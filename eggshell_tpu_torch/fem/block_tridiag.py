"""Block-tridiagonal direct solve by block cyclic reduction (BCR) on
batched `torch.linalg`, counterpart of `eggshell_tpu.fem.block_tridiag`.

A banded matrix (every `mesher.mesh_structured` mesh; any mesh after a
reverse-Cuthill-McKee reorder) is viewed as block tridiagonal with dense
(b, b) blocks, and cyclic reduction takes log2(nb) levels of batched dense
block solves and matmuls: no host round trip, no sparse scatter in the
loop.  Complex systems run in native complex (complex64 or complex128);
the JAX package's real 2x2 embedding (`ComplexBandedSystem`, a workaround
for a TPU runtime without complex dtypes) has no counterpart here.

Leading batch axes of the values and the right-hand side ride through
every level (the counterpart of the JAX package's `vmap` over
frequencies).  The solve is differentiable by autograd through the BCR
itself (the JAX package wraps it in `custom_linear_solve`; both give the
exact derivative of the solve).
"""

from __future__ import annotations

import numpy as np
import torch

from eggshell_tpu_torch.fem.sparse import index_add


class BlockTridiagStructure:
    """Host-side plan mapping COO triplets onto dense block bands.

    Nodes are grouped into nb = ceil(n / b) consecutive blocks of b (after
    the symmetric permutation `order`, node order[k] at position k, when
    given); every entry must couple nodes at most one block apart.
    Triplet t goes to flat position `scatter[t]` of a (3, nb, b, b) band
    tensor: band 0 the diagonal blocks D_i, band 1 the lower L_i (block i
    from i-1), band 2 the upper U_i (block i from i+1).  Duplicate
    triplets accumulate."""

    def __init__(self, rows, cols, num_rows: int, block_size: int, order=None):
        rows = np.asarray(rows, np.int64)
        cols = np.asarray(cols, np.int64)
        n = int(num_rows)
        if order is not None:
            order = np.asarray(order, np.int64)
            pos = np.empty(n, np.int64)
            pos[order] = np.arange(n)
            rows, cols = pos[rows], pos[cols]
            self.order, self.pos = order, pos
        else:
            self.order = self.pos = None
        b = int(block_size)
        nb = -(-n // b)
        br, bc = rows // b, cols // b
        d = bc - br
        if np.any(np.abs(d) > 1):
            raise ValueError(f"block size {b} too small: entries couple blocks "
                             f"{int(np.abs(d).max())} apart")
        band = np.where(d == 0, 0, np.where(d < 0, 1, 2))
        rl, cl = rows - br * b, cols - bc * b
        self.block_size = b
        self.num_rows = n
        self.num_blocks = int(nb)
        self.scatter = ((band * nb + br) * b + rl) * b + cl
        self._key = hash((rows.tobytes(), cols.tobytes(), n, b))
        self._on = {}

    @classmethod
    def from_bandwidth(cls, rows, cols, num_rows: int):
        bw = int(np.max(np.abs(np.asarray(rows, np.int64) - np.asarray(cols, np.int64))))
        return cls(rows, cols, num_rows, max(bw, 1))

    @classmethod
    def auto(cls, rows, cols, num_rows: int):
        """The native order or SciPy's reverse-Cuthill-McKee reorder on the
        host, whichever gives the smaller bandwidth, as the JAX package
        picks."""
        import scipy.sparse as sp
        from scipy.sparse.csgraph import reverse_cuthill_mckee

        rows_a = np.asarray(rows, np.int64)
        cols_a = np.asarray(cols, np.int64)
        bw_native = int(np.max(np.abs(rows_a - cols_a)))
        A = sp.csr_matrix((np.ones(len(rows_a)), (rows_a, cols_a)), shape=(num_rows, num_rows))
        order = np.asarray(reverse_cuthill_mckee(A, symmetric_mode=True))
        pos = np.empty(num_rows, np.int64)
        pos[order] = np.arange(num_rows)
        bw_rcm = int(np.max(np.abs(pos[rows_a] - pos[cols_a])))
        if bw_rcm < bw_native:
            return cls(rows, cols, num_rows, max(bw_rcm, 1), order=order)
        return cls(rows, cols, num_rows, max(bw_native, 1))

    def __hash__(self):
        return self._key

    def __eq__(self, other):
        return (isinstance(other, BlockTridiagStructure) and self._key == other._key
                and self.num_rows == other.num_rows and self.block_size == other.block_size)

    def indices(self, device):
        """(scatter, order, pos) as int64 tensors on `device` (order and pos
        None without a reorder)."""
        key = str(torch.device(device))
        if key not in self._on:
            def t(a):
                return None if a is None else torch.as_tensor(a, device=device)

            self._on[key] = (t(self.scatter), t(self.order), t(self.pos))
        return self._on[key]


def bands_from_coo(vals: torch.Tensor, structure: BlockTridiagStructure) -> torch.Tensor:
    """Scatter-accumulate COO values (..., nnz) into dense bands
    (..., 3, nb, b, b)."""
    nb, b = structure.num_blocks, structure.block_size
    flat = index_add(vals, structure.indices(vals.device)[0], 3 * nb * b * b)
    return flat.reshape(vals.shape[:-1] + (3, nb, b, b))


def padded_bands(vals: torch.Tensor, structure: BlockTridiagStructure) -> torch.Tensor:
    """`bands_from_coo` with a unit diagonal on the padded rows of the last
    partial block, so the padded system is nonsingular."""
    bands = bands_from_coo(vals, structure)
    nb, b, n = structure.num_blocks, structure.block_size, structure.num_rows
    if nb * b > n:
        r = torch.arange(n - (nb - 1) * b, b, device=vals.device)
        unit = torch.zeros(bands.shape[-4:], dtype=bands.dtype, device=vals.device)
        unit[0, -1, r, r] = 1.0
        bands = bands + unit
    return bands


def _pad_blocks(D, L, U, f):
    """Pad the block count to 2^m - 1 with identity diagonal blocks
    (decoupled trailing equations with zero rhs)."""
    nb, b = D.shape[-3], D.shape[-1]
    m = 1
    while (1 << m) - 1 < nb:
        m += 1
    pad = (1 << m) - 1 - nb
    if pad:
        eye = torch.eye(b, dtype=D.dtype, device=D.device).expand(D.shape[:-3] + (pad, b, b))
        z = torch.zeros_like(eye)
        D = torch.cat([D, eye], dim=-3)
        L = torch.cat([L, z], dim=-3)
        U = torch.cat([U, z], dim=-3)
        f = torch.cat([f, f.new_zeros(f.shape[:-3] + (pad,) + f.shape[-2:])], dim=-3)
    return D, L, U, f, m


def _bcr_solve_padded(D, L, U, f, m):
    """Cyclic reduction on 2^m - 1 blocks: D, L, U (..., nbp, b, b), f
    (..., nbp, b, k).  Returns x (..., nbp, b, k).  Each level eliminates
    the blocks at even positions with one batched solve of
    [L | U | f]; the back substitution reads x_e = A^-1 f - A^-1 L x_left
    - A^-1 U x_right (absent neighbours carry structurally zero L_0, U_last)."""
    levels = []
    b = D.shape[-1]
    for _ in range(m - 1):
        Do, Lo, Uo, fo = (t[..., 0::2, :, :] for t in (D, L, U, f))
        De, Le, Ue, fe = (t[..., 1::2, :, :] for t in (D, L, U, f))
        sol = torch.linalg.solve(Do, torch.cat([Lo, Uo, fo], dim=-1))
        AinvL, AinvU, Ainvf = sol[..., :b], sol[..., b:2 * b], sol[..., 2 * b:]
        levels.append((Ainvf, AinvL, AinvU))
        D = De - Le @ AinvU[..., :-1, :, :] - Ue @ AinvL[..., 1:, :, :]
        f = fe - Le @ Ainvf[..., :-1, :, :] - Ue @ Ainvf[..., 1:, :, :]
        L = -(Le @ AinvL[..., :-1, :, :])
        U = -(Ue @ AinvU[..., 1:, :, :])
    x = torch.linalg.solve(D, f)                                   # one block left
    for Ainvf, AinvL, AinvU in reversed(levels):
        zero = torch.zeros_like(x[..., :1, :, :])
        xo = (Ainvf - torch.cat([zero, AinvL[..., 1:, :, :] @ x], dim=-3)
              - torch.cat([AinvU[..., :-1, :, :] @ x, zero], dim=-3))
        pairs = torch.stack([xo[..., :-1, :, :], x], dim=-3)      # (..., no-1, 2, b, k)
        x = torch.cat([pairs.reshape(x.shape[:-3] + (-1,) + x.shape[-2:]),
                       xo[..., -1:, :, :]], dim=-3)
    return x


def block_tridiag_solve_bands(D, L, U, rhs):
    """Solve the block-tridiagonal system given its bands D, L, U
    (..., nb, b, b); rhs (nb*b,) or columns (..., nb*b, k), leading axes
    broadcast.  L[0] and U[-1] are ignored."""
    nb, b = D.shape[-3], D.shape[-1]
    single = rhs.dim() == 1
    R = rhs[..., None] if single else rhs
    f = R.reshape(R.shape[:-2] + (nb, b, R.shape[-1]))
    lead = torch.broadcast_shapes(D.shape[:-3], f.shape[:-3])
    D, L, U = (t.expand(lead + t.shape[-3:]) for t in (D, L, U))
    f = f.expand(lead + f.shape[-3:])
    Dp, Lp, Up, fp, m = _pad_blocks(D, L, U, f)
    x = _bcr_solve_padded(Dp, Lp, Up, fp, m)[..., :nb, :, :]
    x = x.reshape(x.shape[:-3] + (nb * b, x.shape[-1]))
    return x[..., 0] if single else x


def solve_columns(bands, R, structure: BlockTridiagStructure):
    """X = A^-1 R for padded bands (..., 3, nb, b, b) and right-hand-side
    columns R (..., n, k), in the structure's node order."""
    _, order, pos = structure.indices(R.device)
    n, npad = structure.num_rows, structure.num_blocks * structure.block_size
    if order is not None:
        R = R[..., order, :]
    R = torch.cat([R, R.new_zeros(R.shape[:-2] + (npad - n, R.shape[-1]))], dim=-2)
    X = block_tridiag_solve_bands(bands[..., 0, :, :, :], bands[..., 1, :, :, :],
                                  bands[..., 2, :, :, :], R)[..., :n, :]
    return X if pos is None else X[..., pos, :]


def block_tridiag_solve(vals, rhs, structure: BlockTridiagStructure):
    """Solve A x = rhs with A given as COO values (..., nnz) on a banded
    ordering, rhs (..., n), fully on the device; leading batch axes of
    either broadcast.  Differentiable by autograd through the BCR."""
    return solve_columns(padded_bands(vals, structure), rhs[..., None], structure)[..., 0]
