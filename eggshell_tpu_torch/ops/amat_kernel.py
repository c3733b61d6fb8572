"""Contact system matrix A = J M^-1 J^T from compact Jacobian blocks: the
hand-written CUDA kernel and its wrapper.

Counterpart of `eggshell_tpu.ops.amat_kernel.contact_system_matrix_packed`,
in the port's scenario-major layout: A (B, mp, mp) with mp = 3K rounded up
to a multiple of 8, and diag (B, mp) = diag(A).

    A[3i+r, 3j+c] = sum over the slot pairs (si, sj) whose lane bodies are
                    equal of (Jc_i[r, si] M^-1_b) . Jc_j[c, sj]

M^-1 enters as the scalar inverse mass (linear half) and the world inverse
inertia invIg (angular half).  Active rows get +cfm on the diagonal;
inactive rows and the padding rows are zero with a unit diagonal.  On a
CUDA tensor the wrapper launches `csrc/amat.cu`; on a CPU tensor it runs the
plain version.  A CUDA input that the kernel does not take raises.
`amat_launch_plan` sizes the kernel's shared memory for K lanes.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from eggshell_tpu_torch.kernels import MAX_SHARED_BYTES, SHARED_TARGET_BYTES

ROW_BLOCK = 8
# Threads a block of `csrc/amat.cu` (its kThreads); a slab's lanes get one
# thread each.
AMAT_THREADS = 128


def round_rows(m: int) -> int:
    """m rows rounded up to a multiple of ROW_BLOCK, the solvers' padding."""
    return -(-m // ROW_BLOCK) * ROW_BLOCK


def padded_rows(K: int) -> int:
    """mp: the 3K rows of K lanes rounded up to a multiple of 8."""
    return round_rows(3 * K)


class AmatPlan(NamedTuple):
    """How `csrc/amat.cu` runs at K lanes: items of `rows` rows of A (mp:
    the whole matrix; else a multiple of 3) built in one shared tile, Jc
    brought in chunks of `chunk` lanes, and `shared_bytes` of shared memory
    a block."""
    rows: int
    chunk: int
    shared_bytes: int


def amat_shared_bytes(K: int, rows: int, chunk: int) -> int:
    """Shared memory of `csrc/amat.cu` (its `layout`): a tile of rows x mp
    floats, two Jc chunks of chunk x 36 floats, X of min(rows, 3K) rows of
    12 floats, a float of invIg a thread, two mbarriers and a count, 3 ints
    a slab lane, 2 a chunk lane and one a lane block."""
    mp = padded_rows(K)
    xrows = min(rows, 3 * K)
    lanes = -(-xrows // 3)
    return (rows * mp * 4 + 2 * chunk * 36 * 4 + xrows * 12 * 4 + AMAT_THREADS * 4
            + 32 + 3 * lanes * 4 + 2 * chunk * 4 + lanes * chunk * 4)


def _plan(K: int, rows: int, chunk: int) -> AmatPlan:
    return AmatPlan(rows, chunk, amat_shared_bytes(K, rows, chunk))


def _largest(lo: int, hi: int, fits) -> int:
    """The largest x in [lo, hi] with fits(x), for a `fits` that holds up
    to some x and not past it; lo - 1 where none does."""
    while lo <= hi:
        mid = (lo + hi) // 2
        if fits(mid):
            lo = mid + 1
        else:
            hi = mid - 1
    return hi


@functools.lru_cache(maxsize=None)
def amat_launch_plan(K: int) -> AmatPlan:
    """The whole of A as one tile and all of Jc as one chunk where that
    fits SHARED_TARGET_BYTES (every K up to 48; the scenes' largest is 32);
    else the largest slab of whole lanes' rows with all of Jc, then a slab
    of one lane's rows and the largest chunk, first within the target and
    then within the card's limit.  Raises ValueError where not even a slab
    of one lane's rows and a chunk of one lane fit a block (K above
    6,426)."""
    if K < 1:
        raise ValueError(f"K = {K}: A needs at least one lane")
    mp = padded_rows(K)
    for limit in (SHARED_TARGET_BYTES, MAX_SHARED_BYTES):
        if amat_shared_bytes(K, mp, K) <= limit:
            return _plan(K, mp, K)
        lanes = _largest(1, K - 1, lambda L: amat_shared_bytes(K, 3 * L, K) <= limit)
        if lanes >= 1:
            return _plan(K, 3 * lanes, K)
        chunk = _largest(1, K - 1, lambda C: amat_shared_bytes(K, 3, C) <= limit)
        if chunk >= 1:
            return _plan(K, 3, chunk)
    raise ValueError(f"K = {K}: one lane's rows of A (mp = {mp}) and one lane of Jc do not "
                     f"fit a block's {MAX_SHARED_BYTES} bytes of shared memory")


def contact_system_matrix_plain(Jc, b0, b1, act, inv_mass, invIg, K: int, cfm: float):
    """Plain torch version of the kernel, in the kernel's order of
    operations.  Jc (B, 3K, 12), b0 / b1 (B, K) int64, act (B, K) bool,
    inv_mass (n,), invIg (B, n, 3, 3).  Returns A (B, mp, mp), diag (B, mp)."""
    B, m = Jc.shape[:2]
    mp = padded_rows(K)
    dtype, dev = Jc.dtype, Jc.device
    J = Jc.reshape(B, m, 2, 6)
    bodies = torch.stack([b0, b1], -1).repeat_interleave(3, dim=1)    # (B, m, 2)
    ok = bodies >= 0
    safe = torch.clamp(bodies, min=0)
    im = torch.where(ok, inv_mass[safe], torch.zeros((), dtype=dtype, device=dev))
    ig = torch.gather(invIg.reshape(B, 1, -1, 9).expand(B, m, -1, 9), 2,
                      safe[..., None].expand(B, m, 2, 9))
    ig = torch.where(ok[..., None], ig, torch.zeros((), dtype=dtype, device=dev))
    X = torch.cat([
        J[..., :3] * im[..., None],
        torch.stack([J[..., 3] * ig[..., c] + J[..., 4] * ig[..., 3 + c]
                     + J[..., 5] * ig[..., 6 + c] for c in range(3)], -1),
    ], -1)                                                             # (B, m, 2, 6)

    val = torch.zeros((B, m, m), dtype=dtype, device=dev)
    for si in range(2):
        for sj in range(2):
            dot = torch.zeros((B, m, m), dtype=dtype, device=dev)
            for e in range(6):
                dot = dot + X[:, :, None, si, e] * J[:, None, :, sj, e]
            same = bodies[:, :, None, si] == bodies[:, None, :, sj]
            val = val + torch.where(same, dot, torch.zeros((), dtype=dtype, device=dev))
    act_rows = act.repeat_interleave(3, dim=1)
    fix = torch.where(act_rows, torch.full((), cfm, dtype=dtype, device=dev),
                      torch.ones((), dtype=dtype, device=dev))
    A = torch.zeros((B, mp, mp), dtype=dtype, device=dev)
    A[:, :m, :m] = val + torch.diag_embed(fix)
    idx = torch.arange(m, mp, device=dev)
    A[:, idx, idx] = 1.0
    return A, torch.diagonal(A, dim1=-2, dim2=-1).contiguous()


def contact_system_matrix(Jc, b0, b1, act, inv_mass, invIg, K: int, cfm: float):
    """A (B, mp, mp) and diag (B, mp); see `contact_system_matrix_plain`
    for the arguments."""
    if Jc.device.type == "cpu":
        return contact_system_matrix_plain(Jc, b0, b1, act, inv_mass, invIg, K, cfm)
    if Jc.device.type != "cuda":
        raise ValueError(f"unsupported device {Jc.device}")
    from eggshell_tpu_torch import kernels

    B = Jc.shape[0]
    n = inv_mass.shape[0]
    mp = padded_rows(K)
    dev = Jc.device
    f32 = torch.float32
    for name, x, shape, dtype in (
        ("Jc", Jc, (B, 3 * K, 12), f32), ("b0", b0, (B, K), torch.int64),
        ("b1", b1, (B, K), torch.int64), ("act", act, (B, K), torch.bool),
        ("inv_mass", inv_mass, (n,), f32), ("invIg", invIg, (B, n, 3, 3), f32),
    ):
        kernels.check_arg(name, x, shape, dtype, dev)
    if Jc.data_ptr() % 16:
        raise ValueError("Jc must be 16-byte aligned: it is copied in bulk")
    plan = amat_launch_plan(K)
    A = torch.empty((B, mp, mp), dtype=f32, device=dev)
    diag = torch.empty((B, mp), dtype=f32, device=dev)
    kernels.launch("eggshell_amat_f32", dev, Jc, b0, b1, act, inv_mass, invIg, A, diag,
                   B, K, n, mp, float(cfm), plan.rows, plan.chunk)
    contact_system_matrix.launches += 1
    return A, diag


contact_system_matrix.launches = 0
