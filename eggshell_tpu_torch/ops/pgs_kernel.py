"""Batched projected-Jacobi LCP solves: the hand-written CUDA kernels and
their wrappers.

- `solve_lcp_jacobi`: counterpart of
  `eggshell_tpu.ops.pgs_kernel.solve_lcp_jacobi_pallas` (scalar form,
  block=False), with bounds given per row; kernel `csrc/jacobi.cu`.
- `solve_lcp_jacobi_packed`: counterpart of
  `eggshell_tpu.ops.pgs_kernel.solve_lcp_jacobi_packed` (block=False,
  pyramid_mu=0), the fused chain's solve, with box-friction bounds built
  from the lane masks.  It takes the JAX package's resident/streamed
  switch (`stream`, see `streams_a`): resident, kernel
  `csrc/jacobi_packed.cu` (A copied into shared memory once); streamed,
  `solve_lcp_jacobi_packed_stream` (B6b), kernel
  `csrc/jacobi_packed_stream.cu` (A read from device memory in row chunks
  on every sweep).  Both compute the same sweeps, sum for sum.

On a CUDA tensor a wrapper launches its kernel; on a CPU tensor it runs
its plain version.  A CUDA input that the kernel does not take raises;
there is no fallback.
"""

from __future__ import annotations

import torch

from eggshell_tpu_torch.ops import lcp
from eggshell_tpu_torch.ops.amat_kernel import ROW_BLOCK, padded_rows, round_rows

# Hopper: 227 KB of shared memory per block (232,448 bytes).
MAX_SHARED_BYTES = 232_448
# Stand-in for hi = inf, as the TPU kernel has it.
HI_INF = 3.4e38
# The JAX package's switch to the streamed solve (`pgs_kernel.py:343`,
# `:523-524`): the double-buffered A of 128 scenarios over 5 MiB of TPU
# VMEM, i.e. mp >= 72 (K >= 22 lanes, joints counted).  It is a TPU budget,
# kept so that the port takes the streamed kernel on the same
# configurations; the card's own switch is ROADMAP work.
_TPU_LANES = 128
_VMEM_A_BUDGET = 5 * 1024 * 1024


def streams_a(mp: int) -> bool:
    """Whether `solve_lcp_jacobi_packed(stream=None)` streams A for mp rows."""
    return mp * mp * _TPU_LANES * 4 * 2 > _VMEM_A_BUDGET


def _shared_bytes(mp: int) -> int:
    """Shared memory of one scenario's block: A with a row stride of
    mp + 1 floats, and the iterate."""
    return (mp * (mp + 1) + mp) * 4


def solve_lcp_jacobi_plain(A, b, is_eq, lo, hi, iters: int, omega: float,
                           beta: float = 0.0):
    """Plain torch version of the kernel: rows padded to a multiple of 8
    (unit diagonal, zero rhs, equality), hi = inf replaced by 3.4e38,
    x0 = proj(b), then `iters` heavy-ball sweeps.  Returns x (B, m)."""
    B, m = b.shape
    mp = round_rows(m)
    if mp != m:
        pad = mp - m
        A = torch.nn.functional.pad(A, (0, pad, 0, pad))
        unit = torch.cat([torch.zeros(m, dtype=A.dtype, device=A.device),
                          torch.ones(pad, dtype=A.dtype, device=A.device)])
        A = A + torch.diag(unit)
        b = torch.nn.functional.pad(b, (0, pad))
        is_eq = torch.nn.functional.pad(is_eq, (0, pad), value=True)
        lo = torch.nn.functional.pad(lo, (0, pad))
        hi = torch.nn.functional.pad(hi, (0, pad))
    hi = torch.where(torch.isinf(hi), torch.full_like(hi, HI_INF), hi)
    diag = torch.diagonal(A, dim1=-2, dim2=-1)
    inv_diag = 1.0 / diag
    x = lcp.project(b, is_eq, lo, hi)
    xp = x
    for _ in range(iters):
        x, xp = lcp.jacobi_momentum_sweep(A, b, diag, inv_diag, x, xp, is_eq,
                                          lo, hi, omega, beta)
    return x[:, :m]


def solve_lcp_jacobi(A, b, is_eq, lo, hi, iters: int, omega: float,
                     beta: float = 0.0):
    """Batched under-relaxed heavy-ball projected Jacobi:
    A (B, m, m), b / lo / hi (B, m), is_eq (B, m) bool -> x (B, m)."""
    if A.device.type == "cpu":
        return solve_lcp_jacobi_plain(A, b, is_eq, lo, hi, iters, omega, beta)
    if A.device.type != "cuda":
        raise ValueError(f"unsupported device {A.device}")
    from eggshell_tpu_torch import kernels

    B, m = b.shape
    dev = A.device
    mp = round_rows(m)
    if _shared_bytes(mp) > MAX_SHARED_BYTES:
        raise ValueError(
            f"m = {m} needs {_shared_bytes(mp)} bytes of shared memory per "
            f"block, more than the {MAX_SHARED_BYTES} an H100 block has"
        )
    for name, x, shape, dtype in (
        ("A", A, (B, m, m), torch.float32), ("b", b, (B, m), torch.float32),
        ("is_eq", is_eq, (B, m), torch.bool), ("lo", lo, (B, m), torch.float32),
        ("hi", hi, (B, m), torch.float32),
    ):
        kernels.check_arg(name, x, shape, dtype, dev)
    hi = torch.where(torch.isinf(hi), torch.full_like(hi, HI_INF), hi)
    out = torch.empty((B, m), dtype=torch.float32, device=dev)
    kernels.launch("eggshell_jacobi_f32", dev, A, b, is_eq, lo, hi, out, B, m, mp, int(iters),
                   float(omega), float(beta))
    solve_lcp_jacobi.launches += 1
    return out


solve_lcp_jacobi.launches = 0


def _packed_bounds(act, eq, K: int, mp: int, mu: float, dtype):
    """Per-row (active, lo, hi), each (B, mp), of the fused chain's LCP:
    equality lanes free, tangential rows (row % 3 < 2) in [-mu, mu], normal
    rows in [0, 3.4e38]; inactive lanes and padding rows inactive."""
    B = act.shape[0]
    dev = act.device
    m = 3 * K
    pad = mp - m
    active = torch.nn.functional.pad(act.repeat_interleave(3, dim=1), (0, pad))
    tangential = (torch.arange(m, device=dev) % 3 < 2).expand(B, m)
    lo = torch.where(tangential, torch.full((), -mu, dtype=dtype, device=dev),
                     torch.zeros((), dtype=dtype, device=dev))
    hi = torch.where(tangential, torch.full((), mu, dtype=dtype, device=dev),
                     torch.full((), HI_INF, dtype=dtype, device=dev))
    if eq is not None:
        eq3 = eq.repeat_interleave(3, dim=1)
        lo = torch.where(eq3, torch.full((), -HI_INF, dtype=dtype, device=dev), lo)
        hi = torch.where(eq3, torch.full((), HI_INF, dtype=dtype, device=dev), hi)
    lo = torch.nn.functional.pad(lo, (0, pad))
    hi = torch.nn.functional.pad(hi, (0, pad))
    return active, lo, hi


def _check_packed_options(block: bool, pyramid_mu: float) -> None:
    if block:
        raise NotImplementedError(
            "block-Jacobi on the fused chain is not ported yet (ROADMAP B6: block and pyramid)")
    if pyramid_mu > 0.0:
        raise NotImplementedError(
            "Coulomb-pyramid bounds on the fused chain are not ported yet "
            "(ROADMAP B6: block and pyramid)")


def solve_lcp_jacobi_packed_plain(A, diag, rhs, act, eq, K: int, mu: float, iters: int,
                                  omega: float, beta: float, block: bool = False,
                                  pyramid_mu: float = 0.0):
    """Plain torch version of the kernel.  A (B, mp, mp) with its diagonal
    diag (B, mp), rhs (B, 3K), act (B, K) bool, eq None or (B, K) bool.
    x0 = proj(b), then `iters` heavy-ball sweeps.  Returns x (B, mp)."""
    _check_packed_options(block, pyramid_mu)
    mp = A.shape[-1]
    active, lo, hi = _packed_bounds(act, eq, K, mp, mu, A.dtype)
    b = torch.nn.functional.pad(rhs, (0, mp - 3 * K))
    not_eq = torch.zeros_like(active)

    def proj(x):
        return torch.where(active, lcp.project(x, not_eq, lo, hi), x)

    inv_diag = 1.0 / diag
    x = proj(b)
    xp = x
    for _ in range(iters):
        r = b - torch.einsum("bij,bj->bi", A, x) + diag * x
        x, xp = proj((1.0 - omega) * x + omega * r * inv_diag + beta * (x - xp)), x
    return x


def _check_packed_args(A, diag, rhs, act, eq, K: int) -> None:
    from eggshell_tpu_torch import kernels

    B, mp = diag.shape
    if mp != padded_rows(K):
        raise ValueError(f"diag has {mp} rows, expected 3K = {3 * K} rounded up to {ROW_BLOCK}")
    args = [("A", A, (B, mp, mp), torch.float32), ("diag", diag, (B, mp), torch.float32),
            ("rhs", rhs, (B, 3 * K), torch.float32), ("act", act, (B, K), torch.bool)]
    if eq is not None:
        args.append(("eq", eq, (B, K), torch.bool))
    for name, x, shape, dtype in args:
        kernels.check_arg(name, x, shape, dtype, A.device)


def solve_lcp_jacobi_packed_stream(A, diag, rhs, act, eq, K: int, mu: float, iters: int,
                                   omega: float, beta: float):
    """B6b: x (B, mp) of the fused chain's LCP with A streamed from device
    memory on every sweep; the arguments and the plain version are those of
    `solve_lcp_jacobi_packed_plain` (box friction, scalar sweeps)."""
    if A.device.type == "cpu":
        return solve_lcp_jacobi_packed_plain(A, diag, rhs, act, eq, K, mu, iters, omega, beta)
    if A.device.type != "cuda":
        raise ValueError(f"unsupported device {A.device}")
    from eggshell_tpu_torch import kernels

    _check_packed_args(A, diag, rhs, act, eq, K)
    B, mp = diag.shape
    out = torch.empty((B, mp), dtype=torch.float32, device=A.device)
    kernels.launch("eggshell_jacobi_packed_stream_f32", A.device, A, diag, rhs, act, eq, out, B,
                   K, mp, int(iters), float(mu), float(omega), float(beta))
    solve_lcp_jacobi_packed_stream.launches += 1
    return out


solve_lcp_jacobi_packed_stream.launches = 0


def solve_lcp_jacobi_packed(A, diag, rhs, act, eq, K: int, mu: float, iters: int,
                            omega: float, beta: float, block: bool = False,
                            pyramid_mu: float = 0.0, stream=None):
    """x (B, mp) of the fused chain's LCP; see `solve_lcp_jacobi_packed_plain`
    for the arguments.  `stream` None takes the JAX package's rule
    (`streams_a`); True goes to `solve_lcp_jacobi_packed_stream`, where, as
    in the JAX package, `block=True` and `pyramid_mu > 0` raise ValueError.
    On the resident kernel they raise NotImplementedError (not ported)."""
    if stream is None:
        stream = streams_a(padded_rows(K))
    if stream:
        if block:
            raise ValueError(
                "solve_lcp_jacobi_packed: block-Jacobi (jacobi_block=True) is not available on "
                f"the streamed-A path (contact capacity {K}); use jacobi_block=False or reduce "
                "contact_capacity")
        if pyramid_mu > 0.0:
            raise ValueError(
                "solve_lcp_jacobi_packed: COULOMB_PYRAMID bounds are not available on the "
                "streamed-A path; reduce contact_capacity below the stream threshold")
        return solve_lcp_jacobi_packed_stream(A, diag, rhs, act, eq, K, mu, iters, omega, beta)
    if A.device.type == "cpu":
        return solve_lcp_jacobi_packed_plain(A, diag, rhs, act, eq, K, mu, iters, omega, beta,
                                             block, pyramid_mu)
    if A.device.type != "cuda":
        raise ValueError(f"unsupported device {A.device}")
    _check_packed_options(block, pyramid_mu)
    from eggshell_tpu_torch import kernels

    _check_packed_args(A, diag, rhs, act, eq, K)
    B, mp = diag.shape
    if _shared_bytes(mp) > MAX_SHARED_BYTES:
        raise ValueError(
            f"K = {K} needs {_shared_bytes(mp)} bytes of shared memory per "
            f"block, more than the {MAX_SHARED_BYTES} an H100 block has"
        )
    out = torch.empty((B, mp), dtype=torch.float32, device=A.device)
    kernels.launch("eggshell_jacobi_packed_f32", A.device, A, diag, rhs, act, eq, out, B, K, mp,
                   int(iters), float(mu), float(omega), float(beta))
    solve_lcp_jacobi_packed.launches += 1
    return out


solve_lcp_jacobi_packed.launches = 0
