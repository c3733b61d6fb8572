"""Batched projected-Jacobi LCP solve: the hand-written CUDA kernel and
its wrapper.

Counterpart of `eggshell_tpu.ops.pgs_kernel.solve_lcp_jacobi_pallas`
(scalar form, block=False).  On a CUDA tensor the wrapper launches
`csrc/jacobi.cu`; on a CPU tensor it runs the plain version
`solve_lcp_jacobi_plain`.  A CUDA input that the kernel does not take
raises; there is no fallback.
"""

from __future__ import annotations

import torch

from eggshell_tpu_torch.ops import lcp

ROW_BLOCK = 8
# Hopper: 227 KB of shared memory per block (232,448 bytes).
MAX_SHARED_BYTES = 232_448
# Stand-in for hi = inf, as the TPU kernel has it.
HI_INF = 3.4e38


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


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
    mp = _round_up(m, ROW_BLOCK)
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
    mp = _round_up(m, ROW_BLOCK)
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
    lib = kernels.load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.eggshell_jacobi_f32(
            A.data_ptr(), b.data_ptr(), is_eq.data_ptr(), lo.data_ptr(),
            hi.data_ptr(), out.data_ptr(), B, m, mp, int(iters), float(omega),
            float(beta), stream,
        )
    if err != 0:
        raise RuntimeError(f"Jacobi kernel launch failed: {kernels.error_string(err)}")
    solve_lcp_jacobi.launches += 1
    return out


solve_lcp_jacobi.launches = 0
