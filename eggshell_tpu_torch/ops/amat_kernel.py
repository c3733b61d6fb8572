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
"""

from __future__ import annotations

import torch

ROW_BLOCK = 8


def round_rows(m: int) -> int:
    """m rows rounded up to a multiple of ROW_BLOCK, the solvers' padding."""
    return -(-m // ROW_BLOCK) * ROW_BLOCK


def padded_rows(K: int) -> int:
    """mp: the 3K rows of K lanes rounded up to a multiple of 8."""
    return round_rows(3 * K)


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
    A = torch.empty((B, mp, mp), dtype=f32, device=dev)
    diag = torch.empty((B, mp), dtype=f32, device=dev)
    kernels.launch("eggshell_amat_f32", dev, Jc, b0, b1, act, inv_mass, invIg, A, diag,
                   B, K, n, mp, float(cfm))
    contact_system_matrix.launches += 1
    return A, diag


contact_system_matrix.launches = 0
