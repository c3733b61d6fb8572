"""Per-body pre-solve prep of the fused step: the hand-written CUDA kernel
and its wrapper.

Counterpart of `eggshell_tpu.ops.prep_kernel.prep_packed`, in the port's
scenario-major layout.  Per body: R(q), the world inverse inertia
invIg = R I_b^-1 R^T, the forces F = [m g + ext_lin; -w x (Ig w) + ext_ang]
with the world inertia Ig = R I_b R^T, and uhat = u/dt + M^-1 F.  On a
CUDA tensor the wrapper launches `csrc/prep.cu`; on a CPU tensor it runs
the plain version `prep_bodies_plain`.  A CUDA input that the kernel does
not take raises; there is no fallback.  The kernel takes a tile of
consecutive bodies a block (`prep_launch_plan`); inputs that are views at a
storage offset are taken as they are (the kernel copies a misaligned run
in 4-byte pieces).
"""

from __future__ import annotations

import torch

# Bodies a block of the kernel, largest first (csrc/prep.cu takes these).
TILES = (128, 64, 32)


def prep_launch_plan(bodies: int, sms: int) -> int:
    """Bodies a block of `csrc/prep.cu` for `bodies` = B * n bodies on a
    card of `sms` streaming multiprocessors: the largest tile of TILES that
    still gives every SM two blocks, else the smallest.  A block's bodies
    are one thread each; smaller tiles spread the few warps a small batch
    has over more SMs."""
    for tile in TILES:
        if -(-bodies // tile) >= 2 * sms:
            return tile
    return TILES[-1]


def _mat3_mul(A, B):
    """Row-major 9-element lists of tensors: A @ B, sums in k order."""
    return [A[3 * i] * B[j] + A[3 * i + 1] * B[3 + j] + A[3 * i + 2] * B[6 + j]
            for i in range(3) for j in range(3)]


def _mat3_mul_t(A, B):
    """A @ B^T for row-major 9-element lists of tensors."""
    return [A[3 * i] * B[3 * j] + A[3 * i + 1] * B[3 * j + 1] + A[3 * i + 2] * B[3 * j + 2]
            for i in range(3) for j in range(3)]


def quat_mat9(q):
    """quat_to_mat as a row-major list of 9 tensors, (..., 4) -> (...)."""
    qw, qx, qy, qz = q.unbind(-1)
    xx, yy, zz = qx * qx, qy * qy, qz * qz
    xy, xz, yz = qx * qy, qx * qz, qy * qz
    wx, wy, wz = qw * qx, qw * qy, qw * qz
    return [
        1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy),
        2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx),
        2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy),
    ]


def prep_bodies_plain(q, v, w, inv_mass, inertia_body, inv_inertia_body, dt: float,
                      gravity, ext_forces=None):
    """Plain torch version of the kernel, in the kernel's order of
    operations.  q (B, n, 4), v / w (B, n, 3), inv_mass (n,), inertia_body /
    inv_inertia_body (n, 3, 3), ext_forces None or (B, n, 6).
    Returns uhat (B, n, 6), invIg (B, n, 3, 3), F (B, n, 6)."""
    inv_dt = 1.0 / dt
    R = quat_mat9(q)
    invIg = _mat3_mul_t(_mat3_mul(R, list(inv_inertia_body.reshape(-1, 9).unbind(-1))), R)
    Ig = _mat3_mul_t(_mat3_mul(R, list(inertia_body.reshape(-1, 9).unbind(-1))), R)
    w0, w1, w2 = w.unbind(-1)
    Igw = [Ig[3 * i] * w0 + Ig[3 * i + 1] * w1 + Ig[3 * i + 2] * w2 for i in range(3)]
    fang = [-(w1 * Igw[2] - w2 * Igw[1]), -(w2 * Igw[0] - w0 * Igw[2]),
            -(w0 * Igw[1] - w1 * Igw[0])]
    pos = inv_mass > 0
    mass = torch.where(pos, 1.0 / torch.where(pos, inv_mass, torch.ones_like(inv_mass)),
                       torch.zeros_like(inv_mass))
    flin = [(mass * g).expand(w0.shape) for g in gravity]
    if ext_forces is not None:
        flin = [flin[c] + ext_forces[..., c] for c in range(3)]
        fang = [fang[c] + ext_forces[..., 3 + c] for c in range(3)]
    uhat = [v[..., c] * inv_dt + inv_mass * flin[c] for c in range(3)]
    for i in range(3):
        acc = w[..., i] * inv_dt
        for j in range(3):
            acc = acc + invIg[3 * i + j] * fang[j]
        uhat.append(acc)
    B, n = q.shape[:2]
    return (torch.stack(uhat, -1), torch.stack(invIg, -1).reshape(B, n, 3, 3),
            torch.stack(flin + fang, -1))


def prep_bodies(q, v, w, inv_mass, inertia_body, inv_inertia_body, dt: float, gravity,
                ext_forces=None):
    """uhat (B, n, 6), invIg (B, n, 3, 3), F (B, n, 6) of B scenarios of n
    bodies; see `prep_bodies_plain` for the arguments."""
    if q.device.type == "cpu":
        return prep_bodies_plain(q, v, w, inv_mass, inertia_body, inv_inertia_body, dt,
                                 gravity, ext_forces)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    from eggshell_tpu_torch import kernels

    B, n = q.shape[:2]
    dev = q.device
    f32 = torch.float32
    for name, x, shape in (("q", q, (B, n, 4)), ("v", v, (B, n, 3)), ("w", w, (B, n, 3)),
                           ("inv_mass", inv_mass, (n,)), ("inertia_body", inertia_body, (n, 3, 3)),
                           ("inv_inertia_body", inv_inertia_body, (n, 3, 3))):
        kernels.check_arg(name, x, shape, f32, dev)
    if ext_forces is not None:
        kernels.check_arg("ext_forces", ext_forces, (B, n, 6), f32, dev)
    uhat = torch.empty((B, n, 6), dtype=f32, device=dev)
    invIg = torch.empty((B, n, 3, 3), dtype=f32, device=dev)
    F = torch.empty((B, n, 6), dtype=f32, device=dev)
    gx, gy, gz = (float(g) for g in gravity)
    tile = prep_launch_plan(B * n, torch.cuda.get_device_properties(dev).multi_processor_count)
    kernels.launch("eggshell_prep_f32", dev, q, v, w, ext_forces, inv_mass, inertia_body,
                   inv_inertia_body, uhat, invIg, F, B, n, 1.0 / dt, gx, gy, gz, tile)
    prep_bodies.launches += 1
    return uhat, invIg, F


prep_bodies.launches = 0
