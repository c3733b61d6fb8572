"""Compact contact Jacobian blocks and the LCP right-hand side: the
hand-written CUDA kernel and its wrapper.

Counterpart of `eggshell_tpu.ops.jassembly_kernel.contact_jacobian_blocks`,
in the port's scenario-major layout.  Per lane k, with
Rcf = AlignVectors(normal, z), rows 3k..3k+2 of Jc (B, 3K, 12) are

    slot 0 (body b0): [-Rcf | +Rcf [pos  - p_b0]x]
    slot 1 (body b1): [+Rcf | -Rcf [pos1 - p_b1]x]

and rhs = -erp/dt^2 err - Jc . uhat, err = (0, 0, -depth).  Equality
(ball-joint) lanes flip both signs and take err = pos - pos1.  A slot whose
body is -1 (the ground) or whose lane is inactive is zero.  On a CUDA
tensor the wrapper launches `csrc/jassembly.cu`; on a CPU tensor it runs
the plain version.  A CUDA input that the kernel does not take raises.
"""

from __future__ import annotations

import torch


def align_to_z9(nx, ny, nz):
    """Rotation taking n-hat to z as a row-major list of 9 tensors: the TPU
    kernel's branchless FromTwoVectors(n, z), with its antiparallel fallback
    (180 degrees about n x e, e the axis of least |component|, ties to the
    lower index) and its order of operations.  `ops.quaternion.
    align_vectors_mat` normalises first and rounds differently."""
    w = 1.0 + nz
    qx, qy, qz = ny, -nx, 0.0 * nx
    ax, ay, az = nx.abs(), ny.abs(), nz.abs()
    lx = (ax <= ay) & (ax <= az)
    ly = ~lx & (ay <= az)
    lz = ~lx & ~ly
    ex, ey, ez = (x.to(nx.dtype) for x in (lx, ly, lz))
    ox = ny * ez - nz * ey
    oy = nz * ex - nx * ez
    oz = nx * ey - ny * ex
    safe = torch.clamp(torch.sqrt(ox * ox + oy * oy + oz * oz), min=1e-30)
    anti = w < 1e-8
    qw = torch.where(anti, torch.zeros_like(w), w)
    qx = torch.where(anti, ox / safe, qx)
    qy = torch.where(anti, oy / safe, qy)
    qz = torch.where(anti, oz / safe, qz)
    qn = torch.clamp(torch.sqrt(qw * qw + qx * qx + qy * qy + qz * qz), min=1e-30)
    qw, qx, qy, qz = qw / qn, qx / qn, qy / qn, qz / qn
    xx, yy, zz = qx * qx, qy * qy, qz * qz
    xy, xz, yz = qx * qy, qx * qz, qy * qz
    wx, wy, wz = qw * qx, qw * qy, qw * qz
    return [
        1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy),
        2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx),
        2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy),
    ]


def _gather_bodies(x, b):
    """x (B, n, c) rows of the bodies b (B, K), body -1 read as body 0."""
    idx = torch.clamp(b, min=0)[..., None].expand(*b.shape, x.shape[-1])
    return torch.gather(x, 1, idx)


def contact_jacobian_blocks_plain(b0, b1, pos, pos1, nrm, dep, act, eq, p, uhat,
                                  erp_dt2: float):
    """Plain torch version of the kernel, in the kernel's order of
    operations.  b0 / b1 (B, K) int64, pos / pos1 / nrm (B, K, 3), dep (B, K),
    act (B, K) bool, eq None or (B, K) bool, p (B, n, 3), uhat (B, n, 6).
    Returns Jc (B, 3K, 12) and rhs (B, 3K)."""
    B, K = b0.shape
    R = align_to_z9(nrm[..., 0], nrm[..., 1], nrm[..., 2])
    act_f = act.to(pos.dtype)
    eq_f = torch.zeros_like(act_f) if eq is None else eq.to(pos.dtype)
    sgn_flip = 1.0 - 2.0 * eq_f
    px, py, pz = pos.unbind(-1)
    p1x, p1y, p1z = pos1.unbind(-1)
    rr = [
        -erp_dt2 * (eq_f * (px - p1x)) * act_f,
        -erp_dt2 * (eq_f * (py - p1y)) * act_f,
        -erp_dt2 * (eq_f * (pz - p1z) + (1.0 - eq_f) * (-dep)) * act_f,
    ]
    cols = [[None] * 12 for _ in range(3)]
    for s, (bsel, sgn, anchor) in enumerate(((b0, -1.0, pos), (b1, 1.0, pos1))):
        valid = ((bsel >= 0) & act).to(pos.dtype)
        pb = _gather_bodies(p, bsel)
        ub = _gather_bodies(uhat, bsel)
        cx, cy, cz = (anchor - pb).unbind(-1)
        zero = 0.0 * cx
        C = [zero, -cz, cy, cz, zero, -cx, -cy, cx, zero]
        s_eff = sgn * sgn_flip
        for r in range(3):
            lin = [s_eff * R[3 * r + c] * valid for c in range(3)]
            ang = [-s_eff * (R[3 * r] * C[c] + R[3 * r + 1] * C[3 + c]
                             + R[3 * r + 2] * C[6 + c]) * valid for c in range(3)]
            dot = torch.zeros_like(cx)
            for c in range(3):
                cols[r][6 * s + c] = lin[c]
                cols[r][6 * s + 3 + c] = ang[c]
                dot = dot + lin[c] * ub[..., c] + ang[c] * ub[..., 3 + c]
            rr[r] = rr[r] - dot
    Jc = torch.stack([torch.stack(row, -1) for row in cols], 2)     # (B, K, 3, 12)
    return Jc.reshape(B, 3 * K, 12), torch.stack(rr, -1).reshape(B, 3 * K)


def contact_jacobian_blocks(b0, b1, pos, pos1, nrm, dep, act, eq, p, uhat, erp_dt2: float):
    """Jc (B, 3K, 12) and rhs (B, 3K); see `contact_jacobian_blocks_plain`
    for the arguments.  `eq=None` means no equality lanes."""
    if pos.device.type == "cpu":
        return contact_jacobian_blocks_plain(b0, b1, pos, pos1, nrm, dep, act, eq, p, uhat,
                                             erp_dt2)
    if pos.device.type != "cuda":
        raise ValueError(f"unsupported device {pos.device}")
    from eggshell_tpu_torch import kernels

    B, K = b0.shape
    n = p.shape[1]
    dev = pos.device
    f32 = torch.float32
    args = [("b0", b0, (B, K), torch.int64), ("b1", b1, (B, K), torch.int64),
            ("pos", pos, (B, K, 3), f32), ("pos1", pos1, (B, K, 3), f32),
            ("nrm", nrm, (B, K, 3), f32), ("dep", dep, (B, K), f32),
            ("act", act, (B, K), torch.bool), ("p", p, (B, n, 3), f32),
            ("uhat", uhat, (B, n, 6), f32)]
    if eq is not None:
        args.append(("eq", eq, (B, K), torch.bool))
    for name, x, shape, dtype in args:
        kernels.check_arg(name, x, shape, dtype, dev)
    Jc = torch.empty((B, 3 * K, 12), dtype=f32, device=dev)
    rhs = torch.empty((B, 3 * K), dtype=f32, device=dev)
    kernels.launch("eggshell_jassembly_f32", dev, b0, b1, pos, pos1, nrm, dep, act, eq, p,
                   uhat, Jc, rhs, B, K, n, float(erp_dt2))
    contact_jacobian_blocks.launches += 1
    return Jc, rhs


contact_jacobian_blocks.launches = 0
