"""Post-solve integration of the fused chain: the hand-written CUDA kernel
and its wrapper.

Counterpart of `eggshell_tpu.ops.integrate_kernel.integrate_step`, in the
port's scenario-major layout.  Per body: J^T lambda from the compact blocks
(the lanes whose slot body is this body; the ground, -1, is no body),
vdot = [inv_mass rhs_lin; invIg rhs_ang] with rhs = F + J^T lambda, the
midpoint position update and the normalised exp-map quaternion update.  On
a CUDA tensor the wrapper launches `csrc/integrate.cu` as
`integrate_launch_plan` says; on a CPU tensor it runs the plain version.  A
CUDA input that the kernel does not take raises.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from eggshell_tpu_torch.kernels import SHARED_TARGET_BYTES

# Threads a block of `csrc/integrate.cu` (its kThreads).
INTEGRATE_THREADS = 256
# Shared bytes a scenario of the tile takes for each lane (Jc's 36 floats,
# 2 x 6 products, 3 lambdas, 2 int64 body ids) and each body (q, p, v, w,
# invIg, F and the 6 sums), and a block for each body (its inverse mass):
# the kernel's kLaneWords and kBodyWords.
LANE_BYTES = 55 * 4
BODY_BYTES = 34 * 4
# The chunk route's bodies a chunk, at most.
MAX_BODY_CHUNK = 256


class IntegratePlan(NamedTuple):
    """How `csrc/integrate.cu` runs: a tile of `scenarios` scenarios a
    block, its lanes in chunks of `lanes` and its bodies in chunks of
    `bodies` (the chunk route where these are fewer than K and n),
    `threads` a block and `shared_bytes` of shared memory."""
    scenarios: int
    lanes: int
    bodies: int
    threads: int
    shared_bytes: int


def integrate_shared_bytes(scenarios: int, lanes: int, bodies: int) -> int:
    """Shared memory of `csrc/integrate.cu` for a tile of `scenarios`, lane
    chunks of `lanes` and body chunks of `bodies`."""
    return scenarios * (lanes * LANE_BYTES + bodies * BODY_BYTES) + bodies * 4


def _plan(S: int, lanes: int, bodies: int) -> IntegratePlan:
    return IntegratePlan(S, lanes, bodies, INTEGRATE_THREADS,
                         integrate_shared_bytes(S, lanes, bodies))


@functools.lru_cache(maxsize=None)
def integrate_launch_plan(B: int, K: int, n: int) -> IntegratePlan:
    """The tile: as many scenarios as give every thread one (lane, slot) of
    the first phase (INTEGRATE_THREADS // 2K, at least 1, at most B), fewer
    where their lanes and bodies pass SHARED_TARGET_BYTES (half the card's
    limit, so that two blocks share an SM).  Where one scenario's lanes and
    bodies pass it too, the chunk route: one scenario a block, bodies in
    chunks of up to MAX_BODY_CHUNK and lanes in the largest chunks that fit.
    Takes every B >= 0, K >= 0 and n >= 1 (B = 0 launches nothing).  The C
    entry computes the same plan and refuses any other."""
    if B < 0 or K < 0 or n < 1:
        raise ValueError(f"B = {B}, K = {K}, n = {n}: integrate needs B >= 0, K >= 0, n >= 1")
    S = max(1, min(B, INTEGRATE_THREADS // max(1, 2 * K)))
    while S > 1 and integrate_shared_bytes(S, K, n) > SHARED_TARGET_BYTES:
        S -= 1
    if integrate_shared_bytes(S, K, n) <= SHARED_TARGET_BYTES:
        return _plan(S, K, n)
    bodies = min(n, MAX_BODY_CHUNK)
    lanes = (SHARED_TARGET_BYTES - integrate_shared_bytes(1, 0, bodies)) // LANE_BYTES
    return _plan(1, min(K, lanes), bodies)


def integrate_step_plain(Jc, lam, b0, b1, p, q, v, w, inv_mass, invIg, F, dt: float):
    """Plain torch version of the kernel, in the kernel's order of
    operations.  Jc (B, 3K, 12); lam (B, L) with L >= 3K, of which the first
    3K are read; b0 / b1 (B, K) int64; p / v / w (B, n, 3); q (B, n, 4);
    inv_mass (n,); invIg (B, n, 3, 3); F (B, n, 6).
    Returns (p, q, v, w) of the next step."""
    return integrate_bodies_plain(jt_lambda_plain(Jc, lam, b0, b1, p.shape[1]), p, q, v, w,
                                  inv_mass, invIg, F, dt)


def jt_lambda_plain(Jc, lam, b0, b1, n: int):
    """J^T lambda (B, n, 6) of the plain version: for k = 0..K-1, slot 0
    then slot 1, the slot's (l0 J0 + l1 J1) + l2 J2 added to the body it
    names (+0 to every other body)."""
    B, K = b0.shape
    J = Jc.reshape(B, K, 3, 12)
    lm = lam[:, :3 * K].reshape(B, K, 3)
    bodies = torch.arange(n, device=Jc.device)
    jtl = torch.zeros((B, n, 6), dtype=Jc.dtype, device=Jc.device)
    for k in range(K):
        for s, bsel in enumerate((b0, b1)):
            Js = J[:, k, :, 6 * s:6 * s + 6]                                  # (B, 3, 6)
            contrib = (lm[:, k, 0, None] * Js[:, 0] + lm[:, k, 1, None] * Js[:, 1]
                       + lm[:, k, 2, None] * Js[:, 2])                         # (B, 6)
            hit = (bsel[:, k, None] == bodies)[..., None]                       # (B, n, 1)
            jtl = jtl + torch.where(hit, contrib[:, None, :], torch.zeros_like(jtl))
    return jtl


def integrate_bodies_plain(jtl, p, q, v, w, inv_mass, invIg, F, dt: float):
    """The plain version's per-body update from J^T lambda (B, n, 6)."""
    rhs = F + jtl
    vdot_lin = inv_mass[:, None] * rhs[..., :3]
    vdot_ang = (invIg[..., 0] * rhs[..., 3:4] + invIg[..., 1] * rhs[..., 4:5]
                + invIg[..., 2] * rhs[..., 5:6])
    vdot = torch.cat([vdot_lin, vdot_ang], -1)
    u = torch.cat([v, w], -1)
    u_new = u + dt * vdot
    u_mid = 0.5 * (u + u_new)
    p_new = p + dt * u_mid[..., :3]

    phi = dt * u_mid[..., 3:]
    p0, p1, p2 = phi.unbind(-1)
    t2 = p0 * p0 + p1 * p1 + p2 * p2
    small = t2 < 1e-12
    safe_t = torch.sqrt(torch.where(small, torch.ones_like(t2), t2))
    kfac = torch.where(small, 0.5 - t2 / 48.0, torch.sin(0.5 * safe_t) / safe_t)
    dw = torch.where(small, 1.0 - t2 / 8.0, torch.cos(0.5 * safe_t))
    dx, dy, dz = kfac * p0, kfac * p1, kfac * p2
    qw, qx, qy, qz = q.unbind(-1)
    nw = dw * qw - dx * qx - dy * qy - dz * qz
    nx = dw * qx + dx * qw + dy * qz - dz * qy
    ny = dw * qy - dx * qz + dy * qw + dz * qx
    nz = dw * qz + dx * qy - dy * qx + dz * qw
    norm = torch.sqrt(nw * nw + nx * nx + ny * ny + nz * nz)
    inv = 1.0 / torch.where(norm > 0, norm, torch.ones_like(norm))
    q_new = torch.stack([nw * inv, nx * inv, ny * inv, nz * inv], -1)
    return p_new, q_new, u_new[..., :3], u_new[..., 3:]


def integrate_step(Jc, lam, b0, b1, p, q, v, w, inv_mass, invIg, F, dt: float, out=None):
    """(p, q, v, w) of the next step; see `integrate_step_plain` for the
    arguments.  With `out`, four tensors of those shapes that none of the
    inputs share, the step is written into them and they are returned (the
    ping-pong state of `parallel.rollout.StepGraph`)."""
    if p.device.type == "cpu":
        new = integrate_step_plain(Jc, lam, b0, b1, p, q, v, w, inv_mass, invIg, F, dt)
        if out is None:
            return new
        for o, x in zip(out, new):
            o.copy_(x)
        return tuple(out)
    if p.device.type != "cuda":
        raise ValueError(f"unsupported device {p.device}")
    from eggshell_tpu_torch import kernels

    B, K = b0.shape
    n = p.shape[1]
    L = lam.shape[-1]
    dev = p.device
    f32 = torch.float32
    if L < 3 * K:
        raise ValueError(f"lam has {L} rows, fewer than 3K = {3 * K}")
    for name, x, shape, dtype in (
        ("Jc", Jc, (B, 3 * K, 12), f32), ("lam", lam, (B, L), f32),
        ("b0", b0, (B, K), torch.int64), ("b1", b1, (B, K), torch.int64),
        ("p", p, (B, n, 3), f32), ("q", q, (B, n, 4), f32), ("v", v, (B, n, 3), f32),
        ("w", w, (B, n, 3), f32), ("inv_mass", inv_mass, (n,), f32),
        ("invIg", invIg, (B, n, 3, 3), f32), ("F", F, (B, n, 6), f32),
    ):
        kernels.check_arg(name, x, shape, dtype, dev)
    if Jc.data_ptr() % 16:
        raise ValueError("Jc must be 16-byte aligned: the kernel copies it in 16-byte pieces")
    if out is None:
        p_new, v_new, w_new = (torch.empty((B, n, 3), dtype=f32, device=dev) for _ in range(3))
        q_new = torch.empty((B, n, 4), dtype=f32, device=dev)
    else:
        p_new, q_new, v_new, w_new = out
        for name, x, shape in (("p out", p_new, (B, n, 3)), ("q out", q_new, (B, n, 4)),
                               ("v out", v_new, (B, n, 3)), ("w out", w_new, (B, n, 3))):
            kernels.check_arg(name, x, shape, f32, dev)
        if q_new.data_ptr() % 16:
            raise ValueError("q out must be 16-byte aligned: the kernel stores it in 16-byte "
                             "pieces")
    plan = integrate_launch_plan(B, K, n)
    kernels.launch("eggshell_integrate_f32", dev, Jc, lam, b0, b1, p, q, v, w, inv_mass, invIg,
                   F, p_new, q_new, v_new, w_new, B, K, n, L, float(dt), *plan)
    integrate_step.launches += 1
    return p_new, q_new, v_new, w_new


integrate_step.launches = 0
