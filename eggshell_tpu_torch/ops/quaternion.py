"""Quaternion / SO(3) primitives on tensors with any leading batch dims.

Counterpart of `eggshell_tpu.ops.quaternion`: quaternions are (w, x, y, z),
rotations act on column vectors, and every function broadcasts over the
leading dimensions.
"""

from __future__ import annotations

import torch


def cross_mat(a: torch.Tensor) -> torch.Tensor:
    """Skew-symmetric [a]_x with [a]_x b = a x b; (..., 3) -> (..., 3, 3)."""
    ax, ay, az = a[..., 0], a[..., 1], a[..., 2]
    zero = torch.zeros_like(ax)
    return torch.stack(
        [
            torch.stack([zero, -az, ay], dim=-1),
            torch.stack([az, zero, -ax], dim=-1),
            torch.stack([-ay, ax, zero], dim=-1),
        ],
        dim=-2,
    )


def _safe_normalize(v: torch.Tensor):
    """(v/|v|, |v|); zero vectors map to zero."""
    l2 = torch.sum(v * v, dim=-1, keepdim=True)
    valid = l2 > 0
    n_safe = torch.sqrt(torch.where(valid, l2, torch.ones_like(l2)))
    unit = torch.where(valid, v / n_safe, torch.zeros_like(v))
    n = torch.where(valid, n_safe, torch.zeros_like(n_safe))
    return unit, n.squeeze(-1)


def quat_mul(q1: torch.Tensor, q2: torch.Tensor) -> torch.Tensor:
    """Hamilton product q1 * q2, (..., 4) x (..., 4) -> (..., 4)."""
    w1, x1, y1, z1 = q1.unbind(-1)
    w2, x2, y2, z2 = q2.unbind(-1)
    return torch.stack(
        [
            w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
            w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
            w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
            w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
        ],
        dim=-1,
    )


def quat_normalize(q: torch.Tensor) -> torch.Tensor:
    n = torch.linalg.vector_norm(q, dim=-1, keepdim=True)
    return q / torch.where(n > 0, n, torch.ones_like(n))


def quat_to_mat(q: torch.Tensor) -> torch.Tensor:
    """(..., 4) -> (..., 3, 3) rotation matrix."""
    w, x, y, z = q.unbind(-1)
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    return torch.stack(
        [
            torch.stack([1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy)], -1),
            torch.stack([2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx)], -1),
            torch.stack([2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy)], -1),
        ],
        dim=-2,
    )


def quat_from_scaled_axis(phi: torch.Tensor) -> torch.Tensor:
    """Exp-map: rotation vector phi -> unit quaternion, Taylor-safe at 0."""
    t2 = torch.sum(phi * phi, dim=-1, keepdim=True)
    small = t2 < 1e-12
    safe_t = torch.sqrt(torch.where(small, torch.ones_like(t2), t2))
    k = torch.where(small, 0.5 - t2 / 48.0, torch.sin(0.5 * safe_t) / safe_t)
    w = torch.where(small, 1.0 - t2 / 8.0, torch.cos(0.5 * safe_t))
    return torch.cat([w, k * phi], dim=-1)


def integrate_quat(q: torch.Tensor, w: torch.Tensor, dt) -> torch.Tensor:
    """q_new = Q(w dt) * q, renormalised; w is the global angular velocity."""
    return quat_normalize(quat_mul(quat_from_scaled_axis(w * dt), q))


def align_vectors_mat(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Rotation matrix R with R a-hat = b-hat.

    When a ~ -b the half-way quaternion degenerates; the rotation is then
    180 degrees about a-hat x e, e the coordinate axis least aligned with
    a-hat (ties go to the first index, as `torch.argmin` and `jnp.argmin`
    both break them)."""
    ah, _ = _safe_normalize(a)
    bh, _ = _safe_normalize(b)
    w = 1.0 + torch.sum(ah * bh, dim=-1, keepdim=True)
    xyz = torch.linalg.cross(ah, bh, dim=-1)
    q = torch.cat([w, xyz], dim=-1)

    least = torch.argmin(torch.abs(ah), dim=-1)
    e = torch.nn.functional.one_hot(least, 3).to(a.dtype)
    ortho, _ = _safe_normalize(torch.linalg.cross(ah, e, dim=-1))
    q_pi = torch.cat([torch.zeros_like(w), ortho], dim=-1)

    q = torch.where(w < 1e-8, q_pi, q)
    return quat_to_mat(quat_normalize(q))


def box_inertia(mass: torch.Tensor, side_lengths: torch.Tensor) -> torch.Tensor:
    """Body-frame inertia of a solid box, m/12 diag(sy^2+sz^2, ...).

    mass (...,), side_lengths (..., 3) -> (..., 3, 3)."""
    s2 = side_lengths * side_lengths
    d = torch.stack(
        [s2[..., 1] + s2[..., 2], s2[..., 0] + s2[..., 2], s2[..., 0] + s2[..., 1]],
        dim=-1,
    ) * (mass[..., None] / 12.0)
    return torch.diag_embed(d)
