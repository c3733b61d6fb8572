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


def quat_identity(dtype=torch.float32, device="cuda") -> torch.Tensor:
    """The identity rotation (1, 0, 0, 0), on the card unless `device`
    says otherwise, as the scene builders make theirs."""
    return torch.tensor([1.0, 0.0, 0.0, 0.0], dtype=dtype, device=device)


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


def quat_conj(q: torch.Tensor) -> torch.Tensor:
    return q * torch.tensor([1.0, -1.0, -1.0, -1.0], dtype=q.dtype, device=q.device)


def quat_normalize(q: torch.Tensor) -> torch.Tensor:
    n = torch.linalg.vector_norm(q, dim=-1, keepdim=True)
    return q / torch.where(n > 0, n, torch.ones_like(n))


def quat_rotate(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """R(q) v in the two-cross-product form v + 2 w (u x v) + 2 u x (u x v)."""
    u = q[..., 1:]
    w = q[..., :1]
    uv = torch.linalg.cross(u, v, dim=-1)
    return v + 2.0 * (w * uv + torch.linalg.cross(u, uv, dim=-1))


def quat_rotate_inv(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return quat_rotate(quat_conj(q), v)


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


def mat_to_quat(R: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) -> (..., 4): all four Shepperd candidates, the one of the
    largest 4 c^2 taken (ties to the first), sign canonicalised to w >= 0."""
    m = R
    t0 = 1.0 + m[..., 0, 0] + m[..., 1, 1] + m[..., 2, 2]  # 4w^2
    t1 = 1.0 + m[..., 0, 0] - m[..., 1, 1] - m[..., 2, 2]  # 4x^2
    t2 = 1.0 - m[..., 0, 0] + m[..., 1, 1] - m[..., 2, 2]  # 4y^2
    t3 = 1.0 - m[..., 0, 0] - m[..., 1, 1] + m[..., 2, 2]  # 4z^2

    def root(t):
        return torch.sqrt(torch.clamp(t, min=1e-12))

    def s(t):
        return 0.5 / root(t)

    d10, d02 = m[..., 1, 0] - m[..., 0, 1], m[..., 0, 2] - m[..., 2, 0]
    d21 = m[..., 2, 1] - m[..., 1, 2]
    s01, s02 = m[..., 0, 1] + m[..., 1, 0], m[..., 0, 2] + m[..., 2, 0]
    s12 = m[..., 1, 2] + m[..., 2, 1]
    q0 = torch.stack([0.5 * root(t0), d21 * s(t0), d02 * s(t0), d10 * s(t0)], -1)
    q1 = torch.stack([d21 * s(t1), 0.5 * root(t1), s01 * s(t1), s02 * s(t1)], -1)
    q2 = torch.stack([d02 * s(t2), s01 * s(t2), 0.5 * root(t2), s12 * s(t2)], -1)
    q3 = torch.stack([d10 * s(t3), s02 * s(t3), s12 * s(t3), 0.5 * root(t3)], -1)
    idx = torch.argmax(torch.stack([t0, t1, t2, t3], -1), dim=-1)
    qs = torch.stack([q0, q1, q2, q3], -2)                             # (..., 4, 4)
    q = torch.take_along_dim(qs, idx[..., None, None].expand(idx.shape + (1, 4)), dim=-2)[..., 0, :]
    return quat_normalize(torch.where(q[..., :1] < 0, -q, q))


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


def gram_schmidt(m: torch.Tensor) -> torch.Tensor:
    """Column-wise Gram-Schmidt of (..., 3, 3); zero columns stay zero."""
    c0, c1, c2 = m[..., :, 0], m[..., :, 1], m[..., :, 2]
    u0, _ = _safe_normalize(c0)
    u1, _ = _safe_normalize(c1 - torch.sum(c1 * u0, -1, keepdim=True) * u0)
    u2 = c2 - torch.sum(c2 * u0, -1, keepdim=True) * u0
    u2, _ = _safe_normalize(u2 - torch.sum(u2 * u1, -1, keepdim=True) * u1)
    return torch.stack([u0, u1, u2], dim=-1)


def random_quat(generator: torch.Generator, shape=(), dtype=torch.float32) -> torch.Tensor:
    """Uniform random unit quaternions of `shape`, drawn on `generator`'s
    device (the JAX package takes a key where this takes a generator)."""
    q = torch.randn(tuple(shape) + (4,), generator=generator, dtype=dtype,
                    device=generator.device)
    return quat_normalize(q)


def random_rotation(generator: torch.Generator, shape=(), dtype=torch.float32) -> torch.Tensor:
    return quat_to_mat(random_quat(generator, shape, dtype))


def is_orthonormal(R: torch.Tensor, tol: float = 1e-9) -> torch.Tensor:
    """Whether every entry of R^T R - I is below `tol` in magnitude."""
    eye = torch.eye(3, dtype=R.dtype, device=R.device)
    err = torch.abs(R.transpose(-1, -2) @ R - eye)
    return torch.all((err < tol).flatten(-2), dim=-1)


def box_inertia(mass: torch.Tensor, side_lengths: torch.Tensor) -> torch.Tensor:
    """Body-frame inertia of a solid box, m/12 diag(sy^2+sz^2, ...).

    mass (...,), side_lengths (..., 3) -> (..., 3, 3)."""
    s2 = side_lengths * side_lengths
    d = torch.stack(
        [s2[..., 1] + s2[..., 2], s2[..., 0] + s2[..., 2], s2[..., 0] + s2[..., 1]],
        dim=-1,
    ) * (mass[..., None] / 12.0)
    return torch.diag_embed(d)
