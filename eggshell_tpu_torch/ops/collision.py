"""Branchless SAT box-box and box-ground collision on a batch of pairs.

Counterpart of `eggshell_tpu.ops.collision` with the pair index written
out as the leading dimension instead of `vmap`.  It is the plain version
of the narrowphase kernel (`ops/collision_kernel.py`): the same 15 axes,
contact codes 1-16, fixed-capacity clip of the incident face to at most
`MAX_POLY` points, edge-edge contact and the deep-penetration fallback.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from eggshell_tpu_torch.utils.constants import constant

ALIGNMENT_TOLERANCE = 0.9962
TOL = 1e-9
MAX_POLY = 12
MAX_CONTACTS_PER_PAIR = MAX_POLY
GROUND_CONTACTS = 8


class PairContacts(NamedTuple):
    """Fixed-capacity contact sets of N box pairs (masked lanes)."""

    position: torch.Tensor         # (N, MAX_POLY, 3)
    normal: torch.Tensor           # (N, MAX_POLY, 3)
    depth: torch.Tensor            # (N, MAX_POLY)
    active: torch.Tensor           # (N, MAX_POLY) bool
    code: torch.Tensor             # (N,) int32, 0 = separated
    info_depth: torch.Tensor       # (N,)
    separating_axis: torch.Tensor  # (N, 3)


def _sign(x):
    """(x >= 0) ? 1 : -1 — not sign(0) = 0."""
    return torch.where(x >= 0, 1.0, -1.0).to(x.dtype)


def _dot(a, b):
    return torch.sum(a * b, dim=-1)


def _mv(M, v):
    """M @ v over the batch: (N, 3, 3) x (N, 3) -> (N, 3)."""
    return torch.einsum("nij,nj->ni", M, v)


def _mtv(M, v):
    """M^T @ v over the batch."""
    return torch.einsum("nji,nj->ni", M, v)


def _col(M, idx):
    """Column idx[n] of M[n]: (N, 3, 3), (N,) -> (N, 3)."""
    return torch.gather(M, 2, idx[:, None, None].expand(-1, 3, 1))[..., 0]


def _at(v, idx):
    """v[n, idx[n]]."""
    return torch.gather(v, 1, idx[:, None])[:, 0]


def _sel(mask, a, b):
    shape = mask.shape + (1,) * (a.dim() - mask.dim())
    return torch.where(mask.reshape(shape), a, b)


def _clip_halfspace(poly, count, normal, d):
    """Clip each convex polygon by the halfspace normal . P + d >= 0,
    keeping the emission order: per vertex, the vertex if inside, then the
    crossing point to the next vertex if the edge strictly crosses.

    poly (N, MAX_POLY, 2), count (N,), normal (N, 2), d (N,)."""
    dtype = poly.dtype
    idx = torch.arange(MAX_POLY, device=poly.device)
    valid = idx[None, :] < count[:, None]
    nxt = torch.where(idx[None, :] + 1 >= count[:, None], 0, idx[None, :] + 1)
    p1 = poly
    p2 = torch.gather(poly, 1, nxt[..., None].expand(-1, -1, 2))

    k1 = torch.einsum("npc,nc->np", p1, normal) + d[:, None]
    k2 = torch.einsum("npc,nc->np", p2, normal) + d[:, None]
    inside = (k1 >= 0) & valid
    crosses = (k1 * k2 < 0) & valid
    denom = torch.where(crosses, k2 - k1, torch.ones_like(k1))
    t = k1 / denom
    cross_pt = p1 - t[..., None] * (p2 - p1)

    contrib = inside.to(torch.int64) + crosses.to(torch.int64)
    offs = torch.cumsum(contrib, dim=1) - contrib
    new_count = contrib.sum(dim=1)

    slots = idx[None, :, None]
    sel_vert = (offs[:, None, :] == slots) & inside[:, None, :]
    sel_cross = ((offs + inside.to(torch.int64))[:, None, :] == slots) & crosses[:, None, :]
    out = (torch.einsum("nsi,nic->nsc", sel_vert.to(dtype), p1)
           + torch.einsum("nsi,nic->nsc", sel_cross.to(dtype), cross_pt))
    return out, new_count


def _intersect_box_and_rectangle(Ac, AR, Ah, Rc, RR, Rh):
    """Intersection polygon of box A and rectangle R in R's 2D frame:
    (poly (N, MAX_POLY, 2), count (N,))."""
    N = Ac.shape[0]
    Bc = Ac - Rc
    poly = torch.zeros((N, MAX_POLY, 2), dtype=Ac.dtype, device=Ac.device)
    poly[:, 0, 0], poly[:, 0, 1] = -Rh[:, 0], -Rh[:, 1]
    poly[:, 1, 0], poly[:, 1, 1] = -Rh[:, 0], Rh[:, 1]
    poly[:, 2, 0], poly[:, 2, 1] = Rh[:, 0], Rh[:, 1]
    poly[:, 3, 0], poly[:, 3, 1] = Rh[:, 0], -Rh[:, 1]
    count = torch.full((N,), 4, dtype=torch.int64, device=Ac.device)

    Rnormal = RR[:, :, 2]
    for i in range(3):
        Bn = AR[:, :, i]
        BnBc = _dot(Bn, Bc)
        cr = torch.linalg.vector_norm(torch.linalg.cross(Bn, Rnormal, dim=-1), dim=-1)
        for j in (-1.0, 1.0):
            Bd = -j * BnBc - Ah[:, i]
            Bnormal = -j * Bn
            parallel = cr < TOL
            accept = parallel & (Bd <= 0)
            reject = parallel & (Bd > 0)
            Hnormal = torch.stack(
                [_dot(RR[:, :, 0], Bnormal), _dot(RR[:, :, 1], Bnormal)], dim=-1
            )
            new_poly, new_count = _clip_halfspace(poly, count, Hnormal, -Bd)
            poly = _sel(parallel, poly, new_poly)
            count = torch.where(reject, 0, torch.where(accept, count, new_count))
    return poly, count


def _line_closest_approach(pa, ua, pb, ub):
    """alpha, beta minimising |pa + alpha ua - pb - beta ub|."""
    p = pb - pa
    uaub = _dot(ua, ub)
    q1 = _dot(ua, p)
    q2 = -_dot(ub, p)
    d = 1 - uaub * uaub
    degenerate = d == 0
    safe_d = torch.where(degenerate, torch.ones_like(d), d)
    zero = torch.zeros_like(d)
    alpha = torch.where(degenerate, zero, (q1 + uaub * q2) / safe_d)
    beta = torch.where(degenerate, zero, (uaub * q1 + q2) / safe_d)
    return alpha, beta


def collide_boxes(p1, R1, hs1, p2, R2, hs2) -> PairContacts:
    """SAT box-box collision for N pairs: p (N, 3), R (N, 3, 3), half
    side lengths hs (N, 3)."""
    dtype, device = p1.dtype, p1.device
    N = p1.shape[0]
    H1, H2 = hs1, hs2

    R = R1.transpose(-1, -2) @ R2          # box2 rotation in box1's frame
    p = _mtv(R1, p2 - p1)                  # box2 center in box1's frame
    Q = torch.abs(R)

    aacount = (Q.amax(dim=-2) > ALIGNMENT_TOLERANCE).sum(dim=-1)

    # --- 6 face-normal axes ---
    e1_face = torch.cat([p, _mtv(R, p)], dim=-1)                      # (N, 6)
    r_face = torch.cat([H1 + _mv(Q, H2), _mtv(Q, H1) + H2], dim=-1)
    sep_face = torch.abs(e1_face) - r_face
    normals_face = torch.cat([R1.transpose(-1, -2), R2.transpose(-1, -2)], dim=-2)
    i_fn = torch.argmax(sep_face, dim=-1)
    min_depth_FN = _at(sep_face, i_fn)
    n_fn = torch.gather(normals_face, 1, i_fn[:, None, None].expand(-1, 1, 3))[:, 0]
    sepaxis_FN = _sign(_at(e1_face, i_fn))[:, None] * n_fn
    code_FN = i_fn + 1

    # --- 9 edge x edge axes, a-major, code 7 + 3a + b ---
    eye = torch.eye(3, dtype=dtype, device=device)
    Rt = R.transpose(-1, -2)                                          # rows = columns of R
    n = torch.linalg.cross(
        eye[None, :, None, :].expand(N, 3, 3, 3), Rt[:, None, :, :].expand(N, 3, 3, 3),
        dim=-1,
    ).reshape(N, 9, 3)
    l2 = torch.sum(n * n, dim=-1)
    valid = l2 > TOL * TOL
    length = torch.sqrt(torch.where(valid, l2, torch.ones_like(l2)))
    e1_ee = torch.einsum("nkc,nc->nk", n, p)
    span1 = torch.einsum("nkc,nc->nk", torch.abs(n), H1)
    others = ((1, 2), (0, 2), (0, 1))
    span2 = torch.stack(
        [H2[:, others[b][0]] * Q[:, a, others[b][1]]
         + H2[:, others[b][1]] * Q[:, a, others[b][0]]
         for a in range(3) for b in range(3)],
        dim=-1,
    )
    sep_ee_raw = torch.abs(e1_ee) - (span1 + span2)
    separated_ee = valid & (sep_ee_raw > 0)
    safe_len = torch.where(valid, length, torch.ones_like(length))
    sep_ee = torch.where(valid, sep_ee_raw / safe_len, torch.full_like(l2, -float("inf")))
    i_ee = torch.argmax(sep_ee, dim=-1)
    min_depth_EE = _at(sep_ee, i_ee)
    n_best = torch.gather(n, 1, i_ee[:, None, None].expand(-1, 1, 3))[:, 0]
    scale = _sign(_at(e1_ee, i_ee)) * _at(safe_len, i_ee)
    sepaxis_EE = _mv(R1, n_best / scale[:, None])
    code_EE = 7 + i_ee

    separated = (sep_face > 0).any(dim=-1) | separated_ee.any(dim=-1)

    best_is_FN = min_depth_FN > min_depth_EE
    info_depth = torch.where(best_is_FN, -min_depth_FN, -min_depth_EE)
    info_axis = _sel(best_is_FN, sepaxis_FN, sepaxis_EE)

    # --- edge-edge contact ---
    sa1 = _mtv(R1, sepaxis_EE)
    sa2 = _mtv(R2, sepaxis_EE)
    pa = p1 + _mv(R1, _sign(sa1) * H1)
    pb = p2 - _mv(R2, _sign(sa2) * H2)
    ua = _col(R1, (code_EE - 7) // 3)
    ub = _col(R2, (code_EE - 7) % 3)
    alpha, beta = _line_closest_approach(pa, ua, pb, ub)
    ee_pos = (pa + ua * alpha[:, None] + pb + ub * beta[:, None]) * 0.5
    ee_depth = -min_depth_EE

    # --- face-something contact ---
    A_is_1 = code_FN <= 3
    Ac = _sel(A_is_1, p1, p2)
    AR = _sel(A_is_1, R1, R2)
    Ah = _sel(A_is_1, H1, H2)
    Bc0 = _sel(A_is_1, p2, p1)
    BR0 = _sel(A_is_1, R2, R1)
    Bh0 = _sel(A_is_1, H2, H1)
    Aface_normal = sepaxis_FN * torch.where(A_is_1, 1.0, -1.0).to(dtype)[:, None]

    nf = _mtv(BR0, Aface_normal)
    nf_idx = torch.argmax(torch.abs(nf), dim=-1)
    Bface_normal = -_sign(_at(nf, nf_idx))[:, None] * _col(BR0, nf_idx)
    perm1 = (nf_idx + 1) % 3
    perm2 = (nf_idx + 2) % 3
    Rc = Bc0 + Bface_normal * _at(Bh0, nf_idx)[:, None]
    RRm = torch.stack([_col(BR0, perm1), _col(BR0, perm2), _col(BR0, nf_idx)], dim=-1)
    Rh = torch.stack([_at(Bh0, perm1), _at(Bh0, perm2), torch.zeros_like(Ac[:, 0])], dim=-1)

    face_axis = (code_FN - 1) % 3
    AfaceCenter = Ac + Aface_normal * _at(Ah, face_axis)[:, None]
    Ad = -_dot(Aface_normal, AfaceCenter)

    poly, pcount = _intersect_box_and_rectangle(Ac, AR, Ah, Rc, RRm, Rh)
    lane = torch.arange(MAX_POLY, device=device)
    in_poly = lane[None, :] < pcount[:, None]
    face_pos = (Rc[:, None, :] + poly[:, :, :1] * RRm[:, None, :, 0]
                + poly[:, :, 1:2] * RRm[:, None, :, 1])
    face_depth = -(torch.einsum("npc,nc->np", face_pos, Aface_normal) + Ad[:, None])
    keep = in_poly & ((torch.abs(face_depth) > TOL) | (aacount >= 2)[:, None])
    any_face = keep.any(dim=-1)

    fb_depth = -min_depth_FN

    # --- select the branch ---
    use_ee = (aacount == 0) & ~best_is_FN
    positions = _sel(
        use_ee, ee_pos[:, None, :].expand(N, MAX_POLY, 3),
        _sel(any_face, face_pos, p2[:, None, :].expand(N, MAX_POLY, 3)),
    )
    depths = _sel(
        use_ee, ee_depth[:, None].expand(N, MAX_POLY),
        _sel(any_face, face_depth, fb_depth[:, None].expand(N, MAX_POLY)),
    )
    normal = _sel(use_ee, sepaxis_EE, sepaxis_FN)
    one_lane = (lane == 0)[None, :].expand(N, MAX_POLY)
    active = _sel(use_ee, one_lane, _sel(any_face, keep, one_lane)) & ~separated[:, None]
    code = torch.where(
        separated, 0, torch.where(use_ee, code_EE, torch.where(any_face, code_FN, 16))
    ).to(torch.int32)

    return PairContacts(
        position=positions,
        normal=normal[:, None, :].expand(N, MAX_POLY, 3),
        depth=depths,
        active=active,
        code=code,
        info_depth=torch.where(separated, torch.zeros_like(info_depth), info_depth),
        separating_axis=info_axis,
    )


_CORNER_SIGNS = [[x, y, z] for x in (-1.0, 1.0) for y in (-1.0, 1.0) for z in (-1.0, 1.0)]


def collide_box_and_ground(p, R, hs):
    """8-corner z < 0 ground test over any leading dims: p (..., 3),
    R (..., 3, 3), hs (..., 3) -> position (..., 8, 3), normal (..., 8, 3),
    depth (..., 8), active (..., 8).  Corners in x-major/y/z sign order."""
    signs = constant(_CORNER_SIGNS, p.dtype, p.device)
    corners = p[..., None, :] + (signs * hs[..., None, :]) @ R.transpose(-1, -2)
    active = corners[..., 2] < 0
    depth = -corners[..., 2]
    normal = constant((0.0, 0.0, 1.0), p.dtype, p.device)
    return corners, normal.expand(corners.shape), depth, active
