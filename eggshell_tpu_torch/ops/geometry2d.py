"""2D geometry inlines on tensors, counterpart of
`eggshell_tpu.ops.geometry2d` (toolkit/geometry.h)."""

from __future__ import annotations

import torch


def point_segment_distance(p, a, b):
    """Distance from point(s) p to segment ab (broadcasts)."""
    ab = b - a
    t = torch.clamp(torch.sum((p - a) * ab, -1) / torch.clamp(torch.sum(ab * ab, -1), min=1e-300),
                    0.0, 1.0)
    proj = a + t[..., None] * ab
    return torch.linalg.vector_norm(p - proj, dim=-1)


def segments_intersect(p1, p2, p3, p4, eps=0.0):
    """True where segments p1p2 and p3p4 properly intersect."""
    def cross(o, a, b):
        return ((a[..., 0] - o[..., 0]) * (b[..., 1] - o[..., 1])
                - (a[..., 1] - o[..., 1]) * (b[..., 0] - o[..., 0]))

    d1 = cross(p3, p4, p1)
    d2 = cross(p3, p4, p2)
    d3 = cross(p1, p2, p3)
    d4 = cross(p1, p2, p4)
    return (d1 * d2 < -eps) & (d3 * d4 < -eps)


def _cross_terms(verts):
    x, y = verts[..., 0], verts[..., 1]
    xn, yn = torch.roll(x, -1, -1), torch.roll(y, -1, -1)
    return x, y, xn, yn, x * yn - xn * y


def polygon_area(verts):
    """Signed area (CCW positive), shoelace; verts (..., n, 2)."""
    return 0.5 * torch.sum(_cross_terms(verts)[4], dim=-1)


def polygon_centroid(verts):
    x, y, xn, yn, cr = _cross_terms(verts)
    A = 0.5 * torch.sum(cr, -1)
    cx = torch.sum((x + xn) * cr, -1) / (6 * A)
    cy = torch.sum((y + yn) * cr, -1) / (6 * A)
    return torch.stack([cx, cy], -1)


def point_in_polygon(p, verts):
    """Even-odd test; p (..., 2), verts (n, 2)."""
    x, y = p[..., 0], p[..., 1]
    vx, vy = verts[:, 0], verts[:, 1]
    vx2, vy2 = torch.roll(vx, -1), torch.roll(vy, -1)
    cond = (vy[:, None] <= y[None]) != (vy2[:, None] <= y[None])
    xi = vx[:, None] + (y[None] - vy[:, None]) / (vy2[:, None] - vy[:, None] + 1e-300) * (
        vx2[:, None] - vx[:, None])
    hits = cond & (x[None] < xi)
    return torch.sum(hits, dim=0) % 2 == 1
