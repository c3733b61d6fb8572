"""Far-field antenna patterns from near-field FEM solutions — the
rama antenna tier (ComputeAntennaPattern / directivity / phase-center,
ref rama/solver.h:208-224).

2D Kirchhoff aperture integration over the ABC (radiation) boundary:
with outward normal n and far direction r-hat,

  F(phi) = sum over ABC edges of
           L_e [ j k (n . r-hat) u_mid - du/dn ] exp(j k r-hat . r_mid)

(the common factors of the 2D Green's function asymptotics are dropped —
patterns are relative).  `directivity` = max/mean of |F|^2;
`phase_center` finds the origin shift that flattens the pattern phase
over the main lobe (the reference's phase-center adjustment).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from eggshell_tpu_torch.fem.mesher import Mesh


def _abc_edge_data(mesh: Mesh, field: np.ndarray):
    """Midpoints, outward normals, lengths, u_mid, du/dn for ABC edges."""
    edges = mesh.boundary_edges[mesh.edge_kind == 2]
    if len(edges) == 0:
        raise ValueError("mesh has no ABC (radiation) boundary edges")
    pts = mesh.points
    tri = mesh.triangles
    f = np.asarray(field)

    mids = 0.5 * (pts[edges[:, 0]] + pts[edges[:, 1]])
    tang = pts[edges[:, 1]] - pts[edges[:, 0]]
    lens = np.linalg.norm(tang, axis=1)
    nrm = np.stack([tang[:, 1], -tang[:, 0]], axis=1) / lens[:, None]

    # orient normals outward: away from the domain centroid
    centroid = pts.mean(axis=0)
    flip = np.sum(nrm * (mids - centroid), axis=1) < 0
    nrm[flip] *= -1

    u_mid = 0.5 * (f[edges[:, 0]] + f[edges[:, 1]])

    # du/dn from the owning triangle's P1 gradient
    edge_set = {tuple(sorted(e)): i for i, e in enumerate(edges)}
    dudn = np.zeros(len(edges), dtype=complex)
    for t in tri:
        for a, b in ((0, 1), (1, 2), (2, 0)):
            key = tuple(sorted((t[a], t[b])))
            i = edge_set.get(key)
            if i is None:
                continue
            p0, p1, p2 = pts[t[0]], pts[t[1]], pts[t[2]]
            area2 = (p1[0] - p0[0]) * (p2[1] - p0[1]) - (p1[1] - p0[1]) * (
                p2[0] - p0[0]
            )
            bvec = np.array([p1[1] - p2[1], p2[1] - p0[1], p0[1] - p1[1]])
            cvec = np.array([p2[0] - p1[0], p0[0] - p2[0], p1[0] - p0[0]])
            gx = np.sum(f[t] * bvec) / area2
            gy = np.sum(f[t] * cvec) / area2
            dudn[i] = gx * nrm[i, 0] + gy * nrm[i, 1]
    return mids, nrm, lens, u_mid, dudn


def _pattern(edge_data, k0: float, angles: np.ndarray, origin) -> np.ndarray:
    mids, nrm, lens, u_mid, dudn = edge_data
    mids = mids - np.asarray(origin)[None, :]
    rhat = np.stack([np.cos(angles), np.sin(angles)], axis=1)  # (A, 2)
    phase = np.exp(1j * k0 * (rhat @ mids.T))                  # (A, E)
    n_dot_r = rhat @ nrm.T                                     # (A, E)
    # Green's identity with G ~ exp(+j k rhat.r') (engineering
    # exp(+j w t), outgoing exp(-j k r)):
    #   F = contour integral of [u dG/dn - G du/dn]
    #     = sum e^{j k rhat.r'} [ j k (n.rhat) u  -  du/dn ] L_e
    # (for an outgoing wave du/dn = -j k u, so the bracket peaks at
    # 2 j k u in the facing direction and vanishes behind).
    integrand = (1j * k0 * n_dot_r * u_mid[None, :] - dudn[None, :])
    return (integrand * phase) @ lens


def antenna_pattern(
    mesh: Mesh, field, k0: float, angles: np.ndarray,
    origin: Tuple[float, float] = (0.0, 0.0),
) -> np.ndarray:
    """Complex far-field F(angles) from the ABC boundary."""
    return _pattern(_abc_edge_data(mesh, field), k0, angles, origin)


def directivity(pattern: np.ndarray) -> float:
    """max/mean of |F|^2 (ref _Directivity)."""
    p2 = np.abs(pattern) ** 2
    return float(p2.max() / p2.mean())


def phase_center(
    mesh: Mesh, field, k0: float, angles: np.ndarray,
    search_radius: float = 1.0, grid: int = 21,
) -> Tuple[float, float]:
    """Origin shift minimising the phase spread of the pattern over the
    given angles (ref phase-center adjustment, rama/solver.h:208-224)."""
    edge_data = _abc_edge_data(mesh, field)    # independent of the origin
    best = (0.0, 0.0)
    best_spread = np.inf
    for ox in np.linspace(-search_radius, search_radius, grid):
        for oy in np.linspace(-search_radius, search_radius, grid):
            pat = _pattern(edge_data, k0, angles, (ox, oy))
            w = np.abs(pat)
            if w.max() <= 0:
                continue
            ph = np.unwrap(np.angle(pat))
            spread = np.sqrt(np.average((ph - np.average(ph, weights=w)) ** 2,
                                        weights=w))
            if spread < best_spread:
                best_spread = spread
                best = (float(ox), float(oy))
    return best
