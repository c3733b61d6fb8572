"""Waveguide-port geometry and transverse eigenmodes.

The reference solves a WaveguideModeFEMProblem per port and fits
outgoing fields against the computed modes (rama/solver.cc:251,
rama/solver.h:185-197, 240-243).  Here each port's cross-section is a
1D chain of boundary edges; the transverse mode problem

    psi'' + k^2 eps(t) psi = beta^2 psi        (EZ: psi=0 at the ends;
                                                EXY: natural ends)

is discretised with P1 line elements along the chain and solved as a
small dense generalized eigenproblem on the host at plan time.  For
homogeneous straight ports this reproduces the analytic sin / cos
modes; for dielectric-loaded ports it gives the true modes the analytic
assumption misses.

Ordering is by walking the port's edge chain (not by a coordinate
axis), so diagonal and curved ports are handled correctly; `t` is the
arclength along the chain.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np


def order_edge_chain(edges: np.ndarray) -> np.ndarray:
    """Order the nodes of an open chain of edges (E, 2) by walking from
    one endpoint to the other.  Returns the ordered node array (E+1,).

    Replaces ordering by the dominant coordinate axis (which mis-orders
    diagonal ports) with exact connectivity walking; raises on branching
    or closed chains (a port must be a simple open curve, matching the
    reference's port model, rama/mesh.cc boundary links)."""
    edges = np.asarray(edges)
    if len(edges) == 0:
        raise ValueError("empty port edge set")
    from collections import defaultdict

    adj = defaultdict(list)
    for a, b in edges:
        adj[int(a)].append(int(b))
        adj[int(b)].append(int(a))
    ends = [n for n, nbrs in adj.items() if len(nbrs) == 1]
    if len(ends) != 2 or any(len(v) > 2 for v in adj.values()):
        raise ValueError(
            "port edges do not form a simple open chain "
            f"(endpoints: {len(ends)})"
        )
    start = min(ends)  # deterministic orientation
    chain = [start]
    prev = -1
    cur = start
    for _ in range(len(edges)):
        nxt = [n for n in adj[cur] if n != prev]
        if not nxt:
            break
        prev, cur = cur, nxt[0]
        chain.append(cur)
    if len(chain) != len(edges) + 1:
        raise ValueError("disconnected port edge chain")
    return np.asarray(chain, dtype=int)


def port_eps_profile(mesh, port: int, nodes: np.ndarray) -> np.ndarray:
    """Per-node complex permittivity along the port, sampled from the
    triangles adjacent to each port edge (the local PointG epsilon the
    reference evaluates at port points, rama/solver.cc:101-117)."""
    tri = mesh.triangles
    node_tris = {}
    # map node -> adjacent triangle eps values (port nodes only)
    port_set = set(int(n) for n in nodes)
    eps = np.asarray(mesh.epsilon, complex)
    acc = {n: [] for n in port_set}
    for t in range(len(tri)):
        for v in tri[t]:
            v = int(v)
            if v in acc:
                acc[v].append(eps[t])
    node_tris = np.asarray(
        [np.mean(acc[int(n)]) if acc[int(n)] else 1.0 for n in nodes],
        complex,
    )
    return node_tris


@dataclasses.dataclass
class TransverseModes:
    """First M transverse modes on a port cross-section.

    profiles (M, P): mode shapes at the ordered port nodes, normalized to
        unit maximum absolute value (phase fixed so the max-|.| entry is
        real positive).
    beta2 (M,): propagation constants squared, sorted descending by real
        part (propagating modes first).
    kc2 (M,): equivalent cutoff wavenumbers squared, beta2 = k2_ref - kc2
        evaluated with the plan k2 (exact for homogeneous eps).
    """

    profiles: np.ndarray
    beta2: np.ndarray
    kc2: np.ndarray


def port_weight_profiles(mesh, nodes: np.ndarray, Wxx, Wyy, Wxy):
    """Per-node tangential / normal stiffness-weight profiles along a
    port: wt = t^T W t, wn = n^T W n with W the per-triangle 2D
    stiffness tensor (sigma for EZ, sigma/eps for EXY) averaged over
    each node's adjacent triangles, and (t, n) the port chord frame.
    Feeds the weighted 1D transverse eigenproblem (`transverse_modes`)
    for anisotropic / loaded EXY ports (ref rama/solver.cc:251 intends
    WaveguideModeFEMProblem for exactly these)."""
    tri = np.asarray(mesh.triangles)
    pts = np.asarray(mesh.points)
    Wxx = np.asarray(Wxx, complex)
    Wyy = np.asarray(Wyy, complex)
    Wxy = np.asarray(Wxy, complex)
    port_set = {int(n): i for i, n in enumerate(nodes)}
    accxx = [[] for _ in nodes]
    accyy = [[] for _ in nodes]
    accxy = [[] for _ in nodes]
    for t in range(len(tri)):
        for v in tri[t]:
            i = port_set.get(int(v))
            if i is not None:
                accxx[i].append(Wxx[t])
                accyy[i].append(Wyy[t])
                accxy[i].append(Wxy[t])
    wxx = np.asarray([np.mean(a) if a else 1.0 for a in accxx], complex)
    wyy = np.asarray([np.mean(a) if a else 1.0 for a in accyy], complex)
    wxy = np.asarray([np.mean(a) if a else 0.0 for a in accxy], complex)
    chord = pts[nodes[-1]] - pts[nodes[0]]
    that = chord / max(np.linalg.norm(chord), 1e-30)
    nvec = np.asarray([that[1], -that[0]])
    wt = (wxx * that[0] ** 2 + wyy * that[1] ** 2
          + 2.0 * wxy * that[0] * that[1])
    wn = (wxx * nvec[0] ** 2 + wyy * nvec[1] ** 2
          + 2.0 * wxy * nvec[0] * nvec[1])
    return wt, wn


def transverse_modes(
    t: np.ndarray,
    eps: np.ndarray,
    k2: complex,
    num_modes: int,
    dirichlet: bool,
    w_stiff: np.ndarray = None,
    w_beta: np.ndarray = None,
) -> TransverseModes:
    """Solve the 1D transverse eigenproblem along the port.

    P1 line elements on the arclength nodes `t`:

        (k2 * M_eps - K_ws) psi = beta^2 * M_wb psi

    with per-node mass profile `eps`, stiffness weight `w_stiff`
    (tangential t^T W t of the 2D stiffness tensor along the port) and
    beta-weight `w_beta` (normal n^T W n — the weight multiplying beta^2
    when the 2D operator div(W grad u) + k2 eps u is separated along a
    straight port).  Defaults w_stiff = w_beta = 1 reproduce the
    isotropic EZ problem; EXY ports pass eps = 1 with W = sigma/eps
    profiles; anisotropic EZ ports pass W = sigma.  Dirichlet ends for
    EZ (PEC side walls), natural ends for EXY.
    (ref WaveguideModeFEMProblem, rama/solver.cc:251+)"""
    import scipy.linalg as sla

    t = np.asarray(t, float)
    P = len(t)
    h = np.diff(t)
    if np.any(h <= 0):
        raise ValueError("port nodes not strictly ordered")
    eps = np.asarray(eps, complex)
    ws = (np.ones(P, complex) if w_stiff is None
          else np.asarray(w_stiff, complex))
    wb = (np.ones(P, complex) if w_beta is None
          else np.asarray(w_beta, complex))
    eps_e = 0.5 * (eps[:-1] + eps[1:])      # element-wise eps (midpoint)
    ws_e = 0.5 * (ws[:-1] + ws[1:])
    wb_e = 0.5 * (wb[:-1] + wb[1:])

    K = np.zeros((P, P), complex)
    Mb = np.zeros((P, P), complex)
    Me = np.zeros((P, P), complex)
    for e in range(P - 1):
        i, j = e, e + 1
        k_loc = (ws_e[e] / h[e]) * np.array([[1, -1], [-1, 1]])
        m_loc = (h[e] / 6.0) * np.array([[2, 1], [1, 2]])
        for a, ia in ((0, i), (1, j)):
            for b, ib in ((0, i), (1, j)):
                K[ia, ib] += k_loc[a, b]
                Mb[ia, ib] += wb_e[e] * m_loc[a, b]
                Me[ia, ib] += eps_e[e] * m_loc[a, b]

    A = k2 * Me - K
    B = Mb
    if dirichlet:
        keep = np.arange(1, P - 1)
    else:
        keep = np.arange(P)
    Ar = A[np.ix_(keep, keep)]
    Br = B[np.ix_(keep, keep)]

    herm = (
        abs(np.imag(k2)) < 1e-300 and np.abs(np.imag(eps)).max() < 1e-300
        and np.abs(np.imag(ws)).max() < 1e-300
        and np.abs(np.imag(wb)).max() < 1e-300
        and np.real(wb).min() > 0
    )
    if herm:
        w, v = sla.eigh(np.real(Ar), np.real(Br))
        w = w.astype(complex)
        v = v.astype(complex)
    else:
        w, v = sla.eig(Ar, Br)
    order = np.argsort(-np.real(w))
    w = w[order]
    v = v[:, order]

    m = min(num_modes, len(w))
    profiles = np.zeros((m, P), complex)
    for i in range(m):
        full = np.zeros(P, complex)
        full[keep] = v[:, i]
        # normalize: unit max magnitude, phase of the peak -> +1
        peak = np.argmax(np.abs(full))
        full = full / full[peak] * np.abs(full[peak]) / np.abs(full).max()
        profiles[i] = full
    beta2 = w[:m]
    kc2 = k2 - beta2
    return TransverseModes(profiles=profiles, beta2=beta2, kc2=kc2)


def analytic_profiles(t: np.ndarray, length: float, num_modes: int,
                      dirichlet: bool) -> np.ndarray:
    """sin / cos mode shapes for a homogeneous straight port — the
    closed forms the reference hardcodes (EZ sin TE10, EXY uniform;
    rama/solver.cc:176-196)."""
    t = np.asarray(t, float)
    out = np.zeros((num_modes, len(t)))
    for m in range(num_modes):
        if dirichlet:
            out[m] = np.sin((m + 1) * np.pi * t / length)
        else:
            out[m] = (
                np.ones_like(t) if m == 0
                else np.cos(m * np.pi * t / length)
            )
    return out


def beta_from_beta2(beta2):
    """Branch-cut sqrt: propagating modes get +sqrt, evanescent modes get
    -i |sqrt| so port terms decay (ref rama/solver.cc:146-151, 186-193)."""
    import numpy as np

    beta2 = np.asarray(beta2, complex)
    b = np.sqrt(beta2)
    return np.where(np.real(beta2) < 0, -b, b)
