"""P1 FEM Helmholtz solver, counterpart of `eggshell_tpu.fem.helmholtz`
(the rama solver tier: EZ, EXY, ES and SCHRODINGER problems, matched
waveguide ports, absorbing and custom Robin walls, S-parameters).

`plan_driven` takes the problem's static structure from the mesh on the
host (numpy: COO sparsity, port chains and mode profiles, Dirichlet
masks); `solve_driven_core` is a differentiable torch function of the
points, the materials and k0 that assembles the triplet values, solves and
projects S-parameters.  k0 may carry a leading batch axis (a sweep's
frequencies): assembly, the dense solve and the BCR run batched, the host
SuperLU and BiCGStab take one system after another.  The solves:

- dense (N <= DENSE_MAX_N, `solver="auto"`): `torch.linalg.solve`;
- "sparse": the JAX package's own host solve, SciPy's SuperLU
  (`fem.sparse.sparse_solve_structured`);
- "bicgstab": Jacobi-preconditioned BiCGStab on the device;
- "bcr": block cyclic reduction on the device (`fem.block_tridiag`).

Where the JAX package reads `jax_enable_x64` for its complex dtype, the
port takes `dtype` (complex128 by default, complex64 on request).  Every
entry that makes tensors takes a `device`, "cuda" by default.
`solve_modes` runs the JAX package's own host solve (SciPy's ARPACK
shift-invert) or a device eigensolver, and raises on an unknown method.
"""

from __future__ import annotations

import dataclasses
import math
import warnings
from typing import Dict, List, Optional

import numpy as np
import torch

from eggshell_tpu_torch.fem import ports as portlib
from eggshell_tpu_torch.fem import sparse as sparselib
from eggshell_tpu_torch.fem.mesher import Mesh

C0 = 299792458.0


def _real_dtype(dtype):
    return torch.float64 if dtype == torch.complex128 else torch.float32


@dataclasses.dataclass(frozen=True)
class FemConfig:
    """ScriptConfig analog (ref rama/solver.h:42-126)."""

    type: str = "EZ"                   # EZ | EXY | ES | SCHRODINGER
    frequency: float = 10e9            # Hz (EZ/EXY)
    excited_port: int = 1
    excited_mode: int = 1              # 1-based mode index on the port
    unit: float = 1.0                  # geometry unit in meters
    depth: float = np.inf              # out-of-plane depth, geometry units (EXY)

    @property
    def k0(self) -> float:
        return 2 * np.pi * self.frequency / C0 * self.unit

    def k2_eff(self, k0=None):
        """Effective k^2 in geometry units: EXY with a finite depth loses
        (pi/depth)^2 (ref ComputeKSquared, rama/solver.cc:1561-1566)."""
        k0 = self.k0 if k0 is None else k0
        if self.type == "EXY" and np.isfinite(self.depth):
            return k0 * k0 - (np.pi / self.depth) ** 2
        return k0 * k0


# ---------------------------------------------------------------------------
# Element assembly (differentiable in the vertex positions)


def _tri_geometry(pts, tri):
    p0, p1, p2 = pts[tri[:, 0]], pts[tri[:, 1]], pts[tri[:, 2]]
    d1, d2 = p1 - p0, p2 - p0
    det = d1[:, 0] * d2[:, 1] - d1[:, 1] * d2[:, 0]
    area = 0.5 * torch.abs(det)
    b = torch.stack([p1[:, 1] - p2[:, 1], p2[:, 1] - p0[:, 1], p0[:, 1] - p1[:, 1]], 1)
    c = torch.stack([p2[:, 0] - p1[:, 0], p0[:, 0] - p2[:, 0], p1[:, 0] - p0[:, 0]], 1)
    return area, b, c


def _tensor_index(a, device):
    return a if isinstance(a, torch.Tensor) else torch.as_tensor(np.asarray(a, np.int64),
                                                                 device=device)


def element_matrices(pts, tri, eps_tri, sigma_xx=None, sigma_yy=None, sigma_xy=None):
    """Per-element stiffness Ke (anisotropic weights with the sigma_xy cross
    term) and eps-weighted mass Me of P1 triangles, (T, 3, 3) each."""
    tri = _tensor_index(tri, pts.device)
    area, b, c = _tri_geometry(pts, tri)
    sx = torch.ones_like(area) if sigma_xx is None else sigma_xx
    sy = torch.ones_like(area) if sigma_yy is None else sigma_yy
    den = (4.0 * area)[:, None, None]
    Ke = (sx[:, None, None] * b[:, :, None] * b[:, None, :]
          + sy[:, None, None] * c[:, :, None] * c[:, None, :]) / den
    if sigma_xy is not None:
        Ke = Ke + sigma_xy[:, None, None] * (b[:, :, None] * c[:, None, :]
                                             + c[:, :, None] * b[:, None, :]) / den
    base = torch.ones((3, 3), dtype=area.dtype, device=area.device) + torch.eye(
        3, dtype=area.dtype, device=area.device)
    Me = base[None, :, :] * (area / 12.0)[:, None, None] * eps_tri[:, None, None]
    return Ke, Me


def vol_structure(triangles: np.ndarray):
    """COO (rows, cols) of the 9 entries of each triangle, in
    element_matrices' (T, 3, 3) order."""
    tri = np.asarray(triangles)
    return np.repeat(tri, 3, axis=1).reshape(-1), np.tile(tri, (1, 3)).reshape(-1)


def edge_structure(edges: np.ndarray):
    """COO (rows, cols) of the 4 entries of each boundary edge, in
    edge_mass_vals' (E, 2, 2) order."""
    e = np.asarray(edges).reshape(-1, 2)
    return np.repeat(e, 2, axis=1).reshape(-1), np.tile(e, (1, 2)).reshape(-1)


def edge_mass_vals(pts, edges, scale=None):
    """P1 line-element mass len/6 [[2, 1], [1, 2]] of each edge, optionally
    scaled per edge (..., E); (..., E, 2, 2)."""
    e = _tensor_index(np.asarray(edges).reshape(-1, 2), pts.device)
    L = torch.linalg.vector_norm(pts[e[:, 1]] - pts[e[:, 0]], dim=1)
    base = torch.tensor([[2.0, 1.0], [1.0, 2.0]], dtype=L.dtype, device=L.device)
    vals = base[None, :, :] * (L / 6.0)[:, None, None]
    if scale is not None:
        vals = vals * scale[..., None, None]
    return vals


def assemble_matrices(points, triangles, eps_tri, sigma_xx=None, sigma_yy=None,
                      sigma_xy=None):
    """Dense global stiffness K and eps-weighted mass M (small meshes)."""
    Ke, Me = element_matrices(points, triangles, eps_tri, sigma_xx, sigma_yy, sigma_xy)
    rows, cols = vol_structure(np.asarray(triangles))
    N = points.shape[0]
    return (sparselib.coo_to_dense(rows, cols, Ke.reshape(-1), N),
            sparselib.coo_to_dense(rows, cols, Me.reshape(-1), N))


def _boundary_mass(points, edges, N, dtype=torch.complex128):
    """Dense boundary-mass matrix over the given edges."""
    if len(edges) == 0:
        return torch.zeros((N, N), dtype=dtype, device=points.device)
    rows, cols = edge_structure(edges)
    return sparselib.coo_to_dense(rows, cols, edge_mass_vals(points, edges).to(dtype).reshape(-1),
                                  N)


# ---------------------------------------------------------------------------
# Port geometry / modes


def port_frame(mesh: Mesh, port: int):
    """Port nodes ordered along the edge chain, their arclength
    coordinates, the total length and the two ends."""
    nodes = portlib.order_edge_chain(mesh.port_edges(port))
    pts = mesh.points[nodes]
    t = np.concatenate([[0.0], np.cumsum(np.linalg.norm(np.diff(pts, axis=0), axis=1))])
    return nodes, t, float(t[-1]), (pts[0], pts[-1])


def port_beta(k2, width, mode: int = 1, dtype=torch.complex128, device="cuda"):
    """Propagation constant of mode m on a PEC-walled port of width a:
    sqrt(k^2 eps - (m pi / a)^2), evanescent modes on the -j branch."""
    val = torch.tensor(complex(k2 - (mode * np.pi / width) ** 2), dtype=dtype, device=device)
    b = torch.sqrt(val)
    return torch.where(val.real < 0, -b, b)


# ---------------------------------------------------------------------------
# Driven problem plan (host-side static structure)


@dataclasses.dataclass
class PortPlan:
    number: int
    nodes: np.ndarray            # (P,) ordered along the chain
    edges: np.ndarray            # (E, 2)
    adj_tris: np.ndarray         # (E,) triangle adjacent to each edge
    num_modes: int
    dirichlet: bool              # EZ (sin modes) vs EXY (cos modes)
    analytic: bool               # closed-form modes vs numerical profiles
    profiles: Optional[np.ndarray]   # (M, P) numerical mode shapes
    beta2: Optional[np.ndarray]      # (M,) numerical beta^2 at the plan's k0
    wn_profile: Optional[np.ndarray] = None   # (P,) n^T W n along the port


@dataclasses.dataclass
class DrivenPlan:
    config: FemConfig
    N: int
    triangles: np.ndarray
    rows: np.ndarray             # full COO rows (all segments + diag)
    cols: np.ndarray
    seg_slices: Dict[str, slice]
    ports: List[PortPlan]
    abc_edges: np.ndarray
    abc_adj: np.ndarray
    robin_edges: np.ndarray
    robin_alpha: np.ndarray      # (Er,) complex dimensionless coefficients
    robin_adj: np.ndarray
    dirichlet_mask: np.ndarray   # (N,) bool
    dirichlet_values: np.ndarray  # (N,)
    point_source_node: int       # -1 if none
    use_sparse: bool
    structure: sparselib.SparseStructure
    iterative: bool = False      # "bicgstab"
    bcr_structure: Optional[object] = None   # "bcr"
    _on: dict = dataclasses.field(default_factory=dict, repr=False)

    @property
    def num_ports(self) -> int:
        return len(self.ports)

    def index(self, name: str, device) -> torch.Tensor:
        """A host array of the plan (an attribute, or a port's nodes as
        "port<i>") as an int64 or bool tensor on `device`, made once."""
        key = (name, str(torch.device(device)))
        if key not in self._on:
            if name.startswith("port"):
                arr = self.ports[int(name[4:])].nodes
            else:
                arr = getattr(self, name)
            arr = np.asarray(arr)
            self._on[key] = torch.as_tensor(arr if arr.dtype == np.bool_ else
                                            arr.astype(np.int64), device=device)
        return self._on[key]


def _edge_tri_adjacency(mesh: Mesh, edges: np.ndarray) -> np.ndarray:
    """Triangle adjacent to each boundary edge."""
    emap = {}
    tri = mesh.triangles
    for ti in range(len(tri)):
        for a, b in ((0, 1), (1, 2), (2, 0)):
            emap.setdefault((min(tri[ti, a], tri[ti, b]), max(tri[ti, a], tri[ti, b])), ti)
    out = np.zeros(len(edges), dtype=int)
    for i, (a, b) in enumerate(np.asarray(edges).reshape(-1, 2)):
        out[i] = emap.get((min(a, b), max(a, b)), 0)
    return out


DENSE_MAX_N = 1200   # densify below this (one (N, N) complex solve)


def plan_driven(mesh: Mesh, config: FemConfig, num_modes: int = 1,
                numerical_modes: str = "auto", point_source=None,
                solver: str = "auto") -> DrivenPlan:
    """The static structure of the driven problem, numpy on the host.
    numerical_modes "auto" solves the 1D transverse eigenproblem where a
    port's eps or weight profile is not uniform, else the closed-form
    sin/cos modes; "always"/"never" force it.  solver "auto" is dense up
    to DENSE_MAX_N nodes and the host SuperLU above; "dense", "sparse",
    "bicgstab" or "bcr" choose."""
    N = mesh.num_points
    tri = np.asarray(mesh.triangles)
    vr, vc = vol_structure(tri)
    rows, cols = [vr], [vc]
    seg_slices = {"vol": slice(0, len(vr))}
    off = len(vr)
    dirichlet = config.type in ("EZ", "ES")

    ports = []
    for p in sorted(set(int(p) for p in mesh.edge_port[mesh.edge_kind == 1])):
        pe = mesh.port_edges(p)
        nodes, t, width, _ = port_frame(mesh, p)
        adj = _edge_tri_adjacency(mesh, pe)
        eps_prof = portlib.port_eps_profile(mesh, p, nodes)
        sxx = np.asarray(mesh.sigma_xx, complex)
        syy = np.asarray(mesh.sigma_yy, complex)
        sxy = np.asarray(mesh.sigma_xy, complex)
        if config.type == "EXY":
            inv_eps = 1.0 / np.asarray(mesh.epsilon, complex)
            Wxx_t, Wyy_t, Wxy_t = sxx * inv_eps, syy * inv_eps, sxy * inv_eps
        else:
            Wxx_t, Wyy_t, Wxy_t = sxx, syy, sxy
        wt_prof, wn_prof = portlib.port_weight_profiles(mesh, nodes, Wxx_t, Wyy_t, Wxy_t)
        mass_prof = np.ones_like(eps_prof) if config.type == "EXY" else eps_prof

        def _uniform(prof):
            return np.max(np.abs(prof - prof[0])) < 1e-9 * max(1.0, np.max(np.abs(prof)))

        uniform = _uniform(eps_prof) and _uniform(wt_prof) and _uniform(wn_prof)
        use_numerical = (numerical_modes == "always"
                         or (numerical_modes == "auto" and not uniform))
        if config.type == "ES":
            use_numerical = False      # electrostatics has no port modes
        profiles = beta2 = None
        if use_numerical:
            tm = portlib.transverse_modes(t, mass_prof, complex(config.k2_eff()), num_modes,
                                          dirichlet=config.type == "EZ", w_stiff=wt_prof,
                                          w_beta=wn_prof)
            profiles, beta2 = tm.profiles, tm.beta2
        ports.append(PortPlan(
            number=p, nodes=nodes, edges=np.asarray(pe), adj_tris=adj, num_modes=num_modes,
            dirichlet=config.type == "EZ", analytic=not use_numerical, profiles=profiles,
            beta2=beta2, wn_profile=np.asarray(wn_prof) if use_numerical else None))
        er, ec = edge_structure(pe)
        rows.append(er)
        cols.append(ec)
        seg_slices[f"port{p}_mass"] = slice(off, off + len(er))
        off += len(er)
        if num_modes > 1:
            P = len(nodes)
            rows.append(np.repeat(nodes, P))
            cols.append(np.tile(nodes, P))
            seg_slices[f"port{p}_dtn"] = slice(off, off + P * P)
            off += P * P

    abc_edges = mesh.boundary_edges[mesh.edge_kind == 2]
    abc_adj = _edge_tri_adjacency(mesh, abc_edges) if len(abc_edges) else np.zeros(0, int)
    if len(abc_edges):
        er, ec = edge_structure(abc_edges)
        rows.append(er)
        cols.append(ec)
        seg_slices["abc"] = slice(off, off + len(er))
        off += len(er)

    kind4 = mesh.edge_kind == 4
    robin_edges = mesh.boundary_edges[kind4]
    robin_alpha = (np.asarray(mesh.edge_alpha)[kind4]
                   if getattr(mesh, "edge_alpha", None) is not None else np.zeros(0, complex))
    robin_adj = (_edge_tri_adjacency(mesh, robin_edges) if len(robin_edges)
                 else np.zeros(0, int))
    if len(robin_edges):
        er, ec = edge_structure(robin_edges)
        rows.append(er)
        cols.append(ec)
        seg_slices["robin"] = slice(off, off + len(er))
        off += len(er)

    dmask = np.zeros(N, bool)
    dvals = np.zeros(N)
    if dirichlet:
        dmask[np.unique(mesh.boundary_edges[mesh.edge_kind == 0])] = True
        pot = mesh.edge_kind == 3
        if pot.any():
            for e, v in zip(mesh.boundary_edges[pot], mesh.edge_value[pot]):
                dvals[e[0]] = v
                dvals[e[1]] = v
            dmask[np.unique(mesh.boundary_edges[pot])] = True

    diag_idx = np.arange(N)
    rows.append(diag_idx)
    cols.append(diag_idx)
    seg_slices["diag"] = slice(off, off + N)
    rows = np.concatenate(rows)
    cols = np.concatenate(cols)

    node = -1
    if point_source is not None:
        node = int(np.argmin(np.linalg.norm(mesh.points - np.asarray(point_source), axis=1)))

    use_sparse = N > DENSE_MAX_N if solver == "auto" else solver in ("sparse", "bicgstab",
                                                                       "bcr")
    bcr_structure = None
    if solver == "bcr":
        from eggshell_tpu_torch.fem.block_tridiag import BlockTridiagStructure

        bcr_structure = BlockTridiagStructure.auto(rows, cols, N)
    return DrivenPlan(
        config=config, N=N, triangles=tri, rows=rows, cols=cols, seg_slices=seg_slices,
        ports=ports, abc_edges=np.asarray(abc_edges), abc_adj=abc_adj,
        robin_edges=np.asarray(robin_edges), robin_alpha=np.asarray(robin_alpha, complex),
        robin_adj=robin_adj, dirichlet_mask=dmask, dirichlet_values=dvals,
        point_source_node=node, use_sparse=use_sparse,
        structure=sparselib.SparseStructure(rows, cols, N), iterative=solver == "bicgstab",
        bcr_structure=bcr_structure)


# ---------------------------------------------------------------------------
# Driven core (differentiable)


def _port_mass_small(tj, weight=None):
    """(P, P) consistent P1 mass on the port chain from the arclength
    coordinates tj; `weight` (P,) weights each element by the mean of its
    nodes' values."""
    h = tj[1:] - tj[:-1]
    if weight is not None:
        h = h * 0.5 * (weight[:-1] + weight[1:])
    zero = h.new_zeros(1)
    diag = torch.cat([h / 3.0, zero]) + torch.cat([zero, h / 3.0])
    offd = torch.diag_embed(h / 6.0)
    P = tj.shape[0]
    upper = torch.nn.functional.pad(offd, (1, 0, 0, 1)) if P > 1 else offd
    return torch.diag_embed(diag) + upper + upper.T


def _branch_sqrt(x):
    """sqrt with the reference's branch cut: negative real parts give -sqrt
    (rama/solver.cc:146-151)."""
    b = torch.sqrt(x)
    return torch.where(x.real < 0, -b, b)


def _dir_weight(Wxx, Wyy, Wxy, d):
    """d^T W d for a unit direction d = (dx, dy)."""
    return Wxx * d[0] * d[0] + Wyy * d[1] * d[1] + 2.0 * Wxy * d[0] * d[1]


def _port_quantities(pp: PortPlan, pts, eps_tri, Wxx, Wyy, Wxy, k2_eff, is_exy, dtype):
    """Per-port quantities: arclength t, length L, eps at the port, mode
    profiles (M, P), Robin coefficients alpha_m (..., M) (k2_eff may carry
    a batch axis), small port mass (P, P) and, for numerical ports, the
    per-edge scale of the fundamental Robin block."""
    device = pts.device
    nodes = torch.as_tensor(pp.nodes.astype(np.int64), device=device)
    ppts = pts[nodes]
    seg = torch.linalg.vector_norm(ppts[1:] - ppts[:-1], dim=1)
    tj = torch.cat([seg.new_zeros(1), torch.cumsum(seg, 0)])
    L = tj[-1]
    adj = torch.as_tensor(np.asarray(pp.adj_tris, np.int64), device=device)
    eps_port = torch.mean(eps_tri[adj])
    chord = ppts[-1] - ppts[0]
    that = chord / torch.clamp(torch.linalg.vector_norm(chord), min=1e-30)
    nvec = torch.stack([that[1], -that[0]])
    Wn = torch.mean(_dir_weight(Wxx[adj], Wyy[adj], Wxy[adj], nvec))
    Wt = torch.mean(_dir_weight(Wxx[adj], Wyy[adj], Wxy[adj], that))
    k2_mass = k2_eff if is_exy else k2_eff * eps_port
    M = pp.num_modes
    if pp.analytic:
        ms = torch.arange(1, M + 1, device=device) if pp.dirichlet else torch.arange(
            M, device=device)
        x = tj[None, :] * (ms[:, None] * (math.pi / L))
        prof = (torch.sin(x) if pp.dirichlet else torch.cos(x)).to(dtype)
        kc2 = ((ms * (math.pi / L)) ** 2).to(dtype)
        eff_k2 = k2_mass[..., None] - kc2 * Wt
        alphas = 1j * _branch_sqrt(Wn * eff_k2)
        Bp = _port_mass_small(tj).to(dtype)
        be_scale = None
    else:
        prof = torch.as_tensor(pp.profiles, device=device).to(dtype)
        beta2 = torch.as_tensor(pp.beta2, device=device).to(dtype)
        alphas = (1j * _branch_sqrt(beta2)).expand(k2_eff.shape + (M,))
        wn = torch.as_tensor(pp.wn_profile, device=device).to(dtype)
        Bp = _port_mass_small(tj, weight=wn).to(dtype)
        pos = {int(n): i for i, n in enumerate(np.asarray(pp.nodes))}
        e = np.asarray(pp.edges).reshape(-1, 2)
        i0 = torch.as_tensor([pos[int(a)] for a in e[:, 0]], device=device)
        i1 = torch.as_tensor([pos[int(b)] for b in e[:, 1]], device=device)
        be_scale = 0.5 * (wn[i0] + wn[i1])
    return tj, L, eps_port, prof, alphas, Bp, be_scale


def _solve(vals, rhs, plan: DrivenPlan):
    """The configured linear solve of the assembled system."""
    if plan.use_sparse:
        if plan.bcr_structure is not None:
            from eggshell_tpu_torch.fem.block_tridiag import block_tridiag_solve

            return block_tridiag_solve(vals, rhs, plan.bcr_structure)
        if plan.iterative:
            return sparselib.bicgstab_solve_structured(vals, rhs, plan.structure)
        return sparselib.sparse_solve_structured(vals, rhs, plan.structure)
    rows, cols = plan.structure.indices(vals.device)
    A = sparselib.coo_to_dense(rows, cols, vals, plan.N)
    return torch.linalg.solve(A, rhs[..., None])[..., 0]


def solve_driven_core(pts, eps_tri, sxx, syy, sxy, exc_tri, k0, plan: DrivenPlan,
                      return_flux: bool = False, dtype=torch.complex128):
    """Assemble, solve and project S-parameters: a differentiable function
    of the tensors (points (N, 2), per-triangle eps, sigma_xx, sigma_yy,
    sigma_xy, excitation, and k0, a scalar or (F,)), the structure from
    `plan`.  Returns (u (..., N), s (..., num_ports, num_modes)) in `dtype`;
    with `return_flux` also each port mode's power-flux weight
    Re(W_n beta_m) int psi_m^2 (..., num_ports, num_modes)."""
    cfg = plan.config
    device = pts.device
    N = plan.N
    tri = plan.index("triangles", device)
    rdtype = _real_dtype(dtype)
    k0 = (k0.to(device=device, dtype=rdtype) if isinstance(k0, torch.Tensor)
          else torch.tensor(k0, dtype=rdtype, device=device))
    if cfg.type == "EXY" and np.isfinite(cfg.depth):
        k2_eff = (k0 * k0 - (np.pi / cfg.depth) ** 2).to(dtype)
    else:
        k2_eff = (k0 * k0).to(dtype)
    bshape = k2_eff.shape
    k2 = k2_eff[..., None, None, None]

    eps_tri = eps_tri.to(dtype)
    is_exy = cfg.type == "EXY"
    if is_exy:
        inv_eps = 1.0 / eps_tri
        Wxx, Wyy, Wxy = sxx.to(dtype) * inv_eps, syy.to(dtype) * inv_eps, sxy.to(dtype) * inv_eps
        Ke, Me = element_matrices(pts, tri, torch.ones_like(eps_tri), Wxx, Wyy, Wxy)
        vol_vals = Ke - k2 * Me
    elif cfg.type == "ES":
        Wxx, Wyy, Wxy = sxx.to(dtype), syy.to(dtype), sxy.to(dtype)
        Ke, _ = element_matrices(pts, tri, eps_tri, Wxx, Wyy, Wxy)
        vol_vals = Ke.to(dtype).expand(bshape + Ke.shape)
    else:  # EZ
        Wxx, Wyy, Wxy = sxx.to(dtype), syy.to(dtype), sxy.to(dtype)
        Ke, Me = element_matrices(pts, tri, eps_tri, Wxx, Wyy, Wxy)
        vol_vals = Ke.to(dtype) - k2 * Me
    segs = {"vol": vol_vals.reshape(bshape + (-1,))}

    # volume excitation: int s phi = s area / 3 at each vertex
    area, _, _ = _tri_geometry(pts, tri)
    contrib = exc_tri.to(dtype) * area.to(dtype) / 3.0
    rhs = sparselib.index_add(torch.repeat_interleave(contrib, 3), tri.reshape(-1), N)
    rhs = rhs.expand(bshape + (N,))

    port_aux = []
    for i, pp in enumerate(plan.ports):
        tj, L, eps_port, prof, alphas, Bp, be_scale = _port_quantities(
            pp, pts, eps_tri, Wxx, Wyy, Wxy, k2_eff, is_exy, dtype)
        be = edge_mass_vals(pts, pp.edges, scale=be_scale).to(dtype)
        segs[f"port{pp.number}_mass"] = alphas[..., 0, None] * be.reshape(-1)
        if pp.num_modes > 1:
            # DtN corrections sum_m (alpha_m - alpha_1) (Bp psi_m)(Bp psi_m)^T / psi_m^T Bp psi_m
            Bpm = prof @ Bp
            denom = torch.sum(Bpm * prof, dim=1)
            coef = (alphas - alphas[..., :1]) / denom
            dtn = torch.einsum("...m,mp,mq->...pq", coef[..., 1:], Bpm[1:], Bpm[1:])
            segs[f"port{pp.number}_dtn"] = dtn.reshape(bshape + (-1,))
        if pp.number == cfg.excited_port:
            m0 = cfg.excited_mode - 1
            exc = 2.0 * alphas[..., m0, None] * (Bp @ prof[m0])
            rhs = rhs + sparselib.index_add(exc, plan.index(f"port{i}", device), N)
        port_aux.append((i, pp, prof, alphas, Bp))

    def _edge_alphas(edges, adj):
        """alpha_e = i sqrt(W_n k2_mass) of each edge, and W_n."""
        e = _tensor_index(np.asarray(edges).reshape(-1, 2), device)
        adj = _tensor_index(adj, device)
        d = pts[e[:, 1]] - pts[e[:, 0]]
        d = d / torch.clamp(torch.linalg.vector_norm(d, dim=1, keepdim=True), min=1e-30)
        nv = torch.stack([d[:, 1], -d[:, 0]], dim=1)
        Wn = (Wxx[adj] * nv[:, 0] ** 2 + Wyy[adj] * nv[:, 1] ** 2
              + 2.0 * Wxy[adj] * nv[:, 0] * nv[:, 1])
        k2_mass = k2_eff[..., None] if is_exy else k2_eff[..., None] * eps_tri[adj]
        return 1j * _branch_sqrt(Wn * k2_mass), Wn

    if len(plan.abc_edges):
        a_e, _ = _edge_alphas(plan.abc_edges, plan.abc_adj)
        segs["abc"] = edge_mass_vals(pts, plan.abc_edges, scale=a_e).to(dtype).reshape(
            bshape + (-1,))
    if len(plan.robin_edges):
        adj = _tensor_index(plan.robin_adj, device)
        k_phys = _branch_sqrt(k2_eff[..., None] * eps_tri[adj])
        _, Wn_e = _edge_alphas(plan.robin_edges, plan.robin_adj)
        alpha = torch.as_tensor(plan.robin_alpha, device=device).to(dtype) * k_phys * Wn_e
        segs["robin"] = edge_mass_vals(pts, plan.robin_edges, scale=alpha).to(dtype).reshape(
            bshape + (-1,))
    dmask = plan.index("dirichlet_mask", device)
    segs["diag"] = dmask.to(dtype).expand(bshape + (N,))
    vals = torch.cat([segs[name].expand(bshape + segs[name].shape[-1:])
                      for name in plan.seg_slices], dim=-1)

    if plan.point_source_node >= 0:
        rhs = rhs + torch.nn.functional.one_hot(
            torch.tensor(plan.point_source_node, device=device), N).to(dtype)

    if plan.dirichlet_mask.any():
        # elimination with lift: rhs -= A g, unit diagonal on the masked rows
        g = torch.as_tensor(plan.dirichlet_values, device=device).to(dtype)
        rows, cols = plan.structure.indices(device)
        seg_diag = torch.zeros(len(plan.rows), dtype=torch.bool, device=device)
        seg_diag[plan.seg_slices["diag"]] = True
        # the diagonal segment's unit entries are added after the lift
        vals_nodiag = torch.where(seg_diag, torch.zeros((), dtype=dtype, device=device), vals)
        rhs = rhs - sparselib.coo_matvec(rows, cols, vals_nodiag, g, N)
        kill = dmask[rows] | dmask[cols]
        vals = torch.where(kill & ~seg_diag, torch.zeros((), dtype=dtype, device=device), vals)
        rhs = torch.where(dmask, g, rhs)

    u = _solve(vals, rhs, plan)

    # S-parameters: unconjugated Bp-weighted projection onto each mode
    max_modes = max([pp.num_modes for pp in plan.ports], default=0)
    s_rows, f_rows = [], []
    for i, pp, prof, alphas, Bp in port_aux:
        up = u[..., plan.index(f"port{i}", device)]
        Bpm = prof @ Bp
        denom = torch.sum(Bpm * prof, dim=1)
        amp = (up @ Bpm.T) / denom
        if pp.number == cfg.excited_port:
            amp = amp - torch.nn.functional.one_hot(
                torch.tensor(cfg.excited_mode - 1, device=device), pp.num_modes).to(dtype)
        pad = max_modes - pp.num_modes
        s_rows.append(torch.nn.functional.pad(amp, (0, pad)))
        fl = torch.real(-1j * alphas) * torch.real(denom)
        f_rows.append(torch.nn.functional.pad(fl, (0, pad)))
    if s_rows:
        s = torch.stack(s_rows, dim=-2)
        flux = torch.stack(f_rows, dim=-2).to(rdtype)
    else:
        s = torch.zeros(bshape + (0, 0), dtype=dtype, device=device)
        flux = torch.zeros(bshape + (0, 0), dtype=rdtype, device=device)
    if return_flux:
        return u, s, flux
    return u, s


def make_driven_fn(mesh: Mesh, config: FemConfig, num_modes: int = 1,
                   numerical_modes: str = "auto", point_source=None, solver: str = "auto",
                   dtype=torch.complex128):
    """(fn, plan): fn(points, eps_tri, sxx, syy, sxy, exc_tri, k0) -> (u, s)
    is a differentiable torch function on the inputs' device; k0 may be a
    scalar or (F,), the batch axis carried through assembly and the
    dense/BCR solves (the host SuperLU takes each system in turn)."""
    plan = plan_driven(mesh, config, num_modes=num_modes, numerical_modes=numerical_modes,
                       point_source=point_source, solver=solver)

    def fn(pts, eps_tri, sxx, syy, sxy, exc_tri, k0):
        return solve_driven_core(pts, eps_tri, sxx, syy, sxy, exc_tri, k0, plan, dtype=dtype)

    return fn, plan


def mesh_tensors(mesh: Mesh, dtype=torch.complex128, device="cuda"):
    """(points, eps_tri, sigma_xx, sigma_yy, sigma_xy, excitation) of a mesh
    as tensors on `device`: the points and sigmas real, eps and the
    excitation in `dtype`."""
    rdtype = _real_dtype(dtype)

    def t(x, d):
        x = np.asarray(x)
        return torch.as_tensor(x if np.iscomplexobj(x) else x.astype(np.float64),
                               device=device).to(d)

    return (t(mesh.points, rdtype), t(mesh.epsilon, dtype), t(mesh.sigma_xx, rdtype),
            t(mesh.sigma_yy, rdtype), t(mesh.sigma_xy, rdtype), t(mesh.excitation, dtype))


# ---------------------------------------------------------------------------
# Driven solve (convenience wrapper, reference-shaped results)


@dataclasses.dataclass
class DrivenSolution:
    field: torch.Tensor           # (N,) complex nodal field
    s_params: Dict[int, complex]  # port -> S_{port, excited} (mode 1)
    port_power: Dict[int, float]  # outgoing power fraction per port
    k0: float
    s_matrix: Optional[np.ndarray] = None   # (num_ports, num_modes)
    port_numbers: Optional[List[int]] = None
    s_power: Optional[np.ndarray] = None    # s * sqrt(flux / flux_excited)


def solve_driven(mesh: Mesh, config: FemConfig, point_source=None, num_modes: int = 1,
                 numerical_modes: str = "auto", solver: str = "auto",
                 dtype=torch.complex128, device="cuda") -> DrivenSolution:
    """Single-frequency driven solve with matched ports (ref Solver::Solve,
    rama/solver.cc:1382-1422).  `point_source` = (x, y): unit excitation at
    the nearest node."""
    _, plan = make_driven_fn(mesh, config, num_modes=num_modes,
                             numerical_modes=numerical_modes, point_source=point_source,
                             solver=solver, dtype=dtype)
    args = mesh_tensors(mesh, dtype, device)
    k0 = torch.tensor(config.k0, dtype=_real_dtype(dtype), device=device)
    u, s, flux = solve_driven_core(*args, k0, plan, return_flux=True, dtype=dtype)
    s_np = s.detach().cpu().numpy()
    flux_np = flux.detach().cpu().numpy()
    ex_i = next((i for i, pp in enumerate(plan.ports) if pp.number == config.excited_port),
                None)
    if ex_i is None:
        s_power = s_np.copy()
    else:
        fx = flux_np[ex_i, config.excited_mode - 1]
        if fx <= 0:
            warnings.warn(
                f"excited port {config.excited_port} mode {config.excited_mode} is evanescent "
                f"(flux {fx:.3e} <= 0); s_power falls back to field-amplitude s", stacklevel=2)
            s_power = s_np.copy()
        else:
            s_power = s_np * np.sqrt(np.maximum(flux_np, 0.0) / fx)
    s_params, power = {}, {}
    for i, pp in enumerate(plan.ports):
        s_params[pp.number] = complex(s_np[i, 0])
        power[pp.number] = float(np.sum(np.abs(s_power[i]) ** 2))
    return DrivenSolution(field=u, s_params=s_params, port_power=power, k0=config.k0,
                          s_matrix=s_np, port_numbers=[pp.number for pp in plan.ports],
                          s_power=s_power)


def port_outgoing_rms(mesh: Mesh, config: FemConfig, field) -> Dict[int, float]:
    """Outgoing power fraction per port by the reference's metric: the RMS
    of (u - excitation mode) over the port, x2 for EZ (ref
    ComputePortOutgoingField2, rama/solver.cc:940-990)."""
    f = field.detach().cpu().numpy() if isinstance(field, torch.Tensor) else np.asarray(field)
    out = {}
    for p in sorted(set(int(p) for p in mesh.edge_port[mesh.edge_kind == 1])):
        nodes, t, width, _ = port_frame(mesh, p)
        mode = np.sin(np.pi * t / width) if config.type == "EZ" else np.ones_like(t)
        o = f[nodes] - (mode if p == config.excited_port else 0.0)
        dt = np.diff(t)
        w = np.zeros_like(t)
        w[:-1] += dt / 2
        w[1:] += dt / 2
        rms2 = np.sum(w * np.abs(o) ** 2) / width
        if config.type == "EZ":
            rms2 *= 2.0
        out[p] = float(rms2)
    return out


# ---------------------------------------------------------------------------
# Eigenmodes

MODE_METHODS = (None, "arpack", "shift_invert", "lobpcg")


def solve_modes(mesh: Mesh, num_modes: int = 6, sigma: Optional[float] = None,
                dirichlet: bool = True, potential: Optional[np.ndarray] = None,
                use_lobpcg: bool = False, method: Optional[str] = None, device="cuda"):
    """Generalized eigenproblem K psi = lambda M psi (cavity cutoffs,
    Schrodinger levels with `potential`).  `method`:

    - None / "arpack": the JAX package's own host solve, SciPy's ARPACK
      shift-invert (`eigsh`, sigma 1e-6 by default) on the sparse
      assembly; the element matrices are made on `device`;
    - "shift_invert": the device shift-invert subspace iteration with the
      BCR solve (`fem.sparse.shift_invert_modes`);
    - "lobpcg": the device LOBPCG (`fem.sparse.lobpcg_generalized`;
      use_lobpcg=True is its alias).

    Any other method raises ValueError.  Returns (eigenvalues (m,),
    eigenvectors (N, m)) as numpy arrays."""
    if use_lobpcg and method is None:
        method = "lobpcg"
    if method not in MODE_METHODS:
        raise ValueError(f"solve_modes: unknown method {method!r}; one of "
                         f"{', '.join(repr(m) for m in MODE_METHODS)}")
    import scipy.sparse as sp
    import scipy.sparse.linalg as spla

    pts = torch.as_tensor(np.asarray(mesh.points, np.float64), device=device)
    tri = torch.as_tensor(np.asarray(mesh.triangles, np.int64), device=device)
    N = mesh.num_points
    rows, cols = vol_structure(np.asarray(mesh.triangles))
    Ke, Me = element_matrices(pts, tri, torch.ones(mesh.num_triangles, dtype=torch.float64,
                                                   device=device))
    kv = Ke.cpu().numpy().reshape(-1)
    mv = Me.cpu().numpy().reshape(-1)
    if potential is not None:
        pot = torch.as_tensor(np.asarray(potential, np.float64), device=device)
        kv = kv + element_matrices(pts, tri, pot)[1].cpu().numpy().reshape(-1)
    Ks = sp.csr_matrix((kv, (rows, cols)), shape=(N, N))
    Ms = sp.csr_matrix((mv, (rows, cols)), shape=(N, N))
    if dirichlet:
        keep = np.ones(N, bool)
        keep[np.unique(mesh.boundary_edges)] = False
        idx = np.flatnonzero(keep)
        Kr, Mr = Ks[idx][:, idx], Ms[idx][:, idx]
    else:
        idx = np.arange(N)
        Kr, Mr = Ks, Ms

    if method in ("lobpcg", "shift_invert"):
        # K and M on one merged COO pattern of the reduced system
        pat = (abs(Kr.tocoo()) + abs(Mr.tocoo())).tocoo()
        rr, cc = pat.row, pat.col
        kv2 = np.asarray(Kr.tocsr()[rr, cc]).ravel()
        mv2 = np.asarray(Mr.tocsr()[rr, cc]).ravel()
        solver = (sparselib.lobpcg_generalized if method == "lobpcg"
                  else sparselib.shift_invert_modes)
        vals_t, vecs_t = solver(rr, cc, kv2, mv2, Kr.shape[0], num_modes, seed=0, device=device)
        vals, vecs = vals_t.cpu().numpy(), vecs_t.cpu().numpy()
    else:
        vals, vecs = spla.eigsh(Kr.tocsc(), k=num_modes, M=Mr.tocsc(),
                                sigma=1e-6 if sigma is None else sigma, which="LM")
        order = np.argsort(vals)
        vals, vecs = vals[order], vecs[:, order]
    full = np.zeros((N, vals.shape[0]))
    full[idx] = vecs
    return vals, full
