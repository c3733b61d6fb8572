"""FDTD core: the 2D TMz Yee scheme (Ez, Hx, Hy) and the 3D Yee scheme
with CPML walls, in normalised units (c = eps0 = mu0 = 1), with PEC cell
masks and PEC outer walls.

Counterpart of `eggshell_tpu.fem.fdtd`:

- `step_2d`: one leapfrog step in plain torch (the JAX package's XLA
  stencil);
- `step_2d_fused`: the same step on ez-shaped padded H grids, the
  counterpart of `step_2d_pallas`.  On a CUDA tensor it launches the
  hand-written kernel `csrc/fdtd2d.cu` (B8); on a CPU tensor it runs its
  plain version `step_2d_fused_plain`.  A CUDA input that the kernel does
  not take raises; there is no fallback;
- `simulate_2d`: the time loop with a soft source and a probe; it steps
  through `step_2d_fused` on every device;
- `step_3d`, `simulate_3d`: the 3D Yee step, plain torch as the JAX
  package's is plain XLA, with per-wall CPML (`make_cpml_3d`), PEC voxels,
  an eps grid and periodic (toroidal) axes; `energy_3d`, `efield_change`
  and `export_fields_3d` around it.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch


class Field2D(NamedTuple):
    ez: torch.Tensor   # (nx, ny)
    hx: torch.Tensor   # (nx, ny - 1)
    hy: torch.Tensor   # (nx - 1, ny)


def init_2d(nx: int, ny: int, dtype=torch.float32, device="cuda") -> Field2D:
    """A zero field on an nx x ny grid."""
    def zeros(*shape):
        return torch.zeros(shape, dtype=dtype, device=device)

    return Field2D(ez=zeros(nx, ny), hx=zeros(nx, ny - 1), hy=zeros(nx - 1, ny))


def courant_dt(dx: float, dims: int = 2, safety: float = 0.99) -> float:
    """safety * dx / sqrt(dims), under the Courant limit of the grid."""
    return safety * dx / math.sqrt(float(dims))


def step_2d(f: Field2D, dt: float, dx: float, eps_r=None, pec=None) -> Field2D:
    """One leapfrog step: the H half-update, then the E update; E is 0 on
    PEC cells (`pec` (nx, ny) bool) and on the outer rim.  `eps_r` (nx, ny)
    or None (vacuum)."""
    c = dt / dx
    hx = f.hx - c * (f.ez[:, 1:] - f.ez[:, :-1])
    hy = f.hy + c * (f.ez[1:, :] - f.ez[:-1, :])
    curl = torch.zeros_like(f.ez)
    curl[1:-1, :] += hy[1:, :] - hy[:-1, :]
    curl[:, 1:-1] += -(hx[:, 1:] - hx[:, :-1])
    inv_eps = 1.0 if eps_r is None else 1.0 / eps_r
    ez = f.ez + c * inv_eps * curl
    if pec is not None:
        ez = torch.where(pec, torch.zeros_like(ez), ez)
    ez[0, :] = 0.0
    ez[-1, :] = 0.0
    ez[:, 0] = 0.0
    ez[:, -1] = 0.0
    return Field2D(ez=ez, hx=hx, hy=hy)


def energy_2d(f: Field2D, dx: float) -> torch.Tensor:
    """Discrete EM energy 1/2 int (E^2 + H^2)."""
    return 0.5 * dx * dx * ((f.ez ** 2).sum() + (f.hx ** 2).sum() + (f.hy ** 2).sum())


def step_2d_fused_plain(ez, hx_pad, hy_pad, inv_eps, pec_free, dt: float, dx: float):
    """Plain torch version of the kernel, in the TPU kernel's expressions
    (shifted-slice concatenations): all grids (nx, ny); H on ez-shaped
    grids, hx_pad[:, :-1] and hy_pad[:-1, :] live; `pec_free` 0 on PEC
    cells and the rim, 1 elsewhere.  Returns (ez, hx_pad, hy_pad)."""
    c = float(dt / dx)
    zc = torch.zeros_like(ez[:, :1])
    zr = torch.zeros_like(ez[:1, :])
    hx = hx_pad - c * torch.cat([ez[:, 1:] - ez[:, :-1], zc], dim=1)
    hy = hy_pad + c * torch.cat([ez[1:, :] - ez[:-1, :], zr], dim=0)
    curl_x = torch.cat([zr, hy[1:-1, :] - hy[:-2, :], zr], dim=0)
    curl_y = torch.cat([zc, hx[:, 1:-1] - hx[:, :-2], zc], dim=1)
    ez = (ez + c * inv_eps * (curl_x - curl_y)) * pec_free
    return ez, hx, hy


def step_2d_fused(ez, hx_pad, hy_pad, inv_eps, pec_free, dt: float, dx: float):
    """B8: one fused 2D step; the arguments and results are those of
    `step_2d_fused_plain`."""
    if ez.device.type == "cpu":
        return step_2d_fused_plain(ez, hx_pad, hy_pad, inv_eps, pec_free, dt, dx)
    if ez.device.type != "cuda":
        raise ValueError(f"unsupported device {ez.device}")
    from eggshell_tpu_torch import kernels

    nx, ny = ez.shape
    for name, x in (("ez", ez), ("hx_pad", hx_pad), ("hy_pad", hy_pad), ("inv_eps", inv_eps),
                    ("pec_free", pec_free)):
        kernels.check_arg(name, x, (nx, ny), torch.float32, ez.device)
    out = [torch.empty_like(ez) for _ in range(3)]
    kernels.launch("eggshell_fdtd2d_f32", ez.device, ez, hx_pad, hy_pad, inv_eps, pec_free, *out,
                   nx, ny, float(dt / dx))
    step_2d_fused.launches += 1
    return tuple(out)


step_2d_fused.launches = 0


def fused_grids(f: Field2D, eps_r=None, pec=None):
    """The fused step's grids of field `f`: (ez, hx_pad, hy_pad, inv_eps,
    pec_free), each (nx, ny) and contiguous; pec_free is 0 on the PEC cells
    and on the rim."""
    nx, ny = f.ez.shape
    hx_pad = torch.nn.functional.pad(f.hx, (0, 1)).contiguous()
    hy_pad = torch.nn.functional.pad(f.hy, (0, 0, 0, 1)).contiguous()
    ones = torch.ones_like(f.ez)
    inv_eps = ones if eps_r is None else (1.0 / eps_r).to(f.ez.dtype).contiguous()
    pec_free = ones.clone()
    if pec is not None:
        pec_free[pec] = 0.0
    pec_free[0, :] = 0.0
    pec_free[-1, :] = 0.0
    pec_free[:, 0] = 0.0
    pec_free[:, -1] = 0.0
    return f.ez.contiguous(), hx_pad, hy_pad, inv_eps, pec_free


def simulate_2d(f: Field2D, num_steps: int, dt: float, dx: float, eps_r=None, pec=None,
                source_ij: Optional[Tuple[int, int]] = None, source_fn=None,
                probe_ij: Optional[Tuple[int, int]] = None):
    """Run `num_steps` steps of `step_2d_fused`, adding source_fn(t dt) to
    Ez at `source_ij` after step t (t from 0; t dt is a 0-d tensor of the
    field's dtype on its device).  Returns (final field, probe trace): the
    trace holds Ez at `probe_ij` after each step, zeros without a probe."""
    ez, hx, hy, inv_eps, pec_free = fused_grids(f, eps_r, pec)
    trace = torch.zeros(num_steps, dtype=f.ez.dtype, device=f.ez.device)
    for t in range(num_steps):
        ez, hx, hy = step_2d_fused(ez, hx, hy, inv_eps, pec_free, dt, dx)
        if source_ij is not None and source_fn is not None:
            tt = torch.tensor(t, dtype=ez.dtype, device=ez.device) * dt
            ez[source_ij] += source_fn(tt)
        if probe_ij is not None:
            trace[t] = ez[probe_ij]
    return Field2D(ez=ez, hx=hx[:, :-1], hy=hy[:-1, :]), trace


# ---------------------------------------------------------------------------
# 3D Yee computational domain: per-wall CPML absorbing boundaries
# (Roden-Gedney filter arrays and the Psi convolution state), PEC voxel
# masks, toroidal (periodic) symmetry per axis, a material eps grid.


class Field3D(NamedTuple):
    ex: torch.Tensor
    ey: torch.Tensor
    ez: torch.Tensor
    hx: torch.Tensor
    hy: torch.Tensor
    hz: torch.Tensor


def init_3d(n: int, dtype=torch.float32, device="cuda") -> Field3D:
    """A zero field on n x n x n collocated grids."""
    return Field3D(*(torch.zeros((n, n, n), dtype=dtype, device=device) for _ in range(6)))


# Per-wall PML selection bits and periodic-axis bits.
PML_XMIN, PML_XMAX = 1, 2
PML_YMIN, PML_YMAX = 4, 8
PML_ZMIN, PML_ZMAX = 16, 32
PML_ALL = 63
TOROID_X, TOROID_Y, TOROID_Z = 1, 2, 4


class Psi3D(NamedTuple):
    """CPML convolution state: one recursive accumulator per (field
    component, transverse derivative axis) pair, each on the full grid."""
    hx_y: torch.Tensor
    hx_z: torch.Tensor
    hy_z: torch.Tensor
    hy_x: torch.Tensor
    hz_x: torch.Tensor
    hz_y: torch.Tensor
    ex_y: torch.Tensor
    ex_z: torch.Tensor
    ey_z: torch.Tensor
    ey_x: torch.Tensor
    ez_x: torch.Tensor
    ez_y: torch.Tensor


class CPML3D(NamedTuple):
    """Per-axis CPML filter constants: psi <- b psi + a dF, and the update
    takes dF + psi for dF.  a_e/b_e sample sigma at cell edges (offset 0),
    a_h/b_h at centres (offset 0.5); outside the PML a = 0 and b = 1, so
    those cells see the plain Yee update."""
    a_e: Tuple[torch.Tensor, torch.Tensor, torch.Tensor]   # per axis, shape (n,)
    b_e: Tuple[torch.Tensor, torch.Tensor, torch.Tensor]
    a_h: Tuple[torch.Tensor, torch.Tensor, torch.Tensor]
    b_h: Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def _setup_ab(n, dt, dx, depth, lo_on, hi_on, ofs, m=3):
    """Polynomially graded conductivity sigma(u) = sigma_max u^m with
    sigma_max = 0.8 (m + 1) / dx, then b = exp(-sigma dt), a = b - 1
    (kappa = 1, alpha = 0), in float64 numpy."""
    x = np.arange(n, dtype=np.float64) + ofs
    u = np.zeros((n,), np.float64)
    if lo_on and depth > 0:
        u = np.maximum(u, (depth - x) / depth)
    if hi_on and depth > 0:
        u = np.maximum(u, (x - (n - 1 - depth)) / depth)
    u = np.clip(u, 0.0, 1.0)
    sigma = 0.8 * (m + 1) / dx * u ** m
    b = np.exp(-sigma * dt)
    return b - 1.0, b


def make_cpml_3d(shape: Tuple[int, int, int], dt: float, dx: float, pml: int = PML_ALL,
                 depth: int = 8, dtype=torch.float32, device="cuda") -> Tuple[CPML3D, Psi3D]:
    """The filter constants of a domain of `shape` cells with CPML on the
    walls `pml` (PML_* bits), `depth` cells deep (computed in float64, then
    cast to `dtype`), and the zero Psi state."""
    bits = ((PML_XMIN, PML_XMAX), (PML_YMIN, PML_YMAX), (PML_ZMIN, PML_ZMAX))
    consts = {"a_e": [], "b_e": [], "a_h": [], "b_h": []}
    for ax in range(3):
        lo, hi = (pml & bits[ax][0]) != 0, (pml & bits[ax][1]) != 0
        for kind, ofs in (("e", 0.0), ("h", 0.5)):
            a, b = _setup_ab(shape[ax], dt, dx, depth, lo, hi, ofs)
            consts[f"a_{kind}"].append(torch.as_tensor(a, dtype=dtype, device=device))
            consts[f"b_{kind}"].append(torch.as_tensor(b, dtype=dtype, device=device))
    psi = Psi3D(*(torch.zeros(shape, dtype=dtype, device=device) for _ in range(12)))
    return CPML3D(**{k: tuple(v) for k, v in consts.items()}), psi


def _bcast(v: torch.Tensor, axis: int) -> torch.Tensor:
    """A per-axis (n,) filter array as a view that broadcasts over the grid."""
    shape = [1, 1, 1]
    shape[axis] = v.shape[0]
    return v.reshape(shape)


def step_3d(f: Field3D, dt: float, dx: float, eps_r=None, pec=None,
            cpml: Optional[CPML3D] = None, psi: Optional[Psi3D] = None, periodic: int = 0):
    """One 3D Yee leapfrog step (the H update, then E from the new H) on
    collocated grids with periodic (rolled) differences.

    `eps_r` (n, n, n) relative permittivity or None; `pec` (n, n, n) bool
    zeroes E in the masked voxels; E is pinned to 0 on both walls of every
    axis whose TOROID_* bit is not in `periodic`.  With `cpml` and `psi`
    each transverse difference dF becomes dF + psi' with
    psi' = b psi + a dF, and the step returns (field, psi'); without, the
    field alone."""
    c = dt / dx
    use_pml = cpml is not None

    def d(a, axis):
        return torch.roll(a, -1, axis) - a

    def db(a, axis):
        return a - torch.roll(a, 1, axis)

    def conv(a, b, dF, axis, p):
        pn = _bcast(b[axis], axis) * p + _bcast(a[axis], axis) * dF
        return dF + pn, pn

    if use_pml:
        dzy, p_hx_y = conv(cpml.a_h, cpml.b_h, d(f.ez, 1), 1, psi.hx_y)
        dyz, p_hx_z = conv(cpml.a_h, cpml.b_h, d(f.ey, 2), 2, psi.hx_z)
        dxz, p_hy_z = conv(cpml.a_h, cpml.b_h, d(f.ex, 2), 2, psi.hy_z)
        dzx, p_hy_x = conv(cpml.a_h, cpml.b_h, d(f.ez, 0), 0, psi.hy_x)
        dyx, p_hz_x = conv(cpml.a_h, cpml.b_h, d(f.ey, 0), 0, psi.hz_x)
        dxy, p_hz_y = conv(cpml.a_h, cpml.b_h, d(f.ex, 1), 1, psi.hz_y)
    else:
        dzy, dyz = d(f.ez, 1), d(f.ey, 2)
        dxz, dzx = d(f.ex, 2), d(f.ez, 0)
        dyx, dxy = d(f.ey, 0), d(f.ex, 1)

    hx = f.hx - c * (dzy - dyz)
    hy = f.hy - c * (dxz - dzx)
    hz = f.hz - c * (dyx - dxy)

    if use_pml:
        bzy, p_ex_y = conv(cpml.a_e, cpml.b_e, db(hz, 1), 1, psi.ex_y)
        byz, p_ex_z = conv(cpml.a_e, cpml.b_e, db(hy, 2), 2, psi.ex_z)
        bxz, p_ey_z = conv(cpml.a_e, cpml.b_e, db(hx, 2), 2, psi.ey_z)
        bzx, p_ey_x = conv(cpml.a_e, cpml.b_e, db(hz, 0), 0, psi.ey_x)
        byx, p_ez_x = conv(cpml.a_e, cpml.b_e, db(hy, 0), 0, psi.ez_x)
        bxy, p_ez_y = conv(cpml.a_e, cpml.b_e, db(hx, 1), 1, psi.ez_y)
    else:
        bzy, byz = db(hz, 1), db(hy, 2)
        bxz, bzx = db(hx, 2), db(hz, 0)
        byx, bxy = db(hy, 0), db(hx, 1)

    inv_eps = 1.0 if eps_r is None else 1.0 / eps_r
    ex = f.ex + c * inv_eps * (bzy - byz)
    ey = f.ey + c * inv_eps * (bxz - bzx)
    ez = f.ez + c * inv_eps * (byx - bxy)

    for a in (ex, ey, ez):
        for ax in range(3):
            if not periodic & (1 << ax):
                a.select(ax, 0).zero_()
                a.select(ax, -1).zero_()
    if pec is not None:
        ex, ey, ez = (torch.where(pec, torch.zeros_like(a), a) for a in (ex, ey, ez))

    out = Field3D(ex, ey, ez, hx, hy, hz)
    if use_pml:
        return out, Psi3D(p_hx_y, p_hx_z, p_hy_z, p_hy_x, p_hz_x, p_hz_y,
                          p_ex_y, p_ex_z, p_ey_z, p_ey_x, p_ez_x, p_ez_y)
    return out


def simulate_3d(f: Field3D, num_steps: int, dt: float, dx: float, eps_r=None, pec=None,
                cpml: Optional[CPML3D] = None, psi: Optional[Psi3D] = None,
                source_ijk: Optional[Tuple[int, int, int]] = None, source_component: str = "ez",
                source_fn=None, probe_ijk: Optional[Tuple[int, int, int]] = None,
                periodic: int = 0, probe_component: Optional[str] = None):
    """Run `num_steps` steps of `step_3d`, adding source_fn(t dt) to
    `source_component` at `source_ijk` after step t (t from 0; t dt is a 0-d
    tensor of the field's dtype on its device), with no host read inside
    the loop.  Returns (final field, final psi, probe trace) with `cpml`,
    else (final field, probe trace): the trace holds `probe_component`
    (default: the source's) at `probe_ijk` after each step, zeros without
    a probe."""
    if probe_component is None:
        probe_component = source_component
    like = f.ex
    times = torch.arange(num_steps, dtype=like.dtype, device=like.device) * dt
    trace = torch.zeros(num_steps, dtype=like.dtype, device=like.device)
    for t in range(num_steps):
        if cpml is not None:
            f, psi = step_3d(f, dt, dx, eps_r, pec, cpml, psi, periodic)
        else:
            f = step_3d(f, dt, dx, eps_r, pec, periodic=periodic)
        if source_ijk is not None and source_fn is not None:
            getattr(f, source_component)[source_ijk] += source_fn(times[t])
        if probe_ijk is not None:
            trace[t] = getattr(f, probe_component)[probe_ijk]
    if cpml is not None:
        return f, psi, trace
    return f, trace


def energy_3d(f: Field3D, dx: float) -> torch.Tensor:
    """Discrete EM energy 1/2 int (E^2 + H^2)."""
    return 0.5 * dx ** 3 * sum(torch.sum(a ** 2) for a in f)


def efield_change(f: Field3D, snapshot: Field3D) -> torch.Tensor:
    """Fractional RMS E-field change against a snapshot, the convergence
    check: sqrt(sum((E - E_snap)^2)) / sqrt(sum(E^2))."""
    num = (torch.sum((f.ex - snapshot.ex) ** 2) + torch.sum((f.ey - snapshot.ey) ** 2)
           + torch.sum((f.ez - snapshot.ez) ** 2))
    den = torch.sum(f.ex ** 2) + torch.sum(f.ey ** 2) + torch.sum(f.ez ** 2)
    return torch.sqrt(num) / torch.clamp(torch.sqrt(den), min=1e-30)


def export_fields_3d(path: str, f: Field3D, dx: float) -> None:
    """Write the E and H fields (as Ex ... Hz) and dx to a MATLAB file."""
    from eggshell_tpu_torch.utils.mat_file import MatFile

    with MatFile(path) as m:
        for name in ("ex", "ey", "ez", "hx", "hy", "hz"):
            m.write(name.capitalize(), getattr(f, name).detach().cpu().numpy())
        m.write_scalar("dx", dx)
