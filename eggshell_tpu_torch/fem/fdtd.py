"""2D FDTD core: the TMz Yee scheme (Ez, Hx, Hy) in normalised units
(c = eps0 = mu0 = 1), with PEC cell masks and a PEC outer rim.

Counterpart of the 2D part of `eggshell_tpu.fem.fdtd`:

- `step_2d`: one leapfrog step in plain torch (the JAX package's XLA
  stencil);
- `step_2d_fused`: the same step on ez-shaped padded H grids, the
  counterpart of `step_2d_pallas`.  On a CUDA tensor it launches the
  hand-written kernel `csrc/fdtd2d.cu` (B8); on a CPU tensor it runs its
  plain version `step_2d_fused_plain`.  A CUDA input that the kernel does
  not take raises; there is no fallback;
- `simulate_2d`: the time loop with a soft source and a probe; it steps
  through `step_2d_fused` on every device.

The 3D Yee/CPML scheme is still to port (ROADMAP A14).
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

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
