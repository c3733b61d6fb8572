"""Scene specification and simulation state as NamedTuples of tensors.

Counterpart of `eggshell_tpu.physics.scene`.  A `SceneSpec` holds what is
static (one scene, shared by every scenario of a batch) and a `State` the
per-step dynamic state with any leading batch dimensions, e.g. (B, n, 3).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from eggshell_tpu_torch.ops import quaternion as quat
from eggshell_tpu_torch.utils.constants import constant


class SceneSpec(NamedTuple):
    """Static description of a scene.

    Bodies (n): inv_mass (n,) [0 = static], inertia_body / inv_inertia_body
    (n, 3, 3), half_extents (n, 3), ground_enabled (n,) bool.
    Ball joints (J): joint_b0 / joint_b1 (J,) int64 (-1 in joint_b1 = world
    anchor), joint_c0 / joint_c1 (J, 3).
    Candidate pairs (P): pair_i / pair_j (P,) int64.
    """

    inv_mass: torch.Tensor
    inertia_body: torch.Tensor
    inv_inertia_body: torch.Tensor
    half_extents: torch.Tensor
    ground_enabled: torch.Tensor
    joint_b0: torch.Tensor
    joint_b1: torch.Tensor
    joint_c0: torch.Tensor
    joint_c1: torch.Tensor
    pair_i: torch.Tensor
    pair_j: torch.Tensor

    @property
    def num_bodies(self) -> int:
        return self.inv_mass.shape[-1]

    @property
    def num_joints(self) -> int:
        return self.joint_b0.shape[-1]

    @property
    def num_pairs(self) -> int:
        return self.pair_i.shape[-1]


class State(NamedTuple):
    """p (..., n, 3), v (..., n, 3), q (..., n, 4) wxyz, w (..., n, 3)
    angular velocity in the global frame."""

    p: torch.Tensor
    v: torch.Tensor
    q: torch.Tensor
    w: torch.Tensor

    def R(self) -> torch.Tensor:
        return quat.quat_to_mat(self.q)


def _rows(x, n, width, default):
    if x is None:
        return np.tile(np.asarray(default, np.float64), (n, 1))
    return np.asarray(x, np.float64).reshape(n, width)


def make_scene(
    positions: Sequence,
    *,
    device,
    dtype: torch.dtype,
    quats: Optional[Sequence] = None,
    velocities: Optional[Sequence] = None,
    angular_velocities: Optional[Sequence] = None,
    masses: Optional[Sequence] = None,
    inertias: Optional[Sequence] = None,
    half_extents: Optional[Sequence] = None,
    static: Optional[Sequence] = None,
    joints: Sequence = (),
    ground: bool = True,
    pairs: Optional[Sequence] = None,
) -> tuple[SceneSpec, State]:
    """Host-side scene builder (numpy in, tensors on `device` out).

    Default box: unit mass, 0.3 side lengths, solid-box inertia; joints are
    (b0, b1, c0, c1) with b1 = -1 for a world anchor at c1."""
    p = np.asarray(positions, np.float64).reshape(-1, 3)
    n = p.shape[0]
    q = _rows(quats, n, 4, [1.0, 0.0, 0.0, 0.0])
    v = _rows(velocities, n, 3, [0.0, 0.0, 0.0])
    w = _rows(angular_velocities, n, 3, [0.0, 0.0, 0.0])
    m = np.ones(n) if masses is None else np.asarray(masses, np.float64).reshape(n)
    he = _rows(half_extents, n, 3, [0.15, 0.15, 0.15])
    if inertias is not None:
        inertia = np.asarray(inertias, np.float64).reshape(n, 3, 3)
    else:
        inertia = quat.box_inertia(
            torch.as_tensor(m), torch.as_tensor(2.0 * he)
        ).numpy()
    stat = np.zeros(n, bool) if static is None else np.asarray(static, bool).reshape(n)
    inv_mass = np.where(stat, 0.0, 1.0 / m)
    inv_inertia = np.zeros_like(inertia)
    inv_inertia[~stat] = np.linalg.inv(inertia[~stat])

    joints = list(joints)
    jb0 = np.asarray([j[0] for j in joints], np.int64).reshape(-1)
    jb1 = np.asarray([j[1] for j in joints], np.int64).reshape(-1)
    jc0 = np.asarray([j[2] for j in joints], np.float64).reshape(-1, 3)
    jc1 = np.asarray([j[3] for j in joints], np.float64).reshape(-1, 3)

    if pairs is None:
        pairs = [(i, j) for i in range(n) for j in range(i + 1, n)]
    pi = np.asarray([a for a, _ in pairs], np.int64).reshape(-1)
    pj = np.asarray([b for _, b in pairs], np.int64).reshape(-1)

    def f(x):
        return torch.as_tensor(x, dtype=dtype, device=device)

    def i(x):
        return torch.as_tensor(x, dtype=torch.int64, device=device)

    spec = SceneSpec(
        inv_mass=f(inv_mass),
        inertia_body=f(inertia),
        inv_inertia_body=f(inv_inertia),
        half_extents=f(he),
        ground_enabled=torch.full((n,), bool(ground), device=device),
        joint_b0=i(jb0),
        joint_b1=i(jb1),
        joint_c0=f(jc0),
        joint_c1=f(jc1),
        pair_i=i(pi),
        pair_j=i(pj),
    )
    state = State(p=f(p), v=f(v), q=quat.quat_normalize(f(q)), w=f(w))
    return spec, state


def inv_mass_blocks(spec: SceneSpec, state: State) -> torch.Tensor:
    """Per-body 6x6 inverse mass blocks [m^-1 I3, 0; 0, R I_b^-1 R^T],
    (..., n, 6, 6)."""
    R = state.R()
    inv_ig = R @ spec.inv_inertia_body @ R.transpose(-1, -2)
    eye3 = torch.eye(3, dtype=state.p.dtype, device=state.p.device)
    top = (spec.inv_mass[:, None, None] * eye3).expand(inv_ig.shape)
    zero = torch.zeros_like(inv_ig)
    upper = torch.cat([top, zero], dim=-1)
    lower = torch.cat([zero, inv_ig], dim=-1)
    return torch.cat([upper, lower], dim=-2)


def external_forces(spec: SceneSpec, state: State, gravity) -> torch.Tensor:
    """Gravity and gyroscopic torque per body, [m g; -w x (I_g w)],
    (..., n, 6)."""
    g = constant(tuple(gravity), state.p.dtype, state.p.device)
    im = spec.inv_mass
    mass = torch.where(im > 0, 1.0 / torch.where(im > 0, im, torch.ones_like(im)),
                       torch.zeros_like(im))
    fg = (mass[:, None] * g[None, :]).expand(state.w.shape)
    R = state.R()
    ig = R @ spec.inertia_body @ R.transpose(-1, -2)
    torque = -torch.linalg.cross(
        state.w, torch.einsum("...nij,...nj->...ni", ig, state.w), dim=-1
    )
    return torch.cat([fg, torque], dim=-1)


def pack_velocity(state: State) -> torch.Tensor:
    """(..., n, 6) [v; w] rows."""
    return torch.cat([state.v, state.w], dim=-1)


def unpack_velocity(state: State, u: torch.Tensor) -> State:
    return state._replace(v=u[..., :3], w=u[..., 3:])
