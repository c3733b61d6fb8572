"""Constraint assembly for a batch of scenarios: global Jacobian, position
error and LCP bounds.

Counterpart of `eggshell_tpu.physics.constraints.build_constraints`.  Row
order is the JAX package's: 3 rows per contact lane (two tangents, then
the normal, in the contact frame).  Idle lanes give zero J rows, zero
error and equality rows; the system matrix gives them a unit-scale
diagonal so their multipliers come out exactly 0.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from eggshell_tpu_torch.ops import quaternion as quat
from eggshell_tpu_torch.physics.contacts import ContactSet, contact_frames, effective_depth
from eggshell_tpu_torch.physics.scene import SceneSpec, State
from eggshell_tpu_torch.utils.config import FrictionModel, SimConfig


class ConstraintSystem(NamedTuple):
    J: torch.Tensor           # (B, m, n, 6)
    err: torch.Tensor         # (B, m) position error
    is_eq: torch.Tensor       # (B, m) True = equality row
    lo: torch.Tensor          # (B, m)
    hi: torch.Tensor          # (B, m)
    row_active: torch.Tensor  # (B, m) False = idle lane

    @property
    def num_rows(self) -> int:
        return self.J.shape[-3]


def _blocks_to_rows(bodies, blocks, n):
    """(B, c, 3, 6) blocks of bodies (B, c) -> dense rows (B, 3c, n, 6);
    body -1 contributes nothing."""
    B, c = bodies.shape
    onehot = (bodies[..., None] == torch.arange(n, device=bodies.device)).to(blocks.dtype)
    return torch.einsum("bcn,bcrk->bcrnk", onehot, blocks).reshape(B, 3 * c, n, 6)


def _gather_bodies(x, idx):
    """x (B, n, 3), idx (B, K) -> x[b, idx[b, k]] (B, K, 3)."""
    return torch.gather(x, 1, idx[..., None].expand(*idx.shape, x.shape[-1]))


def build_constraints(spec: SceneSpec, states: State, cs: ContactSet,
                      cfg: SimConfig) -> ConstraintSystem:
    if spec.num_joints > 0:
        raise NotImplementedError(
            "joint rows are not ported yet (ROADMAP A9: joints and broadphase scenes)"
        )
    if cfg.friction_model != FrictionModel.BOX:
        raise NotImplementedError(
            f"{cfg.friction_model.name} friction is not ported yet "
            "(ROADMAP A5: the other friction models of physics/constraints.py)"
        )
    n = spec.num_bodies
    B, K = cs.b0.shape
    dtype, device = states.p.dtype, states.p.device

    Rcf = contact_frames(cs)                                       # (B, K, 3, 3)
    b0ok = cs.b0 >= 0
    b1ok = cs.b1 >= 0
    sb0 = torch.where(b0ok, cs.b0, 0)
    sb1 = torch.where(b1ok, cs.b1, 0)
    c0 = quat.cross_mat(cs.position - _gather_bodies(states.p, sb0))
    c1 = quat.cross_mat(cs.position - _gather_bodies(states.p, sb1))
    blk0 = torch.cat([-Rcf, Rcf @ c0], dim=-1)                     # (B, K, 3, 6)
    blk1 = torch.cat([Rcf, -(Rcf @ c1)], dim=-1)

    mu = cfg.friction_bound
    row_on = cs.active[..., None].expand(B, K, 3)
    if cfg.ref_app_bounds:
        lo_c = torch.zeros((B, K, 3), dtype=dtype, device=device)
        hi_c = torch.full((B, K, 3), float("inf"), dtype=dtype, device=device)
    else:
        lo_c = torch.tensor([-mu, -mu, 0.0], dtype=dtype, device=device).expand(B, K, 3)
        hi_c = torch.tensor([mu, mu, float("inf")], dtype=dtype, device=device).expand(B, K, 3)

    zero = torch.zeros((), dtype=dtype, device=device)
    blk0 = torch.where(row_on[..., None] & b0ok[..., None, None], blk0, zero)
    blk1 = torch.where(row_on[..., None] & b1ok[..., None, None], blk1, zero)
    minus1 = torch.full_like(cs.b0, -1)
    J = (_blocks_to_rows(torch.where(cs.active, cs.b0, minus1), blk0, n)
         + _blocks_to_rows(torch.where(cs.active, cs.b1, minus1), blk1, n))

    dep_eff = effective_depth(cs.depth, cfg)
    zk = torch.zeros((B, K), dtype=dtype, device=device)
    cerr = torch.stack([zk, zk, torch.where(cs.active, -dep_eff, zk)], dim=-1)
    cerr = torch.where(row_on, cerr, zero).reshape(B, 3 * K)

    return ConstraintSystem(
        J=J,
        err=cerr,
        is_eq=(~row_on).reshape(B, 3 * K),
        lo=lo_c.reshape(B, 3 * K),
        hi=hi_c.reshape(B, 3 * K),
        row_active=row_on.reshape(B, 3 * K),
    )
