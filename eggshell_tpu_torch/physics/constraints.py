"""Constraint assembly for a batch of scenarios: global Jacobian, position
error and LCP bounds.

Counterpart of `eggshell_tpu.physics.constraints.build_constraints`.  Row
order is the JAX package's: 3 rows per ball joint (world x, y, z) first,
then 3 rows per contact lane (two tangents, then the normal, in the
contact frame).  Idle lanes give zero J rows, zero error and equality
rows; the system matrix gives them a unit-scale diagonal so their
multipliers come out exactly 0.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from eggshell_tpu_torch.ops import quaternion as quat
from eggshell_tpu_torch.physics.contacts import ContactSet, contact_frames, effective_depth
from eggshell_tpu_torch.physics.scene import SceneSpec, State
from eggshell_tpu_torch.utils.config import FrictionModel, SimConfig
from eggshell_tpu_torch.utils.constants import constant


class ConstraintSystem(NamedTuple):
    J: torch.Tensor           # (B, m, n, 6)
    err: torch.Tensor         # (B, m) position error
    is_eq: torch.Tensor       # (B, m) True = equality row
    lo: torch.Tensor          # (B, m)
    hi: torch.Tensor          # (B, m)
    row_active: torch.Tensor  # (B, m) False = idle lane
    couple: torch.Tensor      # (B, m) int64: the row of the contact's normal
    #                           impulse that bounds this tangent row under
    #                           COULOMB_PYRAMID, else -1

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


def _joint_rows(spec: SceneSpec, states: State):
    """J (B, 3J, n, 6) and err (B, 3J) of the ball joints:
    J_b0 = [I, -[R0 c0]x], J_b1 = [-I, [R1 c1]x] (nothing for b1 = -1,
    the world), err = p0 + R0 c0 - target with target the world anchor c1
    or p1 + R1 c1."""
    B, n = states.p.shape[:2]
    Jn = spec.num_joints
    R = quat.quat_to_mat(states.q)
    anchored = spec.joint_b1 < 0
    jb1 = torch.where(anchored, torch.zeros_like(spec.joint_b1), spec.joint_b1)
    r0c0 = torch.einsum("bjik,jk->bji", R[:, spec.joint_b0], spec.joint_c0)
    r1c1 = torch.einsum("bjik,jk->bji", R[:, jb1], spec.joint_c1)
    eye3 = torch.eye(3, dtype=states.p.dtype, device=states.p.device).expand(B, Jn, 3, 3)
    blk0 = torch.cat([eye3, -quat.cross_mat(r0c0)], dim=-1)
    blk1 = torch.cat([-eye3, quat.cross_mat(r1c1)], dim=-1)
    J = (_blocks_to_rows(spec.joint_b0.expand(B, Jn), blk0, n)
         + _blocks_to_rows(spec.joint_b1.expand(B, Jn), blk1, n))
    target = torch.where(anchored[:, None], spec.joint_c1, states.p[:, jb1] + r1c1)
    err = (states.p[:, spec.joint_b0] + r0c0 - target).reshape(B, 3 * Jn)
    return J, err


def _friction_rows(cfg: SimConfig, active, dtype, device):
    """(row_on, eq, lo, hi), each (B, K, 3), of the contact lanes under
    cfg.friction_model (the JAX package's `constraints.py:243-279`):
    NO_FRICTION switches the tangent rows off; INFINITE makes them
    equalities; COULOMB_PYRAMID pins their static bounds to [0, 0] (the
    solver replaces them by +-mu lambda_n); BOX bounds them by
    +-friction_bound, or every row by [0, inf) with `ref_app_bounds`."""
    B, K = active.shape
    fm = cfg.friction_model
    inf = float("inf")

    def rows(values, kind=dtype):
        return constant(values, kind, device).expand(B, K, 3)

    row_on = active[..., None].expand(B, K, 3)
    eq = rows([False, False, False], torch.bool)
    zeros = rows([0.0, 0.0, 0.0])
    if fm == FrictionModel.NO_FRICTION:
        off = torch.zeros_like(active)
        return torch.stack([off, off, active], dim=-1), eq, zeros, rows([0.0, 0.0, inf])
    if fm == FrictionModel.INFINITE:
        return row_on, rows([True, True, False], torch.bool), zeros, rows([0.0, 0.0, inf])
    if fm == FrictionModel.COULOMB_PYRAMID:
        return row_on, eq, zeros, rows([0.0, 0.0, inf])
    if cfg.ref_app_bounds:
        return row_on, eq, zeros, rows([inf, inf, inf])
    mu = cfg.friction_bound
    return row_on, eq, rows([-mu, -mu, 0.0]), rows([mu, mu, inf])


def build_constraints(spec: SceneSpec, states: State, cs: ContactSet,
                      cfg: SimConfig) -> ConstraintSystem:
    n = spec.num_bodies
    Jn = spec.num_joints
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

    row_on, eq, lo_c, hi_c = _friction_rows(cfg, cs.active, dtype, device)

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
    is_eq = torch.where(row_on, eq, True).reshape(B, 3 * K)
    row_active = row_on.reshape(B, 3 * K)
    lo, hi = lo_c.reshape(B, 3 * K), hi_c.reshape(B, 3 * K)

    if cfg.friction_model == FrictionModel.COULOMB_PYRAMID:
        normal_row = 3 * Jn + 3 * torch.arange(K, device=device) + 2
        couple = torch.stack([normal_row, normal_row, torch.full_like(normal_row, -1)], -1)
        couple = torch.where(row_on, couple, -1).reshape(B, 3 * K)
    else:
        couple = torch.full((B, 3 * K), -1, dtype=torch.int64, device=device)

    if Jn > 0:
        Jj, jerr = _joint_rows(spec, states)
        ones = torch.ones((B, 3 * Jn), dtype=torch.bool, device=device)
        jzero = torch.zeros((B, 3 * Jn), dtype=dtype, device=device)
        J = torch.cat([Jj, J], dim=1)
        cerr = torch.cat([jerr, cerr], dim=1)
        is_eq = torch.cat([ones, is_eq], dim=1)
        lo, hi = torch.cat([jzero, lo], dim=1), torch.cat([jzero, hi], dim=1)
        row_active = torch.cat([ones, row_active], dim=1)
        couple = torch.cat([torch.full((B, 3 * Jn), -1, dtype=torch.int64, device=device),
                            couple], dim=1)

    return ConstraintSystem(J=J, err=cerr, is_eq=is_eq, lo=lo, hi=hi, row_active=row_active,
                            couple=couple)


class CompactConstraintSystem(NamedTuple):
    """Constraints as compact two-body blocks, O(K) memory: lane l
    contributes 3 rows that touch at most two bodies.  Counterpart of the
    JAX package's `CompactConstraintSystem`, with a leading scenario axis.

    blocks (B, L, 3, 12): columns 0:6 the rows' [linear | angular] part on
    body b0, 6:12 on body b1; b0 / b1 (B, L) int64, -1 = the ground or the
    world anchor.  The (L, 3) rows flatten in the dense system's order
    (joints first, then contacts); idle lanes have zero blocks."""

    blocks: torch.Tensor      # (B, L, 3, 12)
    b0: torch.Tensor          # (B, L) int64
    b1: torch.Tensor          # (B, L) int64
    err: torch.Tensor         # (B, 3L)
    is_eq: torch.Tensor       # (B, 3L)
    lo: torch.Tensor          # (B, 3L)
    hi: torch.Tensor          # (B, 3L)
    row_active: torch.Tensor  # (B, 3L)


def build_compact_constraints(spec: SceneSpec, states: State, cs: ContactSet,
                              cfg: SimConfig) -> CompactConstraintSystem:
    """The joint and contact constraints as compact blocks, the dense
    Jacobian never formed (the formulas of `build_constraints`); NO_FRICTION,
    INFINITE and BOX friction.  COULOMB_PYRAMID raises NotImplementedError,
    as in the JAX package: its coupled bounds are a dense-path feature."""
    if cfg.friction_model == FrictionModel.COULOMB_PYRAMID:
        raise NotImplementedError("COULOMB_PYRAMID coupling is dense-path only (ops.lcp)")
    Jn = spec.num_joints
    B, K = cs.b0.shape
    dtype, device = states.p.dtype, states.p.device
    zero = torch.zeros((), dtype=dtype, device=device)

    if Jn > 0:
        # joints: blk0 = [I, -[R0 c0]x], blk1 = [-I, [R1 c1]x] (zero for the world)
        R = quat.quat_to_mat(states.q)
        anchored = spec.joint_b1 < 0
        jb1 = torch.where(anchored, torch.zeros_like(spec.joint_b1), spec.joint_b1)
        r0c0 = torch.einsum("bjik,jk->bji", R[:, spec.joint_b0], spec.joint_c0)
        r1c1 = torch.einsum("bjik,jk->bji", R[:, jb1], spec.joint_c1)
        eye3 = torch.eye(3, dtype=dtype, device=device).expand(B, Jn, 3, 3)
        jblk0 = torch.cat([eye3, -quat.cross_mat(r0c0)], dim=-1)
        jblk1 = torch.cat([-eye3, quat.cross_mat(r1c1)], dim=-1)
        jblk1 = torch.where((~anchored)[:, None, None], jblk1, zero)
        jblocks = torch.cat([jblk0, jblk1], dim=-1)                    # (B, Jn, 3, 12)
        tgt = torch.where(anchored[:, None], spec.joint_c1, states.p[:, jb1] + r1c1)
        jerr = (states.p[:, spec.joint_b0] + r0c0 - tgt).reshape(B, 3 * Jn)

    # contacts: blk0 = [-R, R [pos - p0]x], blk1 = [R, -R [pos - p1]x]
    Rcf = contact_frames(cs)                                        # (B, K, 3, 3)
    b0ok = cs.b0 >= 0
    b1ok = cs.b1 >= 0
    c0 = quat.cross_mat(cs.position - _gather_bodies(states.p, torch.where(b0ok, cs.b0, 0)))
    c1 = quat.cross_mat(cs.position - _gather_bodies(states.p, torch.where(b1ok, cs.b1, 0)))
    cblk0 = torch.cat([-Rcf, Rcf @ c0], dim=-1)
    cblk1 = torch.cat([Rcf, -(Rcf @ c1)], dim=-1)
    row_on, eq, lo_c, hi_c = _friction_rows(cfg, cs.active, dtype, device)
    mask3 = row_on[..., None]
    cblk0 = torch.where(mask3 & b0ok[..., None, None], cblk0, zero)
    cblk1 = torch.where(mask3 & b1ok[..., None, None], cblk1, zero)
    blocks = torch.cat([cblk0, cblk1], dim=-1)                     # (B, K, 3, 12)
    dep_eff = effective_depth(cs.depth, cfg)
    zk = torch.zeros((B, K), dtype=dtype, device=device)
    err = torch.stack([zk, zk, torch.where(cs.active, -dep_eff, zk)], dim=-1)
    err = torch.where(row_on, err, zero).reshape(B, 3 * K)
    minus1 = torch.full_like(cs.b0, -1)
    b0 = torch.where(cs.active, cs.b0, minus1)
    b1 = torch.where(cs.active, cs.b1, minus1)
    is_eq = torch.where(row_on, eq, True).reshape(B, 3 * K)
    lo, hi = lo_c.reshape(B, 3 * K), hi_c.reshape(B, 3 * K)
    row_active = row_on.reshape(B, 3 * K)

    if Jn > 0:
        ones = torch.ones((B, 3 * Jn), dtype=torch.bool, device=device)
        jzero = torch.zeros((B, 3 * Jn), dtype=dtype, device=device)
        blocks = torch.cat([jblocks, blocks], dim=1)
        b0 = torch.cat([spec.joint_b0.expand(B, Jn), b0], dim=1)
        b1 = torch.cat([spec.joint_b1.expand(B, Jn), b1], dim=1)
        err = torch.cat([jerr, err], dim=1)
        is_eq = torch.cat([ones, is_eq], dim=1)
        lo, hi = torch.cat([jzero, lo], dim=1), torch.cat([jzero, hi], dim=1)
        row_active = torch.cat([ones, row_active], dim=1)
    # idle rows: zero blocks, so the matrix-free operator sees nothing there
    L = blocks.shape[1]
    blocks = blocks * row_active.reshape(B, L, 3, 1).to(dtype)
    return CompactConstraintSystem(blocks=blocks, b0=b0, b1=b1, err=err, is_eq=is_eq, lo=lo,
                                   hi=hi, row_active=row_active)
