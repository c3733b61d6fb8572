"""The ODE-style velocity stepper for a batch of scenarios.

Counterpart of `eggshell_tpu.physics.stepper`.  `step_ode_batched`
dispatches as the JAX package's does:

- the fused chain (`SolverKind.JACOBI_KERNEL`, BOX or COULOMB_PYRAMID
  friction, `conditional_cfm=False`; the bench configuration),
  counterpart of `_fused_step_all_kernel`: the packed narrowphase kernel,
  the compaction-and-dedupe kernel, ball joints as equality lanes, then
  the body-prep, Jacobian-block, A-formation, packed-Jacobi (resident or
  streamed; scalar or 3x3 block sweeps, box or pyramid bounds) and
  integrate kernels on compact 3x12 blocks, for any B;
- the large-scene tier (`SolverKind.MATRIX_FREE`), counterpart of the
  vmapped `_step_matrix_free`: contacts (B2 on the broadphase's pairs),
  compact two-body constraint blocks, and the matrix-free projected Jacobi
  of `ops.lcp_matrix_free`; no dense Jacobian and no system matrix;
- the unfused branch, every other configuration: contacts, dense
  constraints (ball joints, any friction model), the system matrix with
  always-on or conditional CFM, then the projected-Jacobi LCP kernel for
  JACOBI_KERNEL without pyramid friction, else the plain PGS, SOR or
  Jacobi solve of `ops.lcp` (`_solve_lambda`), and the midpoint
  integration.

With 0 < cfg.pair_capacity < the scene's pairs, every branch's narrowphase
takes each scenario's broadphase selection (`ops.broadphase`).

`step_ode` steps one scene: the unfused branch at a batch of one, under
PGS, JACOBI, SOR or DIRECT (the JAX package's single-scene solver map has
no JACOBI_KERNEL), or the matrix-free step.  DIRECT is the Schur mixed
solver over Murty's pivoting (`ops.lcp_direct`).  The rest of the
single-scene stepper runs the same machinery at a batch of one:
`step_implicit_midpoint`, `step_explicit_euler` (joints only),
`init_stabilize` and `post_stabilize` (a host loop that reads err^2 once
an iteration), `position_constraint_error` and `step_diagnostics`.

Gradients.  Every branch is differentiable with respect to the states and
the control wrenches, on the card as on the CPU:

- the fused chain, where grad mode is on and a state or `ext_forces`
  requires grad, runs as `_FusedStepDiff`, a `torch.autograd.Function`
  (the JAX package's `_fused_step_diff`): its forward is the kernel chain
  unchanged, B6's impulses saved; its backward recomputes the plain twin
  `_step_xla_twin` under autograd, adopting those impulses with the IFT
  adjoint (`ops.lcp.adopt_lcp_solution`), so no sweep is run backward;
- the unfused branch and the matrix-free step are plain torch around the
  narrowphase, whose kernel is wrapped by `collide_boxes_lanes_diff` (in
  float32; float64 takes the plain one, `contacts.box_pair_narrowphase`); the
  plain PGS, SOR and Jacobi solves differentiate through their sweeps and
  DIRECT through `ops.lcp_direct.mixed_constraints_solver_implicit`.

A kernel launched with a tensor that requires grad raises
(`kernels.grad_refusal`): JACOBI_KERNEL's unfused solve (B6c), which has no
backward in either package, refuses a gradient rather than stopping it.
"""

from __future__ import annotations

import math

import torch

from eggshell_tpu_torch.ops import lcp, lcp_direct
from eggshell_tpu_torch.ops import lcp_matrix_free as mf
from eggshell_tpu_torch.ops import quaternion as quat
from eggshell_tpu_torch.ops.amat_kernel import contact_system_matrix, padded_rows
from eggshell_tpu_torch.ops.collision_kernel import collide_boxes_lanes_packed
from eggshell_tpu_torch.ops.compact_kernel import compact_contacts
from eggshell_tpu_torch.ops.integrate_kernel import integrate_step
from eggshell_tpu_torch.ops.jassembly_kernel import contact_jacobian_blocks
from eggshell_tpu_torch.ops.pgs_kernel import (packed_streams, solve_lcp_jacobi,
                                               solve_lcp_jacobi_packed)
from eggshell_tpu_torch.ops.prep_kernel import prep_bodies
from eggshell_tpu_torch.physics import scene as scn
from eggshell_tpu_torch.physics.constraints import (ConstraintSystem, build_compact_constraints,
                                                    build_constraints)
from eggshell_tpu_torch.physics.contacts import (ContactSet, count_dropped_contacts, depth_cap,
                                                 drop_joint_contacts, joint_anchors,
                                                 joint_points, make_contacts_batched,
                                                 scene_pairs)
from eggshell_tpu_torch.physics.scene import SceneSpec, State
from eggshell_tpu_torch.utils.config import FrictionModel, SimConfig, SolverKind

_POWER_ITERS = 12


def _cond_bounds_exact(A):
    eigs = torch.linalg.eigvalsh(A)
    return eigs[..., -1], eigs[..., 0]


def _cond_bounds_power(A):
    """lambda_max by power iteration, lambda_min by inverse iteration
    through one Cholesky factor.  A scenario whose factorization fails
    (A not positive definite) gets lambda_min = 0, i.e. reads as badly
    conditioned."""
    B, m, _ = A.shape
    v = torch.full((B, m), 1.0 / math.sqrt(m), dtype=A.dtype, device=A.device)

    def normalized(w):
        return w / torch.clamp(torch.linalg.vector_norm(w, dim=-1, keepdim=True), min=1e-300)

    def av(x):
        return torch.einsum("bij,bj->bi", A, x)

    for _ in range(_POWER_ITERS):
        v = normalized(av(v))
    lam_max = torch.sum(v * av(v), dim=-1)

    L, info = torch.linalg.cholesky_ex(A)
    u = v
    for _ in range(_POWER_ITERS):
        u = normalized(torch.cholesky_solve(u[..., None], L)[..., 0])
    lam_min = torch.sum(u * av(u), dim=-1)
    ok = (info == 0) & torch.isfinite(lam_min)
    lam_min = torch.where(ok, lam_min, torch.zeros_like(lam_min))
    return lam_max, lam_min


def system_matrix(spec: SceneSpec, states: State, sys: ConstraintSystem,
                  cfg: SimConfig) -> torch.Tensor:
    """A = J M^-1 J^T (B, m, m) with CFM on active rows and, on idle rows,
    a diagonal equal to the largest active diagonal (which keeps cond(A)
    that of the active block).  With `conditional_cfm`, cfg.cfm is added
    only where the estimated condition number exceeds
    cfg.good_condition_number (or A is not positive definite)."""
    B, m = sys.err.shape
    Minv = scn.inv_mass_blocks(spec, states)                       # (B, n, 6, 6)
    JM = torch.einsum("bmnk,bnkl->bmnl", sys.J, Minv)
    A = torch.einsum("bmnl,bonl->bmo", JM, sys.J)

    zero = torch.zeros((), dtype=A.dtype, device=A.device)
    diag = torch.diagonal(A, dim1=-2, dim2=-1)
    diag_scale = torch.amax(torch.where(sys.row_active, diag, zero), dim=-1, keepdim=True)
    diag_scale = torch.where(diag_scale > 0, diag_scale, torch.ones_like(diag_scale))
    A = A + torch.diag_embed(torch.where(sys.row_active, zero, diag_scale))

    if cfg.conditional_cfm:
        if cfg.cond_estimator == "exact":
            lam_max, lam_min = _cond_bounds_exact(A)
        else:
            lam_max, lam_min = _cond_bounds_power(A)
        bad = (lam_min <= 0) | (
            lam_max / torch.clamp(lam_min, min=1e-300) > cfg.good_condition_number
        )
        cfm = torch.where(bad, torch.full_like(lam_max, cfg.cfm), torch.zeros_like(lam_max))
    else:
        cfm = torch.full((B,), cfg.cfm_always, dtype=A.dtype, device=A.device)
    return A + torch.diag_embed(torch.where(sys.row_active, cfm[:, None], zero))


def _integrate(states: State, cfg: SimConfig, u, vdot) -> State:
    """u_new = u + dt v_dot, then the midpoint position update and the
    exp-map orientation update."""
    dt = cfg.dt
    u_new = u + dt * vdot
    u_mid = 0.5 * (u + u_new)
    p_new = states.p + dt * u_mid[..., :3]
    q_new = quat.integrate_quat(states.q, u_mid[..., 3:], dt)
    return State(p=p_new, v=u_new[..., :3], q=q_new, w=u_new[..., 3:])


def _post_solve(states: State, cfg: SimConfig, sys: ConstraintSystem, lam, u, Minv, F) -> State:
    """v_dot = M^-1 (F + J^T lambda), then `_integrate`."""
    JTlam = torch.einsum("bmnk,bm->bnk", sys.J, lam)
    return _integrate(states, cfg, u, torch.einsum("bnij,bnj->bni", Minv, F + JTlam))


def _is_fused(cfg: SimConfig) -> bool:
    """The JAX package's dispatch (`stepper.py:767-773`): the fused chain
    for JACOBI_KERNEL with BOX or pyramid friction and always-on CFM."""
    return (cfg.solver == SolverKind.JACOBI_KERNEL
            and cfg.friction_model in (FrictionModel.BOX, FrictionModel.COULOMB_PYRAMID)
            and not cfg.conditional_cfm)


def _pyramid_mu(cfg: SimConfig) -> float:
    """The Coulomb-pyramid coefficient of the fused chain's solve: friction_mu
    under COULOMB_PYRAMID, else 0 (box friction)."""
    return float(cfg.friction_mu) if cfg.friction_model == FrictionModel.COULOMB_PYRAMID else 0.0


def _solve_lambda(A, rhs, sys: ConstraintSystem, cfg: SimConfig):
    """The unfused branch's plain solve (the JAX package's `_solve_lambda`):
    for DIRECT the mixed pivoting solver with its IFT backward, for PGS,
    JACOBI and SOR `ops.lcp.solve_lcp` with the config's sweep parameters,
    early exit at cfg.solver_tol > 0, and coupled bounds under
    COULOMB_PYRAMID."""
    if cfg.solver == SolverKind.DIRECT:
        return lcp_direct.mixed_constraints_solver_implicit(A, rhs, sys.is_eq, sys.lo, sys.hi)
    method = {SolverKind.PGS: "pgs", SolverKind.JACOBI: "jacobi", SolverKind.SOR: "sor"}[cfg.solver]
    coulomb = cfg.friction_model == FrictionModel.COULOMB_PYRAMID
    return lcp.solve_lcp(
        A, rhs, sys.is_eq, sys.lo, sys.hi, iters=cfg.solver_iters, method=method,
        check_tol=cfg.solver_tol if cfg.solver_tol > 0 else None, omega=cfg.sor_omega,
        jacobi_omega=cfg.jacobi_omega, jacobi_beta=cfg.jacobi_beta,
        couple=sys.couple if coulomb else None, mu=cfg.friction_mu if coulomb else 0.0,
        jacobi_block=bool(cfg.jacobi_block))


def _batched_ext(ext_forces, states: State):
    """Control wrenches (n, 6) or (B, n, 6) as a contiguous (B, n, 6), or None."""
    if ext_forces is None:
        return None
    return ext_forces.expand(states.p.shape[:2] + (6,)).contiguous()


def _pre_solve(spec: SceneSpec, states: State, cfg: SimConfig, ext_forces=None):
    """Everything up to the lambda solve: contacts, constraints, the rhs
    -erp/dt^2 err - J (u/dt + M^-1 F) and the system matrix.  Returns
    (cs, sys, A, rhs, u, Minv, F)."""
    dt = cfg.dt
    cs = make_contacts_batched(spec, states, cfg)
    sys = build_constraints(spec, states, cs, cfg)
    u = scn.pack_velocity(states)                                   # (B, n, 6)
    Minv = scn.inv_mass_blocks(spec, states)
    F = scn.external_forces(spec, states, cfg.gravity)
    if ext_forces is not None:
        F = F + ext_forces
    MinvF = torch.einsum("bnij,bnj->bni", Minv, F)
    rhs = -cfg.erp / dt / dt * sys.err - torch.einsum("bmnk,bnk->bm", sys.J, u / dt + MinvF)
    A = system_matrix(spec, states, sys, cfg)
    return cs, sys, A, rhs, u, Minv, F


def _step_matrix_free(spec: SceneSpec, states: State, cfg: SimConfig, ext_forces=None,
                      cs=None):
    """The large-scene step of B scenarios (the JAX package's vmapped
    `_step_matrix_free`): contacts, compact constraint blocks, the rhs
    -erp/dt^2 err - J (u/dt + M^-1 F), the matrix-free projected Jacobi
    (cfg.solver_iters sweeps, jacobi_omega, jacobi_beta, cfm_always), then
    v_dot = M^-1 (F + J^T lambda) and the midpoint integration.  `cs`
    injects precomputed contacts.  Returns (next states, contacts)."""
    dt = cfg.dt
    n = spec.num_bodies
    if cs is None:
        cs = make_contacts_batched(spec, states, cfg)
    sysc = build_compact_constraints(spec, states, cs, cfg)
    u = scn.pack_velocity(states)
    Minv = scn.inv_mass_blocks(spec, states)
    F = scn.external_forces(spec, states, cfg.gravity)
    if ext_forces is not None:
        F = F + ext_forces
    MinvF = torch.einsum("bnij,bnj->bni", Minv, F)
    rhs = -cfg.erp / dt / dt * sysc.err - mf.j_v(sysc.blocks, sysc.b0, sysc.b1, u / dt + MinvF)
    lam = mf.solve_lcp_matrix_free(
        sysc.blocks, sysc.b0, sysc.b1, Minv, rhs, sysc.is_eq, sysc.lo, sysc.hi,
        iters=cfg.solver_iters, omega=cfg.jacobi_omega, beta=cfg.jacobi_beta,
        cfm=float(cfg.cfm_always))
    JTlam = mf.jt_x(sysc.blocks, sysc.b0, sysc.b1, lam, n)
    vdot = torch.einsum("bnij,bnj->bni", Minv, F + JTlam)
    return _integrate(states, cfg, u, vdot), cs


def _run(name, fn, args):
    return fn(*args)


def _with_joint_lanes(spec: SceneSpec, states: State, cs: ContactSet, eps2: float):
    """The joint-contact dedupe on the compacted contacts, then the joints
    as always-active equality lanes PREPENDED to them (the XLA twin's row
    order): b0 / b1 the joint's bodies, position a0, second anchor a1, a +z
    frame, depth 0.  Returns (lanes, pos1, eq) with Jn + K lanes; a contact
    lane's second anchor is its position."""
    B = states.p.shape[0]
    Jn = spec.num_joints
    a0, a1 = joint_anchors(spec, states)
    cs = drop_joint_contacts(cs, joint_points(a0, a1, spec.joint_b1), spec.joint_b0,
                             spec.joint_b1, eps2)
    zhat = torch.zeros_like(a0)
    zhat[..., 2] = 1.0
    on = torch.ones((B, Jn), dtype=torch.bool, device=a0.device)

    def cat(j, c):
        return torch.cat([j, c], dim=1).contiguous()

    lanes = ContactSet(
        b0=cat(spec.joint_b0.expand(B, Jn), cs.b0), b1=cat(spec.joint_b1.expand(B, Jn), cs.b1),
        position=cat(a0, cs.position), normal=cat(zhat, cs.normal),
        depth=cat(torch.zeros_like(a0[..., 0]), cs.depth), active=cat(on, cs.active))
    return lanes, cat(a1, cs.position), cat(on, torch.zeros_like(cs.active))


def jacobi_phase(K: int) -> str:
    """The fused step's solve phase for K lanes (joints counted):
    "jacobi_packed_stream" where `solve_lcp_jacobi_packed` takes the cluster
    B6b, else "jacobi_packed"."""
    return "jacobi_packed_stream" if packed_streams(padded_rows(K)) else "jacobi_packed"


def _fused_step(spec: SceneSpec, states: State, cfg: SimConfig, ext_forces=None,
                call=_run, out=None, return_lam: bool = False):
    """Counterpart of the JAX package's `_fused_step_all_kernel`, for any
    B: B2p (packed narrowphase, when the scene has pairs), B3 (compaction,
    depth cap and dedupe), the ball joints as equality lanes, then B1 (body
    prep), B4 (Jacobian blocks), B5 (A = J M^-1 J^T with cfm_always), B6 or
    B6b (packed heavy-ball Jacobi, A resident or held by a cluster) and B7
    (integrate) on the compact (B, 3Kx, 12) blocks.  No dense Jacobian, no
    CFM check and no torch compaction.  B6 runs 3x3 block sweeps with
    cfg.jacobi_block and Coulomb-pyramid bounds under COULOMB_PYRAMID.

    Each phase runs as `call(name, fn, args)`, by default fn(*args), with
    name one of "narrowphase", "compact", "prep", "jassembly", "amat",
    "jacobi_packed" or "jacobi_packed_stream", "integrate": `chip_smoke.py`
    records each kernel's arguments through it, and `profile_step` times
    each phase.  With `out`, a State of buffers, B7 writes the next state
    into them (the captured step of `parallel.rollout`).  With
    `return_lam`, returns (next state, B6's impulses (B, 3Kx)) in the
    twin's row order: 3 rows a joint lane, then 3 a contact lane."""
    states = State(*(x.contiguous() for x in states))
    eps2 = cfg.min_constraint_distance ** 2
    pair = pi = pj = None
    if spec.num_pairs > 0:
        # the scene's pairs, or each scenario's broadphase selection and its
        # gate, which B2p writes into the flags (a gated-off lane is the
        # self-pair (0, 0), a deep contact, and must not reach B3)
        pi, pj, gate = scene_pairs(spec, states, cfg)
        pair = call("narrowphase", collide_boxes_lanes_packed, (
            states.p, states.q, spec.half_extents, pi, pj) + (() if gate is None else (gate,)))
    cs = call("compact", compact_contacts, (
        states.p, states.q, spec.half_extents, spec.ground_enabled, pair, pi, pj,
        cfg.contact_capacity, eps2, depth_cap(cfg)))
    pos1, eq = cs.position, None
    if spec.num_joints > 0:
        cs, pos1, eq = _with_joint_lanes(spec, states, cs, eps2)
    Kx = cs.capacity
    uhat, invIg, F = call("prep", prep_bodies, (
        states.q, states.v, states.w, spec.inv_mass, spec.inertia_body, spec.inv_inertia_body,
        cfg.dt, cfg.gravity, _batched_ext(ext_forces, states)))
    Jc, rhs = call("jassembly", contact_jacobian_blocks, (
        cs.b0, cs.b1, cs.position, pos1, cs.normal, cs.depth, cs.active, eq, states.p, uhat,
        float(cfg.erp / cfg.dt / cfg.dt)))
    A, diag = call("amat", contact_system_matrix, (
        Jc, cs.b0, cs.b1, cs.active, spec.inv_mass, invIg, Kx, cfg.cfm_always))
    lam = call(jacobi_phase(Kx), solve_lcp_jacobi_packed, (
        A, diag, rhs, cs.active, eq, Kx, cfg.friction_bound, cfg.solver_iters,
        cfg.jacobi_omega, cfg.jacobi_beta, bool(cfg.jacobi_block), _pyramid_mu(cfg)))
    p, q, v, w = call("integrate", integrate_step, (
        Jc, lam, cs.b0, cs.b1, states.p, states.q, states.v, states.w, spec.inv_mass, invIg, F,
        cfg.dt) + (() if out is None else ((out.p, out.q, out.v, out.w),)))
    if return_lam:
        return State(p=p, v=v, q=q, w=w), lam[:, :3 * Kx]
    return State(p=p, v=v, q=q, w=w)


def _step_xla_twin(spec: SceneSpec, states: State, cfg: SimConfig, ext_forces=None,
                   lam_saved=None) -> State:
    """The fused chain's plain torch twin (the JAX package's
    `_step_xla_twin`), its backward: contacts through
    `collide_boxes_lanes_diff`, dense constraints (joints as equality
    rows), the system matrix with cfm_always, then, with `lam_saved`
    (B, m), B6's impulses adopted with the IFT adjoint against the bounds
    they were solved in (+-mu lambda_n under COULOMB_PYRAMID), else
    `ops.lcp.solve_lcp_implicit` with the fused chain's sweep rule, and the
    midpoint integration."""
    _, sys, A, rhs, u, Minv, F = _pre_solve(spec, states, cfg, _batched_ext(ext_forces, states))
    if lam_saved is not None:
        lo, hi = sys.lo, sys.hi
        if cfg.friction_model == FrictionModel.COULOMB_PYRAMID:
            lo, hi = lcp._bounds(lam_saved, lo, hi, sys.couple, float(cfg.friction_mu))
        lam = lcp.adopt_lcp_solution(A, rhs, sys.is_eq, lo, hi, lam_saved)
    else:
        lam = lcp.solve_lcp_implicit(A, rhs, sys.is_eq, sys.lo, sys.hi, cfg.solver_iters,
                                     "jacobi", cfg.jacobi_omega, 1e-8, cfg.jacobi_beta,
                                     bool(cfg.jacobi_block))
    return _post_solve(states, cfg, sys, lam, u, Minv, F)


class _FusedStepDiff(torch.autograd.Function):
    """The fused step with a backward: forward `_fused_step` (the kernels on
    the card), B6's impulses saved; backward autograd of `_step_xla_twin`
    over the saved inputs with those impulses adopted."""

    @staticmethod
    def forward(ctx, spec, cfg, ext_forces, p, v, q, w):
        out, lam = _fused_step(spec, State(p=p, v=v, q=q, w=w), cfg, ext_forces,
                               return_lam=True)
        ctx.spec, ctx.cfg = spec, cfg
        ctx.save_for_backward(ext_forces, p, v, q, w, lam)
        return out.p, out.v, out.q, out.w

    @staticmethod
    def backward(ctx, gp, gv, gq, gw):
        *saved, lam = ctx.saved_tensors
        inputs = [None if x is None else x.detach().requires_grad_(need)
                  for x, need in zip(saved, ctx.needs_input_grad[2:])]
        wanted = [x for x in inputs if x is not None and x.requires_grad]
        with torch.enable_grad():
            out = _step_xla_twin(ctx.spec, State(*inputs[1:]), ctx.cfg, inputs[0],
                                 lam_saved=lam)
        got = iter(torch.autograd.grad(tuple(out), wanted, (gp, gv, gq, gw), allow_unused=True))
        return (None, None) + tuple(next(got) if x is not None and x.requires_grad else None
                                    for x in inputs)


def _wants_grad(*tensors) -> bool:
    """Grad mode is on and one of `tensors` (None skipped) requires grad."""
    return torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors)


def step_ode_batched(spec: SceneSpec, states: State, cfg: SimConfig, ext_forces=None) -> State:
    """One step of B scenarios of one scene; states (B, n, ...).
    `ext_forces` (n, 6) or (B, n, 6) adds control wrenches [force; torque]
    per body on top of gravity and the gyroscopic torque.  Differentiable
    with respect to `states` and `ext_forces` on every branch (see the
    module); on the fused chain a SceneSpec tensor that requires grad
    raises, as its backward gives the spec no gradient."""
    if _is_fused(cfg):
        if _wants_grad(*spec):
            raise ValueError("the fused step differentiates with respect to the states and "
                             "ext_forces only: a SceneSpec tensor requires grad")
        if _wants_grad(ext_forces, *states):
            return State(*_FusedStepDiff.apply(spec, cfg, ext_forces, *states))
        return _fused_step(spec, states, cfg, ext_forces)
    if cfg.solver == SolverKind.MATRIX_FREE:
        return _step_matrix_free(spec, states, cfg, _batched_ext(ext_forces, states))[0]
    _, sys, A, rhs, u, Minv, F = _pre_solve(spec, states, cfg, _batched_ext(ext_forces, states))
    if (cfg.solver == SolverKind.JACOBI_KERNEL
            and cfg.friction_model != FrictionModel.COULOMB_PYRAMID):
        # the JAX package's kernel call here passes no `block`: jacobi_block
        # is ignored on this branch
        lam = solve_lcp_jacobi(
            A.contiguous(), rhs.contiguous(), sys.is_eq.contiguous(), sys.lo.contiguous(),
            sys.hi.contiguous(), iters=cfg.solver_iters, omega=cfg.jacobi_omega,
            beta=cfg.jacobi_beta,
        )
    else:
        solve_cfg = cfg
        if cfg.solver == SolverKind.JACOBI_KERNEL:
            solve_cfg = cfg.replace(solver=SolverKind.JACOBI)
        lam = _solve_lambda(A, rhs, sys, solve_cfg)
    return _post_solve(states, cfg, sys, lam, u, Minv, F)


def check_single_scene(cfg: SimConfig) -> None:
    """A clear error for JACOBI_KERNEL: the JAX package's single-scene solver
    map has no entry for it (its `step_ode` raises KeyError), so its
    single-scene path runs PGS, JACOBI, SOR, DIRECT and the matrix-free step
    only."""
    if cfg.solver == SolverKind.JACOBI_KERNEL:
        raise ValueError(
            "the single-scene step has no solve for SolverKind.JACOBI_KERNEL, as in the JAX "
            "package (its step_ode's solver map lacks it): use PGS, JACOBI, SOR or DIRECT, or "
            "step_ode_batched")


def step_ode(spec: SceneSpec, state: State, cfg: SimConfig, ext_force=None):
    """One step of one scene, `state` without a batch axis.  Returns
    (new_state, contact_set).  `ext_force` (n, 6) adds control wrenches
    [force; torque] per body.  The unfused branch at a batch of one, the
    batch axis dropped (the JAX package's batched unfused step is the vmap
    of the same per-scene math); PGS, JACOBI, SOR, DIRECT and MATRIX_FREE
    only (`check_single_scene`)."""
    check_single_scene(cfg)
    states = State(*(x[None] for x in state))
    ext = None if ext_force is None else _batched_ext(ext_force, states)
    if cfg.solver == SolverKind.MATRIX_FREE:
        nxt, cs = _step_matrix_free(spec, states, cfg, ext)
        return State(*(x[0] for x in nxt)), ContactSet(*(x[0] for x in cs))
    cs, sys, A, rhs, u, Minv, F = _pre_solve(spec, states, cfg, ext)
    lam = _solve_lambda(A, rhs, sys, cfg)
    nxt = _post_solve(states, cfg, sys, lam, u, Minv, F)
    return State(*(x[0] for x in nxt)), ContactSet(*(x[0] for x in cs))


# ---------------------------------------------------------------------------
# The rest of the single-scene stepper: implicit midpoint, explicit Euler,
# the stabilizers and the diagnostics.  Each takes one scene (no batch axis)
# with the JAX package's signature and runs the unfused machinery above at a
# batch of one, as `step_ode` does.


def _one(x):
    """A State or ContactSet of one scene as a batch of one."""
    return type(x)(*(t[None] for t in x))


def _first(x):
    return type(x)(*(t[0] for t in x))


def step_implicit_midpoint(spec: SceneSpec, state: State, cfg: SimConfig, ext_force=None,
                           fixed_point_iters: int = 4):
    """Implicit-midpoint step of one scene: u_{n+1} = u_n + dt f(x_mid, u_mid),
    x_mid the start state advanced dt/2 with u_mid = (u_n + u_{n+1})/2, by
    `fixed_point_iters` sweeps; each sweep rebuilds the constraints, the
    mass blocks, the forces and the system matrix at the midpoint state and
    re-solves the LCP (PGS, JACOBI, SOR or DIRECT, `check_single_scene`).
    Contacts are detected once, at the start state.  Positions advance
    with u_mid.  Returns (new_state, contact_set).  Differentiable as
    `step_ode` is: the contacts through `collide_boxes_lanes_diff`, the
    solves through their sweeps or DIRECT's implicit backward."""
    check_single_scene(cfg)
    dt = cfg.dt
    states = _one(state)
    ext = None if ext_force is None else _batched_ext(ext_force, states)
    cs = make_contacts_batched(spec, states, cfg)
    u0 = scn.pack_velocity(states)
    u_mid = u0
    for _ in range(fixed_point_iters):
        mid = State(p=states.p + 0.5 * dt * u_mid[..., :3],
                    v=u_mid[..., :3],
                    q=quat.integrate_quat(states.q, u_mid[..., 3:], 0.5 * dt),
                    w=u_mid[..., 3:])
        sys = build_constraints(spec, mid, cs, cfg)
        Minv = scn.inv_mass_blocks(spec, mid)
        F = scn.external_forces(spec, mid, cfg.gravity)
        if ext is not None:
            F = F + ext
        MinvF = torch.einsum("bnij,bnj->bni", Minv, F)
        rhs = -cfg.erp / dt / dt * sys.err - torch.einsum("bmnk,bnk->bm", sys.J,
                                                          u_mid / dt + MinvF)
        A = system_matrix(spec, mid, sys, cfg)
        lam = _solve_lambda(A, rhs, sys, cfg)
        JTlam = torch.einsum("bmnk,bm->bnk", sys.J, lam)
        vdot = torch.einsum("bnij,bnj->bni", Minv, F + JTlam)
        u_mid = 0.5 * (u0 + (u0 + dt * vdot))
    u_new = 2.0 * u_mid - u0
    nxt = State(p=states.p + dt * u_mid[..., :3], v=u_new[..., :3],
                q=quat.integrate_quat(states.q, u_mid[..., 3:], dt), w=u_new[..., 3:])
    return _first(nxt), _first(cs)


def _joint_jdotv(spec: SceneSpec, state: State) -> torch.Tensor:
    """J-dot v of the ball joints, (..., 3 Jn): w0 x (w0 x R0 c0) minus
    w1 x (w1 x R1 c1) (nothing for a joint to the world)."""
    lead = state.p.shape[:-2]
    if spec.num_joints == 0:
        return state.p.new_zeros(lead + (0,))
    R = state.R()
    jb1 = spec.joint_b1
    anchored = jb1 < 0
    sb1 = torch.where(anchored, 0, jb1)
    r0c0 = torch.einsum("...jik,jk->...ji", R[..., spec.joint_b0, :, :], spec.joint_c0)
    r1c1 = torch.einsum("...jik,jk->...ji", R[..., sb1, :, :], spec.joint_c1)
    w0 = state.w[..., spec.joint_b0, :]
    zero = torch.zeros((), dtype=state.w.dtype, device=state.w.device)
    w1 = torch.where(anchored[:, None], zero, state.w[..., sb1, :])
    term0 = torch.linalg.cross(w0, torch.linalg.cross(w0, r0c0, dim=-1), dim=-1)
    term1 = torch.where(anchored[:, None], zero,
                        -torch.linalg.cross(w1, torch.linalg.cross(w1, r1c1, dim=-1), dim=-1))
    return (term0 + term1).reshape(lead + (-1,))


def _empty_contacts(states: State, K: int) -> ContactSet:
    B = states.p.shape[0]
    dtype, device = states.p.dtype, states.p.device
    idle = torch.full((B, K), -1, dtype=torch.int64, device=device)
    return ContactSet(b0=idle, b1=idle.clone(), position=torch.zeros((B, K, 3), dtype=dtype,
                                                                    device=device),
                      normal=torch.zeros((B, K, 3), dtype=dtype, device=device),
                      depth=torch.zeros((B, K), dtype=dtype, device=device),
                      active=torch.zeros((B, K), dtype=torch.bool, device=device))


def step_explicit_euler(spec: SceneSpec, state: State, cfg: SimConfig) -> State:
    """Equality-only explicit Euler of one scene: the joints only, every
    contact lane idle; the equality system A lambda = -J M^-1 F - Jdot v
    solved densely (`torch.linalg.solve`), then u_new = u + dt v_dot and
    the positions advanced with the OLD velocity."""
    dt = cfg.dt
    states = _one(state)
    K = cfg.contact_capacity
    sys = build_constraints(spec, states, _empty_contacts(states, K), cfg)
    u = scn.pack_velocity(states)
    Minv = scn.inv_mass_blocks(spec, states)
    F = scn.external_forces(spec, states, cfg.gravity)
    MinvF = torch.einsum("bnij,bnj->bni", Minv, F)
    jdotv = torch.cat([_joint_jdotv(spec, states), u.new_zeros((1, 3 * K))], dim=-1)
    rhs = -torch.einsum("bmnk,bnk->bm", sys.J, MinvF) - jdotv
    A = system_matrix(spec, states, sys, cfg)
    lam = torch.linalg.solve(A, rhs[..., None])[..., 0]
    vdot = torch.einsum("bnij,bnj->bni", Minv, F + torch.einsum("bmnk,bm->bnk", sys.J, lam))
    u_new = u + dt * vdot
    nxt = State(p=states.p + dt * u[..., :3], v=u_new[..., :3],
                q=quat.integrate_quat(states.q, u[..., 3:], dt), w=u_new[..., 3:])
    return _first(nxt)


def position_constraint_error(spec: SceneSpec, state: State, cfg: SimConfig,
                              cs: ContactSet = None) -> torch.Tensor:
    """Stacked joint and contact position errors of one scene, (m,); the
    contacts detected at `state` unless `cs` (K lanes) is given."""
    states = _one(state)
    csb = make_contacts_batched(spec, states, cfg) if cs is None else _one(cs)
    return build_constraints(spec, states, csb, cfg).err[0]


def _velocity_relaxation(spec: SceneSpec, state: State, sys: ConstraintSystem, scale):
    """vc = -scale J^T (J J^T + T)^-1 err, (..., n, 6), with the Tikhonov
    term T = 1e-10 on active rows and 1 on idle ones (redundant contacts
    make J J^T singular); static bodies get no correction."""
    lead = sys.err.shape[:-1]
    Jf = sys.J.reshape(lead + (sys.num_rows, -1))
    one = torch.ones((), dtype=Jf.dtype, device=Jf.device)
    JJt = Jf @ Jf.transpose(-1, -2) + torch.diag_embed(
        torch.where(sys.row_active, 1e-10 * one, one))
    lam = torch.linalg.solve(JJt, sys.err[..., None])
    vc = (-scale * (Jf.transpose(-1, -2) @ lam))[..., 0].reshape(lead + (spec.num_bodies, 6))
    return torch.where((spec.inv_mass > 0)[:, None], vc, torch.zeros((), dtype=vc.dtype,
                                                                      device=vc.device))


def _advance_positions(state: State, vc: torch.Tensor, dt) -> State:
    """Positions and orientations advanced dt with the correction field vc."""
    return state._replace(p=state.p + dt * vc[..., :3],
                          q=quat.integrate_quat(state.q, vc[..., 3:], dt))


STABILIZE_TOL = 1e-9


def _stabilize(spec, state, cfg, max_steps, dt, correct_velocity, return_iterations):
    """The stabilizers' loop: while err^2 > STABILIZE_TOL and fewer than
    `max_steps` iterations, relax the positions (scale 0.2) by dt, and the
    velocities too with `correct_velocity`.  The JAX package's
    `while_loop` condition is read on the host, one sync an iteration.  The
    contacts are detected once a state: the error of a state and its
    relaxation share them (the JAX package detects the same contacts twice)."""
    st = _one(state)
    i = 0
    while True:
        sys = build_constraints(spec, st, make_contacts_batched(spec, st, cfg), cfg)
        e = sys.err[0]
        if not (float(e @ e) > STABILIZE_TOL and i < max_steps):
            break
        vc = _velocity_relaxation(spec, st, sys, 0.2)
        st = _advance_positions(st, vc, dt)
        if correct_velocity:
            st = scn.unpack_velocity(st, scn.pack_velocity(st) + vc)
        i += 1
    return (_first(st), i) if return_iterations else _first(st)


def init_stabilize(spec: SceneSpec, state: State, cfg: SimConfig, max_steps: int = 100,
                   return_iterations: bool = False):
    """Pre-run position relaxation of one scene: up to `max_steps` steps of
    dt = 500 cfg.dt, contacts re-detected each iteration, until
    err^2 <= 1e-9.  With `return_iterations`, (state, iterations)."""
    return _stabilize(spec, state, cfg, max_steps, cfg.dt * 500, False, return_iterations)


def post_stabilize(spec: SceneSpec, state: State, cfg: SimConfig, max_steps: int = 500,
                   return_iterations: bool = False):
    """Post-step stabilization of one scene: the relaxation applied to the
    positions (dt = 100 cfg.dt) and added to the velocities, contacts
    re-detected each iteration, until err^2 <= 1e-9.  With
    `return_iterations`, (state, iterations)."""
    return _stabilize(spec, state, cfg, max_steps, cfg.dt * 100, True, return_iterations)


def step_diagnostics(spec: SceneSpec, state: State, cfg: SimConfig, ext_force=None) -> dict:
    """One step's metrics of one scene without advancing it: contact count,
    dropped contacts, max penetration, constraint-error norm, the solve's
    complementarity residual (`ops.lcp.residual_error`), kinetic energy
    and max impulse; under DIRECT also `mixed_constraints_solver`'s
    converged, iterations, goodness and fallback_used.  Every value a
    0-dim tensor."""
    check_single_scene(cfg)
    states = _one(state)
    ext = None if ext_force is None else _batched_ext(ext_force, states)
    cs, sys, A, rhs, u, Minv, F = _pre_solve(spec, states, cfg, ext)
    info = None
    if cfg.solver == SolverKind.DIRECT:
        lam, _, info = lcp_direct.mixed_constraints_solver(A, rhs, sys.is_eq, sys.lo, sys.hi,
                                                           return_info=True)
    else:
        lam = _solve_lambda(A, rhs, sys, cfg)
    residual = lcp.residual_error(A, rhs, lam, sys.is_eq, sys.lo, sys.hi)[0]
    im = spec.inv_mass
    mass = torch.where(im > 0, 1.0 / torch.where(im > 0, im, torch.ones_like(im)),
                       torch.zeros_like(im))
    R = state.R()
    Ig = R @ spec.inertia_body @ R.transpose(-1, -2)
    ke = 0.5 * torch.sum(mass[:, None] * state.v ** 2) + 0.5 * torch.sum(
        state.w * torch.einsum("nij,nj->ni", Ig, state.w))
    zero = torch.zeros((), dtype=cs.depth.dtype, device=cs.depth.device)
    out = {
        "num_contacts": cs.active[0].sum(),
        "dropped_contacts": count_dropped_contacts(spec, states, cfg)[0],
        "max_penetration": torch.amax(torch.where(cs.active[0], cs.depth[0], zero)),
        "constraint_error_norm": torch.linalg.vector_norm(sys.err[0]),
        "solver_residual": residual,
        "kinetic_energy": ke,
        "max_impulse": torch.amax(lam[0].abs()),
    }
    if info is not None:
        out.update(solver_converged=info.converged[0], solver_iterations=info.iterations[0],
                   solver_goodness=info.goodness[0], solver_fallback_used=info.fallback_used[0])
    return out
