"""Port parity: the stepper and the rollout of `eggshell_tpu_torch`
against the JAX package, and the port's oracle gate.

- `system_matrix` with both CFM estimators, on the 4-box stack (CFM is
  applied: its redundant contacts make A ill-conditioned) and on a box in
  the air (no contacts: A is the identity, no CFM), float64, within 1e-9;
- the slice: 30 steps of `rollout_batched` at B=8 in float64 against the
  JAX package's with the XLA narrowphase (`contact_kernel=False`; its
  tests hold that equal to the Pallas kernel), within 1e-8;
- the f32 oracle gate of bench.py on the CPU: the DIRECT/f64 trajectory
  in tests/data/oracle_stack4_f64.npz within 1e-3 at every checkpoint;
- every other configuration of `step_ode_batched` against the JAX
  package's, B=4, 6 steps, float64, within 1e-8: the default `SimConfig()`
  (PGS), SOR, the XLA Jacobi, NO_FRICTION, INFINITE, COULOMB_PYRAMID and
  `jacobi_block` on the unfused branch, ball joints there, the broadphase
  there (pair_capacity 2 of a 3-stack's 3 pairs), the matrix-free step,
  and the fused chain with block-Jacobi or COULOMB_PYRAMID (against the
  JAX package's XLA twin of that step, the same configuration with
  SolverKind.JACOBI);
- DIRECT, no longer refused: `rollout_batched` and `step_ode_batched`
  step it (tests/test_torch_direct.py holds it to the JAX package).
"""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eggshell_tpu.parallel.rollout import rollout_batched as jax_rollout_batched
from eggshell_tpu.physics import constraints as jcon
from eggshell_tpu.physics import scene as jscene
from eggshell_tpu.physics import contacts as jcont
from eggshell_tpu.physics import scenes as js
from eggshell_tpu.physics import stepper as jstep
from eggshell_tpu.utils.config import SimConfig as JaxSimConfig
from eggshell_tpu_torch import convert
from eggshell_tpu_torch.parallel.rollout import rollout_batched
from eggshell_tpu_torch.physics import constraints as tcon
from eggshell_tpu_torch.physics import contacts as tcont
from eggshell_tpu_torch.physics import scenes as ts
from eggshell_tpu_torch.physics import stepper as tstep
from eggshell_tpu_torch.physics.scene import State, make_scene
from eggshell_tpu_torch.utils.config import FrictionModel, SimConfig, SolverKind
from torch_limits import time_limit  # noqa: F401

ORACLE = os.path.join(os.path.dirname(__file__), "data", "oracle_stack4_f64.npz")

SLICE = dict(solver=SolverKind.JACOBI_KERNEL, solver_iters=16, jacobi_omega=0.3,
             jacobi_beta=0.45, conditional_cfm=True, cond_estimator="power",
             contact_capacity=20, contact_kernel=True)


def _np(nt):
    return {k: np.asarray(v) for k, v in nt._asdict().items()}


def _batch(spec, st, B, jitter):
    states = jax.tree_util.tree_map(lambda x: jnp.broadcast_to(x, (B,) + x.shape), st)
    states = states._replace(p=states.p + jnp.linspace(0, jitter, B)[:, None, None])
    tspec = convert.spec_from_numpy(_np(spec), device="cpu", dtype=torch.float64)
    tstates = convert.state_from_numpy(_np(states), device="cpu", dtype=torch.float64)
    return (spec, states), (tspec, tstates)


SYSTEM_CASES = {
    "box_stack4": (lambda: js.box_stack(4), 20, True),
    "box_drop_in_air": (lambda: js.box_drop(height=0.5), 8, False),
}


@functools.lru_cache(maxsize=None)
def _jax_system_matrices(case):
    """JAX A of one scene under both estimators, in one compiled program."""
    build, K, _ = SYSTEM_CASES[case]
    (spec, states), _ = _batch(*build(), 4, 1e-3)

    def jax_A(sts):
        out = {}
        for estimator in ("power", "exact"):
            jcfg = JaxSimConfig(contact_capacity=K, conditional_cfm=True,
                                cond_estimator=estimator)
            css = jcont.make_contacts_batched(spec, sts, jcfg, use_kernel=False)
            out[estimator] = jax.vmap(lambda st, cs: jstep.system_matrix(
                spec, st, jcon.build_constraints(spec, st, cs, jcfg), jcfg))(sts, css)
        return out

    return {k: np.asarray(v) for k, v in jax.jit(jax_A)(states).items()}


@pytest.mark.parametrize("estimator", ["power", "exact"])
@pytest.mark.parametrize("case", sorted(SYSTEM_CASES))
def test_system_matrix_matches_jax(case, estimator):
    build, K, cfm_applied = SYSTEM_CASES[case]
    _, (tspec, tstates) = _batch(*build(), 4, 1e-3)
    tcfg = SimConfig(contact_capacity=K, conditional_cfm=True, cond_estimator=estimator)
    want = _jax_system_matrices(case)[estimator]
    sys_ = tcon.build_constraints(tspec, tstates,
                                  tcont.make_contacts_batched(tspec, tstates, tcfg), tcfg)
    got = tstep.system_matrix(tspec, tstates, sys_, tcfg).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-9)

    # the CFM decision: A minus the same matrix without CFM
    plain = tstep.system_matrix(tspec, tstates, sys_,
                                tcfg.replace(conditional_cfm=False, cfm_always=0.0)).numpy()
    added = np.diagonal(got - plain, axis1=1, axis2=2)
    active = sys_.row_active.numpy()
    expect = tcfg.cfm if cfm_applied else 0.0
    np.testing.assert_allclose(added[active], expect, atol=1e-12)
    np.testing.assert_allclose(added[~active], 0.0, atol=1e-12)
    assert active.any() == cfm_applied


def test_slice_rollout_matches_jax():
    (spec, states), (tspec, tstates) = _batch(*js.box_stack(4), 8, 1e-3)
    jcfg = JaxSimConfig(**{**SLICE, "contact_kernel": False})
    want = jax_rollout_batched(spec, states, jcfg, 30)
    got = rollout_batched(tspec, tstates, SimConfig(**SLICE), 30)
    for field in ("p", "v", "q", "w"):
        np.testing.assert_allclose(getattr(got, field).numpy(), np.asarray(getattr(want, field)),
                                   rtol=0, atol=1e-8, err_msg=field)
    # the stack settled without falling over (jitter lifts it by up to 1 mm)
    assert np.abs(got.p.numpy() - tstates.p.numpy()).max() < 2e-3


def test_oracle_gate_f32():
    ref = np.load(ORACLE)
    spec, st = ts.box_stack(4, device="cpu", dtype=torch.float32)
    states = State(*[x.expand((8,) + x.shape).clone() for x in st])
    cfg = SimConfig(**SLICE)
    prev = 0
    for ck in [int(s) for s in ref["steps"]]:
        states = rollout_batched(spec, states, cfg, ck - prev)
        prev = ck
        assert states.p.dtype == torch.float32
        err_p = np.abs(states.p[0].double().numpy() - ref[f"p{ck}"]).max()
        err_v = np.abs(states.v[0].double().numpy() - ref[f"v{ck}"]).max()
        assert err_p < 1e-3 and err_v < 1e-3, (ck, err_p, err_v)


UNSUPPORTED = {
    "direct": dict(solver=SolverKind.DIRECT),
}


@pytest.mark.parametrize("name", sorted(UNSUPPORTED))
def test_unported_branch_raises(name):
    """The branches this test once found refused (DIRECT until its port)
    now step: the rollout and the step give the same finite state."""
    spec, st = ts.box_stack(2, device="cpu", dtype=torch.float64)
    states = State(*[x[None] for x in st])
    cfg = SimConfig(**{**SLICE, **UNSUPPORTED[name]})
    got = rollout_batched(spec, states, cfg, 1)
    want = tstep.step_ode_batched(spec, states, cfg)
    assert all(torch.equal(g, w) and bool(torch.isfinite(g).all()) for g, w in zip(got, want))


PYRAMID = dict(friction_model=FrictionModel.COULOMB_PYRAMID, friction_mu=0.2)
SMALL = {**SLICE, "contact_capacity": 12}
FUSED = {**SMALL, "conditional_cfm": False, "cfm_always": 0.01}
PORTED = {
    # name: (scene, configuration, configuration of the JAX side or None)
    "pgs_default": ("stack", dict(contact_capacity=12), None),
    "sor": ("stack", {**SMALL, "solver": SolverKind.SOR}, None),
    "jacobi_xla": ("stack", {**SMALL, "solver": SolverKind.JACOBI}, None),
    "no_friction": ("stack", {**SMALL, "friction_model": FrictionModel.NO_FRICTION}, None),
    "infinite": ("stack", {**SMALL, "friction_model": FrictionModel.INFINITE}, None),
    "pyramid_unfused": ("sliding", {**SMALL, **PYRAMID}, None),
    "jacobi_block_unfused": ("stack", {**SMALL, "jacobi_block": True}, None),
    "joints": ("joints", {**SMALL, "min_constraint_distance": 0.25}, None),
    "broadphase": ("stack3", {**SMALL, "solver": SolverKind.JACOBI, "pair_capacity": 2}, None),
    "matrix_free": ("stack", {**SMALL, "solver": SolverKind.MATRIX_FREE}, None),
    "fused_chain_block": ("stack", {**FUSED, "jacobi_block": True},
                          {**FUSED, "jacobi_block": True, "solver": SolverKind.JACOBI}),
    "fused_chain_pyramid": ("sliding", {**FUSED, **PYRAMID},
                            {**FUSED, **PYRAMID, "solver": SolverKind.JACOBI}),
}
PORTED_STEPS = 6


def _scene(kind, make):
    """`make` is the JAX package's make_scene or the port's (with device
    and dtype bound).  "stack": box_stack(2); "sliding": the same stack
    sliding at 1.5 m/s and pressed 0.5 mm into the ground, so the tangent
    impulses reach their caps (tests/test_pgs_kernel.py:443-451); "joints":
    two boxes overlapping by 1 mm side by side, joined at their common face
    and hung from the world by the first's top, so the joint-contact dedupe
    drops their contacts (min_constraint_distance 0.25); "stack3":
    box_stack(3), whose 3 pairs the broadphase cuts to the 2 that touch."""
    if kind == "stack3":
        return make([[0.0, 0.0, 0.15], [0.0, 0.0, 0.45], [0.0, 0.0, 0.75]])
    if kind == "joints":
        return make([[0.0, 0.0, 1.0], [0.299, 0.0, 1.0]], ground=True,
                     joints=[(0, 1, [0.15, 0.0, 0.0], [-0.15, 0.0, 0.0]),
                             (0, -1, [0.0, 0.0, 0.15], [0.0, 0.0, 1.15])])
    p = [[0.0, 0.0, 0.15], [0.0, 0.0, 0.45]]
    if kind == "sliding":
        return make([[x, y, z - 5e-4] for x, y, z in p], velocities=[[1.5, 0.0, 0.0]] * 2)
    return make(p)


@functools.lru_cache(maxsize=None)
def _jax_ported(name):
    kind, cfg, jax_cfg = PORTED[name]
    spec, st = _scene(kind, jscene.make_scene)
    (spec, states), _ = _batch(spec, st, 4, 1e-3)
    jcfg = JaxSimConfig(**{**(jax_cfg or cfg), "contact_kernel": False})
    for _ in range(PORTED_STEPS):
        states = jstep.step_ode_batched(spec, states, jcfg)
    return _np(states)


@pytest.mark.parametrize("name", sorted(PORTED))
def test_ported_branch_matches_jax(name):
    kind, cfg, _ = PORTED[name]
    spec, st = _scene(kind, jscene.make_scene)
    _, (tspec, tstates) = _batch(spec, st, 4, 1e-3)
    tcfg = SimConfig(**cfg)
    got = rollout_batched(tspec, tstates, tcfg, PORTED_STEPS)
    want = _jax_ported(name)
    for field in ("p", "v", "q", "w"):
        np.testing.assert_allclose(getattr(got, field).numpy(), want[field], rtol=0, atol=1e-8,
                                   err_msg=field)
    if kind == "joints":
        a0, a1 = tcont.joint_anchors(tspec, got)
        assert float((a0 - a1).norm(dim=-1).max()) < 1e-3
        assert float(tcont.make_contacts_batched(tspec, tstates, tcfg).active.sum()) == 0
        assert int(tcont.make_contacts_batched(
            tspec, tstates, tcfg.replace(min_constraint_distance=1e-6)).active.sum()) > 0
    if kind == "sliding":
        # the pyramid binds: BOX friction (bound 1) moves the stack otherwise
        box = rollout_batched(tspec, tstates, tcfg.replace(friction_model=FrictionModel.BOX),
                              PORTED_STEPS)
        assert float((box.v - got.v).abs().max()) > 1e-6
    if name == "jacobi_block_unfused":
        # the unfused branch's kernel takes no `block`, as in the JAX package
        plain = rollout_batched(tspec, tstates, tcfg.replace(jacobi_block=False), PORTED_STEPS)
        assert all(torch.equal(g, w) for g, w in zip(got, plain))
