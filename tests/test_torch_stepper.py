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
- every configuration the JAX package sends down another branch raises.
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
    "fused_chain_block": dict(conditional_cfm=False, jacobi_block=True),
    "fused_chain_pyramid": dict(conditional_cfm=False,
                                friction_model=FrictionModel.COULOMB_PYRAMID),
    "pyramid_unfused": dict(friction_model=FrictionModel.COULOMB_PYRAMID),
    "no_friction": dict(friction_model=FrictionModel.NO_FRICTION),
    "matrix_free": dict(solver=SolverKind.MATRIX_FREE),
    "direct": dict(solver=SolverKind.DIRECT),
    "pgs": dict(solver=SolverKind.PGS),
    "sor": dict(solver=SolverKind.SOR),
    "jacobi_xla": dict(solver=SolverKind.JACOBI),
    "broadphase": dict(pair_capacity=4),
    "joints": {},
}


@pytest.mark.parametrize("name", sorted(UNSUPPORTED))
def test_unported_branch_raises(name):
    if name == "joints":
        spec, st = make_scene([[0, 0, 1.0], [0.5, 0, 1.0]],
                              joints=[(0, 1, [0.25, 0, 0], [-0.25, 0, 0])],
                              device="cpu", dtype=torch.float64)
    else:
        spec, st = ts.box_stack(2, device="cpu", dtype=torch.float64)
    states = State(*[x[None] for x in st])
    cfg = SimConfig(**{**SLICE, **UNSUPPORTED[name]})
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        rollout_batched(spec, states, cfg, 1)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tstep.step_ode_batched(spec, states, cfg)
