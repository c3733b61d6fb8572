"""Port parity: the rest of the single-scene stepper of `eggshell_tpu_torch`
against the JAX package's, float64 on the CPU, within 1e-8:

- `position_constraint_error`, `_velocity_relaxation` and
  `_advance_positions` on a perturbed chain and a sunk box stack;
- `init_stabilize` and `post_stabilize` on the perturbed chains of
  tests/test_physics.py:159-176 and on the sunk stack: the same iteration
  count (the JAX package's loop body replayed eagerly) and the same state;
- `_joint_jdotv` and `step_explicit_euler` on a spinning chain;
- `step_implicit_midpoint` on a jittered box_stack(3) under PGS, JACOBI
  and DIRECT, with and without `ext_force`, and one gradient under JACOBI
  against `jax.grad`;
- `step_diagnostics` under PGS and DIRECT, every key.

Each JAX function is called as the JAX package jits it; the JAX side of
the narrowphase is its XLA path (`contact_kernel=False`).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eggshell_tpu.physics import constraints as jcon
from eggshell_tpu.physics import contacts as jcont
from eggshell_tpu.physics import scenes as js
from eggshell_tpu.physics import stepper as jstep
from eggshell_tpu.utils.config import SimConfig as JaxSimConfig
from eggshell_tpu.utils.config import SolverKind as JaxSolverKind
from eggshell_tpu_torch import convert
from eggshell_tpu_torch.physics import constraints as tcon
from eggshell_tpu_torch.physics import contacts as tcont
from eggshell_tpu_torch.physics import stepper as tstep
from eggshell_tpu_torch.physics.scene import State
from eggshell_tpu_torch.utils.config import SimConfig, SolverKind
from torch_limits import time_limit  # noqa: F401

TOL = 1e-8
BASE = dict(contact_kernel=False, contact_capacity=16, solver_iters=10)


def _cfgs(solver, **kw):
    """(JAX config, port config) with the same fields."""
    fields = dict(BASE, **kw)
    return (JaxSimConfig(solver=getattr(JaxSolverKind, solver), **fields),
            SimConfig(solver=getattr(SolverKind, solver), **fields))


def _np(nt):
    return {k: np.asarray(v) for k, v in nt._asdict().items()}


def _port(spec, state):
    return (convert.spec_from_numpy(_np(spec), device="cpu", dtype=torch.float64),
            convert.state_from_numpy(_np(state), device="cpu", dtype=torch.float64))


def _close(want, got, tol=TOL, what=""):
    want = np.asarray(want, dtype=np.float64)
    got = got.detach().double().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    scale = max(1.0, float(np.abs(want).max(initial=0.0)))
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale, err_msg=what)


def _close_state(want, got, tol=TOL):
    for k in "pvqw":
        _close(getattr(want, k), getattr(got, k), tol, k)


SCENES = {
    # tests/test_physics.py:159-176: a joint pulled 0.05 m apart, one 0.02 m
    "chain_init": lambda: _shifted(js.chain(4), 2, 1, 0.05),
    "chain_post": lambda: _shifted(js.chain(4), 1, 2, 0.02),
    "stack_sunk": lambda: _shifted(js.box_stack(2), 1, 2, -0.004),
}


def _shifted(scene, body, axis, by):
    spec, state = scene
    return spec, state._replace(p=state.p.at[body, axis].add(by))


@functools.partial(jax.jit, static_argnames=("cfg",))
def _jax_relax(spec, state, cfg):
    """The JAX package's contacts, constraints and relaxation at `state`."""
    cs = jcont.make_contacts(spec, state, cfg)
    sys = jcon.build_constraints(spec, state, cs, cfg)
    return cs, sys.err, jstep._velocity_relaxation(spec, state, sys, 0.2)


_jax_position_error = jax.jit(jstep.position_constraint_error, static_argnames=("cfg",))
_jax_advance = jax.jit(jstep._advance_positions)


def _jax_stabilize_count(spec, state, cfg, dt, correct_velocity, max_steps):
    """The JAX package's stabilizer loop replayed from the host, one
    relaxation a state: its iteration count."""
    i = 0
    while True:
        _, e, vc = _jax_relax(spec, state, cfg)
        if not (float(e @ e) > 1e-9 and i < max_steps):
            return i
        state = _jax_advance(state, vc, dt)
        if correct_velocity:
            state = state._replace(v=state.v + vc[:, :3], w=state.w + vc[:, 3:])
        i += 1


@pytest.mark.parametrize("scene", sorted(SCENES))
def test_position_error_and_relaxation(scene):
    jcfg, tcfg = _cfgs("DIRECT")
    spec, state = SCENES[scene]()
    tspec, tstate = _port(spec, state)
    _close(_jax_position_error(spec, state, jcfg),
           tstep.position_constraint_error(tspec, tstate, tcfg), what="err")
    # the error of given contacts: the JAX package's build_constraints(cs).err
    _, err, vc = _jax_relax(spec, state, jcfg)
    tcs = tcont.make_contacts(tspec, tstate, tcfg)
    _close(err, tstep.position_constraint_error(tspec, tstate, tcfg, tcs), what="err, given cs")
    tsys = tcon.build_constraints(tspec, State(*(x[None] for x in tstate)),
                                  tcont.ContactSet(*(x[None] for x in tcs)), tcfg)
    tvc = tstep._velocity_relaxation(tspec, tstate, tcon.ConstraintSystem(*(x[0] for x in tsys)),
                                     0.2)
    _close(vc, tvc, what="vc")
    if scene == "stack_sunk":
        # the static ground-free stack has no static body; the mask is held
        # on a box made static
        smask = tspec._replace(inv_mass=torch.tensor([0.0, 1.0], dtype=torch.float64))
        assert float(tstep._velocity_relaxation(smask, tstate, tcon.ConstraintSystem(
            *(x[0] for x in tsys)), 0.2)[0].abs().max()) == 0.0
    _close_state(_jax_advance(state, vc, jcfg.dt * 500),
                 tstep._advance_positions(tstate, tvc, tcfg.dt * 500))


@pytest.mark.parametrize("which,scene", [("init", "chain_init"), ("post", "chain_post"),
                                         ("init", "stack_sunk")])
def test_stabilizers(which, scene):
    jcfg, tcfg = _cfgs("DIRECT")
    spec, state = SCENES[scene]()
    tspec, tstate = _port(spec, state)
    max_steps = 100 if which == "init" else 500
    jfn = jstep.init_stabilize if which == "init" else jstep.post_stabilize
    tfn = tstep.init_stabilize if which == "init" else tstep.post_stabilize
    want = jfn(spec, state, jcfg, max_steps=max_steps)
    got, iters = tfn(tspec, tstate, tcfg, max_steps=max_steps, return_iterations=True)
    assert iters == _jax_stabilize_count(spec, state, jcfg,
                                         jcfg.dt * (500 if which == "init" else 100),
                                         which == "post", max_steps)
    assert 0 < iters < max_steps
    _close_state(want, got)
    e = tstep.position_constraint_error(tspec, got, tcfg)
    assert float(e @ e) <= 1e-9


def _spinning_chain():
    spec, state = js.chain(4)
    w = jnp.asarray(np.random.default_rng(0).normal(size=(4, 3)))
    return spec, state._replace(w=w, v=0.1 * w)


def test_joint_jdotv_and_explicit_euler():
    jcfg, tcfg = _cfgs("DIRECT")
    spec, state = _spinning_chain()
    tspec, tstate = _port(spec, state)
    _close(jstep._joint_jdotv(spec, state), tstep._joint_jdotv(tspec, tstate), what="jdotv")
    st, tst = state, tstate
    for _ in range(3):
        st = jstep.step_explicit_euler(spec, st, jcfg)
        tst = tstep.step_explicit_euler(tspec, tst, tcfg)
        _close_state(st, tst)


def _stack3():
    spec, state = js.box_stack(3)
    jit = jnp.asarray(np.random.default_rng(1).normal(scale=1e-3, size=(3, 3)))
    return spec, state._replace(p=state.p + jit)


def _ext(n):
    return jnp.asarray(np.random.default_rng(2).normal(scale=0.5, size=(n, 6)))


@pytest.mark.parametrize("solver", ["PGS", "JACOBI", "DIRECT"])
def test_implicit_midpoint(solver):
    jcfg, tcfg = _cfgs(solver, conditional_cfm=False, cfm_always=1e-3)
    spec, state = _stack3()
    tspec, tstate = _port(spec, state)
    ext = _ext(spec.num_bodies)
    text = torch.tensor(np.asarray(ext))
    st, tst = state, tstate
    for k in range(2):
        # the port without ext_force against the JAX package with zero wrenches
        # (the same sums; one compiled program a solver)
        e, te = (jnp.zeros_like(ext), None) if k == 0 else (ext, text)
        st, cs = jstep.step_implicit_midpoint(spec, st, jcfg, e, fixed_point_iters=3)
        tst, tcs = tstep.step_implicit_midpoint(tspec, tst, tcfg, te, fixed_point_iters=3)
        _close_state(st, tst)
        assert np.array_equal(np.asarray(cs.active), tcs.active.numpy())
        _close(cs.position, tcs.position, what="contacts")


def test_implicit_midpoint_refuses_jacobi_kernel():
    _, tcfg = _cfgs("JACOBI_KERNEL")
    spec, state = _stack3()
    tspec, tstate = _port(spec, state)
    with pytest.raises(ValueError, match="JACOBI_KERNEL"):
        tstep.step_implicit_midpoint(tspec, tstate, tcfg)


def test_implicit_midpoint_gradient():
    """d(sum of z after one step)/d(ext_force, v) under JACOBI against jax.grad."""
    jcfg, tcfg = _cfgs("JACOBI", conditional_cfm=False, cfm_always=1e-3)
    spec, state = _stack3()
    tspec, tstate = _port(spec, state)
    ext = _ext(spec.num_bodies)

    def jloss(e, v):
        nxt, _ = jstep.step_implicit_midpoint(spec, state._replace(v=v), jcfg, e,
                                              fixed_point_iters=2)
        return jnp.sum(nxt.p[:, 2]) + jnp.sum(nxt.w ** 2)

    want = jax.grad(jloss, argnums=(0, 1))(ext, state.v)
    te = torch.tensor(np.asarray(ext), requires_grad=True)
    tv = tstate.v.clone().requires_grad_(True)
    nxt, _ = tstep.step_implicit_midpoint(tspec, tstate._replace(v=tv), tcfg, te,
                                          fixed_point_iters=2)
    (torch.sum(nxt.p[:, 2]) + torch.sum(nxt.w ** 2)).backward()
    for w, g in zip(want, (te.grad, tv.grad)):
        _close(w, g)


@functools.lru_cache(maxsize=None)
def _diag_case(solver):
    jcfg, tcfg = _cfgs(solver, conditional_cfm=False, cfm_always=1e-3)
    spec, state = _stack3()
    state = state._replace(v=state.v.at[:, 0].add(0.05), w=state.w.at[:, 2].add(0.3))
    return jcfg, tcfg, spec, state


@pytest.mark.parametrize("solver", ["PGS", "DIRECT"])
def test_step_diagnostics(solver):
    jcfg, tcfg, spec, state = _diag_case(solver)
    tspec, tstate = _port(spec, state)
    ext = _ext(spec.num_bodies)
    want = jstep.step_diagnostics(spec, state, jcfg, ext)
    got = tstep.step_diagnostics(tspec, tstate, tcfg, torch.tensor(np.asarray(ext)))
    assert sorted(got) == sorted(want)
    if solver == "DIRECT":
        assert {"solver_converged", "solver_iterations", "solver_goodness",
                "solver_fallback_used"} <= set(got)
    for k in want:
        w = np.asarray(want[k])
        if w.dtype == np.bool_ or np.issubdtype(w.dtype, np.integer):
            assert int(got[k]) == int(w), k
        else:
            _close(w, got[k], what=k)


def test_physics_exports_match():
    """`eggshell_tpu_torch.physics` exports what `eggshell_tpu.physics` does."""
    import types

    import eggshell_tpu.physics as jphys
    import eggshell_tpu_torch.physics as tphys

    names = [k for k, v in vars(jphys).items()
             if not k.startswith("_") and not isinstance(v, types.ModuleType)]
    assert names and all(hasattr(tphys, k) for k in names), names
