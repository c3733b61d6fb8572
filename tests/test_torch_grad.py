"""Port parity: gradients through the fused step and its pieces, against
the JAX package, on the CPU in float64.

- The narrowphase's backward (`ops.collision_kernel.collide_boxes_lanes_diff`)
  against `jax.grad` of the vmapped `collision.collide_boxes` on the inputs
  of tests/test_diff_kernel.py:147-187, within 1e-12.
- One fused step (`step_ode_batched` under JACOBI_KERNEL, which takes
  `stepper._FusedStepDiff` when a state or the wrench requires grad): the
  gradients of sum(p[:, -1, 2]) + sum(v^2) with respect to the wrench and
  every state field, on box_stack(2) and cairn(2, seed=4) at B = 2
  (test_diff_kernel.py:32-39's configuration), scalar, 3x3 block and
  Coulomb-pyramid sweeps, against `jax.grad` of the JAX package's
  `_step_xla_twin` adopting the same impulses (what its custom VJP's
  backward computes), within 1e-8.  The twin with impulses to adopt runs
  no sweep, so the scalar and block forms share one JAX program, the
  impulses its argument.  (tests/test_torch_grad_paths.py holds a rollout
  against the twin that solves for itself.)
- The impulses the fused step saves equal the twin's own solve within 1e-10.
- `solve_lcp_implicit` and `adopt_lcp_solution` on tests/test_lcp.py:170-213's
  problem against the JAX package's, within 1e-10.
- The rule that keeps a kernel from stopping a gradient
  (`kernels.grad_refusal`).

The solver paths and the rollout are in tests/test_torch_grad_paths.py.
The JAX side runs its XLA twin, never a Pallas kernel in interpret mode;
each JAX program is compiled once.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eggshell_tpu.ops import collision as jcoll
from eggshell_tpu.ops import lcp as jlcp
from eggshell_tpu.ops import quaternion as jquat
from eggshell_tpu.physics import scenes as js
from eggshell_tpu.physics import stepper as jstep
from eggshell_tpu.utils.config import SimConfig as JaxSimConfig
from eggshell_tpu_torch import convert, kernels
from eggshell_tpu_torch.ops import lcp
from eggshell_tpu_torch.ops.collision_kernel import collide_boxes_lanes_diff
from eggshell_tpu_torch.physics import stepper as tstep
from eggshell_tpu_torch.physics.scene import State
from eggshell_tpu_torch.utils.config import FrictionModel, SimConfig, SolverKind
from torch_limits import time_limit  # noqa: F401

B = 2
# tests/test_diff_kernel.py:32-39
DIFF = dict(conditional_cfm=False, cfm_always=1e-9, solver_iters=30, jacobi_omega=0.3,
            jacobi_beta=0.45, contact_capacity=16)
FORMS = {
    "scalar": SimConfig(solver=SolverKind.JACOBI_KERNEL, **DIFF),
    "block": SimConfig(solver=SolverKind.JACOBI_KERNEL, jacobi_block=True, **DIFF),
    "pyramid": SimConfig(solver=SolverKind.JACOBI_KERNEL, **DIFF,
                         friction_model=FrictionModel.COULOMB_PYRAMID, friction_mu=0.5),
}
CASES = [("box_stack", "scalar"), ("box_stack", "block"), ("box_stack", "pyramid"),
         ("cairn", "scalar")]


def _np(nt):
    return {k: np.asarray(v) for k, v in nt._asdict().items()}


def _jax_cfg(cfg: SimConfig) -> JaxSimConfig:
    return JaxSimConfig.from_json(cfg.to_json())


def _close(got, want, tol, what=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0, atol=tol, err_msg=what)


# ---------------------------------------------------------------------------
# the narrowphase's backward


def _narrowphase_inputs():
    """tests/test_diff_kernel.py:147-187's pairs."""
    rng = np.random.default_rng(3)
    n = 5
    p1 = rng.uniform(-0.1, 0.1, (n, 3))
    p2 = p1 + np.asarray([0.25, 0.0, 0.1]) + rng.uniform(-0.02, 0.02, (n, 3))
    q = rng.normal(size=(n, 4))
    q = q / np.linalg.norm(q, axis=-1, keepdims=True)
    R1 = np.broadcast_to(np.eye(3), (n, 3, 3)).copy()
    R2 = np.asarray(jquat.quat_to_mat(jnp.asarray(q)))
    hs = np.full((n, 3), 0.15)
    return p1, R1, hs, p2, R2, hs


@functools.lru_cache(maxsize=None)
def _jax_narrowphase_grads():
    p1, R1, hs, p2, R2, hs2 = map(jnp.asarray, _narrowphase_inputs())

    def f(p1_, R2_):
        out = jax.vmap(jcoll.collide_boxes)(p1_, R1, hs, p2, R2_, hs2)
        return (jnp.sum(jnp.where(out.active, out.depth, 0.0))
                + jnp.sum(out.position * out.normal) + jnp.sum(out.info_depth)
                + jnp.sum(out.separating_axis * p2))

    return tuple(map(np.asarray, jax.jit(jax.grad(f, argnums=(0, 1)))(p1, R2)))


def test_narrowphase_backward_matches_jax_grad():
    p1, R1, hs, p2, R2, hs2 = (torch.tensor(x) for x in _narrowphase_inputs())
    p1.requires_grad_()
    R2.requires_grad_()
    out = collide_boxes_lanes_diff(p1, R1, hs, p2, R2, hs2)
    zero = torch.zeros((), dtype=torch.float64)
    loss = (torch.sum(torch.where(out.active, out.depth, zero))
            + torch.sum(out.position * out.normal) + torch.sum(out.info_depth)
            + torch.sum(out.separating_axis * p2))
    loss.backward()
    want_p1, want_R2 = _jax_narrowphase_grads()
    assert np.abs(want_p1).max() > 0.1
    _close(p1.grad.numpy(), want_p1, 1e-12, "d/dp1")
    _close(R2.grad.numpy(), want_R2, 1e-12, "d/dR2")
    assert out.active.grad_fn is None and out.code.grad_fn is None


# ---------------------------------------------------------------------------
# one fused step


def _scene(name):
    return js.box_stack(2) if name == "box_stack" else js.cairn(2, seed=4)


def _jittered(st, seed):
    p = np.broadcast_to(np.asarray(st.p), (B,) + st.p.shape)
    p = p + 1e-4 * np.random.default_rng(seed).normal(size=p.shape)
    out = {k: np.broadcast_to(np.asarray(v), (B,) + v.shape).copy() for k, v in _np(st).items()}
    out["p"] = p
    return out


def _loss_jax(out):
    return jnp.sum(out.p[:, -1, 2]) + jnp.sum(out.v ** 2)


def _loss_torch(out):
    return torch.sum(out.p[:, -1, 2]) + torch.sum(out.v ** 2)


@functools.lru_cache(maxsize=None)
def _port_step(scene, form):
    """The port's fused step with the wrench and every state field
    requiring grad: (gradients, saved impulses, inputs)."""
    spec, st = _scene(scene)
    tspec = convert.spec_from_numpy(_np(spec), device="cpu", dtype=torch.float64)
    states = State(*(torch.tensor(v).requires_grad_() for v in
                     (_jittered(st, 0)[k] for k in State._fields)))
    ext = torch.zeros((B, tspec.num_bodies, 6), dtype=torch.float64, requires_grad=True)
    cfg = FORMS[form]
    _, lam = tstep._fused_step(tspec, State(*(x.detach() for x in states)), cfg, None,
                               return_lam=True)
    out = tstep.step_ode_batched(tspec, states, cfg, ext)
    assert out.p.grad_fn is not None and "FusedStepDiff" in type(out.p.grad_fn).__name__
    _loss_torch(out).backward()
    grads = {"ext": ext.grad.numpy(), **{k: getattr(states, k).grad.numpy() for k in "pvqw"}}
    return grads, lam.numpy(), tspec, State(*(x.detach() for x in states))


@functools.lru_cache(maxsize=None)
def _jax_twin_grad(scene, friction_model):
    """jax.grad of the JAX package's twin adopting impulses (an argument),
    jitted once a scene and friction model: with impulses to adopt the twin
    reads no sweep parameter."""
    spec, _ = _scene(scene)
    cfg = _jax_cfg(SimConfig(solver=SolverKind.JACOBI_KERNEL, friction_model=friction_model,
                             friction_mu=0.5, **DIFF))

    def f(e, s, lam):
        return _loss_jax(jstep._step_xla_twin(spec, s, cfg, e, lam_saved=lam))

    return jax.jit(jax.grad(f, argnums=(0, 1)))


def _jax_step_grads(scene, form):
    spec, st = _scene(scene)
    states = type(st)(**{k: jnp.asarray(v) for k, v in _jittered(st, 0).items()})
    ext = jnp.zeros((B, spec.num_bodies, 6))
    grad = _jax_twin_grad(scene, FORMS[form].friction_model)
    ge, gs = grad(ext, states, jnp.asarray(_port_step(scene, form)[1]))
    return {"ext": np.asarray(ge), **{k: np.asarray(getattr(gs, k)) for k in "pvqw"}}


@pytest.mark.parametrize("scene,form", CASES)
def test_fused_step_gradient_matches_jax_twin(scene, form):
    got = _port_step(scene, form)[0]
    want = _jax_step_grads(scene, form)
    assert np.abs(want["p"]).max() > 0.1 and np.abs(want["ext"]).max() > 0
    for k in ("ext", "p", "v", "q", "w"):
        _close(got[k], want[k], 1e-8, f"d/d{k}")


@pytest.mark.parametrize("scene,form", CASES)
def test_saved_impulses_are_the_twins_own_solve(scene, form):
    _, lam, tspec, states = _port_step(scene, form)
    cfg = FORMS[form]
    _, sys, A, rhs, *_ = tstep._pre_solve(tspec, states, cfg)
    assert lam.shape == tuple(rhs.shape)
    couple = sys.couple if form == "pyramid" else None
    want = lcp.solve_lcp(A, rhs, sys.is_eq, sys.lo, sys.hi, iters=cfg.solver_iters,
                         method="jacobi", jacobi_omega=cfg.jacobi_omega,
                         jacobi_beta=cfg.jacobi_beta, jacobi_block=cfg.jacobi_block,
                         couple=couple, mu=cfg.friction_mu if couple is not None else 0.0)
    if scene == "box_stack":                     # cairn(2, seed=4) starts apart
        assert np.abs(lam).max() > 1e-3
    _close(lam, want.numpy(), 1e-10, "lambda")


def test_a_spec_tensor_that_requires_grad_raises():
    _, _, tspec, states = _port_step("box_stack", "scalar")
    spec = tspec._replace(inv_mass=tspec.inv_mass.clone().requires_grad_())
    with pytest.raises(ValueError, match="SceneSpec"):
        tstep.step_ode_batched(spec, states, FORMS["scalar"])


# ---------------------------------------------------------------------------
# the IFT pieces on tests/test_lcp.py:170-213's problem


def _ift_problem(scale):
    """The problem, its rhs times `scale` (40 pushes rows onto their bounds)."""
    rng = np.random.default_rng(7)
    n = 12
    m = rng.uniform(-1, 1, (n, n))
    A = m @ m.T + n * np.eye(n)
    b = scale * rng.uniform(-1, 1, n)
    is_eq = rng.uniform(size=n) < 0.3
    lo = np.where(is_eq, 0.0, -0.5)
    hi = np.where(is_eq, 0.0, 0.8)
    return A, b, is_eq, lo, hi


@functools.lru_cache(maxsize=None)
def _jax_ift(scale):
    A, b, is_eq, lo, hi = map(jnp.asarray, _ift_problem(scale))

    def implicit(A_, b_, lo_, hi_):
        return jnp.sum(jlcp.solve_lcp_implicit(A_, b_, is_eq, lo_, hi_, 400, "pgs") ** 3)

    x = jlcp.solve_lcp(A, b, is_eq, lo, hi, iters=400)

    def adopt(A_, b_, lo_, hi_):
        return jnp.sum(jlcp.adopt_lcp_solution(A_, b_, is_eq, lo_, hi_, x) ** 3)

    grads = [jax.jit(jax.grad(f, argnums=(0, 1, 2, 3)))(A, b, lo, hi) for f in (implicit, adopt)]
    return np.asarray(x), [tuple(map(np.asarray, g)) for g in grads]


@pytest.mark.parametrize("scale", [1.0, 40.0])
def test_implicit_solve_and_adoption_match_jax(scale):
    x_jax, (g_implicit, g_adopt) = _jax_ift(scale)
    A, b, is_eq, lo, hi = (torch.tensor(v)[None] for v in _ift_problem(scale))
    xt = torch.tensor(x_jax)
    clamped = ~is_eq & ((xt >= hi - 1e-8) | (xt <= lo + 1e-8))
    assert bool(clamped.any()) == (scale > 1)
    for name, want in (("implicit", g_implicit), ("adopt", g_adopt)):
        args = [t.clone().requires_grad_() for t in (A, b, lo, hi)]
        if name == "implicit":
            x = lcp.solve_lcp_implicit(args[0], args[1], is_eq, args[2], args[3], 400, "pgs")
        else:
            xs = torch.tensor(x_jax)[None].requires_grad_()
            x = lcp.adopt_lcp_solution(args[0], args[1], is_eq, args[2], args[3], xs)
        _close(x[0].detach().numpy(), x_jax, 1e-10, f"{name} x")
        torch.sum(x ** 3).backward()
        for t, w, what in zip(args, want, ("A", "b", "lo", "hi")):
            _close(t.grad[0].numpy(), w, 1e-10, f"{name} d/d{what}")
        if name == "adopt":
            assert torch.equal(xs.grad, torch.zeros_like(xs))


# ---------------------------------------------------------------------------
# the rule that keeps a kernel from stopping a gradient


def test_a_kernel_refuses_a_tensor_that_requires_grad():
    x = torch.zeros(3)
    xg = torch.zeros(3, requires_grad=True)
    assert kernels.grad_refusal("eggshell_prep_f32", (x, 1, None), True) is None
    assert kernels.grad_refusal("eggshell_prep_f32", (xg * 2, 1), False) is None
    msg = kernels.grad_refusal("eggshell_prep_f32", (x, xg * 2, None, 3), True)
    assert "prep" in msg and "step_ode_batched" in msg
    msg = kernels.grad_refusal("eggshell_narrowphase_f32", (xg,), True)
    assert "narrowphase" in msg and "collide_boxes_lanes_diff" in msg
    msg = kernels.grad_refusal("eggshell_jacobi_f32", (xg,), True)
    assert "no backward" in msg
    for fn_name in kernels._SIGNATURES:
        if fn_name not in ("eggshell_cuda_error_string", "eggshell_integrate_plan"):
            assert kernels.grad_refusal(fn_name, (xg,), True)
    with pytest.raises(RuntimeError, match="requires grad"):
        kernels.launch("eggshell_amat_f32", torch.device("cpu"), xg)
