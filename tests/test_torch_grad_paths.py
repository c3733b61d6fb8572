"""Port parity: gradients through every solver path and through a rollout,
against the JAX package, on the CPU in float64.

- One step of `step_ode_batched` under JACOBI, PGS, SOR, DIRECT and
  MATRIX_FREE on box_stack(2, jitter=0.01, seed=1) at B = 2
  (tests/test_diff_kernel.py:106-145's configuration): the gradient of
  sum(p[:, -1, 2]) + sum(v^2) with respect to the wrench against `jax.grad`
  of the JAX package's `step_ode_batched` (its XLA narrowphase), within
  1e-8 of the gradient's largest magnitude (the gradient is of order
  dt^2: 1e-8 absolute would not test it).  The port's unfused branch differentiates through the
  narrowphase's Function, the plain sweeps (PGS and SOR build each row's
  update out of place) and DIRECT's implicit backward.
- A 5-step rollout of the fused step (tests/test_diff_kernel.py:73-100):
  the gradient of sum(p[:, -1, 2]) + 0.1 sum(ext^2) with respect to the
  wrench against `jax.grad` of the JAX package's twin scanned over the
  same steps, within 1e-8 of its largest magnitude, and against the port's unrolled JACOBI within
  1e-2 of its scale (IFT against reverse through unconverged sweeps).
- A rollout whose states require grad loops and refuses a capture.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eggshell_tpu.physics import scenes as js
from eggshell_tpu.physics import stepper as jstep
from eggshell_tpu.utils.config import SimConfig as JaxSimConfig
from eggshell_tpu_torch import convert
from eggshell_tpu_torch.parallel import rollout as trollout
from eggshell_tpu_torch.physics import stepper as tstep
from eggshell_tpu_torch.physics.scene import State
from eggshell_tpu_torch.utils.config import SimConfig, SolverKind
from torch_limits import time_limit  # noqa: F401

B = 2
SOLVERS = {"jacobi": SolverKind.JACOBI, "pgs": SolverKind.PGS, "sor": SolverKind.SOR,
           "direct": SolverKind.DIRECT, "matrix_free": SolverKind.MATRIX_FREE}
# tests/test_diff_kernel.py:32-39
ROLLOUT = dict(conditional_cfm=False, cfm_always=1e-9, solver_iters=30, jacobi_omega=0.3,
               jacobi_beta=0.45, contact_capacity=16)
ROLLOUT_STEPS = 5


def _np(nt):
    return {k: np.asarray(v) for k, v in nt._asdict().items()}


def _jax_cfg(cfg: SimConfig) -> JaxSimConfig:
    return JaxSimConfig.from_json(cfg.to_json())


def _close(got, want, tol, what=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0, atol=tol, err_msg=what)


def _jittered(st, seed):
    out = {k: np.broadcast_to(np.asarray(v), (B,) + v.shape).copy() for k, v in _np(st).items()}
    out["p"] = out["p"] + 1e-4 * np.random.default_rng(seed).normal(size=out["p"].shape)
    return out


def _both(spec, st, seed):
    """(JAX states, the port's spec, the port's states) of B jittered copies."""
    fields = _jittered(st, seed)
    jstates = type(st)(**{k: jnp.asarray(v) for k, v in fields.items()})
    tspec = convert.spec_from_numpy(_np(spec), device="cpu", dtype=torch.float64)
    return jstates, tspec, State(*(torch.tensor(fields[k]) for k in State._fields))


def _solver_cfg(name):
    iters = 0 if name == "direct" else 40
    return SimConfig(conditional_cfm=False, cfm_always=1e-9, solver_iters=iters,
                     jacobi_omega=0.3, contact_capacity=16, solver=SOLVERS[name],
                     contact_kernel=False)


def _solver_scene():
    spec, st = js.box_stack(2, jitter=0.01, seed=1)
    return (spec, st) + _both(spec, st, 7)


@functools.lru_cache(maxsize=None)
def _jax_solver_grads():
    """The JAX package's gradient under every solver, in one program."""
    spec, _, jstates, _, _ = _solver_scene()

    def grads(e):
        def f(jcfg):
            def loss(e_):
                out = jstep.step_ode_batched(spec, jstates, jcfg, e_)
                return jnp.sum(out.p[:, -1, 2]) + jnp.sum(out.v ** 2)
            return jax.grad(loss)(e)
        return {name: f(_jax_cfg(_solver_cfg(name))) for name in SOLVERS}

    out = jax.jit(grads)(jnp.zeros((B, spec.num_bodies, 6)))
    return {name: np.asarray(g) for name, g in out.items()}


@functools.lru_cache(maxsize=None)
def _solver_case(name):
    _, _, _, tspec, tstates = _solver_scene()
    cfg = _solver_cfg(name)
    want = _jax_solver_grads()[name]
    ext = torch.zeros((B, tspec.num_bodies, 6), dtype=torch.float64, requires_grad=True)
    out = tstep.step_ode_batched(tspec, tstates, cfg, ext)
    (torch.sum(out.p[:, -1, 2]) + torch.sum(out.v ** 2)).backward()
    return ext.grad.numpy(), want


@pytest.mark.parametrize("name", sorted(SOLVERS))
def test_every_solver_path_differentiates_as_jax(name):
    got, want = _solver_case(name)
    assert np.isfinite(got).all()
    scale = np.abs(want).max()
    assert scale > 1e-5
    _close(got, want, 1e-8 * scale, name)


def _rollout_loss_torch(spec, states, cfg, ext):
    for _ in range(ROLLOUT_STEPS):
        states = tstep.step_ode_batched(spec, states, cfg, ext)
    return torch.sum(states.p[:, -1, 2]) + 0.1 * torch.sum(ext ** 2)


@functools.lru_cache(maxsize=None)
def _rollout_case():
    spec, st = js.box_stack(2)
    jstates, tspec, tstates = _both(spec, st, 2)
    kcfg = SimConfig(solver=SolverKind.JACOBI_KERNEL, **ROLLOUT)
    jcfg = _jax_cfg(kcfg)

    def f(e):
        def body(s, _):
            return jstep._step_xla_twin(spec, s, jcfg, e), None
        out, _ = jax.lax.scan(body, jstates, None, length=ROLLOUT_STEPS)
        return jnp.sum(out.p[:, -1, 2]) + 0.1 * jnp.sum(e ** 2)

    want = np.asarray(jax.jit(jax.grad(f))(jnp.zeros((B, spec.num_bodies, 6))))
    grads = {}
    for arm, cfg in (("kernel_ift", kcfg), ("unrolled", kcfg.replace(solver=SolverKind.JACOBI))):
        ext = torch.zeros((B, tspec.num_bodies, 6), dtype=torch.float64, requires_grad=True)
        _rollout_loss_torch(tspec, tstates, cfg, ext).backward()
        grads[arm] = ext.grad.numpy()
    return grads, want


def test_rollout_gradient_matches_the_jax_twin():
    grads, want = _rollout_case()
    scale = np.abs(want).max()
    assert scale > 1e-6
    _close(grads["kernel_ift"], want, 1e-8 * scale, "5-step rollout")


def test_rollout_gradient_is_near_unrolled_reverse():
    grads, _ = _rollout_case()
    scale = max(np.abs(grads["unrolled"]).max(), 1e-6)
    _close(grads["kernel_ift"], grads["unrolled"], 1e-2 * scale, "IFT against unrolled")


def test_a_rollout_that_requires_grad_loops_and_refuses_a_capture():
    spec, st = js.box_stack(2)
    _, tspec, tstates = _both(spec, st, 2)
    cfg = SimConfig(solver=SolverKind.JACOBI_KERNEL, **ROLLOUT)
    states = State(*(x.clone().requires_grad_() for x in tstates))
    assert trollout.graph_capturable(cfg)
    assert not trollout._use_graph(states, cfg, None)
    with pytest.raises(ValueError, match="requires grad"):
        trollout.rollout_batched(tspec, states, cfg, 2, graph=True)
    out = trollout.rollout_batched(tspec, states, cfg, 2)
    torch.sum(out.p).backward()
    assert torch.isfinite(states.p.grad).all() and float(states.p.grad.abs().max()) > 0
    assert "DIRECT" in trollout.capture_refusal(cfg.replace(solver=SolverKind.DIRECT))
