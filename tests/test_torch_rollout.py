"""The port's `parallel.rollout` against the JAX package's, on the CPU.

- `rollout_batched_monitored` on the JAX package's own divergence case
  (`tests/test_mpc_parallel.py`: box_stack(3), float64, B = 6, scenarios 1
  and 4 poisoned with v = 1e9, 20 steps of SolverKind.JACOBI): the flags,
  the count and the first bad steps exactly equal, the final states within
  1e-8, and the healthy scenarios bit for bit the port's unmonitored
  rollout;
- `batch_states` against the JAX package's;
- the capture rule `graph_capturable` on every configuration
  `chip_smoke.py` drives, on `SimConfig()`, on solver_tol > 0, on the
  matrix-free step (which ignores conditional CFM and solver_tol) and on
  the unfused branch with always-on CFM;
- on the CPU the rollouts are the Python loop over `step_ode_batched`,
  bit for bit, and a forced capture raises; the fused step writes into
  the buffers it is given (the captured step's two state buffers).

The captured graph itself runs only on the card
(`tests/test_torch_kernels.py`, marker `cuda`).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eggshell_tpu.parallel.rollout import batch_states as jax_batch_states
from eggshell_tpu.parallel.rollout import rollout_batched_monitored as jax_monitored
from eggshell_tpu.physics import scenes as js
from eggshell_tpu.utils.config import SimConfig as JaxSimConfig
from eggshell_tpu.utils.config import SolverKind as JaxSolverKind
from eggshell_tpu_torch import convert
from eggshell_tpu_torch.parallel.rollout import (batch_states, capture_refusal,
                                                 graph_capturable, rollout_batched,
                                                 rollout_batched_monitored)
from eggshell_tpu_torch.physics import scenes as ts
from eggshell_tpu_torch.physics.stepper import step_ode_batched
from eggshell_tpu_torch.utils.config import BENCH, FrictionModel, SimConfig, SolverKind
from torch_limits import time_limit  # noqa: F401

MONITOR = dict(solver_iters=20, jacobi_omega=0.3, conditional_cfm=False, cfm_always=0.01,
               contact_capacity=20)
B, STEPS = 6, 20
POISONED = np.array([False, True, False, False, True, False])


def _np(nt):
    return {k: np.asarray(v) for k, v in nt._asdict().items()}


def _poisoned():
    spec, st = js.box_stack(3, dtype=jnp.float64)
    states = jax.tree_util.tree_map(lambda x: jnp.broadcast_to(x, (B,) + x.shape).copy(), st)
    states = states._replace(v=jnp.where(jnp.asarray(POISONED)[:, None, None], 1e9, states.v))
    tspec = convert.spec_from_numpy(_np(spec), device="cpu", dtype=torch.float64)
    tstates = convert.state_from_numpy(_np(states), device="cpu", dtype=torch.float64)
    return (spec, states), (tspec, tstates)


def test_monitored_rollout_matches_jax():
    (spec, states), (tspec, tstates) = _poisoned()
    jcfg = JaxSimConfig(solver=JaxSolverKind.JACOBI, **MONITOR)
    want, wdiag = jax_monitored(spec, states, jcfg, STEPS, speed_limit=1e3)
    cfg = SimConfig(solver=SolverKind.JACOBI, **MONITOR)
    got, diag = rollout_batched_monitored(tspec, tstates, cfg, STEPS, speed_limit=1e3)

    np.testing.assert_array_equal(diag["diverged"].numpy(), np.asarray(wdiag["diverged"]))
    np.testing.assert_array_equal(diag["diverged"].numpy(), POISONED)
    assert diag["diverged_count"].dtype == torch.int32
    assert int(diag["diverged_count"]) == int(wdiag["diverged_count"]) == 2
    assert diag["first_bad_step"].dtype == torch.int32
    np.testing.assert_array_equal(diag["first_bad_step"].numpy(),
                                  np.asarray(wdiag["first_bad_step"]))
    for k in "pvqw":
        np.testing.assert_allclose(getattr(got, k).numpy(), np.asarray(getattr(want, k)),
                                   rtol=0, atol=1e-8)
    # frozen at the last good state: the start
    for k in "pvqw":
        assert torch.equal(getattr(got, k)[POISONED], getattr(tstates, k)[POISONED])

    plain = rollout_batched(tspec, tstates, cfg, STEPS)
    ok = ~POISONED
    for k in "pvqw":
        assert torch.equal(getattr(got, k)[ok], getattr(plain, k)[ok])


def test_batch_states_matches_jax():
    sts = [js.box_stack(3, jitter=j, seed=s, dtype=jnp.float64)[1]
           for j, s in ((0.0, 0), (1e-3, 1), (2e-3, 2))]
    want = jax_batch_states(sts)
    got = batch_states([convert.state_from_numpy(_np(s), device="cpu", dtype=torch.float64)
                        for s in sts])
    for k in "pvqw":
        assert getattr(got, k).shape == (3, 3) + getattr(got, k).shape[2:]
        np.testing.assert_array_equal(getattr(got, k).numpy(), np.asarray(getattr(want, k)))


UNFUSED = BENCH.replace(conditional_cfm=True, cond_estimator="power")
# bench.py:298-306's large-scene solver (pile216)
PILE = BENCH.replace(solver=SolverKind.MATRIX_FREE, solver_iters=60, contact_capacity=4096,
                     pair_capacity=2048, broadphase_margin=0.05, max_correcting_vel=2.0)
# Every configuration chip_smoke.py drives, and whether its rollout
# replays a graph on the card.
RULE_CASES = {
    "bench": (BENCH, True),
    "box_drop": (BENCH.replace(contact_capacity=8), True),
    "pendulum_chain6": (BENCH.replace(contact_capacity=4), True),
    "box_stack8": (BENCH.replace(contact_capacity=32), True),
    "living_room": (BENCH.replace(contact_capacity=32), True),
    "box_stack8_k64": (BENCH.replace(contact_capacity=64), True),
    "slice_pyramid": (BENCH.replace(friction_model=FrictionModel.COULOMB_PYRAMID), True),
    "slice_block": (BENCH.replace(jacobi_block=True), True),
    "fused_with_solver_tol": (BENCH.replace(solver_tol=1e-6), True),
    "slice_unfused_power": (UNFUSED, False),
    "joints_unfused": (UNFUSED.replace(contact_capacity=4), False),
    "default_exact_estimator": (SimConfig(), False),
    "plain_solve_with_solver_tol": (SimConfig(conditional_cfm=False, solver_tol=1e-6), False),
    "pile": (PILE, True),
    "pile_conditional_cfm_solver_tol": (PILE.replace(conditional_cfm=True, solver_tol=1e-6),
                                        True),
    "living_room_bp": (BENCH.replace(contact_capacity=32, pair_capacity=6,
                                     broadphase_margin=0.1), True),
    "plain_solve_always_on_cfm": (SimConfig(conditional_cfm=False), True),
}


@pytest.mark.parametrize("name", sorted(RULE_CASES))
def test_graph_capturable_rule(name):
    cfg, want = RULE_CASES[name]
    assert graph_capturable(cfg) is want
    reason = capture_refusal(cfg)
    assert (reason is None) is want
    if not want:
        assert "constants" not in reason
    if name == "default_exact_estimator":
        assert "eigvalsh" in reason
    if name == "slice_unfused_power":
        assert "cholesky" in reason
    if name == "plain_solve_with_solver_tol":
        assert "solver_tol" in reason


def _loop(spec, states, cfg, steps):
    for _ in range(steps):
        states = step_ode_batched(spec, states, cfg)
    return states


@pytest.mark.parametrize("scene", ["box_stack4", "pendulum_chain6"])
def test_cpu_rollout_is_the_loop(scene):
    spec, states, cfg = ts.baseline_batch(scene, 4, device="cpu", dtype=torch.float64)
    got = rollout_batched(spec, states, cfg, 5)
    want = _loop(spec, states, cfg, 5)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    mon, diag = rollout_batched_monitored(spec, states, cfg, 5)
    for g, w in zip(mon, want):
        assert torch.equal(g, w)
    assert not diag["diverged"].any() and int(diag["diverged_count"]) == 0
    assert (diag["first_bad_step"] == 5).all()
    with pytest.raises(ValueError, match="not on a CUDA device"):
        rollout_batched(spec, states, cfg, 5, graph=True)
    with pytest.raises(ValueError, match="not on a CUDA device"):
        rollout_batched_monitored(spec, states, cfg, 5, graph=True)


def test_fused_step_writes_into_given_buffers():
    """The captured step's ping-pong: `_fused_step(out=...)` has B7 write
    the next state into the buffers given, with the same values."""
    from eggshell_tpu_torch.physics.scene import State
    from eggshell_tpu_torch.physics.stepper import _fused_step

    spec, states, cfg = ts.baseline_batch("box_stack4", 3, device="cpu", dtype=torch.float64)
    out = State(*(torch.empty_like(x) for x in states))
    got = _fused_step(spec, states, cfg, out=out)
    want = _fused_step(spec, states, cfg)
    for g, w, o in zip(got, want, out):
        assert torch.equal(g, w) and g.data_ptr() == o.data_ptr()


def test_zero_steps_return_the_start():
    spec, states, cfg = ts.baseline_batch("box_drop", 2, device="cpu", dtype=torch.float64)
    assert rollout_batched(spec, states, cfg, 0) is states
    final, diag = rollout_batched_monitored(spec, states, cfg, 0)
    assert final is states and (diag["first_bad_step"] == 0).all()
