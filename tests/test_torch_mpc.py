"""Port parity: `eggshell_tpu_torch.mpc.sampling`, the single-scene step
and rollout, against the JAX package, on the CPU in float64.

- Batched, on living_room (S = 8, H = 4, controlled body 4; the bench
  configuration at contact_capacity 32, the fused chain): `_mppi_from_controls`
  against JAX's `mppi_update_batched` fed the controls that function
  draws (`sampling.py:181-192`), in "constant" noise with 1 substep and
  "white" noise with 2; `rollout_controlled_batched` against JAX's with a
  running cost and 2 substeps.  Costs, new mean, final states and running
  costs within 1e-8.  The JAX side has `stepper.step_ode_batched`
  replaced by its XLA twin `_step_xla_twin` (the Pallas chain runs in
  interpret mode on the CPU and takes minutes); the twin is the fused
  chain's math, which the port's plain path matches.
- Single scene: `step_ode` over 6 steps on box_drop and box_stack(3) under
  PGS, JACOBI and SOR (`tests/test_mpc_parallel.py`'s configuration),
  states within 1e-8, ContactSet lanes equal and geometry within 1e-9;
  JACOBI_KERNEL raising on both sides; one matrix-free `step_ode` on
  box_drop and `make_contacts` with the broadphase (pair_capacity 1 of
  box_stack(3)'s 3 pairs) against the JAX package's; `rollout` with its trajectory over
  10 steps; `rollout_controlled` (running cost, 2 substeps) and
  `_mppi_from_controls` as `mppi_update` runs it, at box_drop, S = 8,
  H = 6, within 1e-8; one solver_tol > 0 case at S = 4 (each sample's early
  exit, as JAX's vmapped while loop); `SamplingMPC.control_step`'s
  execution and shift at iterations 0; and its behaviour: 5 control steps
  push the box toward +x (JACOBI: PGS's row loop is slow here).
Everything runs on the plain path: on the CPU a rollout is the Python
loop, and graph=True raises.  The captured update runs on the card only
(`tests/test_torch_kernels.py`, marker `cuda`).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eggshell_tpu.mpc import sampling as jmpc
from eggshell_tpu.parallel.rollout import rollout as jax_rollout
from eggshell_tpu.physics import contacts as jcont
from eggshell_tpu.physics import scenes as js
from eggshell_tpu.physics import stepper as jstep
from eggshell_tpu.utils.config import SimConfig as JaxSimConfig
from eggshell_tpu.utils.config import SolverKind as JaxSolverKind
from eggshell_tpu_torch import convert
from eggshell_tpu_torch.mpc import sampling as tmpc
from eggshell_tpu_torch.parallel.rollout import rollout
from eggshell_tpu_torch.physics.contacts import make_contacts
from eggshell_tpu_torch.physics.scene import State
from eggshell_tpu_torch.physics.stepper import step_ode
from eggshell_tpu_torch.utils.config import BENCH, SimConfig, SolverKind
from torch_limits import time_limit  # noqa: F401

TOL = 1e-8
TARGET = (0.0, 0.0, 0.5)
BODY, S, H = 4, 8, 4
LIVING_ROOM = BENCH.replace(contact_capacity=32)
# tests/test_mpc_parallel.py:14-17
MPC_CFG = dict(solver_iters=40, conditional_cfm=False, cfm_always=0.01, contact_capacity=16)


def _np(nt):
    return {k: np.asarray(v) for k, v in nt._asdict().items()}


def _port(spec, st):
    return (convert.spec_from_numpy(_np(spec), device="cpu", dtype=torch.float64),
            convert.state_from_numpy(_np(st), device="cpu", dtype=torch.float64))


def _jax_cfg(cfg: SimConfig) -> JaxSimConfig:
    return JaxSimConfig.from_json(cfg.to_json())


def _close(got, want, tol=TOL, what=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0, atol=tol, err_msg=what)


def _states_close(got: State, want, tol=TOL):
    for k in "pvqw":
        _close(getattr(got, k).numpy(), getattr(want, k), tol, k)


def _jax_cost(body, target):
    t = jnp.asarray(target)
    return lambda final: jnp.sum((final.p[body] - t) ** 2)


def _torch_cost(body, target):
    t = torch.tensor(target, dtype=torch.float64)
    return lambda final: torch.sum((final.p[body] - t) ** 2)


@pytest.fixture
def xla_twin(monkeypatch):
    """JAX's batched step as its XLA twin: `rollout_controlled_batched`
    imports `step_ode_batched` inside its body."""
    monkeypatch.setattr(jstep, "step_ode_batched", jstep._step_xla_twin)


@functools.lru_cache(maxsize=None)
def _living_room():
    return js.living_room(dtype=jnp.float64)


def _jax_controls(key, mean, num_samples, noise_sigma, noise_mode):
    """The sampled controls exactly as the JAX package's
    `mppi_update_batched` draws them (`sampling.py:181-192`)."""
    if noise_mode == "constant":
        eps = jax.random.normal(key, (num_samples, 1, 6), mean.dtype) * noise_sigma
        eps = jnp.broadcast_to(eps, (num_samples, mean.shape[0], 6))
    else:
        eps = jax.random.normal(key, (num_samples, mean.shape[0], 6), mean.dtype) * noise_sigma
    return mean[None] + eps


BATCHED_MPPI = [("constant", 1), ("white", 2)]
MPPI_KEY = 11


def _batched_mean():
    return np.random.default_rng(0).normal(scale=0.5, size=(H, 6))


def _batched_controls():
    return np.random.default_rng(1).normal(scale=5.0, size=(S, H, 6))


@functools.lru_cache(maxsize=None)
def _jax_batched():
    """JAX's batched results on living_room in one compiled program (one
    compile instead of three): `mppi_update_batched` in each BATCHED_MPPI
    case, and `rollout_controlled_batched` with a running cost and 2
    substeps.  Called under the `xla_twin` fixture."""
    spec, st = _living_room()
    jcfg = _jax_cfg(LIVING_ROOM)
    cost = _jax_cost(BODY, TARGET)

    def run(mean, key, ctrls):
        updates = [jmpc.mppi_update_batched(spec, st, jcfg, mean, key, cost, controlled_body=BODY,
                                            num_samples=S, noise_sigma=5.0, temperature=1.0,
                                            noise_mode=mode, substeps=sub)
                   for mode, sub in BATCHED_MPPI]
        states = jax.tree_util.tree_map(lambda x: jnp.broadcast_to(x, (S,) + x.shape), st)
        rollout = jmpc.rollout_controlled_batched(spec, states, jcfg, ctrls, BODY,
                                                  running_cost=cost, substeps=2)
        return updates, rollout

    updates, (final, run_cost) = jax.jit(run)(jnp.asarray(_batched_mean()),
                                              jax.random.PRNGKey(MPPI_KEY),
                                              jnp.asarray(_batched_controls()))
    return ({case: tuple(map(np.asarray, u)) for case, u in zip(BATCHED_MPPI, updates)},
            (_np(final), np.asarray(run_cost)))


@pytest.mark.parametrize("noise_mode,substeps", BATCHED_MPPI)
def test_mppi_from_controls_matches_jax_batched(xla_twin, noise_mode, substeps):
    spec, st = _living_room()
    want_mean, want_costs = _jax_batched()[0][(noise_mode, substeps)]
    ctrls = torch.as_tensor(np.array(_jax_controls(jax.random.PRNGKey(MPPI_KEY),
                                                   jnp.asarray(_batched_mean()), S, 5.0,
                                                   noise_mode)))
    tspec, tst = _port(spec, st)
    got_mean, got_costs = tmpc._mppi_from_controls(tspec, tst, LIVING_ROOM, ctrls,
                                                   _torch_cost(BODY, TARGET), BODY, 1.0, substeps,
                                                   None)
    _close(got_costs.numpy(), want_costs, what="costs")
    _close(got_mean.numpy(), want_mean, what="new mean")
    assert np.ptp(np.asarray(want_costs)) > 1e-6       # the samples' costs differ


def test_rollout_controlled_batched_matches_jax(xla_twin):
    want, want_run = _jax_batched()[1]
    tspec, tst = _port(*_living_room())
    tstates = State(*(x.expand((S,) + x.shape) for x in tst))
    got, got_run = tmpc.rollout_controlled_batched(
        tspec, tstates, LIVING_ROOM, torch.as_tensor(_batched_controls()), BODY,
        running_cost=_torch_cost(BODY, TARGET), substeps=2)
    for k in "pvqw":
        _close(getattr(got, k).numpy(), want[k], what=k)
    _close(got_run.numpy(), want_run, what="running cost")
    # the wrenches moved the controlled body: the samples part
    assert float(got.p[:, BODY].std(0).max()) > 1e-6


def test_controlled_rollout_on_cpu_is_the_loop_and_refuses_a_capture():
    _, (tspec, tst) = None, _port(*_living_room())
    states = State(*(x.expand((2,) + x.shape) for x in tst))
    ctrls = torch.ones((2, 2, 6), dtype=torch.float64)
    got, run = tmpc.rollout_controlled_batched(tspec, states, LIVING_ROOM, ctrls, BODY)
    want, _ = tmpc.rollout_controlled_batched(tspec, states, LIVING_ROOM, ctrls, BODY,
                                              graph=False)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert torch.equal(run, torch.zeros(2, dtype=torch.float64))
    with pytest.raises(ValueError, match="not on a CUDA device"):
        tmpc.rollout_controlled_batched(tspec, states, LIVING_ROOM, ctrls, BODY, graph=True)
    with pytest.raises(ValueError, match="not on a CUDA device"):
        tmpc.mppi_update_batched(tspec, tst, LIVING_ROOM, torch.zeros((2, 6), dtype=torch.float64),
                                 torch.Generator().manual_seed(0), _torch_cost(BODY, TARGET),
                                 BODY, num_samples=2, graph=True)


@pytest.mark.parametrize("noise_mode", ["constant", "white"])
def test_mppi_update_draws_one_randn_and_reweights(noise_mode):
    """`mppi_update_batched` with a generator is `_mppi_from_controls` on
    the controls `_sample` draws from the same seed: one torch.randn of
    (S, 1, 6) ("constant", held over the horizon) or (S, H, 6)."""
    spec, st = js.box_drop(height=0.15, dtype=jnp.float64)
    tspec, tst = _port(spec, st)
    cfg = SimConfig(solver=SolverKind.JACOBI, **MPC_CFG)
    mean = torch.linspace(-1.0, 1.0, 18, dtype=torch.float64).reshape(3, 6)
    cost = _torch_cost(0, (0.05, 0.0, 0.15))
    got = tmpc.mppi_update(tspec, tst, cfg, mean, torch.Generator().manual_seed(5), cost,
                           num_samples=4, noise_sigma=2.0, temperature=0.1,
                           noise_mode=noise_mode)
    ctrls = tmpc._sample(mean, torch.Generator().manual_seed(5), 4, 2.0, noise_mode)
    eps = torch.randn((4, 1 if noise_mode == "constant" else 3, 6), dtype=torch.float64,
                      generator=torch.Generator().manual_seed(5))
    assert torch.equal(ctrls, mean[None] + eps * 2.0)
    want = tmpc._mppi_from_controls(tspec, tst, cfg, ctrls, cost, 0, 0.1, 1, False)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    batched = tmpc.mppi_update_batched(tspec, tst, cfg, mean, torch.Generator().manual_seed(5),
                                       cost, num_samples=4, noise_sigma=2.0, temperature=0.1,
                                       noise_mode=noise_mode)
    assert all(torch.equal(g, w) for g, w in zip(batched, want))


SINGLE_SCENES = {
    "box_drop": lambda: js.box_drop(height=0.15, dtype=jnp.float64),
    "box_stack3": lambda: js.box_stack(3, jitter=1e-3, dtype=jnp.float64),
}
SINGLE_SOLVERS = {"pgs": JaxSolverKind.PGS, "jacobi": JaxSolverKind.JACOBI,
                  "sor": JaxSolverKind.SOR}
STEPS = 6


@functools.lru_cache(maxsize=None)
def _jax_steps():
    """JAX's `step_ode` free runs of STEPS steps, each scene under each
    solver in one compiled program: each step's state and ContactSet,
    stacked, by (scene, solver)."""
    scenes = {scene: build() for scene, build in SINGLE_SCENES.items()}

    def run(starts):
        out = {}
        for scene, (spec, _) in scenes.items():
            for solver, kind in SINGLE_SOLVERS.items():
                jcfg = JaxSimConfig(solver=kind, **MPC_CFG)

                def body(s, _, spec=spec, jcfg=jcfg):
                    nxt, cs = jstep.step_ode(spec, s, jcfg)
                    return nxt, (nxt, cs)

                out[scene, solver] = jax.lax.scan(body, starts[scene], None, length=STEPS)[1]
        return out

    out = jax.jit(run)({scene: st for scene, (_, st) in scenes.items()})
    return {k: (_np(states), _np(css)) for k, (states, css) in out.items()}


@pytest.mark.parametrize("solver", sorted(SINGLE_SOLVERS))
@pytest.mark.parametrize("scene", sorted(SINGLE_SCENES))
def test_step_ode_matches_jax(scene, solver):
    want_states, want_cs = _jax_steps()[scene, solver]
    tspec, state = _port(*SINGLE_SCENES[scene]())
    cfg = SimConfig(solver=SolverKind[solver.upper()], **MPC_CFG)
    for i in range(STEPS):
        state, cs = step_ode(tspec, state, cfg)
        for k in "pvqw":
            _close(getattr(state, k).numpy(), want_states[k][i], what=f"step {i} {k}")
        for k in ("b0", "b1", "active"):
            np.testing.assert_array_equal(getattr(cs, k).numpy(), want_cs[k][i],
                                          err_msg=f"step {i} {k}")
        for k in ("position", "normal", "depth"):
            _close(getattr(cs, k).numpy(), want_cs[k][i], 1e-9, f"step {i} {k}")
    assert cs.active.sum() >= 4 and state.p.shape == (tspec.num_bodies, 3)


def test_unported_and_refused_configurations_raise():
    spec, st = js.box_drop(height=0.15, dtype=jnp.float64)
    with pytest.raises(KeyError):
        jstep.step_ode(spec, st, JaxSimConfig(solver=JaxSolverKind.JACOBI_KERNEL, **MPC_CFG))
    tspec, tst = _port(spec, st)
    cfg = SimConfig(solver=SolverKind.JACOBI_KERNEL, **MPC_CFG)
    mean = torch.zeros((2, 6), dtype=torch.float64)
    calls = [lambda: step_ode(tspec, tst, cfg), lambda: rollout(tspec, tst, cfg, 2),
             lambda: tmpc.rollout_controlled(tspec, tst, cfg, mean, 0),
             lambda: tmpc.mppi_update(tspec, tst, cfg, mean, torch.Generator(),
                                      _torch_cost(0, TARGET), num_samples=2)]
    for call in calls:
        with pytest.raises(ValueError, match="JACOBI_KERNEL"):
            call()
    # the matrix-free step and the broadphase (pair_capacity below the
    # scene's pairs) match the JAX package's
    mcfg = cfg.replace(solver=SolverKind.MATRIX_FREE)
    got, got_cs = step_ode(tspec, tst, mcfg)
    want, want_cs = jstep.step_ode(spec, st, _jax_cfg(mcfg))
    _states_close(got, want)
    np.testing.assert_array_equal(got_cs.active.numpy(), np.asarray(want_cs.active))
    bspec, bst = js.box_stack(3, dtype=jnp.float64)
    sspec, sst = _port(bspec, bst)
    bcfg = SimConfig(pair_capacity=1, **MPC_CFG)
    got_cs = make_contacts(sspec, sst, bcfg)
    want_cs = _np(jax.jit(lambda s: jcont.make_contacts(bspec, s, _jax_cfg(bcfg)))(bst))
    for k in ("b0", "b1", "active"):
        np.testing.assert_array_equal(getattr(got_cs, k).numpy(), want_cs[k], err_msg=k)
    for k in ("position", "normal", "depth"):
        _close(getattr(got_cs, k).numpy(), want_cs[k], 1e-9, k)
    assert int(got_cs.active.sum()) > 0


# single-scene MPPI cases at box_drop: (solver, samples, configuration
# besides MPC_CFG); the solver_tol case stops each sample's sweeps on its own
SINGLE_MPPI = {"pgs_s8_h6": (SolverKind.PGS, 8, {}),
               "jacobi_solver_tol_s4": (SolverKind.JACOBI, 4,
                                        {"solver_tol": 1e-7, "solver_iters": 200})}
SINGLE_H, SINGLE_TARGET, PUSH_TARGET = 6, (0.05, 0.0, 0.15), (0.2, 0.0, 0.15)


def _single_cfg(case) -> SimConfig:
    solver, _, extra = SINGLE_MPPI[case]
    return SimConfig(solver=solver, **{**MPC_CFG, **extra})


def _push_controls():
    ctrls = np.zeros((SINGLE_H, 6))
    ctrls[:, 0] = np.linspace(10.0, 30.0, SINGLE_H)
    ctrls[:, 4] = 0.5
    return ctrls


def _single_mean():
    return jnp.zeros((SINGLE_H, 6)).at[:, 0].set(20.0)


def _plan():
    return np.random.default_rng(3).normal(scale=20.0, size=(5, 6))


def _box_drop():
    return js.box_drop(height=0.15, dtype=jnp.float64)


@functools.lru_cache(maxsize=None)
def _jax_single():
    """JAX's single-scene results at box_drop in one compiled program:
    `rollout` with its trajectory (JACOBI, 10 steps), `rollout_controlled`
    (PGS, a running cost, 2 substeps), `mppi_update` in each SINGLE_MPPI
    case, and `SamplingMPC.control_step` at iterations 0 (JACOBI, 2
    substeps)."""
    spec, st = _box_drop()
    jacobi = JaxSimConfig(solver=JaxSolverKind.JACOBI, **MPC_CFG)
    mpc = jmpc.SamplingMPC(spec=spec, cfg=jacobi, cost_fn=_jax_cost(0, TARGET), horizon=5,
                           num_samples=4, iterations=0, substeps=2)

    def run(start, push, mean, plan, key):
        out = {"rollout": jax_rollout(spec, start, jacobi, 10, keep_trajectory=True),
               "controlled": jmpc.rollout_controlled(
                   spec, start, JaxSimConfig(solver=JaxSolverKind.PGS, **MPC_CFG), push, 0,
                   running_cost=_jax_cost(0, PUSH_TARGET), substeps=2),
               "control_step": mpc.control_step(start, plan, key)}
        for case, (_, num, _) in SINGLE_MPPI.items():
            out[case] = jmpc.mppi_update(spec, start, _jax_cfg(_single_cfg(case)), mean, key,
                                         _jax_cost(0, SINGLE_TARGET), num_samples=num,
                                         noise_sigma=15.0, temperature=3e-4,
                                         noise_mode="constant")
        return out

    out = jax.jit(run)(st, jnp.asarray(_push_controls()), _single_mean(), jnp.asarray(_plan()),
                       jax.random.PRNGKey(2))
    return jax.tree_util.tree_map(np.asarray, out)


def test_rollout_keeps_its_trajectory_as_jax():
    want, want_traj = _jax_single()["rollout"]
    tspec, tst = _port(*_box_drop())
    cfg = SimConfig(solver=SolverKind.JACOBI, **MPC_CFG)
    got, traj = rollout(tspec, tst, cfg, 10, keep_trajectory=True)
    _states_close(got, want)
    for k in "pvqw":
        assert getattr(traj, k).shape == (10,) + getattr(tst, k).shape
        _close(getattr(traj, k).numpy(), getattr(want_traj, k), what=k)
        assert torch.equal(getattr(traj, k)[-1], getattr(got, k))
    final, none = rollout(tspec, tst, cfg, 10)
    assert none is None and all(torch.equal(a, b) for a, b in zip(final, got))
    start, empty = rollout(tspec, tst, cfg, 0, keep_trajectory=True)
    assert start is tst and empty.p.shape == (0,) + tst.p.shape


def test_rollout_controlled_matches_jax():
    want, want_run = _jax_single()["controlled"]
    tspec, tst = _port(*_box_drop())
    got, run = tmpc.rollout_controlled(tspec, tst, SimConfig(**MPC_CFG),
                                       torch.as_tensor(_push_controls()), 0,
                                       running_cost=_torch_cost(0, PUSH_TARGET), substeps=2)
    _states_close(got, want)
    _close(run.numpy(), want_run, what="running cost")
    assert float(got.p[0, 0] - tst.p[0, 0]) > 1e-6     # pushed along +x


@pytest.mark.parametrize("case", sorted(SINGLE_MPPI))
def test_single_scene_mppi_matches_jax(case):
    """`mppi_update`'s update from JAX's controls: the samples as one batch
    on the unfused branch against JAX's vmap of `step_ode`; under
    solver_tol > 0 each sample stops its sweeps on its own, as in JAX's
    vmapped while loop."""
    want_mean, want_costs = _jax_single()[case]
    num = SINGLE_MPPI[case][1]
    ctrls = torch.as_tensor(np.array(_jax_controls(jax.random.PRNGKey(2), _single_mean(), num,
                                                   15.0, "constant")))
    tspec, tst = _port(*_box_drop())
    cfg, cost = _single_cfg(case), _torch_cost(0, SINGLE_TARGET)
    got_mean, got_costs = tmpc._mppi_from_controls(tspec, tst, cfg, ctrls, cost, 0, 3e-4, 1, False)
    _close(got_costs.numpy(), want_costs, what="costs")
    _close(got_mean.numpy(), want_mean, what="new mean")
    if cfg.solver_tol > 0:
        # the early exit binds: a full 200 sweeps give another update
        full, _ = tmpc._mppi_from_controls(tspec, tst, cfg.replace(solver_tol=0.0), ctrls, cost,
                                           0, 3e-4, 1, False)
        assert float((full - got_mean).abs().max()) > 0.0


def test_control_step_executes_and_shifts_as_jax():
    """At iterations 0 the plan is the mean: the first control is applied
    for `substeps` steps and the plan shifts by one with a zero last
    control, as in the JAX package."""
    want, want_plan, want_best = _jax_single()["control_step"]
    tspec, tst = _port(*_box_drop())
    mpc = tmpc.SamplingMPC(spec=tspec, cfg=SimConfig(solver=SolverKind.JACOBI, **MPC_CFG),
                           cost_fn=_torch_cost(0, TARGET), horizon=5, num_samples=4,
                           iterations=0, substeps=2)
    got, plan, best = mpc.control_step(tst, torch.as_tensor(_plan()), torch.Generator())
    _states_close(got, want)
    np.testing.assert_array_equal(plan.numpy(), want_plan)
    assert np.isinf(want_best) and torch.isinf(best)


def test_receding_horizon_pushes_the_box_toward_x():
    """`test_receding_horizon_driver`'s task in the port: 5 control steps
    of one MPPI update each (S = 32, H = 20) push the box toward +x.  The
    samples' costs differ by about 1e-5 here, so at that test's
    temperature 0.2 the weights are uniform to 1e-5 and the push takes the
    sign of the noise's mean (the port moved the box -5.9e-5 to +2.7e-6 m
    for generator seeds 0 to 5); at 1e-6 the weights follow the costs and
    every one of those seeds pushed it 3.3e-4 to 6.7e-4 m along +x."""
    spec, st = js.box_drop(height=0.15, dtype=jnp.float64)
    tspec, tst = _port(spec, st)
    mpc = tmpc.SamplingMPC(spec=tspec, cfg=SimConfig(solver=SolverKind.JACOBI, **MPC_CFG),
                           cost_fn=_torch_cost(0, (0.2, 0.0, 0.15)), horizon=20, num_samples=32,
                           noise_sigma=20.0, temperature=1e-6, iterations=1)
    mean = torch.zeros((mpc.horizon, 6), dtype=torch.float64)
    gen = torch.Generator().manual_seed(1)
    state = tst
    for _ in range(5):
        state, mean, best = mpc.control_step(state, mean, gen)
        assert torch.isfinite(best)
    assert all(bool(torch.isfinite(x).all()) for x in state)
    assert float(state.p[0, 0]) > 0.0
    assert mean.shape == (20, 6) and bool((mean[-1] == 0).all())
