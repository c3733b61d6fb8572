"""Sampling (MPPI) model-predictive control over batched rollouts.

Counterpart of `eggshell_tpu.mpc.sampling`.  Controls are per-step
wrenches [force; torque] on one designated body, a sequence (H, 6); a cost
takes one scene's State to a scalar, written as for the JAX package, and
is mapped over the samples with `torch.func.vmap`.  The noise comes from a
`torch.Generator` where the JAX package takes a key: one `torch.randn` an
update, on the generator's device.

- `rollout_controlled_batched` and `mppi_update_batched` step every sample
  with `step_ode_batched`.  On the card, where
  `parallel.rollout.graph_capturable(cfg)` (the fused chain), a control
  period is captured in a CUDA graph (`parallel.rollout.StepGraph` with a
  control input) and replayed H times an update; elsewhere on the card the
  horizon is a Python loop with a `RolloutLoopWarning`.  `graph` behaves
  as in `parallel.rollout.rollout_batched`.
- `rollout_controlled`, `mppi_update` and `SamplingMPC` step one scene
  through `step_ode`: PGS, JACOBI, SOR or DIRECT, and JACOBI_KERNEL
  refused, as the JAX package's single-scene path fails there.
  `rollout_controlled` is differentiable with respect to the controls
  (`mpc.gradient`): the wrench is written into its slot of a fresh zero
  tensor, which autograd records.  `mppi_update` rolls its
  samples as one batch on the unfused branch of `step_ode_batched`, the
  vmap of the JAX package's `step_ode`.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from eggshell_tpu_torch.parallel.rollout import _fresh, _replayed, _use_graph
from eggshell_tpu_torch.physics.scene import SceneSpec, State
from eggshell_tpu_torch.physics.stepper import check_single_scene, step_ode, step_ode_batched
from eggshell_tpu_torch.utils.config import SimConfig


def _wrench(spec: SceneSpec, controlled_body: int, ctrl, like):
    """Zero wrenches (..., n, 6) in `like`'s dtype with `ctrl` (..., 6) in
    the controlled body's slot."""
    ext = torch.zeros(ctrl.shape[:-1] + (spec.num_bodies, 6), dtype=like.dtype,
                      device=like.device)
    ext[..., controlled_body, :] = ctrl
    return ext


def rollout_controlled(spec: SceneSpec, state: State, cfg: SimConfig, controls,
                       controlled_body: int, running_cost=None, substeps: int = 1):
    """Roll one scene out under the wrenches `controls` (H, 6) on
    `controlled_body`, each held for `substeps` steps of `step_ode`.
    Returns (final_state, total running cost), the running cost summed
    after each control period (0 without `running_cost`)."""
    acc = torch.zeros((), dtype=state.p.dtype, device=state.p.device)
    for ctrl in controls:
        ext = _wrench(spec, controlled_body, ctrl, state.p)
        for _ in range(substeps):
            state, _ = step_ode(spec, state, cfg, ext_force=ext)
        if running_cost is not None:
            acc = acc + running_cost(state)
    return state, acc


def rollout_controlled_batched(spec: SceneSpec, states: State, cfg: SimConfig, controls,
                               controlled_body: int, running_cost=None, substeps: int = 1,
                               graph=None):
    """Roll S samples out, states (S, ...) and `controls` (S, H, 6), every
    step of every sample one `step_ode_batched` step (on the card, a
    captured control period replayed H times, see the module).  Returns
    (final_states (S, ...), total running cost (S,))."""
    S, H = controls.shape[:2]
    if H > 0 and _use_graph(states, cfg, graph, controls):
        g = _replayed(spec, states, cfg, H, controls=controls, controlled_body=controlled_body,
                      substeps=substeps, running_cost=running_cost)
        acc = g.acc.clone() if running_cost is not None else torch.zeros_like(g.acc)
        return _fresh(g.state), acc
    acc = torch.zeros(S, dtype=states.p.dtype, device=states.p.device)
    for t in range(H):
        ext = _wrench(spec, controlled_body, controls[:, t], states.p)
        for _ in range(substeps):
            states = step_ode_batched(spec, states, cfg, ext_forces=ext)
        if running_cost is not None:
            acc = acc + torch.func.vmap(running_cost)(states)
    return states, acc


def _sample(mean_controls, generator: torch.Generator, num_samples: int, noise_sigma: float,
            noise_mode: str):
    """(S, H, 6) sampled control sequences: the mean plus sigma times one
    `torch.randn` on `generator` (one wrench a sample held over the horizon
    for "constant", else one a step)."""
    H = mean_controls.shape[0]
    shape = (num_samples, 1 if noise_mode == "constant" else H, 6)
    eps = torch.randn(shape, generator=generator, dtype=mean_controls.dtype,
                      device=generator.device) * noise_sigma
    return mean_controls[None] + eps.to(mean_controls.device)


def _mppi_from_controls(spec: SceneSpec, state: State, cfg: SimConfig, ctrls, cost_fn,
                        controlled_body: int, temperature: float, substeps: int, graph):
    """The MPPI update from the sampled controls `ctrls` (S, H, 6): each
    sample rolled out from `state`, its cost, and the controls weighted by
    exp(-(cost - min cost) / temperature), normalised.  Returns
    (new_mean (H, 6), costs (S,))."""
    S = ctrls.shape[0]
    states = State(*(x.expand((S,) + x.shape) for x in state))
    final, run = rollout_controlled_batched(spec, states, cfg, ctrls, controlled_body,
                                            substeps=substeps, graph=graph)
    costs = torch.func.vmap(cost_fn)(final) + run
    beta = torch.min(costs)
    wts = torch.exp(-(costs - beta) / temperature)
    wts = wts / torch.sum(wts)
    return torch.einsum("s,shc->hc", wts, ctrls), costs


def mppi_update_batched(spec: SceneSpec, state: State, cfg: SimConfig, mean_controls,
                        generator: torch.Generator, cost_fn: Callable, controlled_body: int = 0,
                        num_samples: int = 256, noise_sigma: float = 1.0,
                        temperature: float = 1.0, noise_mode: str = "white",
                        substeps: int = 1, graph=None):
    """One MPPI iteration on the batched rollout (`rollout_controlled_batched`):
    `num_samples` perturbed sequences of `mean_controls` (H, 6), rolled out
    from `state` (one scene), re-weighted by `cost_fn` of each final state.
    noise_mode "constant" draws one wrench a sample held over the horizon,
    anything else one a step.  Returns (new_mean_controls, costs)."""
    ctrls = _sample(mean_controls, generator, num_samples, noise_sigma, noise_mode)
    return _mppi_from_controls(spec, state, cfg, ctrls, cost_fn, controlled_body, temperature,
                               substeps, graph)


def mppi_update(spec: SceneSpec, state: State, cfg: SimConfig, mean_controls,
                generator: torch.Generator, cost_fn: Callable, controlled_body: int = 0,
                num_samples: int = 256, noise_sigma: float = 1.0, temperature: float = 1.0,
                noise_mode: str = "white", substeps: int = 1):
    """`mppi_update_batched` on the single-scene step (`step_ode`'s
    solvers): the samples roll as one batch on the unfused branch, the
    Python loop.  Returns (new_mean_controls, costs)."""
    check_single_scene(cfg)
    ctrls = _sample(mean_controls, generator, num_samples, noise_sigma, noise_mode)
    return _mppi_from_controls(spec, state, cfg, ctrls, cost_fn, controlled_body, temperature,
                               substeps, graph=False)


class SamplingMPC(NamedTuple):
    """Receding-horizon driver: at each control step, refine the mean with
    `iterations` MPPI updates (white noise), apply its first control for
    `substeps` steps, and shift the plan."""

    spec: SceneSpec
    cfg: SimConfig
    cost_fn: Callable
    controlled_body: int = 0
    horizon: int = 20
    num_samples: int = 256
    noise_sigma: float = 1.0
    temperature: float = 1.0
    iterations: int = 1
    substeps: int = 1

    def plan(self, state: State, mean_controls, generator: torch.Generator):
        """(refined mean, the last update's lowest cost); inf without
        iterations."""
        mc = mean_controls
        best = torch.tensor(float("inf"), dtype=mc.dtype, device=mc.device)
        for _ in range(self.iterations):
            mc, costs = mppi_update(self.spec, state, self.cfg, mc, generator, self.cost_fn,
                                    self.controlled_body, self.num_samples, self.noise_sigma,
                                    self.temperature, substeps=self.substeps)
            best = torch.min(costs)
        return mc, best

    def control_step(self, state: State, mean_controls, generator: torch.Generator):
        """Plan, execute the first control, shift the plan.  Returns
        (next state, shifted plan, best cost)."""
        mc, best = self.plan(state, mean_controls, generator)
        ext = _wrench(self.spec, self.controlled_body, mc[0], state.p)
        for _ in range(self.substeps):
            state, _ = step_ode(self.spec, state, self.cfg, ext_force=ext)
        return state, torch.cat([mc[1:], torch.zeros_like(mc[:1])]), best
