"""Gradient-based MPC through the differentiable rollout.

Counterpart of `eggshell_tpu.mpc.gradient`: plain gradient descent on a
control sequence, each gradient taken by autograd through
`mpc.sampling.rollout_controlled` (one scene, `step_ode`).
"""

from __future__ import annotations

from typing import Callable

import torch

from eggshell_tpu_torch.mpc.sampling import rollout_controlled
from eggshell_tpu_torch.physics.scene import SceneSpec, State
from eggshell_tpu_torch.physics.stepper import check_single_scene
from eggshell_tpu_torch.utils.config import SimConfig


def gradient_mpc_update(spec: SceneSpec, state: State, cfg: SimConfig, controls,
                        cost_fn: Callable[[State], torch.Tensor], controlled_body: int = 0,
                        learning_rate: float = 0.1, steps: int = 10):
    """`steps` updates controls <- controls - learning_rate * d loss / d
    controls, the loss cost_fn(final state) plus the rollout's running cost
    under the wrenches `controls` (H, 6) on `controlled_body`.  Returns
    (controls, cost), cost the loss at the controls before the last update
    (inf without steps), as the JAX package returns it."""
    check_single_scene(cfg)
    c = controls.detach()
    cost = torch.full((), float("inf"), dtype=c.dtype, device=c.device)
    for _ in range(steps):
        var = c.clone().requires_grad_()
        with torch.enable_grad():
            final, run = rollout_controlled(spec, state, cfg, var, controlled_body)
            loss = cost_fn(final) + run
            (g,) = torch.autograd.grad(loss, var)
        c = c - learning_rate * g
        cost = loss.detach()
    return c, cost
