"""Batched rollouts, counterpart of `eggshell_tpu.parallel.rollout`.

The JAX package scans the step over the horizon inside one compiled
program; here the horizon is a Python loop over `step_ode_batched`.
"""

from __future__ import annotations

from eggshell_tpu_torch.physics.scene import SceneSpec, State
from eggshell_tpu_torch.physics.stepper import check_supported, step_ode_batched
from eggshell_tpu_torch.utils.config import SimConfig


def rollout_batched(spec: SceneSpec, states: State, cfg: SimConfig, num_steps: int) -> State:
    """Roll B scenarios of one scene `num_steps` steps forward; states
    (B, n, ...).  Returns the final states."""
    check_supported(cfg)
    for _ in range(num_steps):
        states = step_ode_batched(spec, states, cfg)
    return states
