"""Model-predictive control, counterpart of `eggshell_tpu.mpc`: the sampling
(MPPI) controller.  The gradient controller (`mpc/gradient.py`) waits for
the differentiable step (ROADMAP A10, A11b)."""

from eggshell_tpu_torch.mpc.sampling import SamplingMPC, mppi_update  # noqa: F401
