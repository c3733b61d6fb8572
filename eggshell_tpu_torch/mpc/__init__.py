"""Model-predictive control, counterpart of `eggshell_tpu.mpc`: the sampling
(MPPI) controller and the gradient controller."""

from eggshell_tpu_torch.mpc.gradient import gradient_mpc_update  # noqa: F401
from eggshell_tpu_torch.mpc.sampling import SamplingMPC, mppi_update  # noqa: F401
