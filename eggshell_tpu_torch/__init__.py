"""eggshell_tpu_torch — the PyTorch/CUDA port of `eggshell_tpu`.

The package mirrors the JAX package's subpackage and module names, so
each counterpart is easy to find:

- ``eggshell_tpu_torch.ops``      — quaternion math, SAT narrowphase (plain
  torch + hand-written CUDA kernel), projected-Jacobi LCP (plain torch +
  hand-written CUDA kernel).
- ``eggshell_tpu_torch.physics``  — scenes, contacts, constraints, stepper.
- ``eggshell_tpu_torch.parallel`` — batched rollouts, and one scene's.
- ``eggshell_tpu_torch.mpc``      — sampling (MPPI) model-predictive control.
- ``eggshell_tpu_torch.kernels``  — builds and loads the CUDA sources in
  ``csrc/`` at first use.
- ``eggshell_tpu_torch.convert``  — JAX-package scenes/states (as numpy
  arrays) to the port's tensors.

It imports torch and never jax, nor anything of the JAX package.  Its
`utils.config.SimConfig` has the fields and defaults of the JAX
package's, so one configuration drives both.
"""

import torch

__version__ = "0.1.0"

from eggshell_tpu_torch.utils.config import FrictionModel, SimConfig, SolverKind  # noqa: F401

# The system matrix and the constraint products must stay in full float32
# on the card: TF32 keeps about three decimal digits.  This is PyTorch's
# default already; the port states it rather than relying on it.
torch.backends.cuda.matmul.allow_tf32 = False
