"""Optimizers, counterpart of `eggshell_tpu.opt`, with the same exports."""

from eggshell_tpu_torch.opt.levenberg_marquardt import (  # noqa: F401
    LMOptions,
    levenberg_marquardt,
)
from eggshell_tpu_torch.opt.nelder_mead import nelder_mead  # noqa: F401
from eggshell_tpu_torch.opt.optimizer import (  # noqa: F401
    AbstractOptimizer,
    OptimizerFactory,
    RepeatedOptimizer,
)
from eggshell_tpu_torch.opt.random_search import random_search  # noqa: F401
