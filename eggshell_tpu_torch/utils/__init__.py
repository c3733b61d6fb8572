from eggshell_tpu_torch.utils.config import SimConfig  # noqa: F401
