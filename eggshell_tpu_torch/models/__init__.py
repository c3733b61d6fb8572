from eggshell_tpu_torch.models.api import Model, Parameter  # noqa: F401
