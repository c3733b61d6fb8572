from eggshell_tpu_torch.parallel.rollout import (  # noqa: F401
    batch_states,
    rollout_batched,
)
# The `rollout` function is not re-exported here: it would shadow the
# `eggshell_tpu_torch.parallel.rollout` module attribute.  Use
# `from eggshell_tpu_torch.parallel.rollout import rollout`.
