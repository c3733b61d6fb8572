"""Scenes, contacts, constraints and the stepper: counterpart of
`eggshell_tpu.physics`, with the same exports.  The stepper's are loaded
on first use: the kernel wrappers of `ops` import this package's modules,
and the stepper imports them."""

from eggshell_tpu_torch.physics.scene import SceneSpec, State  # noqa: F401

_STEPPER = ("step_ode", "step_explicit_euler", "init_stabilize", "post_stabilize",
            "position_constraint_error")
__all__ = ["SceneSpec", "State", *_STEPPER]


def __getattr__(name):
    if name in _STEPPER:
        from eggshell_tpu_torch.physics import stepper

        return getattr(stepper, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
