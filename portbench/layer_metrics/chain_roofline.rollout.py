"""The least time of a step's work over the device time of a replayed step,
in percent: the step's bytes from the cell's shapes, its flops from the
contacts the plain reference found in the run's checked answers
(portbench.work)."""

from portbench.layers import chain_roofline as read  # noqa: F401
