"""Device operations a replayed step runs (a count from the trace)."""

from portbench.layers import ops_per_step as read  # noqa: F401
