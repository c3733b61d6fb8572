"""Device ms of the NCCL collectives an MPPI update runs on rank 0,
their wait for the slowest rank included."""

from portbench.layers import collectives_ms as read  # noqa: F401
