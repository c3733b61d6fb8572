"""The share of the traced stretch with no device operation running."""

from portbench.layers import device_idle_pct as read  # noqa: F401
