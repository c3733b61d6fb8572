"""Host and copy cost a rollout call pays outside its replayed steps: the
benchmark's span around the call less the device span of its replays."""

from portbench.layers import call_overhead_ms as read  # noqa: F401
