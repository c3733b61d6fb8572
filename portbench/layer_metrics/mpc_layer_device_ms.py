"""Device ms an MPPI update spends outside the replayed control periods
(sampling, cost, weights, new mean, copies), collectives left out."""

from portbench.layers import outside_replays_ms as read  # noqa: F401
